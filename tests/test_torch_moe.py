"""The port's mixture-of-experts layer on the CPU, held to the JAX package.

Each case feeds the same inputs, from numpy seeds, to the port's
``models/moe.py`` and the reference's, with the reference's params from
``jax.random`` carried across by ``convert``: the router (probabilities,
top-k weights and ids), the load-balance loss, the expert FFN, the
dispatch against ``moe_onehot`` with no drops and at capacity (the same
kept slots as the reference's formula, the output within 1e-5), a tie in
router probability going to the lower expert id, the shared experts, and
``apply_moe``'s branch: no drops at E <= 64, capacity at E = 72 (kimi's
``reduced()`` has 4 experts and never reaches it).  Then the reference's
``tests/test_moe.py`` cases on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as ModelConfigRef
from repro.configs.base import MoEConfig as MoEConfigRef
from repro.models import moe as moe_ref
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe

ATOL = 1e-5
# the reference's functions compiled whole: one compile a shape, where its
# eager ops compile one by one
onehot_ref = jax.jit(moe_ref.moe_onehot, static_argnums=0,
                     static_argnames=("group", "no_drop"))
apply_ref = jax.jit(moe_ref.apply_moe, static_argnums=0,
                    static_argnames=("ep_mode", "no_drop"))
route_ref = jax.jit(moe_ref._route, static_argnums=0)
init_ref = jax.jit(moe_ref.init_moe, static_argnums=(1, 2))


def make_cfgs(E=4, k=2, d=32, f=64, cf=8.0, variant="swiglu", shared=0,
              group=512):
    """tests/test_moe.py's config, on both sides."""
    kw = dict(name="test-moe", family="moe", n_layers=1, d_model=d,
              n_heads=2, n_kv_heads=2, d_ff=f, vocab_size=64,
              mlp_variant=variant, dtype="float32", param_dtype="float32")
    mk = dict(n_experts=E, top_k=k, d_ff_expert=f, capacity_factor=cf,
              n_shared_experts=shared, dispatch_group=group)
    return (ModelConfigRef(**kw, moe=MoEConfigRef(**mk)),
            ModelConfig(**kw, moe=MoEConfig(**mk)))


def _params(cfg_ref, key=0):
    p_ref = init_ref(jax.random.PRNGKey(key), "moe", cfg_ref)
    return p_ref, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p_ref), "cpu")


def _x(shape, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def reference_keep(top_idx, E: int, cap: int) -> np.ndarray:
    """The kept slots (N, g, k) by the lines of the reference's
    ``moe_onehot`` that compute them, from its top-k ids."""
    N, g, k = top_idx.shape
    sel = jax.nn.one_hot(top_idx, E, dtype=jnp.float32)
    pos_in_e = jnp.cumsum(sel.reshape(N, g * k, E), axis=1) - 1.0
    pos_in_e = pos_in_e.reshape(N, g, k, E)
    keep = (pos_in_e < cap) & (sel > 0)
    return np.asarray(keep.any(-1))


# -- the layer's parts ------------------------------------------------------


@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (72, 8), (384, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_reference(E, k, dtype):
    cfg_ref, cfg = make_cfgs(E=E, k=k)
    _, p = _params(cfg_ref)
    x = _x((2, 9, cfg.d_model))
    xt = torch.tensor(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    got = moe.route(cfg, p["router"], xt)
    want = route_ref(cfg_ref, jnp.asarray(p["router"].numpy()), xj)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_route_breaks_ties_by_the_lower_expert_id():
    """Experts 1, 3 and 5 share a router column, so every token's
    probabilities tie among them; ``jax.lax.top_k`` takes the lower ids
    first, and so must the port."""
    cfg_ref, cfg = make_cfgs(E=6, k=2)
    w = _x((cfg.d_model, 6), seed=3)
    w[:, 3] = w[:, 5] = w[:, 1]
    w[:, 1] += 3.0  # make the tied three the top of every token
    w[:, 3] += 3.0
    w[:, 5] += 3.0
    x = np.abs(_x((1, 7, cfg.d_model), seed=4))
    _, _, got = moe.route(cfg, torch.tensor(w), torch.tensor(x))
    _, _, want = route_ref(cfg_ref, jnp.asarray(w), jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == [1, 3]).all()


def test_aux_loss_matches_reference():
    cfg_ref, cfg = make_cfgs(E=8, k=2)
    _, p = _params(cfg_ref)
    x = _x((3, 11, cfg.d_model))
    probs, _, idx = moe.route(cfg, p["router"], torch.tensor(x))
    want = moe_ref._aux_loss(cfg_ref, jnp.asarray(probs.numpy()),
                             jnp.asarray(idx.numpy()))
    _close(moe.aux_loss(cfg, probs, idx), want)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "squared_relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_reference(variant, dtype):
    cfg_ref, cfg = make_cfgs(E=4, variant=variant)
    p_ref, p = _params(cfg_ref)
    assert ("we_gate" in p) == (variant != "squared_relu")
    xe = _x((4, 5, cfg.d_model))
    got = moe.expert_ffn(cfg, p, torch.tensor(xe).to(getattr(torch, dtype)))
    want = moe_ref._expert_ffn(cfg_ref, p_ref, jnp.asarray(xe).astype(dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, np.asarray(want, np.float32),
           ATOL if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("n_stack", [None, 3])
@pytest.mark.parametrize("variant,shared", [("swiglu", 1), ("geglu", 0),
                                            ("squared_relu", 2)])
def test_init_layout_matches_reference(n_stack, variant, shared):
    cfg_ref, cfg = make_cfgs(E=5, variant=variant, shared=shared)
    want = jax.eval_shape(lambda: moe_ref.init_moe(
        jax.random.PRNGKey(0), "moe", cfg_ref, n_stack=n_stack))
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg, n_stack,
                       "cpu")
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == torch.float32
    # fan-in scale, truncated at two standard deviations
    fan_in = got["we_out"].shape[-2]
    assert float(got["we_out"].abs().max()) <= 2 * fan_in**-0.5 + 1e-7
    assert 0.5 < float(got["we_out"].std()) * fan_in**0.5 < 1.0


# -- the dispatch -----------------------------------------------------------

# (E, k, d, f, capacity factor, dispatch group, B, S)
DISPATCH_CASES = [
    (4, 2, 32, 64, 1.25, 512, 2, 8),
    (8, 2, 32, 48, 1.25, 512, 2, 16),  # grok's 8 experts, top-2
    (8, 2, 32, 48, 1.25, 4, 2, 12),  # three groups of 4 a row
    (8, 2, 32, 48, 1.25, 4, 2, 10),  # 10 % 4 != 0: one group of 10
    (72, 8, 64, 32, 1.0, 512, 2, 32),  # the parity run's kimi cut
    (16, 4, 32, 16, 0.1, 512, 3, 5),  # capacity max(1, 0) = 1
]


@pytest.mark.parametrize("E,k,d,f,cf,group,B,S", DISPATCH_CASES)
@pytest.mark.parametrize("no_drop", [False, True])
def test_dispatch_matches_moe_onehot(E, k, d, f, cf, group, B, S, no_drop):
    """The same kept slots as the reference's formula and
    ``moe_onehot``'s output within 1e-5."""
    cfg_ref, cfg = make_cfgs(E=E, k=k, d=d, f=f, cf=cf, group=group)
    p_ref, p = _params(cfg_ref)
    x = _x((B, S, d))
    want, aux_ref = onehot_ref(cfg_ref, p_ref, jnp.asarray(x),
                                       no_drop=no_drop)
    got, aux = moe.dispatch(cfg, p, torch.tensor(x), no_drop=no_drop)
    _close(got, want)
    _close(aux, aux_ref)
    n_groups, g, cap = moe.group_and_capacity(cfg, S, no_drop=no_drop)
    xg = jnp.asarray(x).reshape(B * n_groups, g, d)
    _, _, idx = route_ref(cfg_ref, p_ref["router"], xg)
    keep = moe.kept_slots(torch.tensor(np.asarray(idx)), E, cap)
    np.testing.assert_array_equal(keep.numpy(),
                                  reference_keep(idx, E, cap))
    if no_drop:
        assert keep.all()


def test_capacity_drops_change_the_output():
    """At E = 72, top-8, d = 64, f = 32 and 32 tokens a row, the capacity
    is int(32 * 8 / 72) = 3 against a mean load of 3.6: slots drop, and
    the port drops the reference's."""
    cfg_ref, cfg = make_cfgs(E=72, k=8, d=64, f=32, cf=1.0)
    p_ref, p = _params(cfg_ref, key=2)
    x = _x((2, 32, 64), seed=5)
    _, g, cap = moe.group_and_capacity(cfg, 32)
    assert (g, cap) == (32, 3)
    _, _, idx = moe.route(cfg, p["router"], torch.tensor(x))
    keep = moe.kept_slots(idx, 72, cap)
    assert 0 < int((~keep).sum()) < keep.numel()
    dropped, _ = moe.dispatch(cfg, p, torch.tensor(x))
    full, _ = moe.dispatch(cfg, p, torch.tensor(x), no_drop=True)
    want, _ = onehot_ref(cfg_ref, p_ref, jnp.asarray(x))
    _close(dropped, want)
    rows = (~keep).any(-1)  # tokens that lost a slot
    diff = (dropped - full).abs().amax(-1)
    assert bool((diff[rows] > 1e-3).all())
    assert bool((diff[~rows] <= ATOL).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_keeps_x_dtype(dtype):
    """The expert FFN in x's dtype, the combine in float32, cast back."""
    cfg_ref, cfg = make_cfgs(E=8, k=2)
    p_ref, p = _params(cfg_ref)
    x = _x((2, 6, cfg.d_model))
    got, aux = moe.dispatch(cfg, p, torch.tensor(x).to(getattr(torch, dtype)),
                            no_drop=True)
    want, _ = onehot_ref(cfg_ref, p_ref, jnp.asarray(x).astype(dtype),
                                 no_drop=True)
    assert got.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    _close(got, np.asarray(want, np.float32),
           ATOL if dtype == "float32" else 3e-2)


# -- apply_moe --------------------------------------------------------------


@pytest.mark.parametrize("E,k,shared,variant", [(4, 2, 1, "swiglu"),
                                                (8, 2, 0, "geglu"),
                                                (72, 8, 1, "swiglu")])
@pytest.mark.parametrize("no_drop", [False, True])
def test_apply_moe_matches_reference(E, k, shared, variant, no_drop):
    """The same branch as the reference's: no drops at E <= 64 when asked,
    capacity above 64 experts whatever is asked; the shared experts added
    after; the aux loss scaled by ``router_aux_loss``; decode's
    ``ep_mode="onehot"`` (no_drop) and the automatic one (capacity) on
    both sides."""
    ep_mode = "onehot" if no_drop else None
    d, f = (64, 32) if E == 72 else (32, 48)
    cfg_ref, cfg = make_cfgs(E=E, k=k, d=d, f=f, cf=1.0, variant=variant,
                             shared=shared)
    p_ref, p = _params(cfg_ref, key=3)
    x = _x((2, 32, d), seed=6)
    want, aux_ref = apply_ref(cfg_ref, p_ref, jnp.asarray(x),
                                      ep_mode=ep_mode, no_drop=no_drop)
    got, aux = moe.apply_moe(cfg, p, torch.tensor(x), ep_mode=ep_mode,
                             no_drop=no_drop)
    _close(got, want)
    _close(aux, aux_ref)
    # the branch: at E = 72 no_drop is dropped, so the output is the
    # capacity dispatch's whatever no_drop says
    capped, _ = moe.apply_moe(cfg, p, torch.tensor(x))
    exact, _ = moe.apply_moe(cfg, p, torch.tensor(x), no_drop=True)
    same = torch.equal(capped, exact)
    assert same == (E > 64)
    with pytest.raises(ValueError, match="ep_mode"):
        moe.apply_moe(cfg, p, torch.tensor(x), ep_mode="ring")


def test_shared_expert_matches_reference():
    """tests/test_moe.py::test_shared_expert_path, on both sides."""
    cfg_ref, cfg = make_cfgs()
    cfg_ref = cfg_ref.replace(moe=dataclasses.replace(cfg_ref.moe,
                                                      n_shared_experts=1))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_shared_experts=1))
    p_ref, p = _params(cfg_ref)
    assert "w_in" in p and "w_out" in p and "w_gate" in p
    x = _x((2, 4, cfg.d_model))
    out, aux = moe.apply_moe(cfg, p, torch.tensor(x), ep_mode="onehot")
    want, aux_ref = apply_ref(cfg_ref, p_ref, jnp.asarray(x),
                                      ep_mode="onehot")
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    _close(out, want)
    _close(aux, aux_ref)


# -- tests/test_moe.py on the port ------------------------------------------


def _manual_moe(cfg, p, x):
    """tests/test_moe.py's token-by-token loop (no capacity limit)."""
    k = cfg.moe.top_k
    logits = x @ p["router"].numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    for b in range(x.shape[0]):
        for s in range(x.shape[1]):
            idx = np.argsort(-probs[b, s])[:k]
            w = probs[b, s, idx] / probs[b, s, idx].sum()
            for e, we in zip(idx, w):
                h_in = x[b, s] @ p["we_in"][e].numpy()
                gate = x[b, s] @ p["we_gate"][e].numpy()
                h = gate / (1 + np.exp(-gate)) * h_in
                out[b, s] += we * (h @ p["we_out"][e].numpy())
    return out


@pytest.mark.parametrize("case", ["manual", "capacity", "aux_balance",
                                  "gradients"])
def test_reference_moe_cases_on_port(case):
    """The reference's tests/test_moe.py, case by case, on the port: the
    no-drop dispatch against a token-by-token loop, capacity drops
    shrinking the output, the load-balance loss ~1 when uniform and > 2
    when skewed, and gradients reaching the router and the experts."""
    cfg_ref, cfg = make_cfgs(cf=0.1 if case == "capacity" else 8.0)
    _, p = _params(cfg_ref)
    x = _x((1 if case == "capacity" else 2,
            16 if case == "capacity" else 8, cfg.d_model))
    if case == "manual":
        out, aux = moe.dispatch(cfg, p, torch.tensor(x), no_drop=True)
        np.testing.assert_allclose(out.numpy(), _manual_moe(cfg, p, x),
                                   atol=1e-4, rtol=1e-4)
        assert float(aux) > 0
    elif case == "capacity":
        drop, _ = moe.dispatch(cfg, p, torch.tensor(x))
        full, _ = moe.dispatch(cfg, p, torch.tensor(x), no_drop=True)
        assert float(drop.norm()) < float(full.norm())
    elif case == "aux_balance":
        _, cfg = make_cfgs(E=4, k=1)
        uniform = moe.aux_loss(cfg, torch.full((64, 4), 0.25),
                               torch.arange(4).repeat(16)[:, None])
        skew = moe.aux_loss(cfg, torch.tensor([[0.97, 0.01, 0.01, 0.01]])
                            .repeat(64, 1), torch.zeros((64, 1),
                                                        dtype=torch.long))
        assert float(uniform) == pytest.approx(1.0, rel=1e-3)
        assert float(skew) > 2.0
    else:
        leaves = {name: w.clone().requires_grad_(True)
                  for name, w in p.items()}
        out, aux = moe.dispatch(cfg, leaves, torch.tensor(x))
        (torch.mean(out**2) + aux).backward()
        norms = {name: float(w.grad.norm()) for name, w in leaves.items()}
        assert all(np.isfinite(list(norms.values())))
        assert norms["router"] > 0 and norms["we_in"] > 0
