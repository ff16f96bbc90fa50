"""The transformer zoo's training on the CPU, held to the JAX package.

Each of the eight transformer-family archs (``tinyllama-1.1b``, the dense
trio, the MoE pair, ``paligemma-3b`` with its prefix and
``seamless-m4t-medium`` with its frames) at ``reduced()``, the reference's
params carried across by ``convert``: ``loss_fn``'s loss and metrics, and
every gradient leaf, against ``jax.value_and_grad`` of the reference's
``loss_fn``; the MoE dispatch's router and expert gradients, an expert with
no kept slot among them; ``warmup_cosine``; ``remat`` "block" and "dots"
equal to "none".  ``test_torch_zoo_train_parts.py`` holds the optimizer
steps against the reference's ``make_train_step`` and the pieces around
the step (``train_local``, checkpoints, metrics, the smaller pieces).

Tolerances: float32 on both sides; a loss within 1e-5, a gradient leaf
within 1e-4 of that leaf's largest |gradient| (the sums' order through two
layers and their backward); params after SGD steps within 1e-5 of their
scale; after AdamW steps all but one element in 1000 within 1e-5 of their
scale and every element within 2 lr a step: AdamW moves an element by up
to lr whatever its gradient's size, so where a gradient is ~1e-8, at the
level of the sums' order, its step differs by up to 2 lr.

The card has no JAX, so phase 19 (b) of ``chip_smoke.py`` reads the
reference's full-width float32 training of ``tinyllama-1.1b`` from
``tests/data/torch_parity_train_tinyllama_1_1b.npz`` (seeds and summaries,
no weights).  Rewrite it with

    PYTHONPATH=src python tests/test_torch_zoo_train.py

(~91 s, 25.5 GB resident at the peak).  Here its format is checked, and a
reduced regeneration reproduced by the port's
``chip_smoke.run_train_parity`` on the CPU.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.models import get_model as get_model_ref
from repro.models import moe as moe_ref
from repro.training import adamw as adamw_ref
from repro.training import make_train_step as make_train_step_ref
from repro.training import warmup_cosine as warmup_cosine_ref
from repro_torch.configs import (EncDecConfig, FrontendStub, ModelConfig,
                                 MoEConfig)
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe
from repro_torch.models.model import get_model
from repro_torch.training.optimizer import (tree_leaves, tree_map,
                                            tree_unflatten, warmup_cosine)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]
ARCHS = smoke.ZOO_TRAIN_ARCHS


def port_config(cfg_ref) -> ModelConfig:
    """The port's config with the reference config's values, its
    sub-configs too."""
    kw = {f: getattr(cfg_ref, f) for f in PORT_FIELDS}
    for name, cls in (("moe", MoEConfig), ("encdec", EncDecConfig),
                      ("frontend", FrontendStub)):
        sub = getattr(cfg_ref, name)
        if sub is not None:
            kw[name] = cls(**dataclasses.asdict(sub))
    return ModelConfig(**kw)


def reduced_pair(arch: str, key: int = 0, **changes):
    """(cfg_ref, p_ref, cfg, p): the arch at ``reduced()`` with
    ``changes``, the reference's params from ``PRNGKey(key)`` and their
    copy in the port."""
    cfg_ref = get_config_ref(arch).reduced().replace(**changes)
    p_ref = get_model_ref(cfg_ref).init(jax.random.PRNGKey(key))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, p_ref), "cpu")
    return cfg_ref, p_ref, port_config(cfg_ref), p


def batch_for(cfg, shape=(2, 24), seed=0, mask=False) -> dict:
    """tokens and targets from numpy ``seed``, the prefix embeddings of a
    config with a frontend, and optionally a loss mask."""
    b = smoke.train_batch(cfg, seed, shape)
    if cfg.frontend is not None:
        b["prefix_embed"] = smoke.zoo_prefix(cfg, seed + 1, shape[0])
    if mask:
        b["mask"] = (np.random.default_rng(seed + 2).random(shape)
                     > 0.3).astype(np.float32)
    return b


def torch_batch(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_grads(model, params, batch):
    """(loss, metrics, gradient tree) of ``model.loss_fn`` by autograd."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(live, list(grads)))


def close_leaf(got, want, rtol=GRAD_RTOL, what="", atol=0.0):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale + atol, (
        f"{what}: {err} > {rtol} x {scale} + {atol}")


def close_after_adam(got: dict, want: dict, lr: float, steps: int):
    """Params after ``steps`` AdamW steps of at most ``lr``: all but one
    element in 1000 of each leaf within 1e-5 of its scale, all within 2 lr
    a step."""
    got, want = smoke.flat_tree(got), smoke.flat_tree(want)
    assert sorted(got) == sorted(want)
    for path in got:
        w = np.asarray(want[path], np.float32)
        d = np.abs(got[path].detach().float().numpy() - w)
        assert float(d.max()) <= 2 * lr * steps, path
        assert float((d > 1e-5 * np.abs(w).max()).mean()) <= 1e-3, path


def close_tree(got: dict, want: dict, rtol=GRAD_RTOL, atol=0.0):
    got, want = smoke.flat_tree(got), smoke.flat_tree(want)
    assert sorted(got) == sorted(want)
    for path in got:
        close_leaf(got[path], want[path], rtol, path, atol)


# -- the losses and gradients -----------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    cfg_ref, p_ref, cfg, p = reduced_pair(arch)
    b = batch_for(cfg, mask=arch == "tinyllama-1.1b")
    model_ref = get_model_ref(cfg_ref)
    (loss_ref, met_ref), g_ref = jax.jit(jax.value_and_grad(
        model_ref.loss_fn, has_aux=True))(p_ref, jax_batch(b))
    loss, met, g = port_grads(get_model(cfg), p, torch_batch(b))
    assert abs(float(loss) - float(loss_ref)) <= LOSS_ATOL
    assert sorted(met) == sorted(met_ref)
    for k in met:
        assert abs(float(met[k]) - float(met_ref[k])) <= LOSS_ATOL, k
    if cfg.moe is not None:
        assert float(met["aux"]) > 0  # the router's load-balancing loss
    close_tree(g, g_ref)


def test_moe_dispatch_gradients_match_reference_with_an_empty_expert():
    """The expert loop (``moe.dispatch``) at capacity against the
    reference's one-hot dispatch: the gradients of the output and the aux
    loss by x, the router and every expert, with expert 3's router logit
    pushed down (a feature of x held at 10, its router weight at -100) so
    that no token routes there (its experts' gradients are 0 on both
    sides), and a capacity that drops slots."""
    cfg_ref = get_config_ref("grok-1-314b").reduced()
    cfg_ref = cfg_ref.replace(moe=dataclasses.replace(cfg_ref.moe,
                                                      capacity_factor=0.5))
    cfg = port_config(cfg_ref)
    p_ref = moe_ref.init_moe(jax.random.PRNGKey(3), "moe", cfg_ref)
    tree = jax.tree_util.tree_map(np.asarray, p_ref)
    tree["router"] = tree["router"].copy()
    tree["router"][0, 3] = -100.0
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    x[..., 0] = 10.0
    w = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def f_ref(params, xx):
        out, aux = moe_ref.apply_moe(cfg_ref, params, xx)
        return jnp.sum(out * w) + aux

    g_ref, gx_ref = jax.jit(jax.grad(f_ref, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    p = params_from_numpy(tree, "cpu")
    live = tree_map(lambda t: t.requires_grad_(True), p)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.apply_moe(cfg, live, xt)
    gs = torch.autograd.grad(torch.sum(out * torch.tensor(w)) + aux,
                             [xt, *tree_leaves(live)])
    close_leaf(gs[0], gx_ref, what="x")
    close_tree(tree_unflatten(live, list(gs[1:])), g_ref)
    E = cfg.moe.n_experts
    _, _, top_idx = moe.route(cfg, p["router"], torch.tensor(x).reshape(
        -1, 16, cfg.d_model))
    assert not bool((top_idx == 3).any())
    _, _, cap = moe.group_and_capacity(cfg, 16)
    assert not bool(moe.kept_slots(top_idx, E, cap).all())  # drops slots
    assert float(np.abs(np.asarray(g_ref["we_in"])[3]).max()) == 0.0
    assert float(gs[1 + list(sorted(p)).index("we_in")][3].abs().max()) == 0


# -- the optimizers ---------------------------------------------------------


def test_warmup_cosine_matches_reference():
    for lr, warmup, total, frac in ((3e-4, 5, 20, 0.1), (1.0, 0, 7, 0.0),
                                    (2e-3, 10, 10, 0.5)):
        ours, ref = (warmup_cosine(lr, warmup, total, frac),
                     warmup_cosine_ref(lr, warmup, total, frac))
        for step in range(total + 3):
            got = float(ours(torch.tensor(step, dtype=torch.int32)))
            want = float(ref(jnp.asarray(step, jnp.int32)))
            assert abs(got - want) <= 1e-7 * max(lr, 1e-12) + 1e-12, step


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "grok-1-314b"])
def test_remat_block_and_dots_equal_none(arch):
    _, _, cfg, p = reduced_pair(arch)
    b = torch_batch(batch_for(cfg))
    loss, met, g = port_grads(get_model(cfg), p, b)
    for remat in ("block", "dots"):
        loss_r, met_r, g_r = port_grads(
            get_model(cfg.replace(remat=remat)), p, b)
        assert torch.equal(loss_r, loss), remat
        for a, c in zip(tree_leaves(g_r), tree_leaves(g)):
            assert torch.equal(a, c), remat
    with pytest.raises(ValueError, match="unknown remat"):
        port_grads(get_model(cfg.replace(remat="all")), p, b)


# -- the phase-19 (b) fixture ----------------------------------------------


def to_jax(tree: dict) -> dict:
    """A numpy tree as JAX arrays, emptied leaf by leaf as it goes."""
    out = {}
    for name in list(tree):
        leaf = tree.pop(name)
        out[name] = to_jax(leaf) if isinstance(leaf, dict) else jnp.asarray(
            leaf)
        del leaf
    return out


def build_train_fixture(reduced: bool) -> dict:
    """The reference's training of ``smoke.ZOO_ARCH`` at full width and
    depth in float32 (or ``reduced()``): ``smoke.numpy_params`` and
    ``smoke.train_batch`` from ``smoke.TRAIN_SEED``, step 1's loss, xent
    and gradient summary by ``jax.value_and_grad``, then the losses of
    ``smoke.TRAIN_STEPS`` steps of its ``make_train_step`` with
    adamw(warmup_cosine(*TRAIN_SCHEDULE))."""
    cfg_ref = get_config_ref(smoke.ZOO_ARCH)
    cfg_ref = (cfg_ref.reduced() if reduced
               else smoke.zoo_parity_config(cfg_ref))
    params = to_jax(smoke.numpy_params(cfg_ref, smoke.TRAIN_SEED,
                                       smoke.DRAW_CHUNK))
    batch = jax_batch(smoke.train_batch(cfg_ref, smoke.TRAIN_SEED))
    model = get_model_ref(cfg_ref)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(params, batch)
    run = {"loss": np.float64(float(loss)),
           "xent": np.float64(float(metrics["xent"])),
           **smoke.grad_summary({path: torch.from_numpy(np.array(g))
                                 for path, g in smoke.flat_tree(
                                     grads).items()}, smoke.TRAIN_SEED)}
    del grads
    lr, warmup, total = smoke.TRAIN_SCHEDULE
    opt = adamw_ref(warmup_cosine_ref(lr, warmup, total))
    state = opt.init(params)
    step = jax.jit(make_train_step_ref(model, opt))
    losses = []
    for _ in range(smoke.TRAIN_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    run["losses"] = np.array(losses, np.float64)
    return smoke.train_fixture_arrays(smoke.ZOO_ARCH, reduced, run)


def test_committed_train_fixture_is_what_chip_smoke_reads():
    fx = smoke.load_fixture(smoke.TRAIN_FIXTURE)
    assert str(fx["arch"]) == smoke.ZOO_ARCH and not bool(fx["reduced"])
    assert int(fx["seed"]) == smoke.TRAIN_SEED
    assert int(fx["draw_chunk"]) == smoke.DRAW_CHUNK
    assert tuple(fx["batch_shape"]) == smoke.TRAIN_BATCH
    assert tuple(fx["schedule"]) == smoke.TRAIN_SCHEDULE
    assert int(fx["steps"]) == smoke.TRAIN_STEPS == len(fx["losses"])
    cfg = smoke.zoo_config(fx)
    assert cfg.d_model == 2048 and cfg.n_layers == 22
    assert cfg.dtype == "float32"
    L = cfg.n_layers
    assert fx["norm/layers/wq"].shape == (L,)
    assert int(fx["numel/tok_embed"]) == cfg.vocab_size * cfg.d_model
    assert abs(float(fx["loss"]) - float(fx["losses"][0])) < 1e-6
    assert np.isfinite(fx["losses"]).all() and fx["grad_norm"] > 0
    assert smoke.TRAIN_FIXTURE.stat().st_size < 1 << 20


def test_reduced_train_fixture_regenerates_and_port_reproduces_it():
    fx = build_train_fixture(reduced=True)
    committed = smoke.load_fixture(smoke.TRAIN_FIXTURE)
    assert fx.keys() == committed.keys()
    for k in fx:
        assert fx[k].dtype == committed[k].dtype, k
    got = smoke.run_train_parity(fx, "cpu")
    readings = smoke.check_train_parity(fx, got)
    # on the CPU both sides are float32 through two layers: far inside the
    # card's gates
    assert readings["loss_max_abs_err"] < 1e-5
    assert readings["norm_max_rel_err"] < 1e-5
    assert readings["sample_gate"] < 0.01
    broken = dict(got, **{"norm/layers/wq": got["norm/layers/wq"] * 1.01})
    with pytest.raises(AssertionError, match="training parity missed"):
        smoke.check_train_parity(fx, broken)


if __name__ == "__main__":
    import resource
    import time

    t0 = time.perf_counter()
    arrays = build_train_fixture(reduced=False)
    path = smoke.TRAIN_FIXTURE
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.perf_counter() - t0:.1f} s, peak resident {peak_gb:.1f} GB;"
          f" losses {arrays['losses']}, grad norm {arrays['grad_norm']}")
