"""The port's Zamba2 hybrid (the ``hybrid`` family) on the CPU, held to the
JAX package.

Two configs: ``zamba2-1.2b.reduced()`` (2 Mamba2 layers, d_model 256, 8 SSM
heads of 64 with state 16, the shared block after every layer) and a
5-layer one with ``attn_every`` 2, whose fifth layer is the tail after the
last shared block (``rem`` = 1), which the reduced config never reaches.
With params from ``chip_smoke.numpy_params`` (a numpy seed in the
reference's tree layout, Mamba2's dt and A init) loaded into both: the
causal conv, one Mamba2 block from nonzero states, ``forward``'s hidden
states and caches, ``prefill``'s logits and cache (the shared block's K/V
placed in the fixed cache, ``kv_pos`` -1 after the prompt) and four
``decode_step``s, one layer to 1e-5 and the whole model to 1e-4
(``MODEL_ATOL`` says why); step-by-step decode against one full forward;
the init's tree layout; ``init_cache`` on the meta device; the hybrid tree
through ``convert`` in float32 and bf16; what the port refuses.
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
from repro.models import blocks as blocks_ref
from repro.models import get_model as get_model_ref
from repro.models import hybrid_arch as hybrid_ref
from repro.models import ssm as ssm_ref
from repro_torch.configs import ModelConfig, get_config
from repro_torch.configs.base import (HybridConfig, LSTMConfig, RWKVConfig,
                                      SSMConfig)
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import blocks, hybrid_arch, ssm
from repro_torch.models.model import get_model

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ARCH = "zamba2-1.2b"
# one layer of the port against the reference on the CPU, both in float32
ATOL = 1e-5
# the whole model against the reference: float32 rounding alone moves this
# random model's output by more than 1e-5 (its Mamba2 blocks take the
# residual stream unnormalised, as the reference's do, and every shared
# block adds to it).  Over 4 seeds of each config, with and without a
# cache, as the least t that atol = rtol = t passes (``python
# tests/test_torch_zamba2.py`` prints them): one-ulp relative noise in the
# reference's embedding table moves its own hidden state and K/V by up to
# 9.3e-6, its conv history by up to 2.1e-5 and its SSM states by up to
# 5.1e-5; the port and the reference differ by 4.0e-6 to 1.3e-5 in the
# hidden state and K/V, by up to 2.1e-5 in the conv history and by up to
# 8.9e-5 in the SSM states of the config with a tail
MODEL_ATOL = 1e-4
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]
PORT_NESTED = {c.__name__: [f.name for f in dataclasses.fields(c)]
               for c in (HybridConfig, LSTMConfig, RWKVConfig, SSMConfig)}
# the reduced config, and 5 layers with the shared block after every 2nd
# (two super-layers and a one-layer tail)
CONFIGS = {"reduced": {}, "tail": {"n_layers": 5, "attn_every": 2}}
# the reference's entry points compiled once per config (and max_len)
# rather than traced anew at every call
forward_ref = jax.jit(hybrid_ref.forward, static_argnums=0)
prefill_ref = jax.jit(hybrid_ref.prefill, static_argnums=(0, 3))
decode_step_ref = jax.jit(hybrid_ref.decode_step, static_argnums=0)


def _fields(cfg) -> dict:
    """The port's fields of a config of either package, nested configs as
    dicts of the port's fields (the reference's ``SSMConfig`` also has a
    ``chunk_size``, which only its chunked SSD form reads)."""
    out = {}
    for f in PORT_FIELDS:
        v = getattr(cfg, f)
        if dataclasses.is_dataclass(v):
            v = {g: getattr(v, g) for g in PORT_NESTED[type(v).__name__]}
        out[f] = v
    return out


def _configs(variant="reduced", **kw):
    """The reference's and the port's config: ``variant`` of CONFIGS, then
    ``kw``."""
    spec = dict(CONFIGS[variant])
    out = []
    for cfg in (get_config_ref(ARCH).reduced(), get_config(ARCH).reduced()):
        if "attn_every" in spec:
            cfg = cfg.replace(n_layers=spec["n_layers"],
                              hybrid=dataclasses.replace(
                                  cfg.hybrid, attn_every=spec["attn_every"]))
        out.append(cfg.replace(**kw))
    return tuple(out)


def _params(cfg_ref, seed=0):
    tree = smoke.numpy_params(cfg_ref, seed)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=atol)


def _close_tree(got: dict, want: dict, atol=ATOL):
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == getattr(torch, str(want[name].dtype)), name
        if got[name].dtype == torch.int32:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
        else:
            _close(got[name], want[name], atol)


def _random_states(cfg, B, seed):
    """Nonzero SSM states: the conv history normal, h 0.5 normal."""
    rng = np.random.default_rng(seed)
    cache = ssm.init_block_cache(cfg, cfg.n_layers, B, "cpu")
    return {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
            * (0.5 if k == "h" else 1.0) for k, v in cache.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_configs_match_reference():
    ref = get_config_ref(ARCH)
    for cfg, want in ((get_config(ARCH), ref),
                      (get_config(ARCH).reduced(), ref.reduced()),
                      _configs("tail")[::-1]):
        assert _fields(cfg) == _fields(want)
        assert cfg.supports_long_decode and not cfg.is_attention_free
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
        38, 2048, 8192, 32000)
    assert ssm.dims(cfg) == (4096, 64, 4224, 8384)
    assert hybrid_arch._split(cfg) == (6, 6, 2)
    assert hybrid_arch._split(_configs("tail")[1]) == (2, 2, 1)
    assert hybrid_arch._split(get_config(ARCH).reduced()) == (1, 2, 0)
    assert cfg.n_heads == cfg.n_kv_heads == 32  # MHA: G = 1 in the kernel
    n = sum(int(np.prod(shape))
            for shape, _ in smoke._param_shapes(cfg).values())
    assert n == 1_178_784_640


@pytest.mark.parametrize("variant", list(CONFIGS))
def test_init_params_layout_matches_reference(variant):
    """Leaf names, shapes and dtypes of the reference's init, in float32
    and bf16, and the law of ``numpy_params`` for the Mamba2 leaves."""
    for dtype in ("float32", "bfloat16"):
        cfg_ref, cfg = _configs(variant, param_dtype=dtype)
        want = jax.eval_shape(lambda: get_model_ref(cfg_ref).init(
            jax.random.PRNGKey(0)))
        want = {tuple(k.key for k in path): (leaf.shape, str(leaf.dtype))
                for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
        p = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        got = {tuple(k.split("/")): (tuple(v.shape), str(v.dtype)[6:])
               for k, v in _flat(p).items()}
        assert got == want
        assert {tuple(k.split("/")): shape for k, (shape, _) in
                smoke._param_shapes(cfg).items()} == {
                    k: s for k, (s, _) in want.items()}
    tree = smoke.numpy_params(cfg, 0)["mamba"]
    A = -np.exp(tree["A_log"])
    assert -16 <= A.min() and A.max() <= -1
    dt = np.log1p(np.exp(tree["dt_bias"].astype(np.float64)))
    assert 1e-3 * (1 - 1e-5) <= dt.min() and dt.max() <= 0.1 * (1 + 1e-5)
    assert abs(tree["D"].mean() - 1) < 0.05 and tree["D"].std() < 0.15
    W = cfg.ssm.conv_dim
    assert abs(tree["conv_w"].std() * W**0.5 - 1) < 0.05
    assert tree["conv_b"].std() < 0.03


def test_conv_scan_matches_reference():
    rng = np.random.default_rng(2)
    B, T, C, W = 2, 7, 24, 4
    xbc, hist = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, C), (B, W - 1, C)))
    w = rng.standard_normal((W, C)).astype(np.float32) * 0.5
    b = rng.standard_normal(C).astype(np.float32) * 0.02
    got = ssm._conv_scan(*map(torch.tensor, (xbc, hist, w, b)))
    want = ssm_ref._conv_scan(*map(jnp.asarray, (xbc, hist, w, b)))
    for g, e in zip(got, want):
        _close(g, e)
    # T = 1 (a decode step) keeps the last W - 1 inputs
    got = ssm._conv_scan(*map(torch.tensor, (xbc[:, :1], hist, w, b)))
    want = ssm_ref._conv_scan(*map(jnp.asarray, (xbc[:, :1], hist, w, b)))
    for g, e in zip(got, want):
        _close(g, e)


@pytest.mark.parametrize("T", [9, 1])
def test_apply_block_matches_reference(T):
    """One Mamba2 block of layer 1 from nonzero conv and h states (the skip
    D inside the port's scan, after it in the reference's), at rtol =
    atol = 1e-5; ``out`` receives the new h state."""
    cfg_ref, cfg = _configs()
    p_ref, p = _params(cfg_ref, seed=3)
    lp_ref = jax.tree_util.tree_map(lambda a: a[1], p_ref["mamba"])
    lp = {k: v[1] for k, v in p["mamba"].items()}
    states = _random_states(cfg, 2, 4)
    x = np.random.default_rng(5).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    out = torch.empty(states["h"].shape[1:])
    got = ssm.apply_block(cfg, lp, torch.tensor(x),
                          torch.tensor(states["conv"][1]),
                          torch.tensor(states["h"][1]), out=out)
    want = jax.jit(ssm_ref.apply_block, static_argnums=0)(
        cfg_ref, lp_ref, jnp.asarray(x), jnp.asarray(states["conv"][1]),
        jnp.asarray(states["h"][1]))
    assert got[2] is out
    for g, e in zip(got, want):
        _close(g, e)


@pytest.mark.parametrize("variant", list(CONFIGS))
@pytest.mark.parametrize("with_cache", [False, True])
def test_forward_matches_reference(variant, with_cache):
    cfg_ref, cfg = _configs(variant)
    p_ref, p = _params(cfg_ref)
    tokens = _tokens(cfg, (2, 11))
    states = _random_states(cfg, 2, 5) if with_cache else None
    h, (conv, hs, k, v) = hybrid_arch.forward(
        cfg, p, {"tokens": torch.tensor(tokens)},
        None if states is None else {n: torch.tensor(a)
                                     for n, a in states.items()})
    h_ref, (conv_ref, hs_ref, k_ref, v_ref) = forward_ref(
        cfg_ref, p_ref, {"tokens": jnp.asarray(tokens)},
        None if states is None else {n: jnp.asarray(a)
                                     for n, a in states.items()})
    _close(h, h_ref, MODEL_ATOL)
    _close_tree({"conv": conv, "h": hs, "k": k, "v": v},
                {"conv": conv_ref, "h": hs_ref, "k": k_ref, "v": v_ref},
                MODEL_ATOL)
    _close(blocks.logits_fn(cfg, p, h),
           blocks_ref.logits_fn(cfg_ref, p_ref, h_ref), MODEL_ATOL)


def test_forward_reads_the_cache_it_is_given_and_never_writes_it():
    _, cfg = _configs("tail")
    p = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    cache = {k: torch.tensor(v) for k, v in _random_states(cfg, 2, 6).items()}
    kept = {k: v.clone() for k, v in cache.items()}
    batch = {"tokens": torch.tensor(_tokens(cfg, (2, 3)))}
    _, (conv, hs, _, _) = hybrid_arch.forward(cfg, p, batch, cache)
    for k in cache:
        assert torch.equal(cache[k], kept[k])
    assert conv is not cache["conv"] and hs is not cache["h"]
    # a different state changes the output
    h1 = hybrid_arch.forward(cfg, p, batch, cache)[0]
    h0 = hybrid_arch.forward(cfg, p, batch)[0]
    assert not torch.allclose(h0, h1)


@pytest.mark.parametrize("variant,S,max_len", [("reduced", 8, 16),
                                               ("tail", 8, 6)])
def test_prefill_and_decode_match_reference(variant, S, max_len):
    """``prefill`` (the shared block's K/V in a fixed cache of ``max_len``
    slots: the prompt's first slots and ``kv_pos`` -1 after them, or its
    last ``max_len`` positions when it is longer) and four ``decode_step``s
    against the reference's, every logit and cache leaf."""
    cfg_ref, cfg = _configs(variant)
    p_ref, p = _params(cfg_ref, seed=1)
    tokens = _tokens(cfg, (2, S + 4), seed=1)
    logits, cache = hybrid_arch.prefill(
        cfg, p, {"tokens": torch.tensor(tokens[:, :S])}, max_len)
    logits_ref, cache_ref = prefill_ref(
        cfg_ref, p_ref, {"tokens": jnp.asarray(tokens[:, :S])}, max_len)
    _close(logits, logits_ref, MODEL_ATOL)
    _close_tree(cache, cache_ref, MODEL_ATOL)
    take = min(S, max_len)
    assert (cache["kv_pos"][:, :take] == torch.arange(take)).all()
    assert (cache["kv_pos"][:, take:] == -1).all()
    assert not cache["k"][:, :, take:].any()
    for i in range(4):
        batch = {"token": tokens[:, S + i:S + i + 1],
                 "pos": np.full((2,), S + i, np.int32)}
        logits, cache = hybrid_arch.decode_step(
            cfg, p, {k: torch.tensor(v) for k, v in batch.items()}, cache)
        logits_ref, cache_ref = decode_step_ref(
            cfg_ref, p_ref, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_ref)
        _close(logits, logits_ref, MODEL_ATOL)
        _close_tree(cache, cache_ref, MODEL_ATOL)


@pytest.mark.parametrize("variant", list(CONFIGS))
def test_decode_equals_full_forward_in_port(variant):
    """The reference's strongest serving invariant, in the port: the
    ``chip_smoke.py`` helper the card runs at full width."""
    cfg_ref, cfg = _configs(variant)
    _, p = _params(cfg_ref, seed=2)
    err = smoke.decode_equivalence(cfg, p, _tokens(cfg, (2, 14)), 8, "cpu")
    assert err <= ATOL, err


def test_init_cache_matches_reference_and_takes_meta():
    cfg_ref, cfg = _configs("tail", dtype="bfloat16")
    want = hybrid_ref.init_cache(cfg_ref, 3, 16)
    got = get_model(cfg).init_cache(3, 16, "cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype)[6:] == str(want[k].dtype)
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    meta = get_model(cfg).init_cache(3, 16, device="meta")
    assert all(t.device.type == "meta" for t in meta.values())
    assert meta["h"].shape == (5, 3, 8, 64, 16)
    assert meta["h"].dtype == torch.float32
    assert meta["conv"].shape == (5, 3, 3, 512 + 32)
    assert meta["conv"].dtype == meta["k"].dtype == torch.bfloat16
    assert meta["k"].shape == (2, 3, 16, 4, 64)


def test_hybrid_tree_crosses_convert_bit_for_bit():
    """The reference's hybrid tree, float32 and bf16, to the port and back,
    leaf for leaf; the bf16 tree's prefill agrees with the reference's."""
    for dtype in ("float32", "bfloat16"):
        cfg_ref, cfg = _configs(param_dtype=dtype, dtype=dtype)
        p_ref = jax.jit(get_model_ref(cfg_ref).init)(jax.random.PRNGKey(1))
        tree = jax.tree_util.tree_map(np.asarray, p_ref)
        p = params_from_numpy(tree, "cpu")
        assert p["mamba"]["in_proj"].dtype == getattr(torch, dtype)
        assert p["shared"]["wq"].dtype == getattr(torch, dtype)
        assert p["mamba"]["A_log"].dtype == torch.float32
        back = params_to_numpy(p)
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(tree),
                jax.tree_util.tree_leaves_with_path(back)):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    tokens = _tokens(cfg, (1, 6))
    logits, _ = hybrid_arch.prefill(cfg, p, {"tokens": torch.tensor(tokens)})
    logits_ref, _ = prefill_ref(cfg_ref, p_ref,
                                {"tokens": jnp.asarray(tokens)}, None)
    assert logits.dtype == torch.float32
    # bf16 activations round at other places in the two frameworks: over
    # 6 inits of each config the two differ by 0.055 to 0.137 (~9 bf16
    # ulps) on logits of up to 3.5
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref),
                               atol=0.25, rtol=0)


def test_unported_parts_raise_naming_their_slice():
    """Nothing of the hybrid raises any more: its training loss, which used
    to name zoo step 6b, trains (``tests/test_torch_zamba2_train.py``
    holds it to the reference)."""
    _, cfg = _configs()
    p = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.ones((1, 4), dtype=torch.int32),
             "targets": torch.ones((1, 4), dtype=torch.int32)}
    loss, metrics = get_model(cfg).loss_fn(p, batch)
    assert bool(torch.isfinite(loss)) and sorted(metrics) == ["xent"]


def _need(got, want) -> float:
    """The least t with which atol = rtol = t holds ``got`` to ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (1 + np.abs(want))))


def tolerance_readings(seeds=range(4)):
    """The readings behind ``MODEL_ATOL``: for each config, with and
    without a cache, and each seed, ``forward``'s hidden state, SSM states
    and K/V as the least tolerance that holds the port to the reference,
    and as the least that holds the reference to itself with one-ulp
    relative noise (a random sign a element) in its embedding table."""
    names = ("hidden", "conv", "h", "k", "v")
    for variant in CONFIGS:
        cfg_ref, cfg = _configs(variant)
        for with_cache in (False, True):
            for seed in seeds:
                tree = smoke.numpy_params(cfg_ref, seed)
                p_ref = jax.tree_util.tree_map(jnp.asarray, tree)
                noisy = dict(p_ref)
                emb = tree["tok_embed"]
                sign = np.random.default_rng(seed).choice([-1, 1], emb.shape)
                noisy["tok_embed"] = jnp.asarray(
                    (emb * (1 + sign * 2.0**-23)).astype(np.float32))
                tokens = _tokens(cfg, (2, 11), seed)
                states = (_random_states(cfg, 2, 5 + seed) if with_cache
                          else None)
                h, st = hybrid_arch.forward(
                    cfg, params_from_numpy(tree, "cpu"),
                    {"tokens": torch.tensor(tokens)},
                    None if states is None else
                    {n: torch.tensor(a) for n, a in states.items()})
                port = (h, *st)
                ref_in = (None if states is None else
                          {n: jnp.asarray(a) for n, a in states.items()})
                ref = [forward_ref(cfg_ref, pr, {"tokens": jnp.asarray(
                    tokens)}, ref_in) for pr in (p_ref, noisy)]
                ref = [(r[0], *r[1]) for r in ref]
                print(f"{variant} cache={with_cache} seed={seed}: " + ", ".join(
                    f"{n} port {_need(g.numpy(), e):.2g} ulp "
                    f"{_need(u, e):.2g}"
                    for n, g, e, u in zip(names, port, *ref)), flush=True)


if __name__ == "__main__":
    tolerance_readings()
