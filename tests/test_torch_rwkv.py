"""The port's RWKV6 (the ``ssm`` family) on the CPU, held to the JAX
package.

At ``rwkv6-3b.reduced()`` (2 layers, d_model 256, head size 32, decay LoRA
16), with params from ``chip_smoke.numpy_params`` (a numpy seed in the
reference's tree layout, mix coefficients in [0, 1] and decays inside
(0, 1)) loaded into both: the ddlerp, the time-mix and the channel-mix of
one layer from nonzero states, ``forward``'s hidden states and caches,
``prefill``'s logits and cache and four ``decode_step``s, each to 1e-5;
the chunked CPU path (``scan_chunked``, chunk 8) against the reference's
and against the per-step path, to 1e-4; step-by-step decode against one full
forward; the init's tree layout; ``init_cache`` on the meta device; the
RWKV tree through ``convert`` in float32 and bf16; what the port refuses.
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
from repro.models import rwkv as rwkv_ref
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import blocks, rwkv
from repro_torch.models.model import get_model

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ARCH = "rwkv6-3b"
# the port against the reference on the CPU, both in float32
ATOL = 1e-5
# the chunked scan, against the reference's and against the per-step one:
# it multiplies decays as exp of cumulative log decays, where the two
# libraries' exp and log round apart and the per-step products round
# otherwise (the reference holds chunked and per-step to 2e-4 in the loss,
# tests/test_arch_smoke.py)
CHUNKED_ATOL = 1e-4
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


def _fields(cfg) -> dict:
    """The port's fields of a config of either package, nested configs as
    dicts."""
    return {f: (dataclasses.asdict(getattr(cfg, f))
                if dataclasses.is_dataclass(getattr(cfg, f))
                else getattr(cfg, f)) for f in PORT_FIELDS}


def _configs(**kw):
    cfg_ref = get_config_ref(ARCH).reduced().replace(**kw)
    return cfg_ref, get_config(ARCH).reduced().replace(**kw)


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
        _close(got[name], want[name], atol)


def _random_cache(cfg, B, seed):
    """A nonzero cache: states 0.5 normal, shifts normal."""
    rng = np.random.default_rng(seed)
    cache = rwkv.init_cache(cfg, B, 0, "cpu")
    return {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
            * (0.5 if k == "state" else 1.0) for k, v in cache.items()}


def test_configs_match_reference():
    ref = get_config_ref(ARCH)
    for cfg, want in ((get_config(ARCH), ref),
                      (get_config(ARCH).reduced(), ref.reduced())):
        assert _fields(cfg) == _fields(want)
        assert cfg.is_attention_free and cfg.supports_long_decode
        assert (cfg.is_attention_free, cfg.supports_long_decode) == (
            want.is_attention_free, want.supports_long_decode)
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
        32, 2560, 8960, 65536)
    assert cfg.d_model // cfg.rwkv.head_size == 40
    assert not cfg.tie_embeddings and cfg.family == "ssm"
    tiny = get_config("tinyllama-1.1b")
    assert not tiny.is_attention_free and not tiny.supports_long_decode


def test_init_params_layout_matches_reference():
    """Leaf names, shapes and dtypes of the reference's init, in float32
    and bf16, and the law of ``numpy_params`` for the RWKV leaves."""
    for dtype in ("float32", "bfloat16"):
        cfg_ref, cfg = _configs(param_dtype=dtype)
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
    tree = smoke.numpy_params(cfg, 0)["layers"]
    for name in ("mix_base", "ck_mix"):
        assert 0.2 <= tree[name].min() and tree[name].max() <= 0.8
    assert np.abs(tree["mix_lora_b"]).max() <= 0.005
    assert -1.5 <= tree["decay_base"].min() <= tree["decay_base"].max() <= -0.5
    r = cfg.rwkv.decay_lora
    assert np.abs(tree["decay_lora_b"]).max() <= 0.5 / r


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_layer_functions_match_reference():
    """The ddlerp, the time-mix (from a nonzero state and shift) and the
    channel-mix of layer 1."""
    cfg_ref, cfg = _configs()
    p_ref, p = _params(cfg_ref, seed=3)
    lp_ref = jax.tree_util.tree_map(lambda a: a[1], p_ref["layers"])
    lp = {k: v[1] for k, v in p["layers"].items()}
    rng = np.random.default_rng(4)
    B, T, d = 2, 9, cfg.d_model
    H, N = d // cfg.rwkv.head_size, cfg.rwkv.head_size
    x, last = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, d), (B, d)))
    state = rng.standard_normal((B, H, N, N)).astype(np.float32) * 0.5
    xt, lt, st = map(torch.tensor, (x, last, state))
    xj, lj, sj = map(jnp.asarray, (x, last, state))
    x_prev = np.concatenate([last[:, None], x[:, :-1]], axis=1)
    for got, want in zip(rwkv._ddlerp(lp, xt, torch.tensor(x_prev)),
                         rwkv_ref._ddlerp(lp_ref, xj, jnp.asarray(x_prev))):
        _close(got, want)
    got = rwkv.time_mix_scan(cfg, lp, xt, lt, st)
    want = rwkv_ref.time_mix_scan(cfg_ref, lp_ref, xj, lj, sj)
    for g, w in zip(got, want):
        _close(g, w)
    got = rwkv.channel_mix(cfg, lp, xt, lt)
    want = rwkv_ref.channel_mix(cfg_ref, lp_ref, xj, lj)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("with_cache", [False, True])
def test_forward_matches_reference(with_cache):
    cfg_ref, cfg = _configs()
    p_ref, p = _params(cfg_ref)
    tokens = _tokens(cfg, (2, 11))
    cache = _random_cache(cfg, 2, 5) if with_cache else None
    h, aux, new = rwkv.forward(
        cfg, p, {"tokens": torch.tensor(tokens)},
        None if cache is None else {k: torch.tensor(v)
                                    for k, v in cache.items()})
    h_ref, _, new_ref = rwkv_ref.forward(
        cfg_ref, p_ref, {"tokens": jnp.asarray(tokens)},
        None if cache is None else {k: jnp.asarray(v)
                                    for k, v in cache.items()})
    _close(h, h_ref)
    assert float(aux) == 0.0
    _close_tree(new, new_ref)
    _close(blocks.logits_fn(cfg, p, h), blocks_ref.logits_fn(cfg_ref, p_ref,
                                                             h_ref))


def test_forward_reads_the_cache_it_is_given_and_never_writes_it():
    _, cfg = _configs()
    p = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    cache = {k: torch.tensor(v) for k, v in _random_cache(cfg, 2, 6).items()}
    kept = {k: v.clone() for k, v in cache.items()}
    batch = {"tokens": torch.tensor(_tokens(cfg, (2, 3)))}
    _, _, new = rwkv.forward(cfg, p, batch, cache)
    for k in cache:
        assert torch.equal(cache[k], kept[k]) and new[k] is not cache[k]
    # a different state changes the output
    h1 = rwkv.forward(cfg, p, batch, cache)[0]
    h0 = rwkv.forward(cfg, p, batch)[0]
    assert not torch.allclose(h0, h1)


def test_prefill_and_decode_match_reference():
    cfg_ref, cfg = _configs()
    p_ref, p = _params(cfg_ref, seed=1)
    tokens = _tokens(cfg, (2, 12), seed=1)
    logits, cache = rwkv.prefill(cfg, p, {"tokens": torch.tensor(
        tokens[:, :8])}, 16)
    logits_ref, cache_ref = rwkv_ref.prefill(
        cfg_ref, p_ref, {"tokens": jnp.asarray(tokens[:, :8])}, 16)
    _close(logits, logits_ref)
    _close_tree(cache, cache_ref)
    for i in range(4):
        batch = {"token": tokens[:, 8 + i:9 + i],
                 "pos": np.full((2,), 8 + i, np.int32)}
        logits, cache = rwkv.decode_step(
            cfg, p, {k: torch.tensor(v) for k, v in batch.items()}, cache)
        logits_ref, cache_ref = rwkv_ref.decode_step(
            cfg_ref, p_ref, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_ref)
        _close(logits, logits_ref)
        _close_tree(cache, cache_ref)


def test_decode_equals_full_forward_in_port():
    """The reference's strongest serving invariant, in the port: the
    ``chip_smoke.py`` helper the card runs at full width."""
    cfg_ref, cfg = _configs()
    _, p = _params(cfg_ref, seed=2)
    err = smoke.decode_equivalence(cfg, p, _tokens(cfg, (2, 14)), 8, "cpu")
    assert err <= ATOL, err


@pytest.mark.parametrize("T", [20, 8, 1])
def test_chunked_path_matches_reference_and_stepwise(T):
    """``scan_chunked=True, scan_chunk=8`` (T = 20 pads the last chunk, T =
    1 takes the per-step path as the reference does) against the
    reference's chunked forward and against the port's per-step path."""
    cfg_ref, cfg = _configs(scan_chunked=True, scan_chunk=8)
    p_ref, p = _params(cfg_ref, seed=4)
    tokens = _tokens(cfg, (2, T), seed=4)
    cache = _random_cache(cfg, 2, 7)
    h, _, new = rwkv.forward(cfg, p, {"tokens": torch.tensor(tokens)},
                             {k: torch.tensor(v) for k, v in cache.items()})
    h_ref, _, new_ref = rwkv_ref.forward(
        cfg_ref, p_ref, {"tokens": jnp.asarray(tokens)},
        {k: jnp.asarray(v) for k, v in cache.items()})
    _close(h, h_ref, CHUNKED_ATOL)
    _close_tree(new, new_ref, CHUNKED_ATOL)
    h_step, _, new_step = rwkv.forward(
        cfg.replace(scan_chunked=False), p,
        {"tokens": torch.tensor(tokens)},
        {k: torch.tensor(v) for k, v in cache.items()})
    _close(h, h_step.numpy(), CHUNKED_ATOL)
    _close_tree(new, {k: v.numpy() for k, v in new_step.items()},
                CHUNKED_ATOL)


def test_wkv_chunked_matches_reference_from_a_state():
    B, T, H, N = 2, 19, 3, 8
    rng = np.random.default_rng(9)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.3, 0.95, (B, T, H, N)).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    arrays = (r, k, v, w, u, s0)
    y, s = rwkv.wkv_chunked(*map(torch.tensor, arrays), chunk=8)
    y_ref, s_ref = rwkv_ref.wkv_chunked(*map(jnp.asarray, arrays), chunk=8)
    _close(y, y_ref, CHUNKED_ATOL)
    _close(s, s_ref, CHUNKED_ATOL)
    y_step, s_step = rwkv.wkv_stepwise(*map(torch.tensor, arrays))
    _close(y, y_step.numpy(), CHUNKED_ATOL)
    _close(s, s_step.numpy(), CHUNKED_ATOL)


def test_init_cache_matches_reference_and_takes_meta():
    cfg_ref, cfg = _configs(dtype="bfloat16")
    want = rwkv_ref.init_cache(cfg_ref, 3, 16)
    got = get_model(cfg).init_cache(3, 16, "cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype)[6:] == str(want[k].dtype)
        assert not got[k].any()
    meta = get_model(cfg).init_cache(3, 16, device="meta")
    assert all(t.device.type == "meta" for t in meta.values())
    assert meta["state"].shape == (2, 3, 8, 32, 32)
    assert meta["state"].dtype == torch.float32
    assert meta["shift_tm"].dtype == meta["shift_cm"].dtype == torch.bfloat16


def test_rwkv_tree_crosses_convert_bit_for_bit():
    """The reference's RWKV tree, float32 and bf16, to the port and back,
    leaf for leaf; the bf16 tree's forward agrees with the reference's."""
    for dtype in ("float32", "bfloat16"):
        cfg_ref, cfg = _configs(param_dtype=dtype, dtype=dtype)
        p_ref = get_model_ref(cfg_ref).init(jax.random.PRNGKey(1))
        tree = jax.tree_util.tree_map(np.asarray, p_ref)
        p = params_from_numpy(tree, "cpu")
        assert p["layers"]["w_r"].dtype == getattr(torch, dtype)
        back = params_to_numpy(p)
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(tree),
                jax.tree_util.tree_leaves_with_path(back)):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    tokens = _tokens(cfg, (1, 6))
    logits, _ = rwkv.prefill(cfg, p, {"tokens": torch.tensor(tokens)})
    logits_ref, _ = rwkv_ref.prefill(cfg_ref, p_ref,
                                     {"tokens": jnp.asarray(tokens)})
    assert logits.dtype == torch.float32
    # bf16 activations round at other places in the two frameworks: the
    # two differ by at most 0.028 here, on logits of up to 2.7
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref),
                               atol=0.06, rtol=0)


def test_unported_parts_raise_naming_their_slice():
    """Nothing of RWKV6 raises any more: its training loss, which used to
    name zoo step 6b, trains (``tests/test_torch_rwkv_train.py`` holds it
    to the reference); the VLM and the encoder-decoder, which used to
    raise, serve and train too."""
    _, cfg = _configs()
    p = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.ones((1, 4), dtype=torch.int32),
             "targets": torch.ones((1, 4), dtype=torch.int32)}
    loss, metrics = get_model(cfg).loss_fn(p, batch)
    assert bool(torch.isfinite(loss)) and sorted(metrics) == ["aux", "xent"]
    assert get_config("paligemma-3b").family == "vlm"
    assert get_model(cfg.replace(family="vlm")).prefill is not None
    assert get_model(get_config("seamless-m4t-medium").reduced()).forward
