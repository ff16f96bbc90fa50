"""The port's dense transformer on the CPU, held to the JAX package.

At ``tinyllama-1.1b.reduced()`` (and a grouped-query variant of it), with
the reference's params from ``jax.random.PRNGKey(0)`` carried across by
``convert``: the norm, the rotary embedding, the QKV projection,
``forward``, ``prefill`` (logits and cache) and ``decode_step`` over four
steps, each to 1e-5.  Then the port's own serving invariant (step-by-step
decode equals one full forward), the sliding-window ring buffer at
``h2o-danube-3-4b``'s shape, the init's tree layout, bf16 trees through
``convert`` bit for bit, every ported config equal to the reference's, and
what the port refuses.  The other dense configs and the MoE pair are held
to the reference in ``test_torch_zoo_dense.py`` and
``test_torch_zoo_moe.py``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REGISTRY_REF
from repro.configs import get_config as get_config_ref
from repro.models import blocks as blocks_ref
from repro.models import get_model as get_model_ref
from repro.models import nn as nn_ref
from repro.models import transformer as tr_ref
from repro_torch.configs import REGISTRY, ModelConfig, MoEConfig, get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import blocks, nn, transformer
from repro_torch.models.model import get_model

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ATOL = 1e-5
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


NEW_ARCHS = ("h2o-danube-3-4b", "codeqwen1.5-7b", "nemotron-4-15b",
             "grok-1-314b", "kimi-k2-1t-a32b")


def port_config(cfg_ref) -> ModelConfig:
    """The port's config with the reference config's values."""
    kw = {f: getattr(cfg_ref, f) for f in PORT_FIELDS}
    if cfg_ref.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(cfg_ref.moe))
    return ModelConfig(**kw)


def _configs(variant):
    cfg_ref = get_config_ref("tinyllama-1.1b").reduced()
    if variant == "gqa":  # two query heads per KV head
        cfg_ref = cfg_ref.replace(n_kv_heads=2)
    return cfg_ref, port_config(cfg_ref)


def _params(cfg_ref, key=0):
    p_ref = get_model_ref(cfg_ref).init(jax.random.PRNGKey(key))
    return p_ref, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p_ref), "cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=atol)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, shape,
                                                dtype=np.int32)


def test_configs_match_reference():
    for name in ("tinyllama-1.1b", *NEW_ARCHS):
        ref = get_config_ref(name)
        for cfg, want in ((get_config(name), ref),
                          (get_config(name).reduced(), ref.reduced())):
            assert cfg == port_config(want)
            assert (cfg.resolved_head_dim, cfg.q_dim, cfg.kv_dim) == (
                want.resolved_head_dim, want.q_dim, want.kv_dim)
    assert get_config("lstm-paper").lstm.hidden == 40
    assert get_config("rwkv6-3b").family == "ssm"  # ported in slice 5
    assert get_config("zamba2-1.2b").family == "hybrid"  # ported in slice 6
    # ported in slice 17 (their sub-configs compared in test_torch_vlm.py
    # and test_torch_encdec.py)
    assert get_config("paligemma-3b").family == "vlm"
    assert get_config("seamless-m4t-medium").family == "audio"
    assert sorted(REGISTRY) == sorted(REGISTRY_REF)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    _close(nn.rms_norm(torch.tensor(x), torch.tensor(gamma), 1e-5),
           nn_ref.rms_norm(jnp.asarray(x), jnp.asarray(gamma), 1e-5))
    _close(nn.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0),
           nn_ref.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    # bf16 in, bf16 out, computed in f32 as the reference does
    xb = torch.tensor(x, dtype=torch.bfloat16)
    got = nn.apply_rope(xb, torch.tensor(pos), 10000.0)
    want = nn_ref.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                             10000.0)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), atol=1e-2)


@pytest.mark.parametrize("variant", ["tinyllama", "gqa"])
def test_attn_qkv_and_forward_match_reference(variant):
    cfg_ref, cfg = _configs(variant)
    p_ref, p = _params(cfg_ref)
    tokens = _tokens(cfg, (2, 12))
    x = np.random.default_rng(1).standard_normal((2, 12, cfg.d_model)).astype(
        np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    lp_ref = jax.tree_util.tree_map(lambda a: a[0], p_ref["layers"])
    lp = {k: v[0] for k, v in p["layers"].items()}
    for got, want in zip(
            blocks.attn_qkv(cfg, lp, torch.tensor(x), torch.tensor(pos)),
            blocks_ref.attn_qkv(cfg_ref, lp_ref, jnp.asarray(x),
                                jnp.asarray(pos))):
        _close(got, want)
    h, aux = transformer.forward(cfg, p, {"tokens": torch.tensor(tokens)})
    h_ref, _ = tr_ref.forward(cfg_ref, p_ref, {"tokens": jnp.asarray(tokens)})
    _close(h, h_ref)
    assert float(aux) == 0.0
    _close(blocks.logits_fn(cfg, p, h), blocks_ref.logits_fn(cfg_ref, p_ref,
                                                             h_ref))


@pytest.mark.parametrize("variant", ["tinyllama", "gqa"])
def test_prefill_and_decode_match_reference(variant):
    cfg_ref, cfg = _configs(variant)
    p_ref, p = _params(cfg_ref)
    tokens = _tokens(cfg, (2, 12))
    logits, cache = transformer.prefill(
        cfg, p, {"tokens": torch.tensor(tokens[:, :8])}, 16)
    logits_ref, cache_ref = tr_ref.prefill(
        cfg_ref, p_ref, {"tokens": jnp.asarray(tokens[:, :8])}, 16)
    _close(logits, logits_ref)
    for name in ("k", "v"):
        _close(cache[name], cache_ref[name])
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(cache_ref["kv_pos"]))
    for i in range(4):
        batch = {"token": tokens[:, 8 + i:9 + i],
                 "pos": np.full((2,), 8 + i, np.int32)}
        logits, cache = transformer.decode_step(
            cfg, p, {k: torch.tensor(v) for k, v in batch.items()}, cache)
        logits_ref, cache_ref = tr_ref.decode_step(
            cfg_ref, p_ref, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_ref)
        _close(logits, logits_ref)
        for name in ("k", "v"):
            _close(cache[name], cache_ref[name])
        np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                      np.asarray(cache_ref["kv_pos"]))


def test_prefill_longer_than_cache_matches_reference():
    """A prompt longer than ``max_len`` keeps its last ``max_len`` K/V rows
    and labels them 0..max_len-1, as the reference does."""
    cfg_ref, cfg = _configs("tinyllama")
    p_ref, p = _params(cfg_ref)
    tokens = _tokens(cfg, (1, 10))
    logits, cache = transformer.prefill(cfg, p,
                                        {"tokens": torch.tensor(tokens)}, 6)
    logits_ref, cache_ref = tr_ref.prefill(
        cfg_ref, p_ref, {"tokens": jnp.asarray(tokens)}, 6)
    _close(logits, logits_ref)
    _close(cache["k"], cache_ref["k"])
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(cache_ref["kv_pos"]))


@pytest.mark.parametrize("variant", ["tinyllama", "gqa"])
def test_decode_equals_full_forward_in_port(variant):
    """The reference's strongest serving invariant, in the port: the
    ``chip_smoke.py`` helper the card runs at full width."""
    _, cfg = _configs(variant)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    err = smoke.decode_equivalence(cfg, p, _tokens(cfg, (2, 14)), 8, "cpu")
    assert err <= ATOL, err


def test_swa_ring_buffer_matches_reference():
    """``h2o-danube-3-4b``'s shape reduced, window 8: the prefill fills the
    ring buffer and every decode step wraps it, against the reference's
    caches and logits (its tests/test_decode_equivalence.py setup)."""
    cfg_ref = get_config_ref("h2o-danube-3-4b").reduced().replace(
        window_size=8, attn_chunk=8)
    cfg = port_config(cfg_ref)
    p_ref, p = _params(cfg_ref, key=1)
    tokens = _tokens(cfg, (1, 18), seed=1)
    logits, cache = transformer.prefill(
        cfg, p, {"tokens": torch.tensor(tokens[:, :10])}, 18)
    logits_ref, cache_ref = tr_ref.prefill(
        cfg_ref, p_ref, {"tokens": jnp.asarray(tokens[:, :10])}, 18)
    assert cache["k"].shape[2] == cfg.window_size
    _close(logits, logits_ref)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(cache_ref["kv_pos"]))
    h, _ = transformer.forward(cfg, p, {"tokens": torch.tensor(tokens)})
    full = blocks.logits_fn(cfg, p, h)
    for i in range(10, 18):
        batch = {"token": tokens[:, i:i + 1], "pos": np.full((1,), i,
                                                             np.int32)}
        logits, cache = transformer.decode_step(
            cfg, p, {k: torch.tensor(v) for k, v in batch.items()}, cache)
        logits_ref, cache_ref = tr_ref.decode_step(
            cfg_ref, p_ref, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_ref)
        _close(logits, logits_ref)
        _close(cache["k"], cache_ref["k"])
        np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                      np.asarray(cache_ref["kv_pos"]))
        _close(logits, full[:, i].detach())


def test_init_params_layout_matches_reference():
    cfg_ref, cfg = _configs("tinyllama")
    want = jax.eval_shape(lambda: get_model_ref(cfg_ref).init(
        jax.random.PRNGKey(0)))
    got = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat_want = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_leaves_with_path(want)}
    flat_got = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_leaves_with_path(got)}
    assert flat_got.keys() == flat_want.keys()
    for k, w in flat_want.items():
        assert tuple(flat_got[k].shape) == w.shape, k
        assert flat_got[k].dtype == torch.float32, k
    cache = get_model(cfg).init_cache(3, 20, "cpu")
    cache_ref = get_model_ref(cfg_ref).init_cache(3, 20)
    for name in ("k", "v", "kv_pos"):
        assert tuple(cache[name].shape) == cache_ref[name].shape
    assert (cache["kv_pos"] == -1).all()


def test_bf16_tree_round_trips_bit_for_bit():
    """A reference bf16 tree (``np.asarray`` gives ml_dtypes' bfloat16)
    goes to torch.bfloat16 and back with every bit kept."""
    cfg_ref = get_config_ref("tinyllama-1.1b").reduced().replace(
        param_dtype="bfloat16", dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, get_model_ref(cfg_ref).init(jax.random.PRNGKey(0)))
    p = params_from_numpy(tree, "cpu")
    back = params_to_numpy(p)
    for (path, a), b, t in zip(jax.tree_util.tree_leaves_with_path(tree),
                               jax.tree_util.tree_leaves(back),
                               jax.tree_util.tree_leaves(p)):
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16),
            err_msg=jax.tree_util.keystr(path))
        np.testing.assert_array_equal(b.view(np.uint16), a.view(np.uint16))
    # the bf16 tree serves: prefill in the config's bf16 on both sides
    cfg = port_config(cfg_ref)
    tokens = _tokens(cfg, (1, 6))
    logits, _ = transformer.prefill(cfg, p, {"tokens": torch.tensor(tokens)})
    logits_ref, _ = tr_ref.prefill(cfg_ref, jax.tree_util.tree_map(
        jnp.asarray, tree), {"tokens": jnp.asarray(tokens)})
    assert logits.dtype == torch.float32
    _close(logits, logits_ref, atol=0.25)


def test_unported_parts_raise_naming_their_slice():
    """The zoo's training loss, which raised until zoo step 6, is the
    reference's now: the token cross entropy plus the MoE layers' aux loss
    (``tests/test_torch_zoo_train.py`` holds it and its gradients to the
    reference's).  The MoE, VLM and encoder-decoder families serve and
    train, and a config without a frontend ignores a batch's
    ``prefix_embed``, as the reference's does.  What still raises: an
    unknown family, and the encoder-decoder's serve without frames."""
    _, cfg = _configs("tinyllama")
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.ones((1, 4), dtype=torch.int32),
             "targets": torch.arange(4, dtype=torch.int32)[None]}
    loss, metrics = transformer.loss_fn(cfg, p, batch)
    assert sorted(metrics) == ["aux", "xent"]
    assert float(metrics["aux"]) == 0.0 and float(loss) == float(
        metrics["xent"]) > 0
    h, _ = transformer.forward(cfg, p, {**batch, "prefix_embed": None})
    assert h.shape == (1, 4, cfg.d_model)
    for arch in ("grok-1-314b", "paligemma-3b", "seamless-m4t-medium"):
        rcfg = get_config(arch).reduced()
        model = get_model(rcfg)
        assert model.prefill is not None and model.decode_step is not None
        b = dict(batch)
        if rcfg.frontend is not None:
            fe = rcfg.frontend
            b["prefix_embed"] = torch.zeros((1, fe.n_prefix_tokens,
                                             fe.embed_dim))
        loss, metrics = model.loss_fn(
            model.init(torch.Generator().manual_seed(0), "cpu"), b)
        assert bool(torch.isfinite(loss)) and float(metrics["xent"]) > 0
        assert (float(metrics["aux"]) > 0) == (rcfg.moe is not None) \
            if "aux" in metrics else rcfg.family == "audio"
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg.replace(family="diffusion"))
