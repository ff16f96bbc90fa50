"""The zoo's dense trio on the CPU, held to the JAX package, and the
full-width parity fixtures the card is held to.

``h2o-danube-3-4b`` (head_dim 120, sliding window 4096 and its ring
buffer), ``codeqwen1.5-7b`` (QKV biases, MHA, rope theta 1e6) and
``nemotron-4-15b`` (squared-ReLU with no gate, untied vocab 256,000) at
``reduced()``, with the reference's params carried across by ``convert``:
``forward``, ``prefill`` (logits and cache) and ``decode_step``, each to
1e-5; step-by-step decode against one full forward in the port;
``Engine.generate`` and ``Engine.serve`` token for token and tick for
tick; h2o's decode past its window, codeqwen's biased QKV projection and
nemotron's MLP held to the reference's.

The card has no JAX, so phases 16 and 17 of ``chip_smoke.py`` read the
reference's outputs from ``tests/data/torch_parity_<arch>.npz``: the arch
at full width in float32, at the depth (and for kimi the experts) of
``chip_smoke.PARITY_CUTS``, params from ``chip_smoke.numpy_params`` in
pieces of ``DRAW_CHUNK`` (the fixture holds no weights), the tinyllama
fixture's prompts, tokens, logits and serve run, plus the config's cuts
and, for an MoE config, each dispatch's routing (``route_*``).  Rewrite
one with

    PYTHONPATH=src python tests/test_torch_zoo_dense.py <arch>

for any arch of ``chip_smoke.NEW_ZOO_ARCHS``, one process each (29-49 GB
resident at the peak, about twice the float32 params).  Here each committed
fixture's format is checked, and a reduced-width regeneration reproduced
by the port; ``test_torch_zoo_moe.py`` does the same for the MoE pair
with this file's ``build_fixture``.
"""
import contextlib
import dataclasses
import functools
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
from repro.models import moe as moe_ref
from repro.models import transformer as tr_ref
from repro.serving.batching import Request as RequestRef
from repro.serving.engine import Engine as EngineRef
from repro_torch.configs import ModelConfig, MoEConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks, transformer
from repro_torch.models import moe as moe_port
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ATOL = 1e-5
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


def port_config(cfg_ref) -> ModelConfig:
    """The port's config with the reference config's values."""
    kw = {f: getattr(cfg_ref, f) for f in PORT_FIELDS}
    if cfg_ref.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(cfg_ref.moe))
    return ModelConfig(**kw)


def reduced_pair(arch: str, n_experts: int = 0, key: int = 0):
    """(cfg_ref, p_ref, cfg, p): the arch at ``reduced()`` (with
    ``n_experts`` experts where given), the reference's params from
    ``PRNGKey(key)`` and their copy in the port."""
    cfg_ref = smoke.zoo_reduced_config(get_config_ref(arch), n_experts)
    p_ref = get_model_ref(cfg_ref).init(jax.random.PRNGKey(key))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, p_ref), "cpu")
    return cfg_ref, p_ref, port_config(cfg_ref), p


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def tokens_for(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, shape,
                                                dtype=np.int32)


# -- the reference's routing and the fixtures' writer -----------------------


@contextlib.contextmanager
def recording_reference_routes():
    """Record every dispatch of the reference's MoE layer, in call order,
    as ``smoke.routing_record``s: ``moe_onehot`` wrapped so that each call
    (under ``jax.jit`` and ``lax.scan`` too) hands its router
    probabilities and top-k ids to the host through an ordered
    ``jax.debug.callback``; the kept slots are the reference's capacity
    rule on those ids (``smoke.capacity_keep``, which
    ``test_torch_zoo_moe.py`` holds to ``moe_onehot``)."""
    calls = []
    orig = moe_ref.moe_onehot

    def onehot(cfg, p, x, group=0, no_drop=False):
        B, S, d = x.shape
        n_groups, g, cap = moe_port.group_and_capacity(cfg, S, group,
                                                       no_drop)
        probs, _, idx = moe_ref._route(cfg, p["router"],
                                       x.reshape(B * n_groups, g, d))

        def record(pr, ix):
            ix = np.asarray(ix)
            calls.append(smoke.routing_record(
                np.asarray(pr), ix, smoke.capacity_keep(
                    ix, cfg.moe.n_experts, cap), cfg.moe.top_k))

        jax.debug.callback(record, probs, idx, ordered=True)
        return orig(cfg, p, x, group, no_drop)

    moe_ref.moe_onehot = onehot
    try:
        yield calls
    finally:
        moe_ref.moe_onehot = orig


def fixture_config(arch: str, reduced: bool):
    """The reference's config of an arch's parity run: full width in
    float32 at ``smoke.PARITY_CUTS``' depth and experts, or ``reduced()``
    with those experts."""
    n_layers, n_experts = smoke.PARITY_CUTS[arch]
    cfg = get_config_ref(arch)
    if reduced:
        return smoke.zoo_reduced_config(cfg, n_experts)
    return smoke.zoo_parity_config(cfg, n_layers, n_experts)


def to_jax(tree: dict) -> dict:
    """A numpy tree as JAX arrays, emptied leaf by leaf as it goes, so that
    at most one leaf is held twice."""
    out = {}
    for name in list(tree):
        leaf = tree.pop(name)
        out[name] = to_jax(leaf) if isinstance(leaf, dict) else jnp.asarray(
            leaf)
        del leaf
    return out


def build_fixture(arch: str, reduced: bool) -> dict:
    """The reference's parity run of ``arch``: ``smoke.numpy_params`` (in
    pieces of ``DRAW_CHUNK``) handed to JAX leaf by leaf,
    ``smoke.zoo_prompts`` through its ``Engine.generate`` with each step's
    logits (and for an MoE config each dispatch's routing) recorded, then
    ``smoke.serve_check``'s requests through its ``Engine.serve``."""
    cfg_ref = fixture_config(arch, reduced)
    params = to_jax(smoke.numpy_params(cfg_ref, smoke.ZOO_SEED,
                                       smoke.DRAW_CHUNK))
    prompts = smoke.zoo_prompts(cfg_ref, smoke.ZOO_SEED)
    max_len = prompts.shape[1] + smoke.ZOO_NEW_TOKENS
    engine = EngineRef(cfg_ref, params, max_len=max_len)
    steps = smoke.record_logits(engine)
    extra = smoke.fixture_cuts(cfg_ref)
    with (recording_reference_routes() if cfg_ref.moe is not None
          else contextlib.nullcontext([])) as calls:
        tokens, _ = engine.generate(prompts, smoke.ZOO_NEW_TOKENS)
    if cfg_ref.moe is not None:
        n_moe = cfg_ref.n_layers - min(cfg_ref.moe.first_dense_layers,
                                       cfg_ref.n_layers)
        extra.update(smoke.route_arrays(calls, prompts.shape[0], n_moe))
    serve = smoke.serve_fixture_run(EngineRef, RequestRef, cfg_ref, params)
    return smoke.zoo_fixture_arrays(arch, reduced, smoke.ZOO_SEED, prompts,
                                    tokens, steps, max_len, serve, extra)


def check_committed_fixture(arch: str) -> dict:
    """A committed fixture is the full-width run ``chip_smoke`` reads: its
    arch, config cuts, draw chunk, prompts and token shapes; outputs only
    (well under 1 MB).  Returns it."""
    fx = smoke.load_fixture(smoke.zoo_fixture(arch))
    assert str(fx["arch"]) == arch and not bool(fx["reduced"])
    assert int(fx["seed"]) == smoke.ZOO_SEED
    assert int(fx["draw_chunk"]) == smoke.DRAW_CHUNK
    n_layers, n_experts = smoke.PARITY_CUTS[arch]
    cfg = smoke.zoo_config(fx)
    assert cfg == smoke.zoo_parity_config(get_config(arch), n_layers,
                                          n_experts)
    assert cfg.d_model == get_config(arch).d_model  # full width
    np.testing.assert_array_equal(fx["prompts"],
                                  smoke.zoo_prompts(cfg, smoke.ZOO_SEED))
    n = smoke.ZOO_NEW_TOKENS
    assert fx["tokens"].shape == (smoke.ZOO_PROMPTS[0], n)
    assert (fx["top_ids"][..., 0] == fx["tokens"]).all()
    live = fx["serve_tokens"] >= 0
    assert list(live.sum(1)) == list(smoke.SERVE_CHECK_NEW_TOKENS)
    assert smoke.zoo_fixture(arch).stat().st_size < 1 << 20
    return fx


def reproduce_reduced_fixture(arch: str) -> dict:
    """A reduced regeneration has the committed fixture's keys and dtypes,
    and the port reproduces it: tokens, logits, routing and the serve
    run.  Returns the regenerated fixture."""
    fx = build_fixture(arch, reduced=True)
    committed = smoke.load_fixture(smoke.zoo_fixture(arch))
    assert fx.keys() == committed.keys()
    for k in fx:
        assert fx[k].dtype == committed[k].dtype, k
    with smoke.recording_routes() as routes:
        cfg, params, tokens, steps = smoke.run_zoo_parity(fx, "cpu")
    assert cfg == port_config(fixture_config(arch, reduced=True))
    np.testing.assert_array_equal(tokens, fx["tokens"])
    stops = None
    if cfg.moe is not None:
        routing = smoke.check_zoo_routes(fx, tokens, routes)
        assert routing["route_near_ties"] == []
        stops = routing["stops"]
    assert smoke.check_zoo_parity(fx, tokens, steps, ATOL,
                                  stops)["near_ties"] == []
    done = smoke.serve_check(
        Engine(cfg, params, max_len=smoke.SERVE_CHECK_MAX_LEN, device="cpu"),
        cfg)
    served = smoke.check_zoo_serve(fx, done, atol=ATOL)
    assert served["tokens"] == sum(smoke.SERVE_CHECK_NEW_TOKENS)
    return fx


# -- the dense trio ---------------------------------------------------------


@pytest.mark.parametrize("arch", smoke.DENSE_ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    cfg_ref, p_ref, cfg, p = reduced_pair(arch)
    toks = tokens_for(cfg, (2, 12))
    h, aux = transformer.forward(cfg, p, {"tokens": torch.tensor(toks)})
    h_ref, aux_ref = tr_ref.forward(cfg_ref, p_ref,
                                    {"tokens": jnp.asarray(toks)})
    close(h, h_ref)
    assert float(aux) == float(aux_ref) == 0.0
    logits, cache = transformer.prefill(
        cfg, p, {"tokens": torch.tensor(toks[:, :8])}, 16)
    logits_ref, cache_ref = tr_ref.prefill(
        cfg_ref, p_ref, {"tokens": jnp.asarray(toks[:, :8])}, 16)
    close(logits, logits_ref)
    decode_ref = jax.jit(functools.partial(tr_ref.decode_step, cfg_ref))
    for i in range(4):
        batch = {"token": toks[:, 8 + i:9 + i],
                 "pos": np.full((2,), 8 + i, np.int32)}
        logits, cache = transformer.decode_step(
            cfg, p, {k: torch.tensor(v) for k, v in batch.items()}, cache)
        logits_ref, cache_ref = decode_ref(
            p_ref, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_ref)
        close(logits, logits_ref)
        for name in ("k", "v"):
            close(cache[name], cache_ref[name])
        np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                      np.asarray(cache_ref["kv_pos"]))


@pytest.mark.parametrize("arch", smoke.DENSE_ARCHS)
def test_decode_equals_full_forward_in_port(arch):
    _, _, cfg, p = reduced_pair(arch, key=1)
    err = smoke.decode_equivalence(cfg, p, tokens_for(cfg, (2, 14)), 8,
                                   "cpu")
    assert err <= ATOL, err


@pytest.mark.parametrize("arch", smoke.DENSE_ARCHS)
def test_engine_generate_and_serve_match_reference(arch):
    cfg_ref, p_ref, cfg, p = reduced_pair(arch)
    prompts = tokens_for(cfg, (3, 10), seed=1)
    want, _ = EngineRef(cfg_ref, p_ref, max_len=24).generate(prompts, 6)
    got, _ = Engine(cfg, p, max_len=24, device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    reqs = [(i, tokens_for(cfg, (4 + 3 * (i % 3),), seed=10 + i),
             2 + i % 4) for i in range(5)]
    done_ref = EngineRef(cfg_ref, p_ref, max_len=48).serve(
        [RequestRef(uid=u, prompt=t, max_new_tokens=n) for u, t, n in reqs],
        n_slots=2)
    done = Engine(cfg, p, max_len=48, device="cpu").serve(
        [Request(uid=u, prompt=t, max_new_tokens=n) for u, t, n in reqs],
        n_slots=2)
    assert [r.uid for r in done] == [r.uid for r in done_ref]
    for a, b in zip(done, done_ref):
        assert a.generated == b.generated, a.uid
        assert (a.admitted_at, a.finished_at) == (b.admitted_at,
                                                  b.finished_at)


def test_h2o_ring_buffer_past_window_matches_reference():
    """h2o-danube at ``reduced()`` keeps its window of 64 slots: a 60-token
    prompt and 12 decode steps wrap the ring buffer, held to the
    reference's logits and caches step by step and to one full forward."""
    cfg_ref, p_ref, cfg, p = reduced_pair("h2o-danube-3-4b", key=2)
    assert cfg.attention == "swa" and cfg.window_size == 64
    assert cfg.resolved_head_dim == 64
    toks = tokens_for(cfg, (2, 72), seed=3)
    logits, cache = transformer.prefill(
        cfg, p, {"tokens": torch.tensor(toks[:, :60])}, 72)
    logits_ref, cache_ref = tr_ref.prefill(
        cfg_ref, p_ref, {"tokens": jnp.asarray(toks[:, :60])}, 72)
    assert cache["k"].shape[2] == 64
    close(logits, logits_ref)
    h, _ = transformer.forward(cfg, p, {"tokens": torch.tensor(toks)})
    full = blocks.logits_fn(cfg, p, h)
    for i in range(60, 72):
        batch = {"token": toks[:, i:i + 1], "pos": np.full((2,), i,
                                                           np.int32)}
        logits, cache = transformer.decode_step(
            cfg, p, {k: torch.tensor(v) for k, v in batch.items()}, cache)
        logits_ref, cache_ref = tr_ref.decode_step(
            cfg_ref, p_ref, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_ref)
        close(logits, logits_ref)
        close(cache["k"], cache_ref["k"])
        np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                      np.asarray(cache_ref["kv_pos"]))
        close(logits, full[:, i].detach(), atol=2e-5)
    # the card's window check, at this size: decode past the window
    win = smoke.window_check(cfg, p, "cpu", shape=(60, 12))
    assert win["window"] == 64 and win["err"] <= 2e-5


def test_codeqwen_qkv_bias_matches_reference():
    """codeqwen's QKV biases (zero at init on both sides, so drawn here)
    and rope theta 1e6 through the projection and a whole forward."""
    cfg_ref, p_ref, cfg, p = reduced_pair("codeqwen1.5-7b")
    assert cfg.qkv_bias and cfg.rope_theta == 1e6
    assert cfg.n_heads == cfg.n_kv_heads  # MHA
    rng = np.random.default_rng(4)
    for name in ("bq", "bk", "bv"):
        b = (0.5 * rng.standard_normal(p_ref["layers"][name].shape)).astype(
            np.float32)
        p_ref["layers"][name] = jnp.asarray(b)
        p["layers"][name] = torch.tensor(b)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(100, 109, dtype=np.int32), (2, 1))
    lp = {k: v[0] for k, v in p["layers"].items()}
    lp_ref = jax.tree_util.tree_map(lambda a: a[0], p_ref["layers"])
    for got, want in zip(
            blocks.attn_qkv(cfg, lp, torch.tensor(x), torch.tensor(pos)),
            blocks_ref.attn_qkv(cfg_ref, lp_ref, jnp.asarray(x),
                                jnp.asarray(pos))):
        close(got, want)
    toks = tokens_for(cfg, (2, 10), seed=5)
    h, _ = transformer.forward(cfg, p, {"tokens": torch.tensor(toks)})
    h_ref, _ = tr_ref.forward(cfg_ref, p_ref, {"tokens": jnp.asarray(toks)})
    close(h, h_ref)


def test_nemotron_squared_relu_matches_reference():
    """nemotron's MLP: squared ReLU with no gate, and its untied head."""
    cfg_ref, p_ref, cfg, p = reduced_pair("nemotron-4-15b")
    assert cfg.mlp_variant == "squared_relu" and not cfg.tie_embeddings
    assert "w_gate" not in p["layers"] and "out_head" in p
    assert get_config("nemotron-4-15b").vocab_size == 256_000
    x = np.random.default_rng(6).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    lp = {k: v[1] for k, v in p["layers"].items()}
    lp_ref = jax.tree_util.tree_map(lambda a: a[1], p_ref["layers"])
    close(blocks.apply_mlp(cfg, lp, torch.tensor(x)),
          blocks_ref.apply_mlp(cfg_ref, lp_ref, jnp.asarray(x)))
    h = torch.tensor(x)
    close(blocks.logits_fn(cfg, p, h),
          blocks_ref.logits_fn(cfg_ref, p_ref, jnp.asarray(x)))


@pytest.mark.parametrize("arch", smoke.DENSE_ARCHS)
def test_committed_fixture_is_what_chip_smoke_reads(arch):
    fx = check_committed_fixture(arch)
    assert "route_prefill_idx" not in fx
    assert int(fx["parity_n_experts"]) == 0


def test_reduced_fixture_matches_format_and_port_reproduces_it():
    reproduce_reduced_fixture("codeqwen1.5-7b")


def test_numpy_params_build_the_reference_layout():
    """``chip_smoke.numpy_params`` gives the tree the reference's init
    gives, leaf for leaf, for every new arch at reduced size and at its
    parity config (shapes only); the chunked draws are the same with one
    thread or many and differ from whole-leaf draws."""
    for arch in smoke.NEW_ZOO_ARCHS:
        for cfg_ref in (fixture_config(arch, True),
                        fixture_config(arch, False)):
            want = jax.eval_shape(lambda: get_model_ref(cfg_ref).init(
                jax.random.PRNGKey(0)))
            shapes = {tuple(k.key for k in path): leaf.shape
                      for path, leaf in
                      jax.tree_util.tree_leaves_with_path(want)}
            got = {tuple(k.split("/")): shape for k, (shape, _) in
                   smoke._param_shapes(cfg_ref).items()}
            assert got == shapes, arch
    cfg_ref = fixture_config("kimi-k2-1t-a32b", True)
    chunked = smoke.numpy_params(cfg_ref, 0, 1000)
    again = smoke.numpy_params(cfg_ref, 0, 1000)
    whole = smoke.numpy_params(cfg_ref, 0)
    w = chunked["moe_layers"]["we_in"]
    assert w.size > 1000
    np.testing.assert_array_equal(w, again["moe_layers"]["we_in"])
    assert not np.array_equal(w, whole["moe_layers"]["we_in"])
    # a piece is the leaf's own generator's draw for that piece
    key = [0, smoke.zlib.crc32(b"moe_layers/we_in"), 1]
    piece = np.random.default_rng(key).standard_normal(1000,
                                                       dtype=np.float32)
    scale = np.float32(w.shape[-2] ** -0.5)
    np.testing.assert_array_equal(w.reshape(-1)[1000:2000], piece * scale)


if __name__ == "__main__":
    import resource
    import sys
    import time

    arch = sys.argv[1]
    t0 = time.perf_counter()
    arrays = build_fixture(arch, reduced=False)
    path = smoke.zoo_fixture(arch)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.perf_counter() - t0:.1f} s, peak resident {peak_gb:.1f} GB")
