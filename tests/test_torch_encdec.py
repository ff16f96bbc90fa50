"""The zoo's encoder-decoder on the CPU, held to the JAX package, and the
full-width parity fixtures of it and of the VLM.

``seamless-m4t-medium`` (a 12-layer encoder over 1024 stubbed frames, a
12-layer decoder with cross attention, MHA 16:16, ``relu`` MLP) at
``reduced()``, with the reference's params carried across by
``convert``: ``encode``, ``cross_attention`` and ``project_memory``,
``prefill`` (the logits and every cache leaf: ``k``, ``v``, ``kv_pos``,
``ck``, ``cv``, ``mem_pos``) and ``decode_step``, each to 1e-5;
step-by-step decode against one full forward in the port;
``Engine.generate`` with the frames token for token; ``Engine.serve``
refused as the reference's fails; the init's tree; the training loss
refused, naming zoo step 6.

The card has no JAX, so phase 18 of ``chip_smoke.py`` reads the
reference's outputs from ``tests/data/torch_parity_<arch>.npz`` for
``seamless-m4t-medium`` and ``paligemma-3b``: the arch at full width and
depth in float32, params from ``chip_smoke.numpy_params`` in pieces of
``DRAW_CHUNK``, the prefix embeddings from ``chip_smoke.zoo_prefix`` at
the recorded ``prefix_seed`` (the fixture holds neither weights nor
embeddings), the tinyllama fixture's prompts, greedy tokens, top-64
logits and logsumexp, and for paligemma its text-only serve run.  Rewrite
one with

    PYTHONPATH=src python tests/test_torch_encdec.py <arch>

for either arch of ``chip_smoke.ENCDEC_VLM_ARCHS``, one process each.
Here each committed fixture's format is checked, and a reduced-width
regeneration reproduced by the port (``test_torch_vlm.py`` does both for
paligemma with this file's ``build_fixture``).
"""
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
from repro.models import encdec as ed_ref
from repro.models import get_model as get_model_ref
from repro.serving.batching import Request as RequestRef
from repro.serving.engine import Engine as EngineRef
from repro_torch.configs import (EncDecConfig, FrontendStub, ModelConfig,
                                 get_config)
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks, encdec
from repro_torch.models.model import get_model
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "zoo_dense", ROOT / "tests" / "test_torch_zoo_dense.py")
zd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(zd)
smoke = zd.smoke

ATOL = 1e-5
ARCH = smoke.ENCDEC_ARCH
PORT_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


def port_config(cfg_ref) -> ModelConfig:
    """The port's config with the reference config's values, its
    encoder-decoder and frontend sub-configs too."""
    kw = {f: getattr(cfg_ref, f) for f in PORT_FIELDS}
    if cfg_ref.encdec is not None:
        kw["encdec"] = EncDecConfig(**dataclasses.asdict(cfg_ref.encdec))
    if cfg_ref.frontend is not None:
        kw["frontend"] = FrontendStub(**dataclasses.asdict(cfg_ref.frontend))
    return ModelConfig(**kw)


def reduced_pair(arch: str, key: int = 0, **changes):
    """(cfg_ref, p_ref, cfg, p): the arch at ``reduced()`` with
    ``changes``, the reference's params from ``PRNGKey(key)`` and their
    copy in the port."""
    cfg_ref = get_config_ref(arch).reduced().replace(**changes)
    p_ref = get_model_ref(cfg_ref).init(jax.random.PRNGKey(key))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, p_ref), "cpu")
    return cfg_ref, p_ref, port_config(cfg_ref), p


def prefix_for(cfg, batch: int, seed: int = 0) -> np.ndarray:
    return smoke.zoo_prefix(cfg, seed, batch)


def close_tree(got: dict, want: dict, atol: float = ATOL) -> None:
    """Every leaf of a cache: floats within ``atol``, positions exactly."""
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        ref = np.asarray(want[name])
        assert tuple(leaf.shape) == ref.shape, name
        if leaf.dtype == torch.int32:
            np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=name)
        else:
            zd.close(leaf, ref, atol)


# -- the fixtures' writer ---------------------------------------------------


def build_fixture(arch: str, reduced: bool) -> dict:
    """The reference's parity run of ``arch`` (the encoder-decoder or the
    VLM): ``smoke.numpy_params`` in pieces of ``DRAW_CHUNK`` handed to JAX
    leaf by leaf, ``smoke.zoo_prompts`` after the prefix embeddings
    ``smoke.zoo_prefix`` at ``PREFIX_SEED`` through its
    ``Engine.generate`` (max_len the prefix's positions, the prompt and
    the new tokens) with each step's logits recorded, then, for the VLM,
    ``smoke.serve_check``'s text-only requests through its
    ``Engine.serve``.  The encoder-decoder's serve fails in the reference
    (its prefill reads ``prefix_embed``), so its fixture has none."""
    cfg_ref = zd.fixture_config(arch, reduced)
    params = zd.to_jax(smoke.numpy_params(cfg_ref, smoke.ZOO_SEED,
                                          smoke.DRAW_CHUNK))
    prompts = smoke.zoo_prompts(cfg_ref, smoke.ZOO_SEED)
    prefix = smoke.zoo_prefix(cfg_ref, smoke.PREFIX_SEED, prompts.shape[0])
    max_len = (smoke.prefix_len(cfg_ref, prefix) + prompts.shape[1]
               + smoke.ZOO_NEW_TOKENS)
    engine = EngineRef(cfg_ref, params, max_len=max_len)
    steps = smoke.record_logits(engine)
    tokens, _ = engine.generate(prompts, smoke.ZOO_NEW_TOKENS,
                                prefix_embed=prefix)
    extra = {**smoke.fixture_cuts(cfg_ref),
             "prefix_seed": np.array(smoke.PREFIX_SEED)}
    serve = ({} if cfg_ref.family == "audio" else smoke.serve_fixture_run(
        EngineRef, RequestRef, cfg_ref, params))
    return smoke.zoo_fixture_arrays(arch, reduced, smoke.ZOO_SEED, prompts,
                                    tokens, steps, max_len, serve, extra)


def check_committed_fixture(arch: str) -> dict:
    """A committed fixture is the full-width, full-depth run ``chip_smoke``
    reads: its arch, depth, draw chunk, prefix seed, prompts and token
    shapes; outputs only (well under 1 MB).  Returns it."""
    fx = smoke.load_fixture(smoke.zoo_fixture(arch))
    assert str(fx["arch"]) == arch and not bool(fx["reduced"])
    assert int(fx["seed"]) == smoke.ZOO_SEED
    assert int(fx["draw_chunk"]) == smoke.DRAW_CHUNK
    assert int(fx["prefix_seed"]) == smoke.PREFIX_SEED
    cfg = smoke.zoo_config(fx)
    assert cfg == smoke.zoo_parity_config(get_config(arch))  # no cut
    np.testing.assert_array_equal(fx["prompts"],
                                  smoke.zoo_prompts(cfg, smoke.ZOO_SEED))
    prefix = smoke.fixture_prefix(cfg, fx)
    assert prefix.shape == (smoke.ZOO_PROMPTS[0],
                            cfg.frontend.n_prefix_tokens,
                            cfg.frontend.embed_dim)
    assert int(fx["max_len"]) == (smoke.prefix_len(cfg, prefix)
                                  + smoke.ZOO_PROMPTS[1]
                                  + smoke.ZOO_NEW_TOKENS)
    assert fx["tokens"].shape == (smoke.ZOO_PROMPTS[0],
                                  smoke.ZOO_NEW_TOKENS)
    assert (fx["top_ids"][..., 0] == fx["tokens"]).all()
    assert fx["top_logits"].shape == (*fx["tokens"].shape, smoke.ZOO_TOPK)
    assert smoke.zoo_fixture(arch).stat().st_size < 1 << 20
    return fx


def reproduce_reduced_fixture(arch: str) -> dict:
    """A reduced regeneration has the committed fixture's keys and dtypes,
    and the port reproduces it: tokens and logits, and for the VLM the
    serve run.  Returns the regenerated fixture."""
    fx = build_fixture(arch, reduced=True)
    committed = smoke.load_fixture(smoke.zoo_fixture(arch))
    assert fx.keys() == committed.keys()
    for k in fx:
        assert fx[k].dtype == committed[k].dtype, k
    cfg, params, tokens, steps = smoke.run_zoo_parity(fx, "cpu")
    assert cfg == port_config(zd.fixture_config(arch, reduced=True))
    np.testing.assert_array_equal(tokens, fx["tokens"])
    assert smoke.check_zoo_parity(fx, tokens, steps, ATOL)["near_ties"] == []
    if "serve_tokens" in fx:
        done = smoke.serve_check(Engine(cfg, params, device="cpu",
                                        max_len=smoke.SERVE_CHECK_MAX_LEN),
                                 cfg)
        served = smoke.check_zoo_serve(fx, done, atol=ATOL)
        assert served["tokens"] == sum(smoke.SERVE_CHECK_NEW_TOKENS)
    return fx


# -- the encoder-decoder ----------------------------------------------------


def test_config_matches_reference_and_is_served():
    for cfg, want in ((get_config(ARCH), get_config_ref(ARCH)),
                      (get_config(ARCH).reduced(),
                       get_config_ref(ARCH).reduced())):
        assert cfg == port_config(want)
        assert (cfg.resolved_head_dim, cfg.q_dim, cfg.kv_dim) == (
            want.resolved_head_dim, want.q_dim, want.kv_dim)
    cfg = get_config(ARCH).reduced()
    assert cfg.family == "audio" and cfg.encdec.n_encoder_layers == 2
    assert (cfg.encdec.encoder_len, cfg.frontend.n_prefix_tokens,
            cfg.frontend.embed_dim) == (16, 8, 64)
    model = get_model(cfg)
    assert None not in (model.prefill, model.decode_step, model.init_cache,
                        model.forward)


def test_init_layout_and_cache_match_reference():
    """The port's init gives the reference's tree, leaf for leaf; its
    cache has the reference's leaves, also on the meta device."""
    cfg_ref = get_config_ref(ARCH).reduced()
    cfg = port_config(cfg_ref)
    want = jax.eval_shape(lambda: get_model_ref(cfg_ref).init(
        jax.random.PRNGKey(0)))
    shapes = {tuple(k.key for k in path): leaf.shape for path, leaf in
              jax.tree_util.tree_leaves_with_path(want)}
    p = encdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v.shape)

    assert dict(flat(p)) == shapes
    cache_ref = jax.eval_shape(lambda: get_model_ref(cfg_ref).init_cache(3,
                                                                         20))
    for device in ("cpu", "meta"):
        cache = get_model(cfg).init_cache(3, 20, device)
        assert {k: tuple(v.shape) for k, v in cache.items()} == {
            k: v.shape for k, v in cache_ref.items()}
        assert cache["ck"].dtype == torch.float32


def test_encode_and_cross_attention_match_reference():
    cfg_ref, p_ref, cfg, p = reduced_pair(ARCH)
    frames = prefix_for(cfg, 2)
    mem = encdec.encode(cfg, p, torch.tensor(frames))
    mem_ref = ed_ref.encode(cfg_ref, p_ref, jnp.asarray(frames))
    zd.close(mem, mem_ref)
    lp = {k: v[1] for k, v in p["dec_layers"]["cross"].items()}
    lp_ref = jax.tree_util.tree_map(lambda a: a[1],
                                    p_ref["dec_layers"]["cross"])
    mk, mv = blocks.project_memory(cfg, lp, mem)
    mk_ref, mv_ref = blocks_ref.project_memory(cfg_ref, lp_ref, mem_ref)
    zd.close(mk, mk_ref)
    zd.close(mv, mv_ref)
    x = np.random.default_rng(1).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    mem_pos = np.tile(np.arange(mk.shape[1], dtype=np.int32), (2, 1))
    zd.close(blocks.cross_attention(cfg, lp, torch.tensor(x), mk, mv,
                                    torch.tensor(mem_pos)),
             blocks_ref.cross_attention(cfg_ref, lp_ref, jnp.asarray(x),
                                        mk_ref, mv_ref,
                                        jnp.asarray(mem_pos)))


def test_prefill_and_decode_match_reference():
    """prefill's logits and every cache leaf, then four decode steps'
    logits and caches, each to 1e-5; the cross K/V stay as prefill wrote
    them."""
    cfg_ref, p_ref, cfg, p = reduced_pair(ARCH, key=1)
    toks = zd.tokens_for(cfg, (2, 12), seed=2)
    frames = prefix_for(cfg, 2, seed=3)
    batch = {"tokens": toks[:, :8], "prefix_embed": frames}
    logits, cache = encdec.prefill(
        cfg, p, {k: torch.tensor(v) for k, v in batch.items()}, 16)
    logits_ref, cache_ref = ed_ref.prefill(
        cfg_ref, p_ref, {k: jnp.asarray(v) for k, v in batch.items()}, 16)
    zd.close(logits, logits_ref)
    close_tree(cache, cache_ref)
    ck = cache["ck"].clone()
    decode_ref = jax.jit(functools.partial(ed_ref.decode_step, cfg_ref))
    for i in range(4):
        step = {"token": toks[:, 8 + i:9 + i],
                "pos": np.full((2,), 8 + i, np.int32)}
        logits, cache = encdec.decode_step(
            cfg, p, {k: torch.tensor(v) for k, v in step.items()}, cache)
        logits_ref, cache_ref = decode_ref(
            p_ref, {k: jnp.asarray(v) for k, v in step.items()}, cache_ref)
        zd.close(logits, logits_ref)
        close_tree(cache, cache_ref)
    assert torch.equal(cache["ck"], ck)


def test_decode_equals_full_forward_in_port():
    _, _, cfg, p = reduced_pair(ARCH, key=2)
    err = smoke.decode_equivalence(cfg, p, zd.tokens_for(cfg, (2, 14)), 8,
                                   "cpu", prefix_for(cfg, 2))
    assert err <= ATOL, err


def test_engine_generate_matches_reference():
    """With the frames, token for token; the decoder's positions start at
    the prompt's length (the frames are the encoder's)."""
    cfg_ref, p_ref, cfg, p = reduced_pair(ARCH)
    prompts = zd.tokens_for(cfg, (3, 10), seed=1)
    frames = prefix_for(cfg, 3, seed=4)
    want, _ = EngineRef(cfg_ref, p_ref, max_len=24).generate(
        prompts, 6, prefix_embed=frames)
    engine = Engine(cfg, p, max_len=24, device="cpu")
    seen = []
    decode = engine._decode

    def spy(params, batch, cache):
        seen.append(int(batch["pos"][0]))
        return decode(params, batch, cache)

    engine._decode = spy
    got, _ = engine.generate(prompts, 6, prefix_embed=frames)
    np.testing.assert_array_equal(got, want)
    assert seen == list(range(10, 15))


def test_serve_is_refused_as_the_reference_fails():
    """``Engine.serve`` prefills text alone: the reference's prefill then
    fails at ``batch["prefix_embed"]``, and the port's raises naming it."""
    cfg_ref, p_ref, cfg, p = reduced_pair(ARCH)
    reqs = [(0, zd.tokens_for(cfg, (5,), seed=7), 3)]
    with pytest.raises(KeyError, match="prefix_embed"):
        EngineRef(cfg_ref, p_ref, max_len=24).serve(
            [RequestRef(uid=u, prompt=t, max_new_tokens=n)
             for u, t, n in reqs], n_slots=2)
    with pytest.raises(ValueError, match="prefix_embed"):
        Engine(cfg, p, max_len=24, device="cpu").serve(
            [Request(uid=u, prompt=t, max_new_tokens=n)
             for u, t, n in reqs], n_slots=2)


def test_loss_fn_raises_naming_zoo_step_6():
    """Zoo step 6 brought the loss that raised here: encode the frames,
    the decoder over the tokens, the token cross entropy, equal to the
    reference's (its gradients: ``tests/test_torch_zoo_train.py``).
    Without the frames it raises, as the reference's does."""
    cfg_ref, p_ref, cfg, p = reduced_pair(ARCH)
    tokens = zd.tokens_for(cfg, (2, 5), seed=3)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:],
             "prefix_embed": prefix_for(cfg, 2)}
    loss, metrics = get_model(cfg).loss_fn(
        p, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss_ref, metrics_ref = ed_ref.loss_fn(
        cfg_ref, p_ref, {k: jnp.asarray(v) for k, v in batch.items()})
    assert sorted(metrics) == sorted(metrics_ref) == ["xent"]
    assert abs(float(loss) - float(loss_ref)) <= ATOL
    with pytest.raises(ValueError, match="prefix_embed"):
        get_model(cfg).loss_fn(p, {k: torch.as_tensor(v) for k, v in
                                   batch.items() if k != "prefix_embed"})


def test_committed_fixture_is_what_chip_smoke_reads():
    fx = check_committed_fixture(ARCH)
    assert "serve_tokens" not in fx
    assert int(fx["parity_n_layers"]) == get_config(ARCH).n_layers


def test_reduced_fixture_matches_format_and_port_reproduces_it():
    reproduce_reduced_fixture(ARCH)


@pytest.mark.parametrize("arch", smoke.ENCDEC_VLM_ARCHS)
def test_numpy_params_build_the_reference_layout(arch):
    """``chip_smoke.numpy_params`` gives the tree the reference's init
    gives, leaf for leaf, at reduced size and at full width (shapes
    only): the encoder-decoder's stacks and the VLM's projector."""
    for cfg_ref in (zd.fixture_config(arch, True),
                    zd.fixture_config(arch, False)):
        want = jax.eval_shape(lambda: get_model_ref(cfg_ref).init(
            jax.random.PRNGKey(0)))
        shapes = {tuple(k.key for k in path): leaf.shape for path, leaf in
                  jax.tree_util.tree_leaves_with_path(want)}
        got = {tuple(k.split("/")): shape for k, (shape, _) in
               smoke._param_shapes(cfg_ref).items()}
        assert got == shapes
    tree = smoke.numpy_params(zd.fixture_config(arch, True), 0)
    assert tree["proj_in"].std() == pytest.approx(64**-0.5, rel=0.1)


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
