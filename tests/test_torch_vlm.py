"""The zoo's VLM on the CPU, held to the JAX package, and its full-width
parity fixture.

``paligemma-3b`` (the Gemma-2B-class decoder: MQA, head_dim 256, tied
embeddings, ``geglu``; its SigLIP frontend a stub, so the model owns only
the projector ``proj_in`` of the patch embeddings) at ``reduced()``, with
the reference's params carried across by ``convert``: ``forward`` with
and without the prefix, ``prefill`` (logits and cache) and
``decode_step``, each to 1e-5, the prefix attending causally as the
reference's does; the same at head_dim 256 (``reduced()`` makes it 64),
a D = 256 MQA forward held to the reference; step-by-step decode against
one full forward in the port; ``Engine.generate`` with the prefix token
for token, decoding from the prompt's length plus the prefix's;
``Engine.serve`` of text alone tick for tick; the training loss refused,
naming zoo step 6.  The fixture is written and read as
``test_torch_encdec.py`` says, by its ``build_fixture``:

    PYTHONPATH=src python tests/test_torch_encdec.py paligemma-3b
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.models import transformer as tr_ref
from repro.serving.batching import Request as RequestRef
from repro.serving.engine import Engine as EngineRef
from repro_torch.configs import get_config
from repro_torch.models import blocks, transformer
from repro_torch.models.model import get_model
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "encdec_tests", ROOT / "tests" / "test_torch_encdec.py")
te = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(te)
zd, smoke = te.zd, te.smoke

ATOL = te.ATOL
ARCH = smoke.VLM_ARCH
# reduced() at its own head_dim (64) and at paligemma's 256
HEAD_DIMS = [0, 256]


def pair(head_dim: int = 0, key: int = 0):
    return te.reduced_pair(ARCH, key, **({"head_dim": head_dim}
                                         if head_dim else {}))


def test_config_matches_reference_and_is_served():
    for cfg, want in ((get_config(ARCH), get_config_ref(ARCH)),
                      (get_config(ARCH).reduced(),
                       get_config_ref(ARCH).reduced())):
        assert cfg == te.port_config(want)
    cfg = get_config(ARCH)
    assert cfg.family == "vlm" and cfg.tie_embeddings
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == (8, 1, 256)
    assert (cfg.frontend.n_prefix_tokens, cfg.frontend.embed_dim) == (256,
                                                                      1152)
    assert get_model(cfg.reduced()).prefill is not None


def test_init_has_the_projector_and_no_head():
    cfg = get_config(ARCH).reduced()
    p = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tuple(p["proj_in"].shape) == (64, cfg.d_model)
    assert "out_head" not in p
    tiny = get_config("tinyllama-1.1b").reduced()
    assert "proj_in" not in transformer.init_params(
        tiny, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_forward_with_and_without_prefix_matches_reference(head_dim):
    """The hidden of every position, the prefix's too, to 1e-5; a batch
    without ``prefix_embed`` runs the text alone, as the reference's."""
    cfg_ref, p_ref, cfg, p = pair(head_dim)
    assert cfg.resolved_head_dim == (head_dim or 64)
    toks = zd.tokens_for(cfg, (2, 10))
    patches = te.prefix_for(cfg, 2)
    for batch in ({"tokens": toks, "prefix_embed": patches},
                  {"tokens": toks}):
        h, aux = transformer.forward(
            cfg, p, {k: torch.tensor(v) for k, v in batch.items()})
        h_ref, _ = tr_ref.forward(cfg_ref, p_ref,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
        assert h.shape[1] == 10 + (8 if "prefix_embed" in batch else 0)
        zd.close(h, h_ref)
        assert float(aux) == 0.0


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_prefill_and_decode_with_prefix_match_reference(head_dim):
    """prefill over the prefix and the prompt, then four decode steps at
    positions after both, logits and caches to 1e-5."""
    cfg_ref, p_ref, cfg, p = pair(head_dim, key=1)
    toks = zd.tokens_for(cfg, (2, 12), seed=2)
    patches = te.prefix_for(cfg, 2, seed=3)
    batch = {"tokens": toks[:, :8], "prefix_embed": patches}
    logits, cache = transformer.prefill(
        cfg, p, {k: torch.tensor(v) for k, v in batch.items()}, 24)
    logits_ref, cache_ref = tr_ref.prefill(
        cfg_ref, p_ref, {k: jnp.asarray(v) for k, v in batch.items()}, 24)
    zd.close(logits, logits_ref)
    te.close_tree(cache, cache_ref)
    decode_ref = jax.jit(functools.partial(tr_ref.decode_step, cfg_ref))
    for i in range(4):
        step = {"token": toks[:, 8 + i:9 + i],
                "pos": np.full((2,), 16 + i, np.int32)}
        logits, cache = transformer.decode_step(
            cfg, p, {k: torch.tensor(v) for k, v in step.items()}, cache)
        logits_ref, cache_ref = decode_ref(
            p_ref, {k: jnp.asarray(v) for k, v in step.items()}, cache_ref)
        zd.close(logits, logits_ref)
        te.close_tree(cache, cache_ref)


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_decode_equals_full_forward_in_port(head_dim):
    _, _, cfg, p = pair(head_dim, key=2)
    toks = zd.tokens_for(cfg, (2, 14))
    err = smoke.decode_equivalence(cfg, p, toks, 8, "cpu",
                                   te.prefix_for(cfg, 2))
    assert err <= ATOL, err
    assert smoke.decode_equivalence(cfg, p, toks, 8, "cpu") <= ATOL


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_engine_generate_with_prefix_matches_reference(head_dim):
    """Token for token with the patches; the first decode step sits at the
    prompt's length plus the prefix's 8 positions."""
    cfg_ref, p_ref, cfg, p = pair(head_dim)
    prompts = zd.tokens_for(cfg, (3, 10), seed=1)
    patches = te.prefix_for(cfg, 3, seed=4)
    want, _ = EngineRef(cfg_ref, p_ref, max_len=32).generate(
        prompts, 6, prefix_embed=patches)
    engine = Engine(cfg, p, max_len=32, device="cpu")
    seen = []
    decode = engine._decode

    def spy(params, batch, cache):
        seen.append(batch["pos"].tolist())
        return decode(params, batch, cache)

    engine._decode = spy
    got, _ = engine.generate(prompts, 6, prefix_embed=patches)
    np.testing.assert_array_equal(got, want)
    assert [s[0] for s in seen] == list(range(18, 23))
    assert all(len(set(s)) == 1 for s in seen)
    # without the patches the positions start at the prompt's length
    want, _ = EngineRef(cfg_ref, p_ref, max_len=32).generate(prompts, 4)
    got, _ = Engine(cfg, p, max_len=32, device="cpu").generate(prompts, 4)
    np.testing.assert_array_equal(got, want)


def test_engine_serve_of_text_matches_reference():
    cfg_ref, p_ref, cfg, p = pair()
    reqs = [(i, zd.tokens_for(cfg, (4 + 3 * (i % 3),), seed=10 + i),
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


def test_tied_logits_match_reference():
    """Gemma's tied head and the embedding's sqrt(d) scale."""
    cfg_ref, p_ref, cfg, p = pair()
    toks = zd.tokens_for(cfg, (2, 5), seed=5)
    zd.close(blocks.embed_tokens(cfg, p, torch.tensor(toks)),
             tr_ref.blocks.embed_tokens(cfg_ref, p_ref, jnp.asarray(toks)))
    x = np.random.default_rng(6).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    zd.close(blocks.logits_fn(cfg, p, torch.tensor(x)),
             tr_ref.blocks.logits_fn(cfg_ref, p_ref, jnp.asarray(x)))


def test_loss_fn_raises_naming_zoo_step_6():
    """Zoo step 6 brought the loss that raised here: over the text
    positions only, after the prefix, equal to the reference's with and
    without the patches (its gradients: ``tests/test_torch_zoo_train.py``).
    """
    cfg_ref, p_ref, cfg, p = pair()
    tokens = zd.tokens_for(cfg, (2, 7), seed=4)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    for b in (batch, {**batch, "prefix_embed": te.prefix_for(cfg, 2)}):
        loss, metrics = get_model(cfg).loss_fn(
            p, {k: torch.as_tensor(v) for k, v in b.items()})
        loss_ref, metrics_ref = tr_ref.loss_fn(
            cfg_ref, p_ref, {k: jnp.asarray(v) for k, v in b.items()})
        assert sorted(metrics) == sorted(metrics_ref) == ["aux", "xent"]
        assert abs(float(loss) - float(loss_ref)) <= 1e-5


def test_committed_fixture_is_what_chip_smoke_reads():
    fx = te.check_committed_fixture(ARCH)
    live = fx["serve_tokens"] >= 0
    assert list(live.sum(1)) == list(smoke.SERVE_CHECK_NEW_TOKENS)
    assert int(fx["parity_n_layers"]) == get_config(ARCH).n_layers


def test_reduced_fixture_matches_format_and_port_reproduces_it():
    te.reproduce_reduced_fixture(ARCH)
