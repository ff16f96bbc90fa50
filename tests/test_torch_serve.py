"""The port's serving engine on the CPU, held to the JAX package, and the
full-width parity fixture the card is held to.

At ``tinyllama-1.1b.reduced()`` with the reference's params carried across:
``Engine.generate`` gives the reference's greedy tokens, and
``Engine.serve`` (slot-recycling continuous batching, left-padded pow2
prompt buckets) gives the reference's tokens and tick stamps request by
request, on ``tests/test_serving.py``'s request mix.  The serve launcher
runs on the CPU when asked.

The card has no JAX, so its parity check reads the reference's outputs from
``tests/data/torch_parity_tinyllama.npz``: ``tinyllama-1.1b`` at full width
and depth in float32, params from ``chip_smoke.numpy_params`` (a numpy
seed, the reference's tree layout; the fixture holds no weights), two
prompts of 32 tokens, eight greedy tokens through the reference's
``Engine.generate``, each step's logsumexp and top 64 (id, logit) pairs.
Rewrite it with

    PYTHONPATH=src python tests/test_torch_serve.py

(about 10 GB of memory at its peak and under a minute on the CPU).  Here
a reduced-width regeneration is checked against the committed file's
format and reproduced by the port.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.models import get_model as get_model_ref
from repro.serving.batching import Request as RequestRef
from repro.serving.engine import Engine as EngineRef
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import (
    Engine,
    greedy_sample,
    temperature_sample,
)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# the port against the reference on the CPU, both in float32
ATOL = 1e-5


def _reduced():
    cfg_ref = get_config_ref("tinyllama-1.1b").reduced()
    p_ref = get_model_ref(cfg_ref).init(jax.random.PRNGKey(0))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, p_ref), "cpu")
    return cfg_ref, p_ref, get_config("tinyllama-1.1b").reduced(), p


def build_fixture(reduced: bool) -> dict:
    """The reference's parity run: ``smoke.numpy_params`` loaded into the
    reference, ``smoke.zoo_prompts`` through its ``Engine.generate``, each
    step's logits recorded; then ``smoke.serve_check_requests`` through
    its ``Engine.serve``, each token's top-2 margin recorded."""
    cfg_ref = get_config_ref(smoke.ZOO_ARCH)
    cfg_ref = cfg_ref.reduced() if reduced else smoke.zoo_parity_config(
        cfg_ref)
    tree = smoke.numpy_params(cfg_ref, smoke.ZOO_SEED)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    del tree
    prompts = smoke.zoo_prompts(cfg_ref, smoke.ZOO_SEED)
    max_len = prompts.shape[1] + smoke.ZOO_NEW_TOKENS
    engine = EngineRef(cfg_ref, params, max_len=max_len)
    steps = smoke.record_logits(engine)
    tokens, _ = engine.generate(prompts, smoke.ZOO_NEW_TOKENS)
    serve = smoke.serve_fixture_run(EngineRef, RequestRef, cfg_ref, params)
    return smoke.zoo_fixture_arrays(smoke.ZOO_ARCH, reduced, smoke.ZOO_SEED,
                                    prompts, tokens, steps, max_len, serve)


def _requests(cls, vocab):
    """tests/test_serving.py::test_engine_serve_continuous_batching's mix."""
    rng = np.random.default_rng(0)
    return [cls(uid=i,
                prompt=rng.integers(1, vocab, (4 + 3 * (i % 3),),
                                    dtype=np.int32),
                max_new_tokens=2 + (i % 4))
            for i in range(5)]


def test_generate_matches_reference():
    cfg_ref, p_ref, cfg, p = _reduced()
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (3, 10),
                                                dtype=np.int32)
    want, _ = EngineRef(cfg_ref, p_ref, max_len=24).generate(prompts, 6)
    got, stats = Engine(cfg, p, max_len=24, device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert stats.tokens_out == 18
    assert stats.prefill_s > 0 and stats.decode_s > 0


def test_serve_matches_reference_request_by_request():
    cfg_ref, p_ref, cfg, p = _reduced()
    want = EngineRef(cfg_ref, p_ref, max_len=48).serve(
        _requests(RequestRef, cfg.vocab_size), n_slots=2)
    got = Engine(cfg, p, max_len=48, device="cpu").serve(
        _requests(Request, cfg.vocab_size), n_slots=2)
    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(got, want):
        assert a.generated == b.generated, a.uid
        assert len(a.generated) == a.max_new_tokens
        assert (a.admitted_at, a.finished_at) == (b.admitted_at,
                                                  b.finished_at)


def test_samplers():
    logits = torch.tensor([[0.0, 3.0, 1.0], [5.0, -1.0, 4.9]])
    assert greedy_sample(logits).tolist() == [1, 0]
    assert greedy_sample(logits).dtype == torch.int32
    draws = [temperature_sample(logits, torch.Generator().manual_seed(s),
                                temp=1e-3).tolist() for s in range(3)]
    assert draws == [[1, 0]] * 3  # a cold temperature is greedy
    hot = temperature_sample(logits, torch.Generator().manual_seed(0), 5.0)
    assert hot.shape == (2,) and hot.dtype == torch.int32


def test_serve_launcher_runs_on_cpu(capsys):
    args = serve_launcher.parse_args(["--arch", "tinyllama-1.1b", "--batch",
                                      "2", "--prompt-len", "8",
                                      "--new-tokens", "4"])
    out, stats = serve_launcher.run(args, device="cpu")
    assert out.shape == (2, 4) and stats.tokens_out == 8
    assert "generated (2, 4) tokens" in capsys.readouterr().out


def test_numpy_params_build_the_reference_layout():
    """``chip_smoke.numpy_params`` gives the tree the reference's init
    gives, leaf for leaf, at reduced size and at full width (shapes
    only), and the same seed gives the same draws."""
    for cfg_ref in (get_config_ref(smoke.ZOO_ARCH).reduced(),
                    smoke.zoo_parity_config(get_config_ref(smoke.ZOO_ARCH))):
        want = jax.eval_shape(lambda: get_model_ref(cfg_ref).init(
            jax.random.PRNGKey(0)))
        shapes = {tuple(k.key for k in path): leaf.shape for path, leaf in
                  jax.tree_util.tree_leaves_with_path(want)}
        got = {tuple(k.split("/")): shape for k, (shape, _) in
               smoke._param_shapes(cfg_ref).items()}
        assert got == shapes
    cfg_ref = get_config_ref(smoke.ZOO_ARCH).reduced()
    tree = smoke.numpy_params(cfg_ref, 0)
    again = smoke.numpy_params(cfg_ref, 0)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(again)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(tree["layers"]["wq"],
                              smoke.numpy_params(cfg_ref, 1)["layers"]["wq"])


def test_fixture_is_what_chip_smoke_reads():
    fx = smoke.load_fixture(smoke.ZOO_FIXTURE)
    assert str(fx["arch"]) == smoke.ZOO_ARCH and not bool(fx["reduced"])
    assert int(fx["seed"]) == smoke.ZOO_SEED
    cfg = smoke.zoo_config(fx)
    assert cfg == smoke.zoo_parity_config(get_config(smoke.ZOO_ARCH))
    assert cfg.n_layers == 22 and cfg.d_model == 2048
    np.testing.assert_array_equal(fx["prompts"],
                                  smoke.zoo_prompts(cfg, smoke.ZOO_SEED))
    n = smoke.ZOO_NEW_TOKENS
    assert int(fx["max_len"]) == smoke.ZOO_PROMPTS[1] + n
    assert fx["tokens"].shape == (smoke.ZOO_PROMPTS[0], n)
    assert fx["top_ids"].shape == (smoke.ZOO_PROMPTS[0], n, smoke.ZOO_TOPK)
    assert (fx["top_ids"][..., 0] == fx["tokens"]).all()
    assert smoke.ZOO_FIXTURE.stat().st_size < 1 << 20


def test_reduced_fixture_matches_format_and_port_reproduces_it():
    fx = build_fixture(reduced=True)
    committed = smoke.load_fixture(smoke.ZOO_FIXTURE)
    assert fx.keys() == committed.keys()
    for k in fx:
        assert fx[k].dtype == committed[k].dtype, k
        assert fx[k].shape == committed[k].shape, k
    cfg, params, tokens, steps = smoke.run_zoo_parity(fx, "cpu")
    assert cfg == get_config(smoke.ZOO_ARCH).reduced()
    np.testing.assert_array_equal(tokens, fx["tokens"])
    got = smoke.check_zoo_parity(fx, tokens, steps, atol=ATOL)
    assert got["near_ties"] == []
    # a changed logit beyond the tolerance is caught
    bad = [s.copy() for s in steps]
    bad[3][1, fx["top_ids"][1, 3, 5]] += 10 * ATOL
    with pytest.raises(AssertionError, match="logits off"):
        smoke.check_zoo_parity(fx, tokens, bad, atol=ATOL)
    # the serve run: the port's Engine.serve on the same requests
    done = smoke.serve_check(
        Engine(cfg, params, max_len=smoke.SERVE_CHECK_MAX_LEN, device="cpu"),
        cfg)
    served = smoke.check_zoo_serve(fx, done, atol=ATOL)
    assert served["near_ties"] == []
    assert served["tokens"] == sum(smoke.SERVE_CHECK_NEW_TOKENS)
    # a token changed where the reference's margin is wide is caught
    first = next(r for r in done if r.uid == 0)
    first.generated[2] = (first.generated[2] + 1) % cfg.vocab_size
    with pytest.raises(AssertionError, match="top-2 margin"):
        smoke.check_zoo_serve(fx, done, atol=ATOL)


def test_fixture_carries_the_serve_run():
    """The committed fixture holds the reference's full-width float32
    ``Engine.serve`` of ``smoke.serve_check``'s requests: four requests on
    two slots, each slot freed and refilled once, prefill buckets of 32 and
    64, every token with its reference margin."""
    fx = smoke.load_fixture(smoke.ZOO_FIXTURE)
    cfg = smoke.zoo_config(fx)
    n = len(smoke.SERVE_CHECK_PROMPT_LENS)
    width = max(smoke.SERVE_CHECK_NEW_TOKENS)
    assert fx["serve_tokens"].shape == fx["serve_margin"].shape == (n, width)
    assert fx["serve_admitted_at"].shape == fx["serve_finished_at"].shape == (
        n,)
    live = fx["serve_tokens"] >= 0
    assert list(live.sum(1)) == list(smoke.SERVE_CHECK_NEW_TOKENS)
    assert (fx["serve_tokens"][live] < cfg.vocab_size).all()
    margin = fx["serve_margin"]
    assert (margin[live] >= 0).all() and np.isnan(margin[~live]).all()
    assert list(fx["serve_admitted_at"]) == [0, 0, 7, 11]
    assert list(fx["serve_finished_at"]) == [6, 10, 21, 19]


def test_serve_phase_requests():
    cfg = get_config(smoke.ZOO_ARCH)
    reqs = smoke.zoo_requests(cfg)
    assert [len(r.prompt) for r in reqs] == list(smoke.SERVE_PROMPT_LENS)
    assert min(smoke.SERVE_PROMPT_LENS) == 17
    assert max(smoke.SERVE_PROMPT_LENS) == 300
    assert {r.max_new_tokens for r in reqs} <= set(range(8, 33))
    # the longest prompt's pow2 bucket and its new tokens fit the cache
    bucket = 1 << (max(smoke.SERVE_PROMPT_LENS) - 1).bit_length()
    assert bucket + max(smoke.SERVE_NEW_TOKENS) <= smoke.SERVE_MAX_LEN


if __name__ == "__main__":
    import resource
    import time

    t0 = time.perf_counter()
    arrays = build_fixture(reduced=False)
    smoke.ZOO_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(smoke.ZOO_FIXTURE, **arrays)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"wrote {smoke.ZOO_FIXTURE} "
          f"({smoke.ZOO_FIXTURE.stat().st_size} bytes) in "
          f"{time.perf_counter() - t0:.1f} s, peak resident {peak_gb:.1f} GB")
