"""The port's serving engine on RWKV6 (``rwkv6-3b``) on the CPU, held to the
JAX package, and the full-width parity fixture the card is held to.

At ``rwkv6-3b.reduced()`` with params from ``chip_smoke.numpy_params``
loaded into both: ``Engine.generate`` gives the reference's greedy tokens,
and ``Engine.serve`` (slot-recycling continuous batching over the
recurrent-state cache: the WKV states and the token shifts scatter into
their slots at batch axis 1; the left pads of a prompt run through the
recurrence, as the reference's do) gives the reference's tokens and tick
stamps request by request.  The serve launcher runs ``--arch rwkv6-3b`` on
the CPU when asked.

The card has no JAX, so its parity check reads the reference's outputs from
``tests/data/torch_parity_rwkv6_3b.npz``: ``rwkv6-3b`` at full width and
depth in float32 (32 layers, d_model 2560, 40 heads of 64, vocab 65536),
params from ``chip_smoke.numpy_params`` (a numpy seed, the reference's tree
layout; the fixture holds no weights), two prompts of 32 tokens, eight
greedy tokens through the reference's ``Engine.generate``, each step's
logsumexp and top 64 (id, logit) pairs.  Rewrite it with

    PYTHONPATH=src python tests/test_torch_rwkv_serve.py

(about 16 GB of memory at its peak: the 12.4 GB float32 tree, handed to
JAX leaf by leaf).  Here a reduced-width regeneration is checked against
the committed file's format and reproduced by the port.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as get_config_ref
from repro.models import get_model as get_model_ref
from repro.serving.batching import Request as RequestRef
from repro.serving.engine import Engine as EngineRef
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ARCH = smoke.RWKV_ARCH
# the port against the reference on the CPU, both in float32
ATOL = 1e-5


def _to_jax(tree: dict) -> dict:
    """A nested dict of numpy arrays as JAX arrays, emptying ``tree`` leaf
    by leaf so that the two copies of a large tree never coexist whole."""
    out = {}
    for name in list(tree):
        leaf = tree.pop(name)
        out[name] = (_to_jax(leaf) if isinstance(leaf, dict)
                     else jnp.asarray(leaf))
        del leaf
    return out


def _reduced():
    cfg_ref = get_config_ref(ARCH).reduced()
    tree = smoke.numpy_params(cfg_ref, 0)
    return (cfg_ref, _to_jax(smoke.numpy_params(cfg_ref, 0)),
            get_config(ARCH).reduced(), params_from_numpy(tree, "cpu"))


def build_fixture(reduced: bool) -> dict:
    """The reference's parity run: ``smoke.numpy_params`` loaded into the
    reference, ``smoke.zoo_prompts`` through its ``Engine.generate``, each
    step's logits recorded; then ``smoke.serve_check_requests`` through
    its ``Engine.serve``, each token's top-2 margin recorded."""
    cfg_ref = get_config_ref(ARCH)
    cfg_ref = cfg_ref.reduced() if reduced else smoke.zoo_parity_config(
        cfg_ref)
    params = _to_jax(smoke.numpy_params(cfg_ref, smoke.ZOO_SEED))
    prompts = smoke.zoo_prompts(cfg_ref, smoke.ZOO_SEED)
    max_len = prompts.shape[1] + smoke.ZOO_NEW_TOKENS
    engine = EngineRef(cfg_ref, params, max_len=max_len)
    steps = smoke.record_logits(engine)
    tokens, _ = engine.generate(prompts, smoke.ZOO_NEW_TOKENS)
    serve = smoke.serve_fixture_run(EngineRef, RequestRef, cfg_ref, params)
    return smoke.zoo_fixture_arrays(ARCH, reduced, smoke.ZOO_SEED, prompts,
                                    tokens, steps, max_len, serve)


def _requests(cls, vocab):
    """Prompts of 4 to 10 tokens (left-padded to buckets of 4, 8 and 16),
    2 to 5 new tokens each."""
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
    assert stats.tokens_out == 18
    assert stats.prefill_s > 0 and stats.decode_s > 0


def test_serve_matches_reference_request_by_request():
    cfg_ref, p_ref, cfg, p = _reduced()
    want = EngineRef(cfg_ref, p_ref, max_len=48).serve(
        _requests(RequestRef, cfg.vocab_size), n_slots=2)
    engine = Engine(cfg, p, max_len=48, device="cpu")
    got = engine.serve(_requests(Request, cfg.vocab_size), n_slots=2)
    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(got, want):
        assert a.generated == b.generated, a.uid
        assert len(a.generated) == a.max_new_tokens
        assert (a.admitted_at, a.finished_at) == (b.admitted_at,
                                                  b.finished_at)
    # every leaf of the recurrent cache has its batch axis at 1
    assert engine._batch_axes == {"state": 1, "shift_tm": 1, "shift_cm": 1}


def test_serve_launcher_runs_on_cpu(capsys):
    args = serve_launcher.parse_args(["--arch", ARCH, "--batch", "2",
                                      "--prompt-len", "8", "--new-tokens",
                                      "4"])
    out, stats = serve_launcher.run(args, device="cpu")
    assert out.shape == (2, 4) and stats.tokens_out == 8
    assert ((out >= 0) & (out < get_config(ARCH).reduced().vocab_size)).all()
    assert "generated (2, 4) tokens" in capsys.readouterr().out


def test_numpy_params_build_the_reference_layout_at_full_width():
    """``chip_smoke.numpy_params`` gives the tree the reference's init
    gives, leaf for leaf, at full width (shapes only: 3.1 B parameters)."""
    cfg_ref = smoke.zoo_parity_config(get_config_ref(ARCH))
    want = jax.eval_shape(lambda: get_model_ref(cfg_ref).init(
        jax.random.PRNGKey(0)))
    shapes = {tuple(k.key for k in path): leaf.shape for path, leaf in
              jax.tree_util.tree_leaves_with_path(want)}
    got = {tuple(k.split("/")): shape for k, (shape, _) in
           smoke._param_shapes(cfg_ref).items()}
    assert got == shapes
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert 3.0e9 < n < 3.2e9, n


def test_fixture_is_what_chip_smoke_reads():
    fx = smoke.load_fixture(smoke.RWKV_FIXTURE)
    assert str(fx["arch"]) == ARCH and not bool(fx["reduced"])
    assert int(fx["seed"]) == smoke.ZOO_SEED
    cfg = smoke.zoo_config(fx)
    assert cfg == smoke.zoo_parity_config(get_config(ARCH))
    assert cfg.n_layers == 32 and cfg.d_model == 2560
    np.testing.assert_array_equal(fx["prompts"],
                                  smoke.zoo_prompts(cfg, smoke.ZOO_SEED))
    n = smoke.ZOO_NEW_TOKENS
    assert int(fx["max_len"]) == smoke.ZOO_PROMPTS[1] + n
    assert fx["tokens"].shape == (smoke.ZOO_PROMPTS[0], n)
    assert fx["top_ids"].shape == (smoke.ZOO_PROMPTS[0], n, smoke.ZOO_TOPK)
    assert (fx["top_ids"][..., 0] == fx["tokens"]).all()
    assert np.isfinite(fx["top_logits"]).all() and np.isfinite(fx["lse"]).all()
    assert smoke.RWKV_FIXTURE.stat().st_size < 1 << 20


def test_reduced_fixture_matches_format_and_port_reproduces_it():
    fx = build_fixture(reduced=True)
    committed = smoke.load_fixture(smoke.RWKV_FIXTURE)
    assert fx.keys() == committed.keys()
    for k in fx:
        assert fx[k].dtype == committed[k].dtype, k
        assert fx[k].shape == committed[k].shape, k
    cfg, params, tokens, steps = smoke.run_zoo_parity(fx, "cpu")
    assert cfg == get_config(ARCH).reduced()
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
    fx = smoke.load_fixture(smoke.RWKV_FIXTURE)
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


if __name__ == "__main__":
    import resource
    import time

    t0 = time.perf_counter()
    arrays = build_fixture(reduced=False)
    smoke.RWKV_FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(smoke.RWKV_FIXTURE, **arrays)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"wrote {smoke.RWKV_FIXTURE} "
          f"({smoke.RWKV_FIXTURE.stat().st_size} bytes) in "
          f"{time.perf_counter() - t0:.1f} s, peak resident {peak_gb:.1f} GB")
