"""The zoo's MoE pair on the CPU, held to the JAX package, and their
full-width parity fixtures.

``grok-1-314b`` (8 experts top-2, gated GELU, logit soft-capping) and
``kimi-k2-1t-a32b`` (a dense first layer, then routed experts top-8 and a
shared expert, head_dim 112) at ``reduced()``, and kimi at reduced width
with 72 experts (above 64, so serving keeps the capacity and drops
slots), with the reference's params carried across by ``convert``:
``forward`` (hidden and the summed aux loss), ``prefill`` and
``decode_step`` with the reference's layer offsets into the one KV cache,
each to 1e-5; the init's two stacks; step-by-step decode against one full
forward in the port; ``Engine.generate`` and ``Engine.serve`` token for
token and tick for tick; the routing and kept slots of every dispatch
against the reference's.  The fixtures are written and read as
``test_torch_zoo_dense.py`` says, by its ``build_fixture``:

    PYTHONPATH=src python tests/test_torch_zoo_moe.py <arch>
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as get_model_ref
from repro.models import moe as moe_ref
from repro.models import transformer as tr_ref
from repro.serving.batching import Request as RequestRef
from repro.serving.engine import Engine as EngineRef
from repro_torch.models import moe, transformer
from repro_torch.models.model import get_model
from repro_torch.serving.batching import Request
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "zoo_dense", ROOT / "tests" / "test_torch_zoo_dense.py")
zd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(zd)
smoke = zd.smoke

ATOL = zd.ATOL
# (arch, experts): the two configs at reduced(), and kimi with 72 experts
CASES = [("grok-1-314b", 0), ("kimi-k2-1t-a32b", 0), ("kimi-k2-1t-a32b", 72)]
IDS = ["grok", "kimi", "kimi72"]


@pytest.mark.parametrize("arch,experts", CASES, ids=IDS)
def test_forward_prefill_decode_match_reference(arch, experts):
    cfg_ref, p_ref, cfg, p = zd.reduced_pair(arch, experts)
    toks = zd.tokens_for(cfg, (2, 12))
    h, aux = transformer.forward(cfg, p, {"tokens": torch.tensor(toks)})
    h_ref, aux_ref = tr_ref.forward(cfg_ref, p_ref,
                                    {"tokens": jnp.asarray(toks)})
    zd.close(h, h_ref)
    zd.close(aux, aux_ref)
    assert float(aux) > 0
    logits, cache = transformer.prefill(
        cfg, p, {"tokens": torch.tensor(toks[:, :8])}, 16)
    logits_ref, cache_ref = tr_ref.prefill(
        cfg_ref, p_ref, {"tokens": jnp.asarray(toks[:, :8])}, 16)
    zd.close(logits, logits_ref)
    for name in ("k", "v"):  # every layer's rows at its offset
        zd.close(cache[name], cache_ref[name])
    decode_ref = jax.jit(functools.partial(tr_ref.decode_step, cfg_ref))
    for i in range(4):
        batch = {"token": toks[:, 8 + i:9 + i],
                 "pos": np.full((2,), 8 + i, np.int32)}
        logits, cache = transformer.decode_step(
            cfg, p, {k: torch.tensor(v) for k, v in batch.items()}, cache)
        logits_ref, cache_ref = decode_ref(
            p_ref, {k: jnp.asarray(v) for k, v in batch.items()},
            cache_ref)
        zd.close(logits, logits_ref)
        for name in ("k", "v"):
            zd.close(cache[name], cache_ref[name])


@pytest.mark.parametrize("arch,experts", CASES, ids=IDS)
def test_init_layout_matches_reference(arch, experts):
    """Two stacks as the reference's: ``layers`` for the first dense
    layers (kimi's one), ``moe_layers`` for the rest."""
    cfg_ref, _, cfg, _ = zd.reduced_pair(arch, experts)
    want = jax.eval_shape(lambda: get_model_ref(cfg_ref).init(
        jax.random.PRNGKey(0)))
    got = get_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    flat_want = {jax.tree_util.keystr(k): v.shape for k, v in
                 jax.tree_util.tree_leaves_with_path(want)}
    flat_got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_leaves_with_path(got)}
    assert flat_got == flat_want
    assert ("layers" in got) == (arch.startswith("kimi"))
    assert got["moe_layers"]["we_in"].shape[1] == cfg.moe.n_experts


@pytest.mark.parametrize("arch,experts", CASES, ids=IDS)
def test_decode_equals_full_forward_in_port(arch, experts):
    """With the forward's capacity raised to the worst case, as the
    reference's tests/test_decode_equivalence.py does."""
    _, _, cfg, p = zd.reduced_pair(arch, experts, key=1)
    err = smoke.decode_equivalence(smoke.decode_equivalence_config(cfg), p,
                                   zd.tokens_for(cfg, (2, 14)), 8, "cpu")
    assert err <= ATOL, err


@pytest.mark.parametrize("arch,experts", CASES, ids=IDS)
def test_engine_generate_and_serve_match_reference(arch, experts):
    """Left-padded prompts are routed and take capacity on both sides."""
    cfg_ref, p_ref, cfg, p = zd.reduced_pair(arch, experts)
    prompts = zd.tokens_for(cfg, (3, 10), seed=1)
    want, _ = EngineRef(cfg_ref, p_ref, max_len=24).generate(prompts, 6)
    got, _ = Engine(cfg, p, max_len=24, device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    reqs = [(i, zd.tokens_for(cfg, (4 + 3 * (i % 3),), seed=10 + i),
             2 + i % 4) for i in range(5)]
    done_ref = EngineRef(cfg_ref, p_ref, max_len=48).serve(
        [RequestRef(uid=u, prompt=t, max_new_tokens=n) for u, t, n in reqs],
        n_slots=2)
    done = Engine(cfg, p, max_len=48, device="cpu").serve(
        [Request(uid=u, prompt=t, max_new_tokens=n) for u, t, n in reqs],
        n_slots=2)
    for a, b in zip(done, done_ref):
        assert a.uid == b.uid and a.generated == b.generated, a.uid
        assert (a.admitted_at, a.finished_at) == (b.admitted_at,
                                                  b.finished_at)


def test_routing_records_match_reference():
    """Every dispatch of a generate, recorded on both sides
    (``recording_reference_routes``, ``smoke.recording_routes``): the
    same top-k ids and kept slots; the reference's kept slots by
    ``smoke.capacity_keep`` are those with which ``moe_onehot``'s output
    is reproduced; at 72 experts the capacity drops slots."""
    cfg_ref, p_ref, cfg, p = zd.reduced_pair("kimi-k2-1t-a32b", 72)
    prompts = zd.tokens_for(cfg, (2, 32), seed=2)
    with zd.recording_reference_routes() as want:
        EngineRef(cfg_ref, p_ref, max_len=40).generate(prompts, 4)
    with smoke.recording_routes() as got:
        Engine(cfg, p, max_len=40, device="cpu").generate(prompts, 4)
    assert len(got) == len(want) == 4  # one MoE layer: prefill + 3 steps
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["idx"], b["idx"])
        np.testing.assert_array_equal(a["keep"], b["keep"])
        np.testing.assert_allclose(a["margin"], b["margin"], atol=1e-6)
    assert not want[0]["keep"].all()  # the prefill dropped slots
    assert all(r["keep"].all() for r in want[1:])  # a decode step none
    # capacity_keep's slots give moe_onehot's output through the port's
    # dispatch of exactly those slots
    lp = {k: v[0] for k, v in p["moe_layers"].items()}
    lp_ref = jax.tree_util.tree_map(lambda a: a[0], p_ref["moe_layers"])
    x = np.random.default_rng(3).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    out_ref, _ = moe_ref.moe_onehot(cfg_ref, lp_ref, jnp.asarray(x))
    _, _, idx = moe_ref._route(cfg_ref, lp_ref["router"], jnp.asarray(x))
    _, _, cap = moe.group_and_capacity(cfg, 32)
    keep = smoke.capacity_keep(np.asarray(idx), 72, cap)
    np.testing.assert_array_equal(
        moe.kept_slots(torch.tensor(np.asarray(idx)), 72, cap).numpy(), keep)
    out, _ = moe.dispatch(cfg, lp, torch.tensor(x))
    zd.close(out, out_ref)


def test_route_check_catches_a_differing_route():
    """``check_zoo_routes`` passes the port's own records, ends a row at a
    flip below the routing tolerance, and fails one above it or a changed
    kept slot."""
    fx = zd.build_fixture("kimi-k2-1t-a32b", reduced=True)
    with smoke.recording_routes() as routes:
        _, _, tokens, _ = smoke.run_zoo_parity(fx, "cpu")
    assert smoke.check_zoo_routes(fx, tokens, routes)["stops"] == {}
    flipped = [dict(r) for r in routes]
    flipped[2] = {**routes[2], "idx": routes[2]["idx"].copy()}
    flipped[2]["idx"][1, 0, :2] = flipped[2]["idx"][1, 0, 1::-1]
    near = dict(fx, route_decode_margin=fx["route_decode_margin"].copy())
    near["route_decode_margin"][1, :, 1] = 1e-7
    got = smoke.check_zoo_routes(near, tokens, flipped)
    assert got["stops"] == {1: 2} and got["route_near_ties"][0][:2] == (1, 2)
    with pytest.raises(AssertionError, match="routing margin"):
        smoke.check_zoo_routes(fx, tokens, flipped)
    dropped = [dict(r) for r in routes]
    dropped[0] = {**routes[0], "keep": ~routes[0]["keep"]}
    with pytest.raises(AssertionError, match="kept other slots"):
        smoke.check_zoo_routes(fx, tokens, dropped)


@pytest.mark.parametrize("arch", smoke.MOE_ARCHS)
def test_committed_fixture_is_what_chip_smoke_reads(arch):
    """The MoE fixtures also carry each dispatch's routing: the prefill's
    (MoE layers, 2, 32, k) and the seven decode steps'; kimi's prefill
    drops slots at 72 experts, grok's serving none."""
    fx = zd.check_committed_fixture(arch)
    cfg = smoke.zoo_config(fx)
    n_moe = cfg.n_layers - min(cfg.moe.first_dense_layers, cfg.n_layers)
    B, S = smoke.ZOO_PROMPTS
    k = cfg.moe.top_k
    assert fx["route_prefill_idx"].shape == (n_moe, B, S, k)
    assert fx["route_decode_idx"].shape == (smoke.ZOO_NEW_TOKENS - 1, n_moe,
                                            B, k)
    assert (fx["route_prefill_idx"] < cfg.moe.n_experts).all()
    assert (fx["route_prefill_margin"] >= 0).all()
    dropped = int((~fx["route_prefill_keep"]).sum())
    assert (dropped > 0) == (cfg.moe.n_experts > 64)
    assert fx["route_decode_keep"].all()


def test_reduced_fixture_matches_format_and_port_reproduces_it():
    fx = zd.reproduce_reduced_fixture("kimi-k2-1t-a32b")
    assert not fx["route_prefill_keep"].all()


if __name__ == "__main__":
    import resource
    import sys
    import time

    arch = sys.argv[1]
    t0 = time.perf_counter()
    arrays = zd.build_fixture(arch, reduced=False)
    path = smoke.zoo_fixture(arch)
    np.savez_compressed(path, **arrays)
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.perf_counter() - t0:.1f} s, peak resident {peak_gb:.1f} GB")
