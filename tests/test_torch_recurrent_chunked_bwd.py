"""The Hopper backward kernels' algorithms for the two recurrent scans in
plain PyTorch, held to the JAX package on the CPU.

``rwkv6_scan.ref.wkv_bwd_chunked_ref`` is the WKV backward kernels'
algorithm (``csrc/rwkv6_backward.cu``): the boundary states and gradients
by chunk, then every chunk's gradients, every decay a running product of
w, dw division-free.  ``ssm_scan.ref.ssd_bwd_chunked_ref`` is the
selective scan's (``csrc/ssm_backward.cu``): the chunked SSD form with its
float64 segment sums, ddt and da through them.  Both run here exactly and
in the kernels' 3xTF32 rounding of the products' operands, and are held to
``jax.vjp`` of the reference's ``models/rwkv.py: wkv_stepwise`` and
``models/ssm.py: ssd_stepwise`` plus the skip (the gradient the JAX
package trains with) and to the port's stepwise ``wkv_bwd_ref`` and
``selective_scan_bwd_ref``: T ragged against the chunk and T = 1, from a
zero state and a nonzero one, with and without a final state's gradient,
decays w that are exactly 0 (the model's exp(-exp(dw)) with dw up to 5),
steps dt x 40 (exp(dt a) exactly 0), N = 16 and 24.  Inputs come from the
numpy laws of ``tests/test_torch_rwkv_train.py`` and
``tests/test_torch_zamba2_train.py``.

Tolerance: each gradient within ``TOL`` = 1e-5 of its largest |value|,
the stepwise refs' own tolerance against ``jax.vjp``
(``test_torch_rwkv_train.SCAN_RTOL``): both sides float32, the sums in
another order (by chunk, and over a chunk in the products) through up to
77 steps; 3xTF32 drops only the a_lo b_lo term of each product (~2^-22 of
it), and the readings stay below 2e-6.  The CUDA kernels run only on a
card, where ``chip_smoke.py`` holds them to the stepwise refs at 1e-4.
"""
import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.models import rwkv as rwkv_jax
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan import ref as ssm_ref

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tests" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


rwkv_train = _load("test_torch_rwkv_train")
zamba2_train = _load("test_torch_zamba2_train")
TOL = rwkv_train.SCAN_RTOL
WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "dstate0")
SSD_GRADS = zamba2_train.GRADS
ROUNDINGS = [None, "tf32x3"]
STATES = [(True, True), (False, False), (True, False), (False, True)]
# label -> the case's _scan_inputs arguments and the ref's chunk
WKV_CASES = {"ragged T=37 N=16": (dict(T=37, N=16, seed=11), 16),
             "T=1": (dict(T=1, N=16, seed=12), 16),
             "w = 0, T=40": (dict(T=40, N=16, seed=13, zero_decays=True),
                             16),
             "N=24 T=17": (dict(T=17, N=24, seed=14), 16),
             "chunk 8": (dict(T=21, N=16, seed=15), 8)}
SSD_CASES = {"ragged T=77 N=16": (dict(T=77, P=8, N=16, seed=21), 64),
             "T=1": (dict(T=1, P=8, N=16, seed=22), 64),
             "dt x 40": (dict(T=50, P=8, N=16, seed=23, dt_scale=40.0), 64),
             "N=24 T=33": (dict(T=33, P=6, N=24, seed=24), 64),
             "chunk 16": (dict(T=37, P=8, N=16, seed=25), 16)}


def _check(got, want, names):
    for name, g, w in zip(names, got, want):
        rwkv_train.close_leaf(g, w, TOL, name)


@functools.lru_cache(maxsize=None)
def _wkv(label, state, dstate):
    """(the case's arrays, jax.vjp of wkv_stepwise, the stepwise ref)."""
    kw, _ = WKV_CASES[label]
    r, k, v, w, u, s0, dy, ds = rwkv_train._scan_inputs(**kw)
    s0 = s0 if state else np.zeros_like(s0)
    ds = ds if dstate else None
    want = rwkv_train._reference_vjp(rwkv_jax.wkv_stepwise,
                                     (r, k, v, w, u, s0), dy, ds)
    arrays = (*(torch.tensor(a) for a in (r, k, v, w, u)),
              torch.tensor(s0) if state else None, torch.tensor(dy),
              None if ds is None else torch.tensor(ds))
    return arrays, want, wkv_ref.wkv_bwd_ref(*arrays)


@functools.lru_cache(maxsize=None)
def _ssd(label, state, dstate):
    """(the case's arrays, jax.vjp of ssd_stepwise plus the skip, the
    stepwise ref)."""
    kw, _ = SSD_CASES[label]
    x, b, c, dt, a, d, s0, dy, ds = zamba2_train._scan_inputs(
        B=2, H=3, **kw)
    s0 = s0 if state else np.zeros_like(s0)
    ds = ds if dstate else None
    want = zamba2_train._reference_vjp(zamba2_train._stepwise,
                                       (x, b, c, dt, a, d, s0), dy, ds)
    arrays = (*(torch.tensor(t) for t in (x, b, c, dt, a, d)),
              torch.tensor(s0) if state else None, torch.tensor(dy),
              None if ds is None else torch.tensor(ds))
    return arrays, want, ssm_ref.selective_scan_bwd_ref(*arrays)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("state, dstate", STATES)
def test_wkv_bwd_chunked_matches_reference_vjp(state, dstate, rounding):
    arrays, want, stepwise = _wkv("ragged T=37 N=16", state, dstate)
    got = wkv_ref.wkv_bwd_chunked_ref(*arrays, operand_rounding=rounding)
    assert all(g.dtype == torch.float32 for g in got)
    _check(got, want, WKV_GRADS)
    _check(got, stepwise, WKV_GRADS)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("label", [k for k in WKV_CASES if k[0] != "r"])
def test_wkv_bwd_chunked_edge_cases(label, rounding):
    arrays, want, stepwise = _wkv(label, True, True)
    got = wkv_ref.wkv_bwd_chunked_ref(*arrays, chunk=WKV_CASES[label][1],
                                      operand_rounding=rounding)
    _check(got, want, WKV_GRADS)
    _check(got, stepwise, WKV_GRADS)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("state, dstate", STATES)
def test_ssd_bwd_chunked_matches_reference_vjp(state, dstate, rounding):
    arrays, want, stepwise = _ssd("ragged T=77 N=16", state, dstate)
    got = ssm_ref.ssd_bwd_chunked_ref(*arrays, operand_rounding=rounding)
    assert all(g.dtype == torch.float32 for g in got)
    _check(got, want, SSD_GRADS)
    _check(got, stepwise, SSD_GRADS)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("label", [k for k in SSD_CASES if k[0] != "r"])
def test_ssd_bwd_chunked_edge_cases(label, rounding):
    arrays, want, stepwise = _ssd(label, True, True)
    got = ssm_ref.ssd_bwd_chunked_ref(*arrays, chunk=SSD_CASES[label][1],
                                      operand_rounding=rounding)
    _check(got, want, SSD_GRADS)
    _check(got, stepwise, SSD_GRADS)
    if label == "dt x 40":  # the steps' decays do round to 0
        x, b, c, dt, a = arrays[:5]
        assert (torch.exp(dt * a) == 0).any()


def test_log_space_dw_divided_by_w_misses_where_w_is_zero():
    """Why the kernel takes dw division-free.  The usual chunked backward
    gets the gradient of log w from cumulative sums, dlog w_t = Phi_t -
    k_t (G_t v_t) with Phi_t = rowsum(G_t S_t) = Phi_T - sum_{q>t} (k_q dk_q
    - r_q dr_q), and divides by w.  That agrees with the stepwise dw where
    w is not small, and is 0/0 where w is exactly 0, where the stepwise dw
    is finite and not 0; the chunked ref's dw matches the stepwise one
    there too."""
    arrays, _, stepwise = _wkv("w = 0, T=40", True, True)
    r, k, v, w, u, s0, dy, ds = arrays
    dr, dk, _, dw, _, _ = stepwise
    _, s_T = wkv_ref.wkv_ref(r, k, v, w, u, s0)
    phi = (ds * s_T).sum(-1)  # (B,H,N): rowsum(G_T S_T)
    vdy = (v * dy).sum(-1, keepdim=True)
    dlog = torch.empty_like(w)
    for t in reversed(range(w.shape[1])):
        gv = dk[:, t] - u * r[:, t] * vdy[:, t]  # G_t v_t
        dlog[:, t] = phi - k[:, t] * gv
        phi = phi - (k[:, t] * dk[:, t] - r[:, t] * dr[:, t])
    zero, large = w == 0, w > 0.1
    assert zero.any() and large.any()
    dw_log = dlog / w
    scale = float(dw.abs().max())
    assert float((dw_log[large] - dw[large]).abs().max()) <= TOL * scale
    assert torch.isfinite(dw[zero]).all() and (dw[zero] != 0).any()
    assert not torch.isfinite(dw_log[zero]).all()
    chunked = wkv_ref.wkv_bwd_chunked_ref(*arrays, operand_rounding="tf32x3")
    assert float((chunked[3][zero] - dw[zero]).abs().max()) <= TOL * scale


def test_chunked_refs_refuse_what_they_do_not_take():
    arrays, _, _ = _wkv("T=1", True, True)
    with pytest.raises(ValueError, match="chunk"):
        wkv_ref.wkv_bwd_chunked_ref(*arrays, chunk=0)
    with pytest.raises(ValueError, match="operand_rounding"):
        wkv_ref.wkv_bwd_chunked_ref(*arrays, operand_rounding="bf16")
    arrays, _, _ = _ssd("T=1", True, True)
    with pytest.raises(ValueError, match="chunk"):
        ssm_ref.ssd_bwd_chunked_ref(*arrays, chunk=0)
    with pytest.raises(ValueError, match="operand_rounding"):
        ssm_ref.ssd_bwd_chunked_ref(*arrays, operand_rounding="bf16")


@pytest.mark.parametrize("kernel, prefix", [(wkv_kernel, "rwkv6"),
                                            (ssm_kernel, "ssm")])
def test_backward_sources_hold_the_chunked_kernels(kernel, prefix):
    """What the card builds: each backward's two kernels by the names the
    wrapper counts, their products on the tensor cores in 3xTF32, no
    atomics, no fast math, and no source of the one-kernel design left."""
    src = kernel.BWD_SOURCE.read_text()
    assert list(kernel.BWD_KERNELS) == ["bounds", "chunk"]
    for name in kernel.BWD_KERNELS:
        assert f"{prefix}_bwd_{name}_kernel(" in src
    assert f"{prefix}_bwd_kernel" not in src
    assert "mma_3xtf32" in src
    assert re.search(r"\batomic[A-Z]\w*\s*\(|\batom\.", src) is None
    assert not any("fast_math" in flag for flag in _build.NVCC_FLAGS)
    assert not hasattr(kernel, "BWD_CHUNK")
    assert kernel.LIBRARIES[f"{prefix}_backward"] == [kernel.BWD_SOURCE]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("name", ["wkv", "ssd"])
def test_kernels_bounds_split_the_calls_bound(name, state):
    """``chip_smoke``'s bound of each backward kernel is its share of the
    call's (the function's own bytes and operations, no boundary-state
    scratch): the two add up to the call's bound on the call's limiting
    side, and neither exceeds the kernel's own floor with the scratch it
    writes or reads."""
    smoke = rwkv_train.smoke
    bound, shapes = {
        "wkv": (smoke._wkv_bwd_bound,
                [smoke.WKV_TRAIN_SHAPE, *(s for s, _, _ in
                                          smoke.WKV_BWD_CASES.values())]),
        "ssd": (smoke._ssm_bwd_bound,
                [smoke.SSM_TRAIN_SHAPE, *(s for s, _, _ in
                                          smoke.SSM_BWD_CASES.values())])}[
        name]
    for shape in shapes:
        call_ms, call_by = bound(*shape, state, state)
        parts = [bound(*shape, state, state, part=k)
                 for k in ("bounds", "chunk")]
        assert all(by == call_by and ms > 0 for ms, by in parts), shape
        assert sum(ms for ms, _ in parts) == pytest.approx(call_ms,
                                                           rel=1e-12)
        for k, (ms, _) in zip(("bounds", "chunk"), parts):
            assert ms <= bound(*shape, state, state,
                               part=f"design:{k}")[0] * (1 + 1e-12), shape
