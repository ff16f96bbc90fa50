"""The Mamba2 selective scan on the card: the wrapper around ``csrc/``.

``ssm_scan`` replaces the Pallas TPU kernel of
``src/repro/kernels/ssm_scan/kernel.py``: the selective-state recurrence
of every (batch, head), in the model's layout (x (B,T,H,P), one group's b
and c (B,T,N) read by every head, dt (B,T,H), a and d (H,)), float32 in
and out, from a given state (zero when none is given) to the final state.
With a zero state it computes the Pallas kernel's function; with any other
it computes the reference's oracle ``ssm_scan_ref(..., state0)``.  What
bounds it: the bytes of x, y, b, c, dt and the state (see the sources for
each design and its distance from the bound).

One library holds two kernels, and every call launches exactly one of
them, by ``kernel_for``:

- ``decode_rows`` (``csrc/ssm_decode.cu``), T <= ``DECODE_MAX_T``: every
  decode step.  The recurrence step by step, each state row split over
  ``ref.decode_lanes(N)`` lanes with 16-byte accesses
  (``ref.ssm_decode_rows_ref`` is its order of summation);
- ``chunked`` (``csrc/ssm_chunked.cu``), longer T: every prefill.  Mamba2's
  chunked SSD form in chunks of ``CHUNK`` steps, its products on the
  tensor cores in 3xTF32 (``ref.ssd_chunked_ref(..., chunk=CHUNK,
  operand_rounding="tf32x3")`` is its algorithm).

The wrapper checks its inputs, allocates y (and the state, unless given
``out``) with ``torch.empty``, launches on the current CUDA stream, raises
when the launch fails, and counts its successful launches in a plain
integer ``.launches`` and by kernel in ``.launches_by_kernel``; at T = 0
it launches nothing and counts nothing.  The library builds with ``nvcc``
at the first launch (``kernels/_build``, which also hashes the
``*.cuh`` headers beside the sources and the common ``kernels/csrc/
tf32_mma.cuh``); ``LIBRARIES`` names it for a caller that builds every
library up front.

``ssm_scan_backward`` is the recurrence's gradient, a library of its own
(``csrc/ssm_backward.cu``): the JAX package has no kernel for it (XLA
differentiates its scan).  Mamba2's chunked SSD form in chunks of
``CHUNK`` steps, its products on the tensor cores in 3xTF32, its segment
sums in float64, division-free, two launches a call, in ``BWD_KERNELS``'
order: ``bounds`` walks the chunks forward for the state at each chunk's
start and backward for the state's gradient at each chunk's end, into a
scratch the wrapper allocates; ``chunk`` takes every chunk's gradients in
parallel (``ref.selective_scan_bwd_ref`` is its function,
``ref.ssd_bwd_chunked_ref(..., chunk=CHUNK, operand_rounding="tf32x3")``
its algorithm).  It keeps no state from the forward.  It counts each
launch as the forward does, in ``.launches`` and ``.launches_by_kernel``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "ssm_scan.cu"
CHUNKED_SOURCE = CSRC / "ssm_chunked.cu"
DECODE_SOURCE = CSRC / "ssm_decode.cu"
BWD_SOURCE = CSRC / "ssm_backward.cu"
# every library of this package: name -> its sources
LIBRARIES = {"ssm_scan": [SOURCE, CHUNKED_SOURCE, DECODE_SOURCE],
             "ssm_backward": [BWD_SOURCE]}
# the largest head dim and state dim the kernels take
MAX_HEAD_DIM = 64
MAX_STATE_DIM = 64
# the largest H and B (the grid's y and z dims)
MAX_GRID = 65535
# the chunked kernel's steps a chunk; the longest T the decode kernel takes
CHUNK = 64
DECODE_MAX_T = 8
# the kernels by name, as the C entry point numbers them
KERNELS = {"chunked": 0, "decode_rows": 1}
# the backward's two kernels by name, as the C entry point numbers them,
# in launch order; its chunks are the forward's CHUNK steps
BWD_KERNELS = {"bounds": 0, "chunk": 1}


def kernel_for(T: int) -> str:
    """The kernel that takes a call of T >= 1 steps: ``decode_rows`` for
    T <= DECODE_MAX_T (every decode step), ``chunked`` otherwise (every
    prefill)."""
    return "decode_rows" if T <= DECODE_MAX_T else "chunked"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel's library, built (or loaded) at the first call."""
    lib = _build.load_library("ssm_scan", LIBRARIES["ssm_scan"])
    lib.ssm_scan_forward.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.ssm_scan_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """The backward's library, built (or loaded) at the first call."""
    lib = _build.load_library("ssm_backward", LIBRARIES["ssm_backward"])
    lib.ssm_scan_backward.argtypes = (
        [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.ssm_scan_backward.restype = ctypes.c_int
    return lib


def _check(name, x, b, c, dt, a, d, states, extra=()):
    """The forward's and the backward's checks: x (and ``extra``, each
    (label, tensor) of x's shape) (B,T,H,P), b, c (B,T,N), dt (B,T,H), a,
    d (H,), ``states`` each (label, tensor or None) (B,H,P,N); float32,
    contiguous, one CUDA device.  Returns (B, T, H, P, N)."""
    if x.dim() != 4:
        raise ValueError(f"{name}: expected x (B,T,H,P), got x "
                         f"{tuple(x.shape)}")
    B, T, H, P = x.shape
    N = b.shape[-1] if b.dim() == 3 else -1
    shapes = {"b": (b, (B, T, N)), "c": (c, (B, T, N)), "dt": (dt, (B, T, H)),
              "a": (a, (H,)), "d": (d, (H,)),
              **{label: (t, (B, H, P, N)) for label, t in states},
              **{label: (t, (B, T, H, P)) for label, t in extra}}
    for label, (t, want) in shapes.items():
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name}: {label} must be {want} for x "
                             f"{tuple(x.shape)} and N = {N}, got "
                             f"{tuple(t.shape)}")
    if (not 1 <= P <= MAX_HEAD_DIM or not 1 <= N <= MAX_STATE_DIM
            or not 1 <= B <= MAX_GRID or not 1 <= H <= MAX_GRID):
        raise ValueError(f"{name}: need 1 <= P <= {MAX_HEAD_DIM}, 1 <= N <= "
                         f"{MAX_STATE_DIM} and 1 <= B, H <= {MAX_GRID}, got "
                         f"B={B}, H={H}, P={P}, N={N}")
    tensors = [x] + [t for t, _ in shapes.values() if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: inputs must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return B, T, H, P, N


def ssm_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
             state0: Optional[torch.Tensor] = None, *,
             out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel ``kernel_for(T)`` picks on the current CUDA stream.

    x (B,T,H,P); b, c (B,T,N); dt (B,T,H); a, d (H,); state0 and ``out``
    (B,H,P,N) or None; all float32, contiguous, on one CUDA device;
    1 <= P, N <= 64, 1 <= B, H <= 65535.  ``out`` receives the final state
    and may be ``state0`` itself.  Returns (y (B,T,H,P), final state).
    Raises on anything else, and when the launch fails."""
    name = "ssm_scan"
    B, T, H, P, N = _check(name, x, b, c, dt, a, d,
                           (("state0", state0), ("out", out)))
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32,
                        device=x.device) if out is None else out
    if T == 0:  # nothing to launch, nothing counted
        if state0 is None:
            state.zero_()
        elif state is not state0:
            state.copy_(state0)
        return y, state
    which = kernel_for(T)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().ssm_scan_forward(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
            a.data_ptr(), d.data_ptr(),
            None if state0 is None else state0.data_ptr(), y.data_ptr(),
            state.data_ptr(), B, T, H, P, N, KERNELS[which], stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch of {which} failed with CUDA "
                           f"error {err} (B={B}, T={T}, H={H}, P={P}, N={N})")
    ssm_scan.launches += 1
    ssm_scan.launches_by_kernel[which] += 1
    return y, state


# launches since the last reset, in all and by kernel; only a successful
# launch counts
ssm_scan.launches = 0
ssm_scan.launches_by_kernel = dict.fromkeys(KERNELS, 0)


def ssm_scan_backward(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                      state0: Optional[torch.Tensor], dy: torch.Tensor,
                      dstate: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``ssm_scan(x, b, c, dt, a, d, state0)`` for the
    output's gradient ``dy`` and the final state's ``dstate`` (None: zero):
    the launches of ``BWD_KERNELS`` in order on the current CUDA stream.

    Takes the forward's inputs as ``ssm_scan`` does, dy (B,T,H,P) and
    dstate (B,H,P,N), float32 and contiguous on x's device.  Returns (dx
    (B,T,H,P), db, dc (B,T,N), ddt (B,T,H), da, dd (H,), dstate0
    (B,H,P,N), None when state0 is None), float32;
    ``ref.selective_scan_bwd_ref`` is its function.  The kernels write
    each head's share of the sums over heads (db, dc) and each chunk's of
    the sums over batch rows and steps (da, dd), summed here in a fixed
    order, and the boundary states and gradients into a scratch of
    2 B H ceil(T / CHUNK) P N floats.  Raises on anything else, and when a
    launch fails.  At T = 0 nothing launches: dstate0 is dstate."""
    name = "ssm_scan_backward"
    B, T, H, P, N = _check(name, x, b, c, dt, a, d,
                           (("state0", state0), ("dstate", dstate)),
                           (("dy", dy),))
    dx = torch.empty_like(x)
    dstate0 = None if state0 is None else torch.empty_like(state0)
    if T == 0:  # nothing to launch, nothing counted
        if dstate0 is not None and dstate is None:
            dstate0.zero_()
        elif dstate0 is not None:
            dstate0.copy_(dstate)
        return (dx, torch.zeros_like(b), torch.zeros_like(c),
                torch.empty_like(dt), torch.zeros_like(a),
                torch.zeros_like(d), dstate0)
    chunks = -(-T // CHUNK)
    db_part, dc_part = (torch.empty((B, T, H, N), dtype=torch.float32,
                                    device=x.device) for _ in range(2))
    ddt = torch.empty_like(dt)
    da_part, dd_part = (torch.empty((B, chunks, H), dtype=torch.float32,
                                    device=x.device) for _ in range(2))
    s_bounds, g_bounds = (torch.empty((B, H, chunks, P, N),
                                      dtype=torch.float32, device=x.device)
                          for _ in range(2))
    ptrs = [None if t is None else t.data_ptr() for t in (
        x, b, c, dt, a, d, state0, dy, dstate, dx, db_part, dc_part, ddt,
        da_part, dd_part, dstate0, s_bounds, g_bounds)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for which, number in BWD_KERNELS.items():
            err = bwd_library().ssm_scan_backward(*ptrs, B, T, H, P, N,
                                                  number, stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch of {which} failed with "
                                   f"CUDA error {err} (B={B}, T={T}, H={H}, "
                                   f"P={P}, N={N})")
            ssm_scan_backward.launches += 1
            ssm_scan_backward.launches_by_kernel[which] += 1
    return (dx, db_part.sum(2), dc_part.sum(2), ddt, da_part.sum((0, 1)),
            dd_part.sum((0, 1)), dstate0)


# launches since the last reset, in all and by kernel; only a successful
# launch counts
ssm_scan_backward.launches = 0
ssm_scan_backward.launches_by_kernel = dict.fromkeys(BWD_KERNELS, 0)
