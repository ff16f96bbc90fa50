"""The RWKV6 WKV scan on the card: the wrapper around ``csrc/``.

``rwkv6_scan`` replaces the Pallas TPU kernel of
``src/repro/kernels/rwkv6_scan/kernel.py``: the WKV recurrence of every
(batch, head), in the model's (B,T,H,N) layout, float32 in and out, from a
given state (zero when none is given) to the final state.  With a zero
state it computes the Pallas kernel's function; with any other it computes
the reference's oracle ``rwkv6_scan_ref(..., state0)``.  What bounds it:
the bytes of r, k, v, w, y and the state (see the sources for each design
and its distance from the bound).

One library holds two kernels, and every call launches exactly one of
them, by ``kernel_for``:

- ``decode_rows`` (``csrc/rwkv6_decode.cu``), T <= ``DECODE_MAX_T``: every
  decode step.  The recurrence step by step, each state column split over
  ``ref.decode_lanes(N)`` lanes of 4 rows, 16-byte accesses
  (``ref.wkv_decode_rows_ref`` is its order of summation);
- ``chunked`` (``csrc/rwkv6_chunked.cu``), longer T: every prefill.  The
  chunked WKV form in chunks of ``CHUNK`` steps, its decays as running
  products of w, its products on the tensor cores in 3xTF32, a block per
  ``COLS`` value columns (``ref.wkv_chunked_ref(..., chunk=CHUNK,
  cols=COLS, operand_rounding="tf32x3")`` is its algorithm).

The wrapper checks its inputs, allocates y (and the state, unless given
``out``) with ``torch.empty``, launches on the current CUDA stream, raises
when the launch fails, and counts its successful launches in a plain
integer ``.launches`` and by kernel in ``.launches_by_kernel``; at T = 0
it launches nothing and counts nothing.  The library builds with ``nvcc``
at the first launch (``kernels/_build``, which also hashes the
``*.cuh`` headers beside the sources and the common ``kernels/csrc/
tf32_mma.cuh``); ``LIBRARIES`` names it for a caller that builds every
library up front.

``rwkv6_scan_backward`` is the recurrence's gradient, a library of its own
(``csrc/rwkv6_backward.cu``): the JAX package has no kernel for it (XLA
differentiates its scan).  The chunked form in chunks of ``CHUNK`` steps,
its products on the tensor cores in 3xTF32, division-free, two launches a
call, in ``BWD_KERNELS``' order: ``bounds`` walks the chunks forward for
the state at each chunk's start and backward for the state's gradient at
each chunk's end, into a scratch the wrapper allocates; ``chunk`` takes
every chunk's gradients in parallel (``ref.wkv_bwd_ref`` is its function,
``ref.wkv_bwd_chunked_ref(..., chunk=CHUNK, operand_rounding="tf32x3")``
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
SOURCE = CSRC / "rwkv6_scan.cu"
CHUNKED_SOURCE = CSRC / "rwkv6_chunked.cu"
DECODE_SOURCE = CSRC / "rwkv6_decode.cu"
BWD_SOURCE = CSRC / "rwkv6_backward.cu"
# every library of this package: name -> its sources
LIBRARIES = {"rwkv6_scan": [SOURCE, CHUNKED_SOURCE, DECODE_SOURCE],
             "rwkv6_backward": [BWD_SOURCE]}
# the largest head size the kernels take
MAX_HEAD_SIZE = 64
# the largest H and B (the grid's y and z dims)
MAX_GRID = 65535
# the chunked kernel's steps a chunk and value columns a block; the
# longest T the decode kernel takes
CHUNK = 16
COLS = 32
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
    """The kernels' library, built (or loaded) at the first call."""
    lib = _build.load_library("rwkv6_scan", LIBRARIES["rwkv6_scan"])
    lib.rwkv6_scan_forward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.rwkv6_scan_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """The backward's library, built (or loaded) at the first call."""
    lib = _build.load_library("rwkv6_backward", LIBRARIES["rwkv6_backward"])
    lib.rwkv6_scan_backward.argtypes = (
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.rwkv6_scan_backward.restype = ctypes.c_int
    return lib


def _check(name, r, k, v, w, u, states, extra=()):
    """The forward's and the backward's checks: r, k, v, w (and ``extra``,
    each (label, tensor) of r's shape) (B,T,H,N), u (H,N), ``states`` each
    (label, tensor or None) (B,H,N,N); float32, contiguous, one CUDA
    device.  Returns (B, T, H, N)."""
    if r.dim() != 4:
        raise ValueError(f"{name}: expected r, k, v, w (B,T,H,N), got r "
                         f"{tuple(r.shape)}")
    B, T, H, N = r.shape
    same = [k, v, w, *(t for _, t in extra)]
    if any(t.shape != r.shape for t in same):
        raise ValueError(f"{name}: r, k, v, w"
                         f"{''.join(', ' + label for label, _ in extra)} "
                         f"must share one shape, got "
                         f"{[tuple(t.shape) for t in (r, *same)]}")
    if tuple(u.shape) != (H, N):
        raise ValueError(f"{name}: u must be (H,N) = {(H, N)}, got "
                         f"{tuple(u.shape)}")
    for label, s in states:
        if s is not None and tuple(s.shape) != (B, H, N, N):
            raise ValueError(f"{name}: {label} must be (B,H,N,N) = "
                             f"{(B, H, N, N)}, got {tuple(s.shape)}")
    if (not 1 <= N <= MAX_HEAD_SIZE or not 1 <= B <= MAX_GRID
            or not 1 <= H <= MAX_GRID):
        raise ValueError(f"{name}: need 1 <= N <= {MAX_HEAD_SIZE} and 1 <= "
                         f"B, H <= {MAX_GRID}, got B={B}, H={H}, N={N}")
    tensors = [t for t in (r, *same, u, *(s for _, s in states))
               if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: inputs must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.device.type != "cuda" or t.device != r.device for t in tensors):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return B, T, H, N


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state0: Optional[torch.Tensor] = None, *,
               out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel ``kernel_for(T)`` picks on the current CUDA stream.

    r, k, v, w (B,T,H,N); u (H,N); state0 and ``out`` (B,H,N,N) or None;
    all float32, contiguous, on one CUDA device; 1 <= N <= 64,
    1 <= B, H <= 65535.  ``out`` receives the final state and may be
    ``state0`` itself.  Returns (y (B,T,H,N), final state).  Raises on
    anything else, and when the launch fails."""
    name = "rwkv6_scan"
    B, T, H, N = _check(name, r, k, v, w, u,
                        (("state0", state0), ("out", out)))
    y = torch.empty_like(r)
    state = torch.empty((B, H, N, N), dtype=torch.float32,
                        device=r.device) if out is None else out
    if T == 0:  # nothing to launch, nothing counted
        if state0 is None:
            state.zero_()
        elif state is not state0:
            state.copy_(state0)
        return y, state
    which = kernel_for(T)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().rwkv6_scan_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(), B, T, H, N, KERNELS[which],
            stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch of {which} failed with CUDA "
                           f"error {err} (B={B}, T={T}, H={H}, N={N})")
    rwkv6_scan.launches += 1
    rwkv6_scan.launches_by_kernel[which] += 1
    return y, state


# launches since the last reset, in all and by kernel; only a successful
# launch counts
rwkv6_scan.launches = 0
rwkv6_scan.launches_by_kernel = dict.fromkeys(KERNELS, 0)


def rwkv6_scan_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        state0: Optional[torch.Tensor], dy: torch.Tensor,
                        dstate: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The gradients of ``rwkv6_scan(r, k, v, w, u, state0)`` for the
    output's gradient ``dy`` and the final state's ``dstate`` (None: zero):
    the launches of ``BWD_KERNELS`` in order on the current CUDA stream.

    Takes the forward's inputs as ``rwkv6_scan`` does, dy (B,T,H,N) and
    dstate (B,H,N,N), float32 and contiguous on r's device.  Returns (dr,
    dk, dv, dw (B,T,H,N), du (H,N), dstate0 (B,H,N,N), None when state0
    is None), float32; ``ref.wkv_bwd_ref`` is its function.  The kernels
    write each chunk's du, summed here over B and the chunks in a fixed
    order, and the boundary states and gradients into a scratch of
    2 B H ceil(T / CHUNK) N^2 floats.  Raises on anything else, and when a
    launch fails.  At T = 0 nothing launches: dstate0 is dstate."""
    name = "rwkv6_scan_backward"
    B, T, H, N = _check(name, r, k, v, w, u,
                        (("state0", state0), ("dstate", dstate)),
                        (("dy", dy),))
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    dstate0 = None if state0 is None else torch.empty_like(state0)
    if T == 0:  # nothing to launch, nothing counted
        du = torch.zeros_like(u)
        if dstate0 is not None and dstate is None:
            dstate0.zero_()
        elif dstate0 is not None:
            dstate0.copy_(dstate)
        return dr, dk, dv, dw, du, dstate0
    chunks = -(-T // CHUNK)
    du_part = torch.empty((B, chunks, H, N), dtype=torch.float32,
                          device=r.device)
    s_bounds, g_bounds = (torch.empty((B, H, chunks, N, N),
                                      dtype=torch.float32, device=r.device)
                          for _ in range(2))
    ptrs = [None if t is None else t.data_ptr() for t in (
        r, k, v, w, u, state0, dy, dstate, dr, dk, dv, dw, du_part, dstate0,
        s_bounds, g_bounds)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        for which, number in BWD_KERNELS.items():
            err = bwd_library().rwkv6_scan_backward(*ptrs, B, T, H, N,
                                                    number, stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch of {which} failed with "
                                   f"CUDA error {err} (B={B}, T={T}, H={H}, "
                                   f"N={N})")
            rwkv6_scan_backward.launches += 1
            rwkv6_scan_backward.launches_by_kernel[which] += 1
    return dr, dk, dv, dw, du_part.sum((0, 1)), dstate0


# launches since the last reset, in all and by kernel; only a successful
# launch counts
rwkv6_scan_backward.launches = 0
rwkv6_scan_backward.launches_by_kernel = dict.fromkeys(BWD_KERNELS, 0)
