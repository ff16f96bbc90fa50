"""The int8 dequantizing matmul on the card: the wrapper around
``csrc/int8_matmul.cu``.

``int8_matmul`` replaces the Pallas TPU kernel of
``src/repro/kernels/int8_matmul/kernel.py``: x (M,K) float32 or bfloat16,
q (K,N) int8, scale (N,) float32 -> y = (x @ q) * scale, (M,N) in
``x.dtype``, the sum float32 and the scale applied once per output after the
K loop.  With a leading stream axis, x (S,M,K), q (S,K,N) int8 and scale
(S,N) -> (S,M,N), it computes a fleet's S products in one launch (the
stream a grid axis, as the reference's ``pallas_call`` gains one under
``jax.vmap``), each stream's sums those of a single-stream launch.  What
bounds it: at the serving path's shapes a call is a few MFLOP
over a few hundred KB, far under a microsecond of the card's rates, so
latency sets its time: tiles sized to those shapes, the whole K staged at
once (see the source for the design).

The wrapper checks its inputs, allocates the output with ``torch.empty``,
launches on the current CUDA stream, raises when the launch fails, and
counts its successful launches in a plain integer ``.launches`` (one a
call, whatever S); at S=0 or M=0 it returns without launching or
counting.  The library builds with ``nvcc`` at
the first launch (``kernels/_build``); ``LIBRARIES`` names it for a caller
that builds every library up front.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "int8_matmul.cu"
# every library of this package: name -> its sources
LIBRARIES = {"int8_matmul": [SOURCE]}
# output columns one block takes for N > 16 (a 16 x 32 tile); the grid's
# second axis holds at most 65535 such tiles, its third at most 65535
# streams
BLOCK_N = 32
MAX_STREAMS = 65_535


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel's library, built (or loaded) at the first call."""
    lib = _build.load_library("int8_matmul", LIBRARIES["int8_matmul"])
    lib.int8_matmul_forward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.int8_matmul_forward.restype = ctypes.c_int
    return lib


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current CUDA stream.

    x (M,K) float32 or bfloat16, q (K,N) int8, scale (N,) float32, or all
    with a leading stream axis (x (S,M,K), q (S,K,N), scale (S,N)), all
    contiguous on one CUDA device.  Returns (M,N), or (S,M,N), in
    ``x.dtype``.  Raises on anything else, and when the launch fails."""
    name = "int8_matmul"
    single = x.dim() == 2
    if single:
        x, q, scale = x[None], q[None], scale[None]
    if x.dim() != 3 or q.dim() != 3 or scale.dim() != 2:
        raise ValueError(f"{name}: expected x (M,K), q (K,N), scale (N), or "
                         f"with a stream axis x (S,M,K), q (S,K,N), scale "
                         f"(S,N); got {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}")
    S, M, K = x.shape
    N = q.shape[2]
    if tuple(q.shape[:2]) != (S, K) or tuple(scale.shape) != (S, N):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)} do not match")
    if K < 1 or N < 1 or -(-N // BLOCK_N) > 65535 or S > MAX_STREAMS:
        raise ValueError(f"{name}: need K >= 1, 1 <= N <= "
                         f"{65535 * BLOCK_N} and S <= {MAX_STREAMS}, got "
                         f"K={K}, N={N}, S={S}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if q.dtype != torch.int8:
        raise TypeError(f"{name}: q must be int8, got {q.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"{name}: scale must be float32, got {scale.dtype}")
    if any(t.device.type != "cuda" or t.device != x.device
           for t in (x, q, scale)):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device, "
                         f"got {[str(t.device) for t in (x, q, scale)]}")
    if not all(t.is_contiguous() for t in (x, q, scale)):
        raise ValueError(f"{name}: inputs must be contiguous")
    y = torch.empty((S, M, N), dtype=x.dtype, device=x.device)
    if S and M:  # else nothing to launch, nothing counted
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = library().int8_matmul_forward(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), S,
                M, K, N, int(x.dtype == torch.bfloat16), stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed with CUDA error {err} "
                               f"(S={S}, M={M}, K={K}, N={N}, {x.dtype})")
        int8_matmul.launches += 1
    return y[0] if single else y


# launches of the kernel since the last reset; only a successful launch counts
int8_matmul.launches = 0
