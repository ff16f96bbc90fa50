"""The fused whole-sequence LSTM forward on the card: the wrapper around
``csrc/lstm_sequence.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/lstm_cell/kernel.py:
lstm_sequence_fused`` (``_sequence_kernel``).  Given x (B,T,F) in float32 or
bfloat16, wx (F,4H), wh (H,4H) and b (4H) in float32, it returns the final
(h, c), each (B,H) in ``x.dtype``.  Compute is float32; gate order i, f, g, o.

What bounds it: at the paper's shape (B=250, T=5, F=5, H=40) a call is
2*B*T*(F+H)*4H = 18 MFLOP over ~134 KB, a fraction of a microsecond at the
card's float32 or memory rate, so launch latency and the serial T-step chain
set its time.  The design keeps the weights and the h/c carry on chip for all
T steps (one block per tile of batch rows, weights in shared memory, one
thread per (row, hidden unit)) and writes only the final state; see the
source for the details.

The library builds with ``nvcc`` at the first launch (``kernels/_build``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "lstm_sequence.cu"
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel's library, built (or loaded) at the first call."""
    lib = _build.load_library("lstm_sequence", [SOURCE])
    lib.lstm_sequence_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lstm_sequence_smem_bytes.restype = ctypes.c_longlong
    lib.lstm_sequence_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.lstm_sequence_forward.restype = ctypes.c_int
    return lib


def smem_bytes(F: int, H: int) -> int:
    """Shared memory one block of the kernel needs at (F, H)."""
    return int(library().lstm_sequence_smem_bytes(F, H))


def max_hidden(F: int) -> int:
    """The largest H whose weights fit the kernel's shared-memory plan."""
    H = 1
    while smem_bytes(F, H + 1) <= SMEM_LIMIT:
        H += 1
    return H


def lstm_sequence_fused(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                        b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused sequence kernel on the current CUDA stream.

    x (B,T,F) float32 or bfloat16; wx (F,4H), wh (H,4H), b (4H) float32, all
    contiguous on one CUDA device.  Returns the final (h, c), each (B,H) in
    ``x.dtype``.  Raises on anything else, and when the launch fails."""
    if x.dim() != 3 or wx.dim() != 2 or wh.dim() != 2 or b.dim() != 1:
        raise ValueError(
            "lstm_sequence_fused: expected x (B,T,F), wx (F,4H), wh (H,4H), "
            f"b (4H); got {tuple(x.shape)}, {tuple(wx.shape)}, "
            f"{tuple(wh.shape)}, {tuple(b.shape)}")
    B, T, F = x.shape
    H = wh.shape[0]
    if (tuple(wx.shape) != (F, 4 * H) or tuple(wh.shape) != (H, 4 * H)
            or tuple(b.shape) != (4 * H,)):
        raise ValueError(
            f"lstm_sequence_fused: weight shapes {tuple(wx.shape)}, "
            f"{tuple(wh.shape)}, {tuple(b.shape)} do not match F={F}, H={H}")
    if T < 1 or H < 1:
        raise ValueError(f"lstm_sequence_fused: need T, H >= 1, got {T}, {H}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lstm_sequence_fused: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    for name, w in (("wx", wx), ("wh", wh), ("b", b)):
        if w.dtype != torch.float32:
            raise TypeError(
                f"lstm_sequence_fused: {name} must be float32, got {w.dtype}")
    tensors = (x, wx, wh, b)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(
            "lstm_sequence_fused: all inputs must lie on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lstm_sequence_fused: inputs must be contiguous")
    need = smem_bytes(F, H)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"lstm_sequence_fused: F={F}, H={H} needs {need} bytes of shared "
            f"memory for its weights, more than the {SMEM_LIMIT} a block may "
            f"use; the largest H that fits at F={F} is {max_hidden(F)}")

    h = torch.empty((B, H), dtype=x.dtype, device=x.device)
    c = torch.empty((B, H), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().lstm_sequence_forward(
            x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            h.data_ptr(), c.data_ptr(), B, T, F, H,
            int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(
            f"lstm_sequence_fused: launch failed with CUDA error {err} "
            f"(B={B}, T={T}, F={F}, H={H}, {x.dtype})")
    lstm_sequence_fused.launches += 1
    return h, c


# launches of the kernel since the last reset; only a successful launch counts
lstm_sequence_fused.launches = 0
