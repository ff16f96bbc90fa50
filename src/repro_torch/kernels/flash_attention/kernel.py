"""Flash attention on the card: the wrapper around
``csrc/flash_attention.cu``.

``flash_attention`` replaces the Pallas TPU kernel of
``src/repro/kernels/flash_attention/kernel.py``: grouped-query attention
over explicit positions, q (B,Sq,Hq,D) against k, v (B,Sk,Hkv,D) in float32
or bfloat16, ``q_pos`` (B,Sq) and ``kv_pos`` (B,Sk) int32 with -1 on an
unwritten slot, causal and an optional sliding window; the output is
(B,Sq,Hq,D) in q's dtype, the statistics float32.  What bounds it: the
bytes of q, k, v and o at the served shapes (see the source for the design
and its distance from the bound).

The wrapper checks its inputs, allocates the output with ``torch.empty``,
launches on the current CUDA stream, raises when the launch fails, and
counts its successful launches in a plain integer ``.launches``; with no
query rows it returns without launching or counting.  The library builds
with ``nvcc`` at the first launch (``kernels/_build``); ``LIBRARIES`` names
it for a caller that builds every library up front.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# every library of this package: name -> its sources
LIBRARIES = {"flash_attention": [SOURCE]}
# the kernel's largest head dim, and its (query, head) rows per block
MAX_HEAD_DIM = 128
BLOCK_ROWS = 64


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel's library, built (or loaded) at the first call."""
    lib = _build.load_library("flash_attention",
                              LIBRARIES["flash_attention"])
    lib.flash_attention_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                      ctypes.c_int,
                                                      ctypes.c_void_p])
    lib.flash_attention_forward.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel on the current CUDA stream.

    q (B,Sq,Hq,D), k and v (B,Sk,Hkv,D), one dtype (float32 or bfloat16);
    q_pos (B,Sq) and kv_pos (B,Sk) int32; all contiguous on one CUDA
    device; Hq a multiple of Hkv and D <= 128.  ``scale`` defaults to
    D**-0.5.  Returns (B,Sq,Hq,D) in q's dtype.  Raises on anything else,
    and when the launch fails."""
    name = "flash_attention"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: expected q (B,Sq,Hq,D), k and v "
                         f"(B,Sk,Hkv,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or q_pos.shape != (B, Sq) or kv_pos.shape != (B, Sk)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, kv_pos {tuple(kv_pos.shape)} "
                         "do not match")
    if Hkv < 1 or Hq % Hkv or not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: need Hq a multiple of Hkv >= 1 and 1 <= D "
                         f"<= {MAX_HEAD_DIM}, got Hq={Hq}, Hkv={Hkv}, D={D}")
    blocks = -(-Sq * (Hq // Hkv) // BLOCK_ROWS)
    if B > 65535 or Hkv > 65535 or blocks > 2**31 - 1:
        raise ValueError(f"{name}: grid too large for B={B}, Sq={Sq}, "
                         f"Hq={Hq}, Hkv={Hkv}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: q, k and v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError(f"{name}: positions must be int32, got "
                        f"{q_pos.dtype}, {kv_pos.dtype}")
    tensors = (q, k, v, q_pos, kv_pos)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must lie on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    o = torch.empty_like(q)
    if B == 0 or Sq == 0:  # nothing to launch, nothing counted
        return o
    scale = D**-0.5 if scale is None else float(scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), o.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
            int(causal), int(window), scale, int(q.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err} "
                           f"(B={B}, Sq={Sq}, Sk={Sk}, Hq={Hq}, Hkv={Hkv}, "
                           f"D={D}, {q.dtype})")
    flash_attention.launches += 1
    return o


# launches of the kernel since the last reset; only a successful launch counts
flash_attention.launches = 0
