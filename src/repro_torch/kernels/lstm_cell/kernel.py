"""The LSTM kernels on the card: the wrappers around ``csrc/*.cu``.

Four hand-written CUDA kernels, each replacing a Pallas TPU kernel of
``src/repro/kernels/lstm_cell/kernel.py`` (see the sources for the design):

* ``lstm_cell`` (``csrc/lstm_cell.cu``) replaces ``lstm_cell``: one step,
  x (B,F), h and c (B,H), each float32 or bfloat16, and wx (F,4H),
  wh (H,4H), b (4H) -> (h', c'), h' in ``h.dtype`` and c' in ``c.dtype``.
  The step of the per-step baseline ``ops.lstm_sequence_scan``.
* ``lstm_sequence_fused`` (``csrc/lstm_sequence.cu: lstm_sequence_kernel``)
  replaces ``lstm_sequence_fused``: x (B,T,F) in float32 or bfloat16, wx
  (F,4H), wh (H,4H) and b (4H) -> the final (h, c), each (B,H) in
  ``x.dtype``.  The serving forward.
* ``lstm_sequence_fwd_train`` (same source, ``lstm_train_fwd_kernel``)
  replaces ``lstm_sequence_fwd_train``: the same inputs -> the residuals the
  backward needs, post-activation gates (B,T,4H) and c_seq, h_seq (B,T,H),
  float32.  One thread a (row, gate column), the input projection taken
  before the recurrence, wx and b staged by a bulk asynchronous copy
  (``ref.lstm_sequence_fwd_train_tiled_ref`` is its order of summation).
* ``lstm_sequence_bwd`` (``csrc/lstm_sequence_bwd.cu``: a reverse-time
  kernel over tiles of batch rows that keeps dz on chip and writes each
  tile's partial weight gradient, then a kernel that sums the partials in
  a fixed order) replaces ``lstm_sequence_bwd``: x, the residuals, the weights
  and the cotangents dh, dc (B,H) of the final state -> dx (B,T,F), dwx
  (F,4H), dwh (H,4H), db (4H), float32.  Reruns on the same inputs are
  bit-identical (no atomics).  ``ref.lstm_sequence_bwd_tiled_ref`` is its
  algorithm, at the tiling ``bwd_tiling`` reports.

Compute is float32; gate order i, f, g, o.  The forward wrappers take the
weights in float32 or bfloat16, as the reference's kernels do, and cast
bfloat16 ones to float32 once (exact) before the launch; the training pair
copies a weight that is not 16-byte aligned once (its bulk copies need the
alignment).  What bounds them: at the paper's shapes (B of 64 to 256, T=5,
F=5, H=40) a call is a few MFLOP over a few hundred KB, a fraction of a
microsecond at the card's float32 or memory rate, so launch latency and the
serial T-step chain set their time.

Each wrapper checks its inputs, allocates its outputs with ``torch.empty``,
launches on the current CUDA stream, raises when the launch fails, and counts
its successful launches in a plain integer ``.launches`` (one a call, the
backward's two kernels included); at B=0 it returns without launching or
counting.  The libraries build with ``nvcc`` at the first launch
(``kernels/_build``, which also hashes the ``csrc/*.cuh`` headers beside the
sources); ``LIBRARIES`` names them for a caller that builds them all up
front.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "lstm_sequence.cu"
BWD_SOURCE = CSRC / "lstm_sequence_bwd.cu"
CELL_SOURCE = CSRC / "lstm_cell.cu"
# every library of this package: name -> its sources
LIBRARIES = {"lstm_sequence": [SOURCE], "lstm_sequence_bwd": [BWD_SOURCE],
             "lstm_cell": [CELL_SOURCE]}
FLOATS = (torch.float32, torch.bfloat16)
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The forward kernels' library, built (or loaded) at the first call."""
    lib = _build.load_library("lstm_sequence", LIBRARIES["lstm_sequence"])
    lib.lstm_sequence_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lstm_sequence_smem_bytes.restype = ctypes.c_longlong
    lib.lstm_sequence_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.lstm_sequence_forward.restype = ctypes.c_int
    lib.lstm_sequence_forward_train.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.lstm_sequence_forward_train.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """The backward kernels' library, built (or loaded) at the first call."""
    lib = _build.load_library("lstm_sequence_bwd",
                              LIBRARIES["lstm_sequence_bwd"])
    lib.lstm_sequence_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lstm_sequence_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.lstm_sequence_bwd_tiling.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    lib.lstm_sequence_bwd_tiling.restype = ctypes.c_longlong
    lib.lstm_sequence_backward.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.lstm_sequence_backward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def cell_library() -> ctypes.CDLL:
    """The one-step kernel's library, built (or loaded) at the first call."""
    lib = _build.load_library("lstm_cell", LIBRARIES["lstm_cell"])
    lib.lstm_cell_forward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.lstm_cell_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def smem_bytes(F: int, H: int) -> int:
    """Shared memory one block of the forward kernels needs at (F, H)."""
    return int(library().lstm_sequence_smem_bytes(F, H))


@functools.lru_cache(maxsize=None)
def bwd_smem_bytes(F: int, H: int) -> int:
    """Shared memory one block of the reverse-time kernel needs at (F, H),
    at its smallest tiling (one row, one step a chunk)."""
    return int(bwd_library().lstm_sequence_bwd_smem_bytes(F, H))


class BwdTiling(NamedTuple):
    """How the reverse-time kernel cuts a call: batch rows a block, steps a
    chunk of its time loop, lanes a piece of dh is split over (32 where the
    lanes hold wh in registers, else the unit's 4), blocks, and the floats
    of the workspace of their partial weight gradients."""
    rows: int
    chunk: int
    lanes: int
    blocks: int
    workspace: int


@functools.lru_cache(maxsize=None)
def bwd_tiling(B: int, T: int, F: int, H: int) -> BwdTiling:
    """The reverse-time kernel's tiling at (B, T, F, H)."""
    out = (ctypes.c_int * 4)()
    floats = int(bwd_library().lstm_sequence_bwd_tiling(B, T, F, H, out))
    if floats < 0:
        raise ValueError(f"lstm_sequence_bwd: F={F}, H={H} does not fit a "
                         "block's shared memory")
    return BwdTiling(*out, floats)


def _largest_h(need, F: int) -> int:
    H = 1
    while need(F, H + 1) <= SMEM_LIMIT:
        H += 1
    return H


def max_hidden(F: int) -> int:
    """The largest H whose weights fit the forward kernels' shared memory."""
    return _largest_h(smem_bytes, F)


def max_hidden_bwd(F: int) -> int:
    """The largest H whose weights fit the backward's shared memory."""
    return _largest_h(bwd_smem_bytes, F)


def _check_forward_inputs(name: str, x: torch.Tensor, wx: torch.Tensor,
                          wh: torch.Tensor, b: torch.Tensor) -> None:
    """Raise unless (x, wx, wh, b) is what the forward kernels take."""
    if x.dim() != 3 or wx.dim() != 2 or wh.dim() != 2 or b.dim() != 1:
        raise ValueError(
            f"{name}: expected x (B,T,F), wx (F,4H), wh (H,4H), "
            f"b (4H); got {tuple(x.shape)}, {tuple(wx.shape)}, "
            f"{tuple(wh.shape)}, {tuple(b.shape)}")
    B, T, F = x.shape
    H = wh.shape[0]
    if (tuple(wx.shape) != (F, 4 * H) or tuple(wh.shape) != (H, 4 * H)
            or tuple(b.shape) != (4 * H,)):
        raise ValueError(
            f"{name}: weight shapes {tuple(wx.shape)}, "
            f"{tuple(wh.shape)}, {tuple(b.shape)} do not match F={F}, H={H}")
    if T < 1 or H < 1:
        raise ValueError(f"{name}: need T, H >= 1, got {T}, {H}")
    _check_floats(name, (("x", x), ("wx", wx), ("wh", wh), ("b", b)))
    _check_placement(name, (x, wx, wh, b))
    need = smem_bytes(F, H)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{name}: F={F}, H={H} needs {need} bytes of shared "
            f"memory for its weights, more than the {SMEM_LIMIT} a block may "
            f"use; the largest H that fits at F={F} is {max_hidden(F)}")


def _check_floats(name: str, named) -> None:
    """Raise unless each (name, tensor) of ``named`` is float32 or bfloat16."""
    for tname, t in named:
        if t.dtype not in FLOATS:
            raise TypeError(f"{name}: {tname} must be float32 or bfloat16, "
                            f"got {t.dtype}")


def f32_weights(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The weights in float32, as the kernels take them: bfloat16 ones cast
    once (exact), float32 ones as they are."""
    return wx.float(), wh.float(), b.float()


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy where its data is not 16-byte aligned (a view
    into a larger buffer): the bulk copies read 16-byte aligned sources."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_placement(name: str, tensors) -> None:
    x = tensors[0]
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(
            f"{name}: all inputs must lie on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def _raise_on_error(name: str, err: int, x: torch.Tensor, H: int) -> None:
    if err != 0:
        B, T, F = x.shape
        raise RuntimeError(
            f"{name}: launch failed with CUDA error {err} "
            f"(B={B}, T={T}, F={F}, H={H}, {x.dtype})")


def lstm_sequence_fused(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                        b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused sequence kernel on the current CUDA stream.

    x (B,T,F), wx (F,4H), wh (H,4H), b (4H), each float32 or bfloat16, all
    contiguous on one CUDA device.  Returns the final (h, c), each (B,H) in
    ``x.dtype``.  Raises on anything else, and when the launch fails."""
    _check_forward_inputs("lstm_sequence_fused", x, wx, wh, b)
    wx, wh, b = f32_weights(wx, wh, b)
    B, T, F = x.shape
    H = wh.shape[0]
    h = torch.empty((B, H), dtype=x.dtype, device=x.device)
    c = torch.empty((B, H), dtype=x.dtype, device=x.device)
    if B == 0:  # nothing to launch, nothing counted
        return h, c
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().lstm_sequence_forward(
            x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            h.data_ptr(), c.data_ptr(), B, T, F, H,
            int(x.dtype == torch.bfloat16), stream)
    _raise_on_error("lstm_sequence_fused", err, x, H)
    lstm_sequence_fused.launches += 1
    return h, c


# launches of the kernel since the last reset; only a successful launch counts
lstm_sequence_fused.launches = 0


def lstm_sequence_fwd_train(x: torch.Tensor, wx: torch.Tensor,
                            wh: torch.Tensor, b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch the residual-emitting forward on the current CUDA stream.

    Takes what ``lstm_sequence_fused`` takes.  Returns the post-activation
    gates (B,T,4H) and c_seq, h_seq (B,T,H), all float32; ``h_seq[:, -1]``
    is the final hidden state.  Raises on anything else, and when the launch
    fails."""
    _check_forward_inputs("lstm_sequence_fwd_train", x, wx, wh, b)
    wx, wh, b = map(_aligned16, f32_weights(wx, wh, b))
    B, T, F = x.shape
    H = wh.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    gates = torch.empty((B, T, 4 * H), **f32)
    c_seq = torch.empty((B, T, H), **f32)
    h_seq = torch.empty((B, T, H), **f32)
    if B == 0:  # nothing to launch, nothing counted
        return gates, c_seq, h_seq
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().lstm_sequence_forward_train(
            x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            gates.data_ptr(), c_seq.data_ptr(), h_seq.data_ptr(), B, T, F, H,
            int(x.dtype == torch.bfloat16), stream)
    _raise_on_error("lstm_sequence_fwd_train", err, x, H)
    lstm_sequence_fwd_train.launches += 1
    return gates, c_seq, h_seq


lstm_sequence_fwd_train.launches = 0


def lstm_sequence_bwd(x: torch.Tensor, gates: torch.Tensor,
                      c_seq: torch.Tensor, h_seq: torch.Tensor,
                      wx: torch.Tensor, wh: torch.Tensor, dh: torch.Tensor,
                      dc: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Launch the backward on the current CUDA stream: the reverse-time
    kernel, then the combine of its partials (one launch as counted here).

    x (B,T,F) float32 or bfloat16; the residuals of
    ``lstm_sequence_fwd_train``; wx (F,4H), wh (H,4H); dh, dc (B,H), the
    cotangents of the final (h, c); all but x float32, contiguous, on one
    CUDA device.  Returns (dx (B,T,F), dwx, dwh, db), float32.  Raises on
    anything else, and when a launch fails."""
    name = "lstm_sequence_bwd"
    if x.dim() != 3 or wx.dim() != 2 or wh.dim() != 2:
        raise ValueError(f"{name}: expected x (B,T,F), wx (F,4H), wh (H,4H); "
                         f"got {tuple(x.shape)}, {tuple(wx.shape)}, "
                         f"{tuple(wh.shape)}")
    B, T, F = x.shape
    H = wh.shape[0]
    want = {"gates": (gates, (B, T, 4 * H)), "c_seq": (c_seq, (B, T, H)),
            "h_seq": (h_seq, (B, T, H)), "wx": (wx, (F, 4 * H)),
            "wh": (wh, (H, 4 * H)), "dh": (dh, (B, H)), "dc": (dc, (B, H))}
    for tname, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} is {tuple(t.shape)}, expected "
                             f"{shape} for B={B}, T={T}, F={F}, H={H}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
    if T < 1 or H < 1:
        raise ValueError(f"{name}: need T, H >= 1, got {T}, {H}")
    _check_floats(name, (("x", x),))
    _check_placement(name, (x, *(t for t, _ in want.values())))
    need = bwd_smem_bytes(F, H)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{name}: F={F}, H={H} needs {need} bytes of shared memory for "
            f"its weights, more than the {SMEM_LIMIT} a block may use; the "
            f"largest H that fits at F={F} is {max_hidden_bwd(F)}")

    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((B, T, F), **f32)
    if B == 0:  # no rows: zero weight gradients, nothing launched or counted
        return (dx, torch.zeros((F, 4 * H), **f32),
                torch.zeros((H, 4 * H), **f32), torch.zeros((4 * H,), **f32))
    part = torch.empty((bwd_tiling(B, T, F, H).workspace,), **f32)
    wx, wh = _aligned16(wx), _aligned16(wh)
    dwx = torch.empty((F, 4 * H), **f32)
    dwh = torch.empty((H, 4 * H), **f32)
    db = torch.empty((4 * H,), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = bwd_library().lstm_sequence_backward(
            x.data_ptr(), gates.data_ptr(), c_seq.data_ptr(), h_seq.data_ptr(),
            wx.data_ptr(), wh.data_ptr(), dh.data_ptr(), dc.data_ptr(),
            dx.data_ptr(), part.data_ptr(), dwx.data_ptr(), dwh.data_ptr(),
            db.data_ptr(), B, T, F, H, int(x.dtype == torch.bfloat16), stream)
    _raise_on_error(name, err, x, H)
    lstm_sequence_bwd.launches += 1
    return dx, dwx, dwh, db


lstm_sequence_bwd.launches = 0


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one fused LSTM step on the current CUDA stream.

    x (B,F), h and c (B,H), wx (F,4H), wh (H,4H), b (4H), each float32 or
    bfloat16, all contiguous on one CUDA device.  Returns (h', c'), h' in
    ``h.dtype`` and c' in ``c.dtype``.  Raises on anything else, and when
    the launch fails."""
    name = "lstm_cell"
    if (x.dim(), h.dim(), c.dim(), wx.dim(), wh.dim(), b.dim()) != (
            2, 2, 2, 2, 2, 1):
        raise ValueError(
            f"{name}: expected x (B,F), h, c (B,H), wx (F,4H), wh (H,4H), "
            f"b (4H); got {tuple(x.shape)}, {tuple(h.shape)}, "
            f"{tuple(c.shape)}, {tuple(wx.shape)}, {tuple(wh.shape)}, "
            f"{tuple(b.shape)}")
    B, F = x.shape
    H = wh.shape[0]
    if (tuple(h.shape) != (B, H) or tuple(c.shape) != (B, H)
            or tuple(wx.shape) != (F, 4 * H) or tuple(wh.shape) != (H, 4 * H)
            or tuple(b.shape) != (4 * H,)):
        raise ValueError(
            f"{name}: shapes {tuple(h.shape)}, {tuple(c.shape)}, "
            f"{tuple(wx.shape)}, {tuple(wh.shape)}, {tuple(b.shape)} do not "
            f"match B={B}, F={F}, H={H}")
    if H < 1:
        raise ValueError(f"{name}: need H >= 1, got {H}")
    _check_floats(name, (("x", x), ("h", h), ("c", c), ("wx", wx),
                         ("wh", wh), ("b", b)))
    _check_placement(name, (x, h, c, wx, wh, b))
    wx, wh, b = f32_weights(wx, wh, b)
    h_out = torch.empty((B, H), dtype=h.dtype, device=x.device)
    c_out = torch.empty((B, H), dtype=c.dtype, device=x.device)
    if B == 0:  # nothing to launch, nothing counted
        return h_out, c_out
    dtypes = sum(1 << i for i, t in enumerate((x, h, c))
                 if t.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = cell_library().lstm_cell_forward(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
            wh.data_ptr(), b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            B, F, H, dtypes, stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: launch failed with CUDA error {err} (B={B}, F={F}, "
            f"H={H}, {x.dtype}, {h.dtype}, {c.dtype})")
    lstm_cell.launches += 1
    return h_out, c_out


lstm_cell.launches = 0
