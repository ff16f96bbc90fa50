"""The LSTM kernels on the card: the wrappers around ``csrc/*.cu``.

Four hand-written CUDA kernels, each replacing a Pallas TPU kernel of
``src/repro/kernels/lstm_cell/kernel.py`` (see the sources for the design):

* ``lstm_cell`` (``csrc/lstm_cell.cu``) replaces ``lstm_cell``: one step,
  x (B,F), h and c (B,H), each float32 or bfloat16, and wx (F,4H),
  wh (H,4H), b (4H) -> (h', c'), h' in ``h.dtype`` and c' in ``c.dtype``.
  The step of the per-step baseline ``ops.lstm_sequence_scan``.  A block
  owns a few batch rows and up to 128 hidden units, a thread a gate column,
  the grid one or two blocks an SM: ``cell_tiling`` computes it, the
  wrapper passes it, and the library refuses a tiling it cannot launch.
* ``lstm_sequence_fused`` (``csrc/lstm_sequence.cu: lstm_serve_fwd_kernel``)
  replaces ``lstm_sequence_fused``: x (B,T,F) in float32 or bfloat16, wx
  (F,4H), wh (H,4H) and b (4H) -> the final (h, c), each (B,H) in
  ``x.dtype``.  The serving forward.
* ``lstm_sequence_fwd_train`` (same source, ``lstm_train_fwd_kernel``)
  replaces ``lstm_sequence_fwd_train``: the same inputs -> the residuals the
  backward needs, post-activation gates (B,T,4H) and c_seq, h_seq (B,T,H),
  float32.
  The two forward kernels share one recurrence: a batch row a block, a
  thread a gate column, the input projection taken before the recurrence,
  wx and b staged by a bulk asynchronous copy
  (``ref.lstm_sequence_fwd_train_tiled_ref`` is their order of summation).
* ``lstm_sequence_bwd`` (``csrc/lstm_sequence_bwd.cu``: a reverse-time
  kernel over tiles of batch rows that keeps dz on chip and writes each
  tile's partial weight gradient, then a kernel that sums the partials in
  a fixed order) replaces ``lstm_sequence_bwd``: x, the residuals, the weights
  and the cotangents dh, dc (B,H) of the final state -> dx (B,T,F), dwx
  (F,4H), dwh (H,4H), db (4H), float32.  Reruns on the same inputs are
  bit-identical (no atomics).  ``ref.lstm_sequence_bwd_tiled_ref`` is its
  algorithm, at the tiling ``bwd_tiling`` reports.

The three sequence kernels take a stream axis: x (S,B,T,F) with stacked
weights wx (S,F,4H), wh (S,H,4H), b (S,4H), every output with a leading S,
is one launch over a fleet of S independent LSTMs (a grid axis, as the
reference's ``pallas_call`` gains one under ``jax.vmap``); each stream's
sums are those of a single-stream launch.  A 3-D x with 2-D weights is the
S = 1 case, and its outputs come back without the stream axis.

Compute is float32; gate order i, f, g, o.  The forward wrappers take the
weights in float32 or bfloat16, as the reference's kernels do, and cast
bfloat16 ones to float32 once (exact) before the launch; the sequence
kernels copy a weight that is not 16-byte aligned once (their bulk copies
need the alignment; the models' weights are tensors of their own, aligned,
so the serving and training paths copy nothing).  What bounds them: at the paper's shapes (B of 64 to 256, T=5,
F=5, H=40) a call is a few MFLOP over a few hundred KB, a fraction of a
microsecond at the card's float32 or memory rate, so launch latency and the
serial T-step chain set their time.

Each wrapper checks its inputs, allocates its outputs with ``torch.empty``,
launches on the current CUDA stream, raises when the launch fails, and counts
its successful launches in a plain integer ``.launches`` (one a call,
whatever S, the backward's two kernels included); at S=0 or B=0 it returns
without launching or counting.  The libraries build with ``nvcc`` at the first launch
(``kernels/_build``, which also hashes the ``csrc/*.cuh`` headers beside the
sources); ``LIBRARIES`` names them for a caller that builds them all up
front.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

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
# the card's SMs: the one-step kernel sizes its grid to them
SMS = 132
# the one-step kernel's rows a block (its accumulators a thread), the units
# a block owns at most (four threads each: a 512-thread block), and the
# depth K = F + H up to which a thread holds its weight column in registers
# (kMaxThreads / 4 and kRegK of csrc/lstm_cell.cu)
CELL_ROWS = (1, 2, 4, 8)
CELL_MAX_UNITS = 128
CELL_REG_K = 64


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The forward kernels' library, built (or loaded) at the first call."""
    lib = _build.load_library("lstm_sequence", LIBRARIES["lstm_sequence"])
    lib.lstm_sequence_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lstm_sequence_smem_bytes.restype = ctypes.c_longlong
    lib.lstm_sequence_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.lstm_sequence_forward.restype = ctypes.c_int
    lib.lstm_sequence_forward_train.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.lstm_sequence_backward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def cell_library() -> ctypes.CDLL:
    """The one-step kernel's library, built (or loaded) at the first call."""
    lib = _build.load_library("lstm_cell", LIBRARIES["lstm_cell"])
    lib.lstm_cell_forward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.lstm_cell_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def smem_bytes(F: int, H: int) -> int:
    """Shared memory one block of the forward kernels needs at (F, H), at
    the least (x read from global memory where a chunk of it does not
    fit)."""
    return int(library().lstm_sequence_smem_bytes(F, H))


@functools.lru_cache(maxsize=None)
def bwd_smem_bytes(F: int, H: int) -> int:
    """Shared memory one block of the reverse-time kernel needs at (F, H),
    at its smallest tiling (one row, one step a chunk)."""
    return int(bwd_library().lstm_sequence_bwd_smem_bytes(F, H))


class BwdTiling(NamedTuple):
    """How the reverse-time kernel cuts one stream: batch rows a block,
    steps a chunk of its time loop, lanes a piece of dh is split over (32
    where the lanes hold wh in registers, else the unit's 4), blocks, and
    the floats of the workspace of their partial weight gradients (an
    S-stream call takes S such workspaces, one after another)."""
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


class CellTiling(NamedTuple):
    """How the one-step kernel cuts a call: batch rows and hidden units a
    block, its threads (four a unit: thread p owns gate p % 4 of the tile's
    unit p // 4, for every row of the block) and its grid (row tiles, unit
    tiles)."""
    rows: int
    units: int
    threads: int
    grid: Tuple[int, int]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def cell_tiling(B: int, F: int, H: int, rows: Optional[int] = None
                ) -> CellTiling:
    """The one-step kernel's tiling at (B, F, H).  A block owns all H units
    where 4H <= 512 threads; above that the units are cut into equal tiles
    of at most 128, a multiple of 8 (whole warps).  ``rows`` (1, 2, 4 or 8)
    forces the rows a block.  By default they are the fewest that keep the
    grid within two blocks an SM where K = F + H <= CELL_REG_K (a thread
    holds its weight column in registers and the step is bound by the
    latency of its chain, which more blocks in flight hide), else within
    one wave (the column streams from L2, and every row tile reads all the
    weights again)."""
    if B < 0 or F < 0 or H < 1:
        raise ValueError(f"lstm_cell: need B, F >= 0 and H >= 1, got "
                         f"B={B}, F={F}, H={H}")
    units = H
    if H > CELL_MAX_UNITS:
        units = 8 * _ceil_div(_ceil_div(H, _ceil_div(H, CELL_MAX_UNITS)), 8)
    tiles = _ceil_div(H, units)
    if rows is None:
        most = (2 if F + H <= CELL_REG_K else 1) * SMS
        rows = next((r for r in CELL_ROWS
                     if _ceil_div(B, r) * tiles <= most), CELL_ROWS[-1])
    elif rows not in CELL_ROWS:
        raise ValueError(f"lstm_cell: rows a block must be one of "
                         f"{CELL_ROWS}, got {rows}")
    return CellTiling(rows, units, 4 * units, (_ceil_div(B, rows), tiles))


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


# the streams one launch takes (the grid's y axis)
MAX_STREAMS = 65_535


def _with_streams(x: torch.Tensor, *rest: torch.Tensor):
    """(single, x, *rest) with a leading stream axis: a 3-D x (one LSTM) and
    its arguments gain an S = 1 axis (views, no copy); a 4-D x passes as
    it is.  ``single`` says to drop the axis from the outputs."""
    if x.dim() == 3:
        return (True, x[None], *(t[None] for t in rest))
    return (False, x, *rest)


def _check_forward_inputs(name: str, x: torch.Tensor, wx: torch.Tensor,
                          wh: torch.Tensor, b: torch.Tensor) -> None:
    """Raise unless (x, wx, wh, b), with their stream axis, is what the
    forward kernels take."""
    if x.dim() != 4 or wx.dim() != 3 or wh.dim() != 3 or b.dim() != 2:
        raise ValueError(
            f"{name}: expected x (B,T,F), wx (F,4H), wh (H,4H), b (4H), or "
            f"with a stream axis x (S,B,T,F), wx (S,F,4H), wh (S,H,4H), "
            f"b (S,4H); got {tuple(x.shape)}, {tuple(wx.shape)}, "
            f"{tuple(wh.shape)}, {tuple(b.shape)}")
    S, B, T, F = x.shape
    H = wh.shape[1]
    if (tuple(wx.shape) != (S, F, 4 * H) or tuple(wh.shape) != (S, H, 4 * H)
            or tuple(b.shape) != (S, 4 * H)):
        raise ValueError(
            f"{name}: weight shapes {tuple(wx.shape)}, "
            f"{tuple(wh.shape)}, {tuple(b.shape)} do not match S={S}, F={F}, "
            f"H={H}")
    if T < 1 or H < 1:
        raise ValueError(f"{name}: need T, H >= 1, got {T}, {H}")
    if S > MAX_STREAMS:
        raise ValueError(f"{name}: at most {MAX_STREAMS} streams a launch, "
                         f"got {S}")
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
    into a larger buffer): the bulk copies read 16-byte aligned sources.  A
    stream's slice of a stacked weight is a multiple of 16 bytes, so an
    aligned base aligns every stream."""
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
        S, B, T, F = x.shape
        raise RuntimeError(
            f"{name}: launch failed with CUDA error {err} "
            f"(S={S}, B={B}, T={T}, F={F}, H={H}, {x.dtype})")


def lstm_sequence_fused(x: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                        b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused sequence kernel on the current CUDA stream.

    x (B,T,F), wx (F,4H), wh (H,4H), b (4H), or all with a leading stream
    axis (x (S,B,T,F), wx (S,F,4H), ...), each float32 or bfloat16, all
    contiguous on one CUDA device.  Returns the final (h, c), each (B,H) or
    (S,B,H) in ``x.dtype``.  Raises on anything else, and when the launch
    fails."""
    single, x, wx, wh, b = _with_streams(x, wx, wh, b)
    _check_forward_inputs("lstm_sequence_fused", x, wx, wh, b)
    wx, wh, b = map(_aligned16, f32_weights(wx, wh, b))
    S, B, T, F = x.shape
    H = wh.shape[1]
    h = torch.empty((S, B, H), dtype=x.dtype, device=x.device)
    c = torch.empty((S, B, H), dtype=x.dtype, device=x.device)
    if S and B:  # else nothing to launch, nothing counted
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = library().lstm_sequence_forward(
                x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
                h.data_ptr(), c.data_ptr(), S, B, T, F, H,
                int(x.dtype == torch.bfloat16), stream)
        _raise_on_error("lstm_sequence_fused", err, x, H)
        lstm_sequence_fused.launches += 1
    return (h[0], c[0]) if single else (h, c)


# launches of the kernel since the last reset; only a successful launch counts
lstm_sequence_fused.launches = 0


def lstm_sequence_fwd_train(x: torch.Tensor, wx: torch.Tensor,
                            wh: torch.Tensor, b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch the residual-emitting forward on the current CUDA stream.

    Takes what ``lstm_sequence_fused`` takes.  Returns the post-activation
    gates (B,T,4H) and c_seq, h_seq (B,T,H), all float32, each with a
    leading S where x has one; ``h_seq[..., -1, :]`` is the final hidden
    state.  Raises on anything else, and when the launch fails."""
    single, x, wx, wh, b = _with_streams(x, wx, wh, b)
    _check_forward_inputs("lstm_sequence_fwd_train", x, wx, wh, b)
    wx, wh, b = map(_aligned16, f32_weights(wx, wh, b))
    S, B, T, F = x.shape
    H = wh.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    gates = torch.empty((S, B, T, 4 * H), **f32)
    c_seq = torch.empty((S, B, T, H), **f32)
    h_seq = torch.empty((S, B, T, H), **f32)
    if S and B:  # else nothing to launch, nothing counted
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = library().lstm_sequence_forward_train(
                x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
                gates.data_ptr(), c_seq.data_ptr(), h_seq.data_ptr(), S, B,
                T, F, H, int(x.dtype == torch.bfloat16), stream)
        _raise_on_error("lstm_sequence_fwd_train", err, x, H)
        lstm_sequence_fwd_train.launches += 1
    if single:
        return gates[0], c_seq[0], h_seq[0]
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
    cotangents of the final (h, c); or all with a leading stream axis; all
    but x float32, contiguous, on one CUDA device.  Returns (dx (B,T,F),
    dwx, dwh, db), float32, each with a leading S where x has one: every
    stream's own weight gradients, its partials summed in a fixed order.
    Raises on anything else, and when a launch fails."""
    name = "lstm_sequence_bwd"
    single, x, gates, c_seq, h_seq, wx, wh, dh, dc = _with_streams(
        x, gates, c_seq, h_seq, wx, wh, dh, dc)
    if x.dim() != 4 or wx.dim() != 3 or wh.dim() != 3:
        raise ValueError(f"{name}: expected x (B,T,F), wx (F,4H), wh (H,4H), "
                         f"or with a stream axis x (S,B,T,F), wx (S,F,4H), "
                         f"wh (S,H,4H); got {tuple(x.shape)}, "
                         f"{tuple(wx.shape)}, {tuple(wh.shape)}")
    S, B, T, F = x.shape
    H = wh.shape[1]
    want = {"gates": (gates, (S, B, T, 4 * H)),
            "c_seq": (c_seq, (S, B, T, H)), "h_seq": (h_seq, (S, B, T, H)),
            "wx": (wx, (S, F, 4 * H)), "wh": (wh, (S, H, 4 * H)),
            "dh": (dh, (S, B, H)), "dc": (dc, (S, B, H))}
    for tname, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} is {tuple(t.shape)}, expected "
                             f"{shape} for S={S}, B={B}, T={T}, F={F}, H={H}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
    if T < 1 or H < 1:
        raise ValueError(f"{name}: need T, H >= 1, got {T}, {H}")
    if S > MAX_STREAMS:
        raise ValueError(f"{name}: at most {MAX_STREAMS} streams a launch, "
                         f"got {S}")
    _check_floats(name, (("x", x),))
    _check_placement(name, (x, *(t for t, _ in want.values())))
    need = bwd_smem_bytes(F, H)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{name}: F={F}, H={H} needs {need} bytes of shared memory for "
            f"its weights, more than the {SMEM_LIMIT} a block may use; the "
            f"largest H that fits at F={F} is {max_hidden_bwd(F)}")

    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((S, B, T, F), **f32)
    if S == 0 or B == 0:
        # no rows: zero weight gradients, nothing launched or counted
        grads = (dx, torch.zeros((S, F, 4 * H), **f32),
                 torch.zeros((S, H, 4 * H), **f32),
                 torch.zeros((S, 4 * H), **f32))
    else:
        part = torch.empty((S * bwd_tiling(B, T, F, H).workspace,), **f32)
        wx, wh = _aligned16(wx), _aligned16(wh)
        dwx = torch.empty((S, F, 4 * H), **f32)
        dwh = torch.empty((S, H, 4 * H), **f32)
        db = torch.empty((S, 4 * H), **f32)
        grads = (dx, dwx, dwh, db)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = bwd_library().lstm_sequence_backward(
                x.data_ptr(), gates.data_ptr(), c_seq.data_ptr(),
                h_seq.data_ptr(), wx.data_ptr(), wh.data_ptr(), dh.data_ptr(),
                dc.data_ptr(), dx.data_ptr(), part.data_ptr(), dwx.data_ptr(),
                dwh.data_ptr(), db.data_ptr(), S, B, T, F, H,
                int(x.dtype == torch.bfloat16), stream)
        _raise_on_error(name, err, x, H)
        lstm_sequence_bwd.launches += 1
    return tuple(g[0] for g in grads) if single else grads


lstm_sequence_bwd.launches = 0


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
              rows: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch one fused LSTM step on the current CUDA stream.

    x (B,F), h and c (B,H), wx (F,4H), wh (H,4H), b (4H), each float32 or
    bfloat16, all contiguous on one CUDA device.  Returns (h', c'), h' in
    ``h.dtype`` and c' in ``c.dtype``.  ``rows`` forces the batch rows a
    block (``cell_tiling``), to measure the choice.  Raises on anything
    else, and when the launch fails."""
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
    tiling = cell_tiling(B, F, H, rows)
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
            B, F, H, dtypes, tiling.rows, tiling.units, tiling.threads,
            *tiling.grid, stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: launch failed with CUDA error {err} (B={B}, F={F}, "
            f"H={H}, {x.dtype}, {h.dtype}, {c.dtype}, {tiling})")
    lstm_cell.launches += 1
    return h_out, c_out


lstm_cell.launches = 0
