"""Flash attention on the card: the wrapper around ``csrc/``.

``flash_attention`` replaces the Pallas TPU kernel of
``src/repro/kernels/flash_attention/kernel.py``: grouped-query attention
over explicit positions, q (B,Sq,Hq,D) against k, v (B,Sk,Hkv,D) in float32
or bfloat16, ``q_pos`` (B,Sq) and ``kv_pos`` (B,Sk) int32 with -1 on an
unwritten slot, causal and an optional sliding window; the output is
(B,Sq,Hq,D) in q's dtype, the statistics float32.  What bounds it: the
bytes of q, k, v and o at the served shapes (see the sources for each
design and its distance from the bound).

One library holds three kernels, and every call launches exactly one of
them, by ``kernel_for``:

- ``decode_split`` (``csrc/flash_decode.cu``): Sq * G <= 64 rows a KV
  head, float32 or bf16, rows of 16-byte multiples -- every decode step.
  A split over Sk of 64 keys a block, combined in split order by the last
  block to finish;
- ``prefill_wgmma`` (``csrc/flash_prefill.cu``): otherwise bf16 with
  D % 8 == 0 -- the bf16 prefill on the tensor cores, K and V through TMA
  (above D = 128 two blocks a row block, each with half the output
  columns);
- ``simt`` (``csrc/flash_attention.cu``): everything else (a float32
  prefill, rows that are not 16-byte multiples), on the CUDA cores in
  float32.

The gradient is a second library, two routes of two kernels each,
launched in turn by ``flash_attention_backward``; ``bwd_kernel_for``
picks the route, as ``kernel_for`` the forward's kernel:

- ``wgmma`` (``csrc/flash_backward_wgmma.cu``): bf16 with D % 8 == 0 --
  every bf16 training step -- on the tensor cores, fed by TMA:
  ``bwd_dq_wgmma`` (dQ, and each row's lse and delta into scratch laid out
  by ``bwd_tiling``'s row tiles) and ``bwd_dkdv_wgmma`` (dK and dV, a
  block a tile of 64 keys and a run of its live row tiles; with more than
  one run the last block of a key tile to arrive sums the runs' partials
  in run order, elected by an arrival counter in the split decode's
  buffer);
- ``simt`` (``csrc/flash_backward.cu``): everything else (float32, rows
  that are not 16-byte multiples), on the CUDA cores in float32: ``bwd_dq``
  and ``bwd_dkdv`` (the group's query heads summed in-kernel).

Neither route changes the forward: both recompute the softmax statistics
from q and k.

The wrapper checks its inputs, allocates the output and the split
decode's scratch with ``torch.empty``, copies a view that does not start
on 16 bytes where the kernel loads 16-byte vectors, launches on the
current CUDA stream, raises when the launch fails, and counts its
successful launches in ``.launches`` and by kernel in
``.launches_by_kernel``; with no query rows it returns without launching
or counting.  The arrival counters of the split decode and of
``bwd_dkdv_wgmma`` live in one buffer a (device, stream), zeroed once and
left zero by every call.  The library builds with ``nvcc`` at the first
launch (``kernels/_build``); ``LIBRARIES`` names both libraries for a
caller that builds every library up front.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
PREFILL_SOURCE = CSRC / "flash_prefill.cu"
DECODE_SOURCE = CSRC / "flash_decode.cu"
BWD_SOURCE = CSRC / "flash_backward.cu"
BWD_WGMMA_SOURCE = CSRC / "flash_backward_wgmma.cu"
# every library of this package: name -> its sources
LIBRARIES = {"flash_attention": [SOURCE, PREFILL_SOURCE, DECODE_SOURCE],
             "flash_backward": [BWD_SOURCE, BWD_WGMMA_SOURCE]}
# the kernels' largest head dim (PaliGemma's 256), and the SIMT kernel's
# rows per block
MAX_HEAD_DIM = 256
BLOCK_ROWS = 64
# the split decode takes calls of at most this many (query, head) rows a
# KV head, and splits the keys in runs of DECODE_SPLIT
DECODE_MAX_ROWS = 64
DECODE_SPLIT = 64
# the kernels by name, as the C entry point numbers them
KERNELS = {"simt": 0, "prefill_wgmma": 1, "decode_split": 2}
# the backward's routes, each two kernels launched in this order, and
# every backward kernel by name
BWD_ROUTES = {"wgmma": ("bwd_dq_wgmma", "bwd_dkdv_wgmma"),
              "simt": ("bwd_dq", "bwd_dkdv")}
BWD_KERNELS = ("bwd_dq", "bwd_dkdv", "bwd_dq_wgmma", "bwd_dkdv_wgmma")
# the tensor-core backward's tiles: keys a K/V tile (a bwd_dkdv block), rows
# of a bwd_dkdv row tile at most, and the blocks bwd_dkdv aims at: two
# waves of an H100's 132 SMs
BWD_KEYS = 64
BWD_TILE_ROWS = 64
BWD_MIN_BLOCKS = 2 * 132


def bwd_kernel_for(D: int, dtype: torch.dtype) -> str:
    """The backward's route for rows of D elements of ``dtype``:
    ``wgmma`` for bf16 with D % 8 == 0 (TMA needs 16-byte rows), ``simt``
    for everything else, as ``kernel_for`` splits the forward."""
    return "wgmma" if dtype == torch.bfloat16 and D % 8 == 0 else "simt"


class BwdTiling(NamedTuple):
    """The tensor-core backward's geometry for one call (``bwd_tiling``)."""
    gb: int            # heads of a row tile
    qt: int            # queries of a row tile
    head_tiles: int    # row tiles across one query run's G heads
    row_tiles: int     # row tiles of a (batch, KV head)
    key_tiles: int     # tiles of BWD_KEYS keys
    panels: int        # 64-column panels of D (1, 2 or 4)
    split: int         # blocks sharing a tile's output columns (2 at 4)
    runs: int          # blocks of bwd_dkdv a key tile (and panel half)
    dq_blocks: int
    dkdv_blocks: int
    stats_numel: int   # floats of the (lse, delta) scratch
    partial_numel: int  # floats of bwd_dkdv's partials (0 with one run)
    counters: int      # arrival counters (0 with one run)


def bwd_tiling(B: int, Sq: int, Sk: int, Hq: int, Hkv: int,
               D: int) -> BwdTiling:
    """How ``bwd_dq_wgmma`` and ``bwd_dkdv_wgmma`` cut a call
    (``csrc/flash_backward_wgmma.cu``).  Row tiles of a KV head's Sq G
    (query, head) rows: gb heads x qt queries, all G heads of 64 // G
    queries when G <= 64, else 64 heads of one query; their (lse, delta)
    pairs are laid out 64 a tile.  bwd_dkdv's grid is (key tiles x split x
    runs, Hkv, B): ``runs``, the least that gives BWD_MIN_BLOCKS blocks,
    at most the row tiles, splits each key tile's n live row tiles into
    runs of equal count (run r takes [n r / runs, n (r + 1) / runs)), each
    run's f32 partial dK and dV (2 x 64 keys x 64 columns a panel of its
    block) summed by the last to arrive, counted on one counter a (batch,
    KV head, key tile, half).
    bwd_dq's blocks hold 128 rows (64 at D > 128) of one (batch, KV head),
    ``split`` a row block."""
    G = Hq // Hkv
    gb = min(G, BWD_TILE_ROWS)
    qt = BWD_TILE_ROWS // G if G <= BWD_TILE_ROWS else 1
    head_tiles = -(-G // gb)
    row_tiles = -(-Sq // qt) * head_tiles
    key_tiles = -(-Sk // BWD_KEYS)
    panels = 1 if D <= 64 else 2 if D <= 128 else 4
    split = 2 if panels == 4 else 1
    units = B * Hkv * key_tiles * split
    runs = max(1, min(row_tiles, -(-BWD_MIN_BLOCKS // max(units, 1))))
    dq_rows = 128 if panels <= 2 else 64
    dq_blocks = -(-Sq * G // dq_rows) * split * Hkv * B
    per_run = 2 * BWD_KEYS * 64 * (panels // split)
    return BwdTiling(
        gb=gb, qt=qt, head_tiles=head_tiles, row_tiles=row_tiles,
        key_tiles=key_tiles, panels=panels, split=split, runs=runs,
        dq_blocks=dq_blocks, dkdv_blocks=units * runs,
        stats_numel=2 * BWD_TILE_ROWS * row_tiles * B * Hkv,
        partial_numel=units * runs * per_run if runs > 1 else 0,
        counters=units if runs > 1 else 0)


def kernel_for(Sq: int, Hq: int, Hkv: int, D: int,
               dtype: torch.dtype) -> str:
    """The kernel that takes a call whose rows are D elements of
    ``dtype``: where a row is a 16-byte multiple (D % 8 == 0 in bf16,
    D % 4 == 0 in float32), ``decode_split`` for Sq * (Hq/Hkv) <= 64 rows
    a KV head and otherwise, in bf16, ``prefill_wgmma`` (both load rows in
    16-byte pieces, and TMA needs 16-byte strides); everything else
    ``simt``."""
    row16 = D * (2 if dtype == torch.bfloat16 else 4) % 16 == 0
    if row16 and Sq * (Hq // Hkv) <= DECODE_MAX_ROWS:
        return "decode_split"
    if row16 and dtype == torch.bfloat16:
        return "prefill_wgmma"
    return "simt"


def decode_scratch_numel(B: int, Sq: int, Sk: int, Hq: int, Hkv: int,
                         D: int) -> int:
    """Floats of the split decode's scratch: (m, l, acc[D]) for each of the
    B * Hkv * Sq * G rows and each split of DECODE_SPLIT keys."""
    splits = max(1, -(-Sk // DECODE_SPLIT))
    return B * Sq * Hq * splits * (D + 2)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' library, built (or loaded) at the first call."""
    lib = _build.load_library("flash_attention",
                              LIBRARIES["flash_attention"])
    lib.flash_attention_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    lib.flash_attention_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """The backward's library, built (or loaded) at the first call."""
    lib = _build.load_library("flash_backward", LIBRARIES["flash_backward"])
    shape = [ctypes.c_int] * 8 + [ctypes.c_float]
    for fn in (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkdv):
        fn.argtypes = ([ctypes.c_void_p] * 10 + shape
                       + [ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_bwd_dq_wgmma.argtypes = (
        [ctypes.c_void_p] * 9 + shape + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.flash_attention_bwd_dkdv_wgmma.argtypes = (
        [ctypes.c_void_p] * 11 + shape + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    for fn in (lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkdv,
               lib.flash_attention_bwd_dq_wgmma,
               lib.flash_attention_bwd_dkdv_wgmma):
        fn.restype = ctypes.c_int
    return lib


# (device, stream) -> the arrival counters of the split decode and of
# bwd_dkdv_wgmma (int32, all zero between calls): calls on one stream run
# in order, and two in flight on two streams must not share a buffer
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


def _check(name, q, k, v, q_pos, kv_pos):
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_pos: torch.Tensor, kv_pos: torch.Tensor, *, kernel: str,
            causal: bool = True, window: int = 0,
            scale: Optional[float] = None,
            p_bf16: bool = False) -> torch.Tensor:
    """Check the inputs as ``flash_attention`` does, launch the named
    kernel (a key of ``KERNELS``) whatever ``kernel_for`` would pick, and
    return the output; counts nothing.  For ``chip_smoke.py``, which times
    one kernel against another at one shape; the port's path never calls
    it.  Raises when the kernel cannot take the call or the launch
    fails."""
    _check("flash_attention", q, k, v, q_pos, kv_pos)
    return _run(q, k, v, q_pos, kv_pos, kernel, causal, window, scale,
                p_bf16)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _run(q, k, v, q_pos, kv_pos, kernel, causal, window, scale, p_bf16):
    """The launch itself, on inputs ``_check`` has passed."""
    name = "flash_attention"
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return o
    # the two Hopper kernels read q, k and v in pieces of up to 16 bytes
    # (TMA, vector loads) from 16-byte aligned starts; a view that starts
    # elsewhere is copied once
    if kernel != "simt":
        q, k, v = (_aligned(t) for t in (q, k, v))
    scale = D**-0.5 if scale is None else float(scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = counters = None
        if kernel == "decode_split":
            scratch = torch.empty(
                decode_scratch_numel(B, Sq, Sk, Hq, Hkv, D),
                dtype=torch.float32, device=q.device)
            counters = _counters(q.device, stream, B * Hkv)
        err = library().flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), o.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
            int(causal), int(window), scale, int(q.dtype == torch.bfloat16),
            int(p_bf16), KERNELS[kernel],
            None if scratch is None else scratch.data_ptr(),
            None if counters is None else counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch of {kernel} failed with CUDA "
                           f"error {err} (B={B}, Sq={Sq}, Sk={Sk}, Hq={Hq}, "
                           f"Hkv={Hkv}, D={D}, {q.dtype})")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    p_bf16: bool = False) -> torch.Tensor:
    """Launch the kernel ``kernel_for`` picks on the current CUDA stream.

    q (B,Sq,Hq,D), k and v (B,Sk,Hkv,D), one dtype (float32 or bfloat16);
    q_pos (B,Sq) and kv_pos (B,Sk) int32; all contiguous on one CUDA
    device; Hq a multiple of Hkv and D <= 256.  ``scale`` defaults to
    D**-0.5; ``p_bf16`` rounds p and v to bf16 before the P V product (the
    reference's ``attend(p_dtype=bfloat16)``).  Returns (B,Sq,Hq,D) in q's
    dtype.  Raises on anything else, and when the launch fails."""
    _check("flash_attention", q, k, v, q_pos, kv_pos)
    B, Sq, Hq, D = q.shape
    which = kernel_for(Sq, Hq, k.shape[2], D, q.dtype)
    o = _run(q, k, v, q_pos, kv_pos, which, causal, window, scale, p_bf16)
    if B and Sq:
        flash_attention.launches += 1
        flash_attention.launches_by_kernel[which] += 1
    return o


# launches since the last reset, in all and by kernel; only a successful
# launch counts
flash_attention.launches = 0
flash_attention.launches_by_kernel = dict.fromkeys(KERNELS, 0)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, q_pos: torch.Tensor,
                             kv_pos: torch.Tensor, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None,
                             kernel: Optional[str] = None,
                             stats_fill: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v, q_pos, kv_pos, causal=,
    window=, scale=)`` whose output was ``o``, for the output's gradient
    ``do``: the two kernels of the route ``bwd_kernel_for`` picks, dQ's
    then dK's and dV's, on the current CUDA stream.

    q, o, do (B,Sq,Hq,D) and k, v (B,Sk,Hkv,D) in one dtype (float32 or
    bfloat16), positions int32, all contiguous on one CUDA device, as the
    forward takes them; p in float32 (there is no backward of
    ``p_bf16``).  The gradients come back in the inputs' dtype, computed
    in float32 (the ``wgmma`` route's products from bf16 operands, P and
    dS as hi + lo parts); a row that attends no slot gets zero.
    ``kernel`` ("wgmma" or "simt") forces a route, for ``chip_smoke.py``,
    which times one route against the other; the port's path never passes
    it.  ``stats_fill`` fills the statistics scratch with a value before
    the launches (``torch.empty`` leaves whatever the allocator hands
    back), for ``chip_smoke.py``'s check that a slot no kernel writes never
    reaches the gradients; the port's path never passes it either.  Raises
    on anything else, when the forced route cannot take the call, and when
    a launch fails.  With no query rows nothing launches
    (dk and dv are zero); with no keys only the dQ kernel does."""
    name = "flash_attention_backward"
    D = q.shape[-1]
    route = bwd_kernel_for(D, q.dtype) if kernel is None else kernel
    if route not in BWD_ROUTES or (
            route == "wgmma" and bwd_kernel_for(D, q.dtype) != "wgmma"):
        raise ValueError(f"{name}: route {kernel!r} cannot take D={D} "
                         f"{q.dtype} (routes: {sorted(BWD_ROUTES)})")
    _check(name, q, k, v, q_pos, kv_pos)
    for what, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"{tuple(q.shape)} {q.dtype} tensor on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    scale = D**-0.5 if scale is None else float(scale)
    shape = (B, Sq, Sk, Hq, Hkv, D, int(causal), int(window), scale)
    lib = bwd_library()

    def scratch(*size):
        t = torch.empty(size, dtype=torch.float32, device=q.device)
        return t if stats_fill is None else t.fill_(stats_fill)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
            tl = bwd_tiling(B, Sq, Sk, Hq, Hkv, D)
            stats = scratch(tl.stats_numel)
            partial = counters = None
            if tl.runs > 1:
                partial = torch.empty(tl.partial_numel, dtype=torch.float32,
                                      device=q.device)
                counters = _counters(q.device, stream, tl.counters)
            tiles = (tl.gb, tl.qt, tl.row_tiles)
            launches = (
                (lib.flash_attention_bwd_dq_wgmma,
                 (q, k, v, o, do, q_pos, kv_pos, dq, stats), tiles),
                (lib.flash_attention_bwd_dkdv_wgmma,
                 (q, k, v, do, q_pos, kv_pos, stats, dk, dv, partial,
                  counters), (*tiles, tl.runs)))
        else:
            # each (query, head) row's lse and delta, written by bwd_dq
            lse, delta = scratch(2, B * Sq * Hq)
            is_bf16 = (int(q.dtype == torch.bfloat16),)
            launches = (
                (lib.flash_attention_bwd_dq,
                 (q, k, v, o, do, q_pos, kv_pos, dq, lse, delta), is_bf16),
                (lib.flash_attention_bwd_dkdv,
                 (q, k, v, do, q_pos, kv_pos, lse, delta, dk, dv), is_bf16))
        for kname, (fn, tensors, extra) in zip(BWD_ROUTES[route],
                                               launches[:2 if Sk else 1]):
            err = fn(*(None if t is None else t.data_ptr() for t in tensors),
                     *shape, *extra, stream)
            if err != 0:
                raise RuntimeError(
                    f"{name}: launch of {kname} failed with CUDA error {err} "
                    f"(B={B}, Sq={Sq}, Sk={Sk}, Hq={Hq}, Hkv={Hkv}, D={D}, "
                    f"{q.dtype})")
            flash_attention_backward.launches += 1
            flash_attention_backward.launches_by_kernel[kname] += 1
    return dq, dk, dv


# launches since the last reset, in all and by kernel; only a successful
# launch counts
flash_attention_backward.launches = 0
flash_attention_backward.launches_by_kernel = dict.fromkeys(BWD_KERNELS, 0)
