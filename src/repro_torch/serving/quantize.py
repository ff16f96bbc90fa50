"""Int8 weight quantization for edge inference.

The port of ``src/repro/serving/quantize.py``: symmetric per-output-channel
int8 weight quantization, applied to a params tree (floating leaves of 2-D
and up with at least ``min_size`` elements; biases and tiny leaves stay in
float).

    qparams = quantize_tree(params, min_size=64)   # ~3-4x smaller syncs
    params = dequantize_tree(qparams)               # back to float
    y = qmatmul(x, qt)         # kernels.int8_matmul: the fused dequant matmul

``quantize`` is the reference's term for term: the absolute maximum over
every axis but the last, ``max(amax, 1e-12) / 127``, ``round`` (half to even,
as ``jnp.round``), ``clamp(-127, 127)``, int8.  Both divisions are true
divisions by tensors: PyTorch multiplies by a reciprocal when it divides a
CUDA tensor by a Python number, which is one rounding off the reference, so
``q`` and ``scale`` would no longer equal its bit for bit.

Params are nested dicts of tensors, as elsewhere in the port.
``tree_leaves`` visits them in sorted key order and yields a ``QTensor`` as
its ``q`` then its ``scale``: the order of ``jax.tree_util.tree_leaves`` on
the reference's pytree, so checksums (``tree_checksum``, the model sync's
integrity stamp) and byte counts agree leaf for leaf.

A ``FleetParamView`` (one stream of a fleet's stacked fit output) is the
per-stream tree it stands for to every function here; ``tree_checksum``
reads its slice of the fleet's one host copy.  ``quantize_fleet``
quantizes a whole fleet's views in one pass over the stacked tree, each
stream's ``q`` and ``scale`` bit for bit those of its own ``quantize``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.stacked import (
    FleetParamView,
    host_params,
    materialize_params,
)

Params = Any

# leaves smaller than this stay float (norm gains, biases, scalars)
MIN_QUANT_SIZE = 1024


@dataclass(frozen=True)
class QTensor:
    """Symmetric per-channel int8 tensor: w ~ q * scale (last dim = out)."""

    q: torch.Tensor  # int8, the original's shape
    scale: torch.Tensor  # float32, the original's shape[-1:] (2-D)
    orig_dtype: str  # the original's dtype by name, e.g. "float32"

    @property
    def nbytes(self) -> int:
        return int(self.q.numel()) + int(self.scale.numel()) * 4


def quantize(w: torch.Tensor) -> QTensor:
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / torch.tensor(127.0,
                                                        device=w.device)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale[..., 0, :] if w.dim() > 1 else scale,
                   orig_dtype=str(w.dtype).removeprefix("torch."))


def dequantize(qt: QTensor) -> torch.Tensor:
    scale = qt.scale
    while scale.dim() < qt.q.dim():
        scale = scale[None]
    return (qt.q.float() * scale).to(getattr(torch, qt.orig_dtype))


def _is_quantizable(x, min_size: int = MIN_QUANT_SIZE) -> bool:
    return (isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.dim() >= 2 and x.numel() >= min_size)


def _map(fn: Callable[[Any], Any], tree: Params) -> Params:
    """``fn`` over the leaves of nested dicts, a ``QTensor`` being one leaf;
    keys in sorted order."""
    tree = materialize_params(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def quantize_tree(params: Params, min_size: int = MIN_QUANT_SIZE) -> Params:
    """Quantize every floating matrix leaf of at least ``min_size``
    elements; smaller leaves (and all 1-D leaves: biases, norm gains) pass
    through in float.  The speed layer's sync lowers the threshold to 64,
    so the paper's LSTM (7,781 parameters) quantizes its kernel, recurrent
    and dense matrices and keeps its 10-element head in float."""
    return _map(lambda x: quantize(x) if _is_quantizable(x, min_size) else x,
                params)


def _quantize_stacked(w: torch.Tensor) -> QTensor:
    """``quantize`` of every stream of a stacked (S, ..., N) leaf at once:
    the absolute maximum over every axis but the stream axis and the last,
    then the same elementwise steps, so each stream's ``q`` and ``scale``
    are bit for bit its own ``quantize``'s."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, w.dim() - 1)), keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / torch.tensor(127.0,
                                                        device=w.device)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale[..., 0, :],
                   orig_dtype=str(w.dtype).removeprefix("torch."))


def quantize_fleet(params_seq, min_size: int = MIN_QUANT_SIZE) -> list:
    """``quantize_tree`` of each stream of a fleet, batched:
    ``FleetParamView`` handles are grouped by their stacked fit output and each
    group quantizes in one pass over the stacked tree on the device; every
    stream's ``QTensor`` leaves are slices of the result, bit for bit the
    ``q`` and ``scale`` of a per-stream ``quantize_tree``.  Any other tree
    takes ``quantize_tree``."""
    seq = list(params_seq)
    out: list = [None] * len(seq)
    groups: dict = {}
    for i, p in enumerate(seq):
        if isinstance(p, FleetParamView):
            groups.setdefault(id(p.owner), (p.owner, []))[1].append(i)
        else:
            out[i] = quantize_tree(p, min_size)
    for owner, idxs in groups.values():
        # quantizability is a per-stream property: judged on slot 0
        staged = _map(lambda x: _quantize_stacked(x)
                      if _is_quantizable(x[0], min_size) else x,
                      owner.stacked)
        for i in idxs:
            j = seq[i].slot
            out[i] = _map(lambda x: QTensor(q=x.q[j], scale=x.scale[j],
                                            orig_dtype=x.orig_dtype)
                          if isinstance(x, QTensor) else x[j], staged)
    return out


def dequantize_tree(qparams: Params) -> Params:
    return _map(lambda x: dequantize(x) if isinstance(x, QTensor) else x,
                qparams)


def _items(tree: Any) -> Iterator[Any]:
    """Leaves in sorted key order, a ``QTensor`` as one item; ``None`` is an
    empty subtree, as in ``jax.tree_util``."""
    tree = materialize_params(tree)
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _items(v)
    elif tree is not None:
        yield tree


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The arrays of a tree in the reference's order: sorted keys, list and
    tuple items in order, a ``QTensor`` as its ``q`` then its ``scale``."""
    for x in _items(tree):
        if isinstance(x, QTensor):
            yield x.q
            yield x.scale
        else:
            yield x


def _leaf_nbytes(x: Any) -> int:
    """Bytes of one tensor or array, read from its shape and type (a device
    tensor is not copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def tree_nbytes(params: Params) -> int:
    return sum(x.nbytes if isinstance(x, QTensor) else _leaf_nbytes(x)
               for x in _items(params))


def tree_checksum(tree: Any) -> int:
    """CRC32 over every leaf of a params tree, in ``tree_leaves`` order (a
    ``QTensor`` as its int8 ``q`` then its float32 ``scale``, so one bit
    flipped anywhere in an int8 publish changes it).  Each leaf's shape and
    dtype are digested before its bytes, so two leaves with the same bytes
    and another shape or type do not collide.  The training site stamps
    every model publish with it and ``ModelSync`` verifies it; equal to the
    reference's ``runtime.faults.tree_checksum`` on the same tree."""
    tree = host_params(tree)
    c = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(leaf))
        c = zlib.crc32(repr((a.shape, a.dtype.str)).encode(), c)
        c = zlib.crc32(a.tobytes(), c)
    return c


def quantization_error(params: Params) -> Dict[str, float]:
    """Max relative error per quantized leaf (diagnostics): for each leaf
    ``quantize_tree`` would quantize, by its path joined with "/", the
    largest |dequantize(quantize(w)) - w| over the largest |w|."""
    out: Dict[str, float] = {}

    def visit(path, x):
        x = materialize_params(x)
        if isinstance(x, dict):
            for k in sorted(x):
                visit(path + (str(k),), x[k])
        elif _is_quantizable(x):
            xf = x.float()
            back = dequantize(quantize(x)).float()
            denom = torch.clamp(xf.abs().max(), min=1e-12)
            out["/".join(path)] = float((back - xf).abs().max() / denom)

    visit((), params)
    return out
