"""npz checkpointing with path-flattened keys, in the reference's format
(``src/repro/training/checkpoint.py``), so a file written by either package
loads in the other.

Each leaf of a nested dict of tensors is one npz entry, its key the path's
keys joined by ``SEP``; a bfloat16 leaf, which numpy cannot hold, is stored
as its uint16 bits under ``BF16_TAG`` + key.  A step or meta goes to a
``.json`` file beside the ``.npz``.  This is the artifact the paper
synchronizes edge<->cloud: the runtime's model-sync message carries a
``CheckpointHandle`` (path + nbytes).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device

SEP = "::"
BF16_TAG = "__bf16__"  # numpy can't persist bfloat16; store the u16 view


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}

    def visit(keys, x):
        if isinstance(x, dict):
            for k in sorted(x):
                visit(keys + [str(k)], x[k])
        else:
            key = SEP.join(keys)
            if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
                key = BF16_TAG + key
            flat[key] = _host(x)

    visit([], tree)
    return flat


def _unflatten(flat: Dict[str, np.ndarray], device: torch.device) -> Any:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        if k.startswith(BF16_TAG):
            k = k[len(BF16_TAG):]
            t = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(v)
        *parents, leaf = k.split(SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.to(device)
    return tree


@dataclass(frozen=True)
class CheckpointHandle:
    path: str
    nbytes: int
    step: int = 0
    meta: Optional[Dict[str, Any]] = None


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Any, step: int = 0,
         meta: Optional[Dict[str, Any]] = None) -> CheckpointHandle:
    """Write ``tree`` to ``path`` (``.npz`` added if missing), and the step
    and meta to ``path.json`` when either is given."""
    full = _npz(path)
    os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
    flat = _flatten(tree)
    np.savez(full, **flat)
    if meta is not None or step:
        with open(full + ".json", "w") as f:
            json.dump({"step": step, "meta": meta or {}}, f)
    nbytes = sum(v.nbytes for v in flat.values())
    return CheckpointHandle(path=full, nbytes=nbytes, step=step, meta=meta)


def load(path: str, device: Optional[Union[str, torch.device]] = None
         ) -> Any:
    """The nested dict of tensors ``save`` wrote, on ``device`` (the
    current CUDA device unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    with np.load(_npz(path)) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat, dev)


def nbytes_of(tree: Any) -> int:
    """Bytes of every leaf of a nested dict (tensors or arrays)."""
    if isinstance(tree, dict):
        return sum(nbytes_of(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return int(tree.numel()) * tree.element_size()
    return int(np.asarray(tree).nbytes)
