"""Carry weights between the reference and the port.

The reference's params are a nested dict of arrays; as numpy
(``jax.tree_util.tree_map(np.asarray, params)``) they become the port's
nested dict of tensors leaf by leaf, with the same keys, shapes and dtypes.
A round trip is exact, bfloat16 included.

A JAX bfloat16 array becomes a numpy array of the ``bfloat16`` extension
type of ``ml_dtypes``, which ``torch.from_numpy`` rejects.  The port does
not import ``ml_dtypes``: it recognises the type by its name, carries the
16-bit patterns as ``uint16`` and reinterprets them as ``torch.bfloat16``.
The way back needs numpy to know the type, which it does wherever
``ml_dtypes`` was loaded (as it is beside JAX).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf_to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    elif device.type != "cpu" and a.flags.writeable:
        # no host copy: the move onto the device copies (a parity tree is
        # tens of GB)
        t = torch.from_numpy(np.ascontiguousarray(a))
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _tensor_to_leaf(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError("numpy has no bfloat16 type in this process "
                            "(it comes with ml_dtypes); convert the tree "
                            "with .float() first") from e
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def params_from_numpy(tree: Mapping[str, Any],
                      device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return {k: params_from_numpy(v, dev) if isinstance(v, Mapping)
            else _leaf_to_tensor(v, dev)
            for k, v in tree.items()}


def params_to_numpy(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> nested dict of numpy arrays on the host."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping)
            else _tensor_to_leaf(v)
            for k, v in tree.items()}
