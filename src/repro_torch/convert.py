"""Carry weights between the reference and the port.

The reference's params are a nested dict of arrays; as numpy
(``jax.tree_util.tree_map(np.asarray, params)``) they become the port's
nested dict of tensors leaf by leaf, with the same keys, shapes and dtypes.
A round trip is exact.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_numpy(tree: Mapping[str, Any],
                      device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return {k: params_from_numpy(v, dev) if isinstance(v, Mapping)
            else torch.from_numpy(np.array(v)).to(dev)
            for k, v in tree.items()}


def params_to_numpy(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> nested dict of numpy arrays on the host."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping)
            else v.detach().cpu().numpy()
            for k, v in tree.items()}
