"""The production mesh on one H100.

The reference builds a TPU mesh, (data=16, model=16) = 256 chips or, for
multi-pod, (pod=2, data=16, model=16) = 512, over which
``distributed/sharding.py`` shards params, batches and caches.  The port
runs on one card, where that mesh collapses to one device, as
``sharding.py`` does (it is kept out of the port), so the production mesh
is one H100 and its hardware model.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import H100, HardwareModel


@dataclass(frozen=True)
class Mesh:
    """A named set of chips and their hardware model."""

    name: str
    n_chips: int
    hw: HardwareModel


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """One H100 (``1xH100``).  A multi-pod mesh is refused: it shards over
    ``distributed/sharding.py``, which the port keeps out."""
    if multi_pod:
        raise ValueError(
            "multi-pod meshes shard over distributed/sharding.py, which the "
            "port keeps out: it runs on one H100 (make_production_mesh())")
    return Mesh(name="1xH100", n_chips=1, hw=H100)
