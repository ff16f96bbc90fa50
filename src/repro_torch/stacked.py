"""One stream's params inside a fleet's stacked fit output.

``FleetForecaster`` (``training.compiled``, which re-exports these names)
trains a fleet in one stacked tree, every leaf with a leading stream axis,
and hands each stream a ``FleetParamView`` of it.  The reference registers its view as a pytree, so
every tree function sees through it; here the tree functions that take a
params tree (``training.optimizer.tree_leaves``/``tree_map``,
``serving.quantize``'s, ``FleetState.handoff``) resolve a view with
``materialize_params``.  This module imports nothing of the port, so those
modules can.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

Params = Any


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


class _FleetStack:
    """Owner of one fleet fit's stacked params on the device.  ``stacked``
    keeps the leading stream-bucket axis; views slice it, and a host copy of
    it is made once, however many of its streams need one."""

    __slots__ = ("stacked", "_host")

    def __init__(self, stacked: Params):
        self.stacked = stacked
        self._host: Optional[Params] = None

    def dim(self) -> int:
        """The stream slots of the stack (the bucket, padded slots too)."""
        node = self.stacked
        while isinstance(node, dict):
            node = node[sorted(node)[0]]
        return int(node.shape[0])

    def host(self) -> Params:
        """The stacked tree as numpy arrays on the host (cached): one copy
        off the device per leaf for the whole fleet."""
        if self._host is None:
            self._host = _tree_map(lambda t: t.detach().cpu().numpy(),
                                   self.stacked)
        return self._host


class FleetParamView:
    """Stream ``slot`` of a stacked fit output.  ``tree()`` is its params
    tree on the device, slices of the stacked leaves (no copy), and
    ``host_tree()`` its numpy slices of the owner's one host copy, for a
    publish boundary (a checksum, bytes on the wire).  ``predict_fleet``
    recognizes sibling views of one owner and serves the stacked tree as it
    is.  A view keeps its owner's whole stacked tree alive."""

    __slots__ = ("owner", "slot", "_tree")

    def __init__(self, owner: _FleetStack, slot: int):
        self.owner = owner
        self.slot = slot
        self._tree: Optional[Dict[str, Any]] = None

    def tree(self) -> Params:
        if self._tree is None:
            j = self.slot
            self._tree = _tree_map(lambda t: t[j], self.owner.stacked)
        return self._tree

    def host_tree(self) -> Params:
        j = self.slot
        return _tree_map(lambda a: a[j], self.owner.host())

    # the per-stream tree's mapping surface, for callers that index params
    def __getitem__(self, key):
        return self.tree()[key]

    def keys(self):
        return self.tree().keys()

    def values(self):
        return self.tree().values()


def materialize_params(params: Params) -> Params:
    """A ``FleetParamView`` as its per-stream tree on the device; anything
    else as it is."""
    return params.tree() if isinstance(params, FleetParamView) else params


def host_params(params: Params) -> Params:
    """A ``FleetParamView`` as its per-stream tree on the host (numpy slices
    of its owner's one host copy); anything else as it is."""
    return params.host_tree() if isinstance(params, FleetParamView) \
        else params
