"""Zone-aware node tree: nodes grouped by zone, iterated round-robin so
adjacent list positions interleave zones (reference:
pkg/scheduler/internal/cache/node_tree.go:31 nodeTree — the ordering
becomes the node-tensor row permutation in the tensor snapshot)."""

from __future__ import annotations

from typing import Dict, List

from ..api import types as api
from .tensors import zone_key


class NodeTree:
    def __init__(self):
        self._zones: List[str] = []
        self._tree: Dict[str, List[str]] = {}
        self.num_nodes = 0

    def add_node(self, node: api.Node) -> None:
        # reference: node_tree.go:59 addNode
        zone = zone_key(node)
        names = self._tree.get(zone)
        if names is None:
            self._zones.append(zone)
            names = self._tree[zone] = []
        if node.name not in names:
            names.append(node.name)
            self.num_nodes += 1

    def remove_node(self, node: api.Node) -> bool:
        # reference: node_tree.go:87 removeNode
        zone = zone_key(node)
        names = self._tree.get(zone, [])
        if node.name in names:
            names.remove(node.name)
            self.num_nodes -= 1
            if not names:
                del self._tree[zone]
                self._zones.remove(zone)
            return True
        return False

    def update_node(self, old: api.Node, new: api.Node) -> None:
        # reference: node_tree.go:113 updateNode
        if old is not None and zone_key(old) == zone_key(new):
            return
        if old is not None:
            self.remove_node(old)
        self.add_node(new)

    def list(self) -> List[str]:
        """Round-robin over zones (reference: node_tree.go:135 next — the
        iterator state is reset per full listing here since the snapshot
        consumes the whole list)."""
        idx = {z: 0 for z in self._zones}
        out: List[str] = []
        exhausted = 0
        zi = 0
        n_zones = len(self._zones)
        while n_zones and exhausted < n_zones:
            z = self._zones[zi % n_zones]
            i = idx[z]
            if i < len(self._tree[z]):
                out.append(self._tree[z][i])
                idx[z] += 1
                if idx[z] == len(self._tree[z]):
                    exhausted += 1
            zi += 1
        return out
