"""String interning: the bridge from Kubernetes' string-typed world (labels,
taints, ports, images, namespaces) to dense integer ids usable on the device.

Every membership test the reference does with Go maps/sets (label selector
matching, taint toleration, hostPort conflict, image presence) becomes a
multi-hot vector over one of these vocabularies, and set intersection becomes
a matrix product.  Vocabularies are grow-only so ids are stable across
snapshots; tensor widths are padded to power-of-two buckets, which the
placements depend on (the gumbel plane is drawn at the padded node count),
so they match the JAX package's buckets exactly.
"""

from __future__ import annotations

from typing import Dict, Hashable, List


def pow2_bucket(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= max(n, minimum)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class Vocab:
    """Grow-only intern table: hashable key -> stable dense id."""

    __slots__ = ("name", "_ids", "_keys")

    def __init__(self, name: str):
        self.name = name
        self._ids: Dict[Hashable, int] = {}
        self._keys: List[Hashable] = []

    def intern(self, key: Hashable) -> int:
        i = self._ids.get(key)
        if i is None:
            i = len(self._keys)
            self._ids[key] = i
            self._keys.append(key)
        return i

    def get(self, key: Hashable, default: int = -1) -> int:
        """default (-1) if unknown (unknown => can never match anything
        in-cluster).  The explicit default keeps dict-style call sites —
        e.g. table.rname.get(name, -1) for a victim carrying an
        unregistered extended resource — from raising."""
        return self._ids.get(key, default)

    def key(self, i: int) -> Hashable:
        return self._keys[i]

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._ids

    @property
    def cap(self) -> int:
        return pow2_bucket(len(self._keys))


class InternTable:
    """All vocabularies for one cluster.

    kv     : (label_key, label_value) pairs -> id       (axis L)
    key    : label keys -> id                           (axis K)
    port   : (protocol, host_ip, host_port) -> id       (axis P)
    taint  : (key, value, effect) -> id                 (axis T)
    image  : normalized image name -> id                (axis I)
    ns     : namespace -> id                            (axis NS)
    rname  : extended/scalar resource name -> id        (scalar channels)
    topokey: topology label keys in active use -> id    (axis TK)

    topokey is a *small* subset of `key`: only keys named by topology spread
    constraints or pod (anti-)affinity terms, plus the well-known
    zone/region/hostname keys — so the per-node (key -> label-value-id)
    matrix stays [N, TK] with TK tiny instead of [N, K].
    """

    def __init__(self):
        self.kv = Vocab("kv")
        self.key = Vocab("key")
        self.port = Vocab("port")
        self.taint = Vocab("taint")
        self.image = Vocab("image")
        self.ns = Vocab("ns")
        self.rname = Vocab("rname")
        self.topokey = Vocab("topokey")
        self.zone = Vocab("zone")    # GetZoneKey strings (region:zone)
        self.avoid = Vocab("avoid")  # (controller kind, uid) pairs from
                                     # preferAvoidPods annotations
