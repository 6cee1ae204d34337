"""Cluster snapshot tensorization: NodeInfos -> dense device tensors.

The analog of the reference's scheduler cache snapshot (reference:
pkg/scheduler/internal/cache/snapshot.go:29 Snapshot, cache.go:202
UpdateSnapshot): the cluster becomes a struct-of-arrays over the node axis
(plus an existing-pods axis for affinity/spread) that the auction reads.
All strings are interned (utils/intern.py); all set membership is
multi-hot.  The numpy builder is the JAX package's, unchanged, so the pad
buckets (N, PP, MLn/MLp, Et) and every array match it exactly: the
selectHost gumbel plane is drawn at the padded N, so a different pad
would change tie-breaks and with them placements.

Unit conventions (every value the scheduler compares is exact in f32):
  channel 0: CPU millicores          (raw int value)
  channel 1: memory MiB              (bytes / 2^20; exact for Mi-granular values)
  channel 2: ephemeral-storage MiB
  channel 3: pod count / max pods
  channel 4+: scalar (extended) resources, raw integer value, one channel
              per interned resource name.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..api import types as api
from ..api.resource import Resource
from ..framework.types import NodeInfo, PodInfo
from ..ops.selectors import (FIELD_PREFIX, SelectorCompiler, SelectorSet,
                             selector_to_device)
from ..utils.device import copy_to
from ..utils.intern import InternTable, pow2_bucket

MIB = float(2 ** 20)

# fixed channels
CH_CPU, CH_MEM, CH_EPH, CH_PODS = 0, 1, 2, 3
N_FIXED_CHANNELS = 4


def resource_to_channels(r: Resource, table: InternTable, R: int,
                         intern_new: bool = True) -> np.ndarray:
    out = np.zeros((R,), np.float32)
    out[CH_CPU] = r.milli_cpu
    out[CH_MEM] = r.memory / MIB
    out[CH_EPH] = r.ephemeral_storage / MIB
    out[CH_PODS] = r.allowed_pod_number
    for name, v in r.scalar_resources.items():
        i = table.rname.intern(name) if intern_new else table.rname.get(name)
        ch = N_FIXED_CHANNELS + i
        if 0 <= i and ch < R:
            out[ch] = v
    return out


class ExistingTerms(NamedTuple):
    """Flattened (anti-)affinity terms owned by *existing* pods, matched
    against incoming pods: one instance for filtering (required
    anti-affinity, interpodaffinity/filtering.go:166) and one for scoring
    (preferred +w / -w and required-affinity x hardWeight,
    interpodaffinity/scoring.go:128)."""
    sel: SelectorSet           # [Et] selectors over incoming-pod labels
    ns_hot: torch.Tensor       # [Et, NS] f32 — namespaces the term applies to
    topo_key: torch.Tensor     # [Et] i32 index into topokey axis
    pod_idx: torch.Tensor      # [Et] i32 owning existing-pod row
    weight: torch.Tensor       # [Et] f32 (signed; 1.0 for filter terms)
    valid: torch.Tensor        # [Et] bool


class ClusterTensors(NamedTuple):
    """One device-side cluster snapshot (torch tensors)."""
    # node axis ------------------------------------------------------------
    allocatable: torch.Tensor        # [N, R] f32
    requested: torch.Tensor          # [N, R] f32
    nonzero_requested: torch.Tensor  # [N, 2] f32 (cpu milli, mem MiB)
    node_valid: torch.Tensor         # [N] bool
    unschedulable: torch.Tensor      # [N] bool (.spec.unschedulable)
    kv: torch.Tensor                 # [N, L] bool — node has label (k,v)
    keymask: torch.Tensor            # [N, K] bool — node has label key
    num: torch.Tensor                # [N, K] f32 numeric label value
                                     #   (+inf when absent/non-numeric)
    topo_pair: torch.Tensor          # [N, TK] i32 kv id of (topokey, value), -1 absent
    taints: torch.Tensor             # [N, T] bool
    ports: torch.Tensor              # [N, P] bool
    images: torch.Tensor             # [N, I] bool
    avoid_hot: torch.Tensor          # [N, AV] bool preferAvoidPods entries
    zone_hot: torch.Tensor           # [N, Z] f32 one-hot over the zone vocab
    # vocab-side metadata ---------------------------------------------------
    taint_is_hard: torch.Tensor      # [T] bool (NoSchedule | NoExecute)
    taint_is_prefer: torch.Tensor    # [T] bool (PreferNoSchedule)
    image_size: torch.Tensor         # [I] f32 bytes
    image_spread: torch.Tensor       # [I] f32 fraction of nodes having the image
    # existing pods axis ----------------------------------------------------
    pod_kv: torch.Tensor             # [P, L] bool
    pod_key: torch.Tensor            # [P, K] bool
    pod_ns_hot: torch.Tensor         # [P, NS] f32 one-hot
    pod_node: torch.Tensor           # [P] i32 node row (-1 invalid)
    pod_valid: torch.Tensor          # [P] bool
    pod_terminating: torch.Tensor    # [P] bool (deletionTimestamp set)
    # existing pods' terms --------------------------------------------------
    filter_terms: ExistingTerms      # required anti-affinity (filter)
    score_terms: ExistingTerms       # preferred +/-, required x hardWeight (score)

    @property
    def n_nodes_cap(self) -> int:
        return self.allocatable.shape[0]


def _terms_to_device(t: ExistingTerms, device) -> ExistingTerms:
    return ExistingTerms(
        sel=selector_to_device(t.sel, device),
        **{f: copy_to(getattr(t, f), device)
           for f in ExistingTerms._fields if f != "sel"})


class HostClusterArrays(NamedTuple):
    """Numpy twin of ClusterTensors (what the builder fills).

    The two label one-hots (kv [N, L], pod_kv [P, L]) are held COMPACT as
    [., ML] i32 id lists and densified on the device by to_device."""
    arrays: dict

    def to_device(self, device) -> ClusterTensors:
        """Copy every array to ``device``.  Always a copy, never a view of
        the host arrays: an aliased mirror lets a later in-place update on
        either side corrupt the other (the reference hit exactly that with
        a zero-copy upload)."""
        a = self.arrays
        L = a["_kv_cap"]
        vals = {}
        for f in ClusterTensors._fields:
            if f in ("kv", "pod_kv"):
                continue
            if f in ("filter_terms", "score_terms"):
                vals[f] = _terms_to_device(a[f], device)
            else:
                vals[f] = copy_to(a[f], device)
        vals["kv"] = _densify_ids(copy_to(a["_kv_ids"], device), L)
        vals["pod_kv"] = _densify_ids(copy_to(a["_pod_kv_ids"], device), L)
        return ClusterTensors(**vals)


def _densify_ids(ids: torch.Tensor, L: int) -> torch.Tensor:
    """[X, ML] i32 id lists (-1 pad) -> [X, L] bool multi-hot."""
    X = ids.shape[0]
    ok = (ids >= 0) & (ids < L)
    cols = torch.where(ok, ids.long(), torch.full_like(ids.long(), L))
    out = torch.zeros((X, L + 1), dtype=torch.bool, device=ids.device)
    out.scatter_(1, cols, True)
    return out[:, :L].contiguous()


def cluster_from_numpy(d, device) -> ClusterTensors:
    """Build ClusterTensors from the leaves of a JAX-package ClusterTensors
    given as a (nested) dict of numpy arrays with the same field names —
    the tests feed both packages identical state this way."""
    def terms(x) -> ExistingTerms:
        x = dict(x)
        x["sel"] = SelectorSet(**dict(x["sel"]))
        return _terms_to_device(ExistingTerms(**x), device)

    d = dict(d)
    vals = {f: (terms(d[f]) if f in ("filter_terms", "score_terms")
                else copy_to(d[f], device))
            for f in ClusterTensors._fields}
    return ClusterTensors(**vals)


# Well-known topology keys are always present so zone/hostname spreading
# needs no vocab growth (reference: pkg/apis/core/v1/well_known_labels.go).
SEED_TOPOKEYS = (api.LABEL_HOSTNAME, api.LABEL_ZONE, api.LABEL_REGION,
                 api.LABEL_ZONE_LEGACY, api.LABEL_REGION_LEGACY)


class SnapshotBuilder:
    """Builds HostClusterArrays from a list of NodeInfos.

    Mirrors the roles of snapshot.go:49 (NewSnapshot) — including the
    HavePodsWithAffinityList secondary index, which here becomes the
    flattened ExistingTerms tensors.  DefaultHardPodAffinityWeight = 1
    (reference: apis/config/v1beta1/defaults.go hardPodAffinityWeight).
    """

    def __init__(self, table: Optional[InternTable] = None,
                 hard_pod_affinity_weight: int = 1):
        self.table = table or InternTable()
        for k in SEED_TOPOKEYS:
            self.table.topokey.intern(k)
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.compiler = SelectorCompiler(self.table)

    # -- interning helpers --------------------------------------------------

    def _intern_node_strings(self, nodes: List[NodeInfo]) -> None:
        """First pass: make sure vocab contains everything in the cluster so
        bucket caps are final before array allocation."""
        t = self.table
        for ni in nodes:
            node = ni.node
            if node is None:
                continue
            for k, v in node.metadata.labels.items():
                t.kv.intern((k, v)); t.key.intern(k)
            t.kv.intern((FIELD_PREFIX + "metadata.name", node.name))
            t.key.intern(FIELD_PREFIX + "metadata.name")
            for taint in node.spec.taints:
                t.taint.intern((taint.key, taint.value, taint.effect))
            for name in ni.image_states:
                t.image.intern(_norm_image(name))
            for r in ni.allocatable.scalar_resources:
                t.rname.intern(r)
            zk = zone_key(node)
            if zk:
                t.zone.intern(zk)
            for kind, uid in _avoid_entries(node):
                t.avoid.intern((kind, uid))
            for triple in ni.used_ports:
                for pid in _port_ids_node(triple):
                    t.port.intern(pid)
            for pi in ni.pods:
                p = pi.pod
                t.ns.intern(p.namespace)
                for k, v in p.metadata.labels.items():
                    t.kv.intern((k, v)); t.key.intern(k)
                for term in (pi.required_anti_affinity_terms
                             + [w.term for w in pi.preferred_affinity_terms]
                             + [w.term for w in pi.preferred_anti_affinity_terms]
                             + pi.required_affinity_terms):
                    t.topokey.intern(term.topology_key)
                    for ns in term.namespaces:
                        t.ns.intern(ns)

    def intern_pending(self, pods: List[PodInfo]) -> None:
        """Pre-intern the strings of *pending* pods so vocab capacities are
        final before snapshot arrays are sized.  Without this, two batch pods
        sharing a label or hostPort that exists nowhere else in the cluster
        could not see each other in the intra-batch (scan) interactions."""
        t = self.table
        for pi in pods:
            p = pi.pod
            t.ns.intern(p.namespace)
            for k, v in p.metadata.labels.items():
                t.kv.intern((k, v)); t.key.intern(k)
            for c in p.spec.containers:
                for port in c.ports:
                    if port.host_port <= 0:
                        continue
                    triple = (port.protocol or "TCP", port.host_ip or "0.0.0.0",
                              port.host_port)
                    for pid in _port_ids_node(triple) + port_ids_pod(triple):
                        t.port.intern(pid)
            for term in (pi.required_affinity_terms + pi.required_anti_affinity_terms
                         + [w.term for w in pi.preferred_affinity_terms]
                         + [w.term for w in pi.preferred_anti_affinity_terms]):
                t.topokey.intern(term.topology_key)
                for ns in term.namespaces:
                    t.ns.intern(ns)
            for c in p.spec.topology_spread_constraints:
                t.topokey.intern(c.topology_key)

    # -- build --------------------------------------------------------------

    def build(self, nodes: List[NodeInfo]) -> HostClusterArrays:
        self._intern_node_strings(nodes)
        t = self.table
        N = pow2_bucket(len(nodes), 8)
        R = N_FIXED_CHANNELS + t.rname.cap
        L, K, TK = t.kv.cap, t.key.cap, t.topokey.cap
        T, P, I, NS = t.taint.cap, t.port.cap, t.image.cap, t.ns.cap
        AV = t.avoid.cap
        n_pods = sum(len(ni.pods) for ni in nodes)
        PP = pow2_bucket(n_pods, 8)
        # compact label-id forms of kv/pod_kv (densified on device)
        MLn = pow2_bucket(max((len(ni.node.metadata.labels) + 1
                               for ni in nodes if ni.node is not None),
                              default=1), 4)
        MLp = pow2_bucket(max((len(pi.pod.metadata.labels)
                               for ni in nodes for pi in ni.pods),
                              default=1), 4)

        d: dict = {
            "allocatable": np.zeros((N, R), np.float32),
            "requested": np.zeros((N, R), np.float32),
            "nonzero_requested": np.zeros((N, 2), np.float32),
            "node_valid": np.zeros((N,), bool),
            "unschedulable": np.zeros((N,), bool),
            "_kv_ids": np.full((N, MLn), -1, np.int32),
            "_pod_kv_ids": np.full((PP, MLp), -1, np.int32),
            "_kv_cap": L,
            "keymask": np.zeros((N, K), bool),
            "num": np.full((N, K), np.inf, np.float32),
            "topo_pair": np.full((N, TK), -1, np.int32),
            "taints": np.zeros((N, T), bool),
            "ports": np.zeros((N, P), bool),
            "images": np.zeros((N, I), bool),
            "avoid_hot": np.zeros((N, AV), bool),
            "zone_hot": np.zeros((N, t.zone.cap), np.float32),
            "taint_is_hard": np.zeros((T,), bool),
            "taint_is_prefer": np.zeros((T,), bool),
            "image_size": np.zeros((I,), np.float32),
            "image_spread": np.zeros((I,), np.float32),
            "pod_key": np.zeros((PP, K), bool),
            "pod_ns_hot": np.zeros((PP, NS), np.float32),
            "pod_node": np.full((PP,), -1, np.int32),
            "pod_valid": np.zeros((PP,), bool),
            "pod_terminating": np.zeros((PP,), bool),
        }

        # vocab metadata
        for i in range(len(t.taint)):
            _, _, effect = t.taint.key(i)
            d["taint_is_hard"][i] = effect in (api.TAINT_EFFECT_NO_SCHEDULE,
                                               api.TAINT_EFFECT_NO_EXECUTE)
            d["taint_is_prefer"][i] = effect == api.TAINT_EFFECT_PREFER_NO_SCHEDULE

        image_nodes = np.zeros((I,), np.float32)
        pod_row = 0
        pod_rows: Dict[str, int] = {}  # pod uid -> row
        filter_owners: List[Tuple[PodInfo, int]] = []
        score_owners: List[Tuple[PodInfo, int]] = []

        for n_idx, ni in enumerate(nodes):
            node = ni.node
            if node is None:
                continue
            fill_node_row(d, n_idx, ni, t)
            for ii in np.nonzero(d["images"][n_idx])[0]:
                image_nodes[ii] += 1

            for pi in ni.pods:
                fill_pod_row(d, pod_row, pi, n_idx, t)
                pod_rows[pi.pod.uid] = pod_row
                if pi.required_anti_affinity_terms:
                    filter_owners.append((pi, pod_row))
                if (pi.preferred_affinity_terms or pi.preferred_anti_affinity_terms
                        or pi.required_affinity_terms):
                    score_owners.append((pi, pod_row))
                pod_row += 1

        n_valid = max(float(len(nodes)), 1.0)
        d["image_spread"] = image_nodes / n_valid

        d["filter_terms"] = self._build_terms(filter_owners, kind="filter")
        d["score_terms"] = self._build_terms(score_owners, kind="score")
        # row assignments + per-image node counts (kept for parity with the
        # JAX package's builder, whose delta path starts from them)
        d["_pod_rows"] = pod_rows
        d["_image_nodes"] = image_nodes
        return HostClusterArrays(arrays=d)

    def _build_terms(self, owners: List[Tuple[PodInfo, int]], kind: str) -> ExistingTerms:
        t = self.table
        NS = t.ns.cap
        sels, nss, topos, pods, weights = [], [], [], [], []

        def add(term, pod_row, weight):
            sels.append(term.selector)
            nss.append(term.namespaces)
            topos.append(t.topokey.get(term.topology_key))
            pods.append(pod_row)
            weights.append(float(weight))

        for pi, row in owners:
            if kind == "filter":
                for term in pi.required_anti_affinity_terms:
                    add(term, row, 1.0)
            else:
                for w in pi.preferred_affinity_terms:
                    add(w.term, row, w.weight)
                for w in pi.preferred_anti_affinity_terms:
                    add(w.term, row, -w.weight)
                if self.hard_pod_affinity_weight:
                    for term in pi.required_affinity_terms:
                        add(term, row, self.hard_pod_affinity_weight)

        Et = pow2_bucket(len(sels), 1)
        sel_set = self.compiler.compile(sels + [None] * (Et - len(sels)), pad_s=Et)
        ns_hot = np.zeros((Et, NS), np.float32)
        topo_key = np.zeros((Et,), np.int32)
        pod_idx = np.zeros((Et,), np.int32)
        weight = np.zeros((Et,), np.float32)
        valid = np.zeros((Et,), bool)
        for i in range(len(sels)):
            for ns in nss[i]:
                j = t.ns.get(ns)
                if j >= 0:
                    ns_hot[i, j] = 1.0
            topo_key[i] = max(topos[i], 0)
            pod_idx[i] = pods[i]
            weight[i] = weights[i]
            valid[i] = True
        return ExistingTerms(sel=sel_set, ns_hot=ns_hot, topo_key=topo_key,
                             pod_idx=pod_idx, weight=weight, valid=valid)


# --------------------------------------------------------------------------
# Per-row fills used by SnapshotBuilder.build (copied from the JAX package,
# where its incremental delta path shares them).  Filling a row through
# these helpers produces byte-identical arrays to a fresh build of the same
# NodeInfo against the same InternTable.


def fill_node_row(d: dict, n_idx: int, ni: NodeInfo, t: InternTable) -> None:
    """(Re)fill every node-axis array row for one NodeInfo.  Clears the row
    first so refilling a previously-populated row leaves no stale
    label/taint/port bits behind."""
    node = ni.node
    R = d["allocatable"].shape[1]
    d["node_valid"][n_idx] = True
    d["unschedulable"][n_idx] = node.spec.unschedulable
    d["_kv_ids"][n_idx] = -1
    d["keymask"][n_idx] = False
    d["num"][n_idx] = np.inf
    d["topo_pair"][n_idx] = -1
    d["taints"][n_idx] = False
    d["ports"][n_idx] = False
    d["images"][n_idx] = False
    d["avoid_hot"][n_idx] = False
    d["zone_hot"][n_idx] = 0.0
    d["allocatable"][n_idx] = resource_to_channels(ni.allocatable, t, R)
    req = resource_to_channels(ni.requested, t, R)
    req[CH_PODS] = len(ni.pods)
    d["requested"][n_idx] = req
    d["nonzero_requested"][n_idx, 0] = ni.non_zero_requested.milli_cpu
    d["nonzero_requested"][n_idx, 1] = ni.non_zero_requested.memory / MIB
    labels = dict(node.metadata.labels)
    labels[FIELD_PREFIX + "metadata.name"] = node.name
    for li, (k, v) in enumerate(labels.items()):
        d["_kv_ids"][n_idx, li] = t.kv.get((k, v))
        ki = t.key.get(k)
        d["keymask"][n_idx, ki] = True
        try:
            d["num"][n_idx, ki] = float(int(v))
        except ValueError:
            pass
    for tk_i in range(len(t.topokey)):
        tk = t.topokey.key(tk_i)
        if tk in labels:
            d["topo_pair"][n_idx, tk_i] = t.kv.get((tk, labels[tk]))
    for taint in node.spec.taints:
        d["taints"][n_idx, t.taint.get((taint.key, taint.value,
                                        taint.effect))] = True
    for triple in ni.used_ports:
        for pid in _port_ids_node(triple):
            d["ports"][n_idx, t.port.get(pid)] = True
    for name, size in ni.image_states.items():
        ii = t.image.get(_norm_image(name))
        d["images"][n_idx, ii] = True
        d["image_size"][ii] = size
    for kind, uid in _avoid_entries(node):
        d["avoid_hot"][n_idx, t.avoid.get((kind, uid))] = True
    zk = zone_key(node)
    if zk:
        d["zone_hot"][n_idx, t.zone.get(zk)] = 1.0


def fill_pod_row(d: dict, row: int, pi: PodInfo, n_idx: int,
                 t: InternTable) -> None:
    """(Re)fill one existing-pod row.  Clears first."""
    clear_pod_row(d, row)
    p = pi.pod
    d["pod_node"][row] = n_idx
    d["pod_valid"][row] = True
    d["pod_terminating"][row] = p.metadata.deletion_timestamp is not None
    d["pod_ns_hot"][row, t.ns.get(p.namespace)] = 1.0
    for li, (k, v) in enumerate(p.metadata.labels.items()):
        d["_pod_kv_ids"][row, li] = t.kv.get((k, v))
        d["pod_key"][row, t.key.get(k)] = True


def clear_pod_row(d: dict, row: int) -> None:
    """Reset a pod row to build-time defaults (an evicted pod's freed row
    must be byte-identical to a fresh build's padding row)."""
    d["pod_node"][row] = -1
    d["pod_valid"][row] = False
    d["pod_terminating"][row] = False
    d["pod_ns_hot"][row] = 0.0
    d["_pod_kv_ids"][row] = -1
    d["pod_key"][row] = False


def _norm_image(name: str) -> str:
    """Normalize image name: bare names get :latest; a registry-less repo is
    left as-is (reference: imagelocality/image_locality.go normalizedImageName)."""
    if "@" in name:
        return name
    tag_sep = name.rfind(":")
    slash = name.rfind("/")
    if tag_sep <= slash:  # no tag after last path component
        return name + ":latest"
    return name


WILDCARD_IP = "0.0.0.0"
_ANY = "__any__"
_WILD = "__wild__"


def _port_ids_node(triple: Tuple[str, str, int]):
    """Port ids a *node* registers for one used (proto, ip, port).

    Encodes HostPortInfo's wildcard semantics
    (reference: framework/v1alpha1/types.go:694 HostPortInfo.CheckConflict)
    as set-intersection: specific ip registers {specific, ANY}; wildcard
    registers {WILD, ANY}.  A pod checks {specific, WILD} (specific ip) or
    {ANY} (wildcard).  Intersection != 0  <=>  CheckConflict == true.
    """
    proto, ip, port = triple
    if ip == WILDCARD_IP:
        return [(proto, _WILD, port), (proto, _ANY, port)]
    return [(proto, ip, port), (proto, _ANY, port)]


def port_ids_pod(triple: Tuple[str, str, int]):
    """Port ids a *pod* probes for one wanted (proto, ip, port)."""
    proto, ip, port = triple
    if ip == WILDCARD_IP:
        return [(proto, _ANY, port)]
    return [(proto, ip, port), (proto, _WILD, port)]


def _avoid_entries(node: api.Node) -> List[Tuple[str, str]]:
    """(kind, uid) pairs from the preferAvoidPods annotation (reference:
    pkg/apis/core/v1/helper/helpers.go:239 GetAvoidPodsFromNodeAnnotations,
    matched by kind+UID in nodepreferavoidpods/node_prefer_avoid_pods.go:76)."""
    raw = node.metadata.annotations.get(api.PREFER_AVOID_PODS_ANNOTATION_KEY)
    if not raw:
        return []
    import json
    out = []
    try:
        doc = json.loads(raw)
        for entry in doc.get("preferAvoidPods", []):
            ctrl = entry.get("podSignature", {}).get("podController", {})
            out.append((ctrl.get("kind", ""), ctrl.get("uid", "")))
    except (ValueError, AttributeError):
        return []
    return out


def zone_key(node: api.Node) -> str:
    """region:zone key for zone-aware spreading
    (reference: pkg/util/node/node.go:148 GetZoneKey)."""
    labels = node.metadata.labels
    # legacy failure-domain labels take precedence (reference behavior)
    region = labels.get(api.LABEL_REGION_LEGACY, labels.get(api.LABEL_REGION, ""))
    zone = labels.get(api.LABEL_ZONE_LEGACY, labels.get(api.LABEL_ZONE, ""))
    if not region and not zone:
        return ""
    return region + ":\x00:" + zone
