"""Pending-pod batch tensorization.

The reference schedules strictly one pod per cycle (reference:
pkg/scheduler/scheduler.go:509 scheduleOne); the scheduler lifts a whole
batch of B pending pods into dense arrays and filters and scores all of
them at once on the device.  Everything string-typed is resolved against
the cluster InternTable at batch-build time (lookups only — a pod
referencing a label value that exists nowhere in the cluster simply never
matches).  The numpy builder is the JAX package's, unchanged (B =
pow2_bucket(pods, 8)); batch_to_device and densify_for are torch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from ..api import types as api
from ..framework.types import PodInfo, compute_pod_resource_limits
from ..ops.selectors import (FIELD_PREFIX, SelectorCompiler, SelectorSet,
                             selector_to_device)
from ..state.tensors import (MIB, N_FIXED_CHANNELS, CH_PODS, port_ids_pod,
                             resource_to_channels, _densify_ids, _norm_image)
from ..utils.device import copy_to
from ..utils.intern import InternTable, pow2_bucket


class PodTerms(NamedTuple):
    """Flattened pod-side (anti-)affinity terms, matched against existing
    pods (reference: framework/v1alpha1/types.go:79 AffinityTerm).
    Selector set is flat [B*T]; companion arrays are [B, T]."""
    sel: SelectorSet
    ns_hot: np.ndarray    # [B, T, NS]
    topo_key: np.ndarray  # [B, T] i32 (index into topokey axis)
    topo_known: np.ndarray  # [B, T] bool — topology key exists in cluster vocab
    weight: np.ndarray    # [B, T] f32 (signed for preferred anti)
    valid: np.ndarray     # [B, T] bool
    self_match: np.ndarray  # [B, T] bool — incoming pod matches its own term
                            # (the bootstrap rule, interpodaffinity/filtering.go:353)


class SpreadConstraints(NamedTuple):
    """Topology spread constraints per pod
    (reference: podtopologyspread/common.go:70 topologySpreadConstraint)."""
    sel: SelectorSet      # [B*C] over existing pods
    topo_key: np.ndarray  # [B, C] i32
    topo_known: np.ndarray  # [B, C] bool
    max_skew: np.ndarray  # [B, C] f32
    valid: np.ndarray     # [B, C] bool
    self_match: np.ndarray  # [B, C] bool — pod's own labels match the
                            # constraint selector (counts itself when placed)


class PodBatch(NamedTuple):
    """B pending pods as a struct-of-arrays (numpy on the host, torch
    tensors once moved by batch_to_device).

    Pod label sets travel to the device as compact id lists (kv_ids/key_ids)
    and are densified to [B, L]/[B, K] one-hots on the device by densify_for() — a pod has O(10) labels, so shipping [B, L] dense floats
    would waste transfer bandwidth by ~L/10x.  kv_hot/key_hot are None until
    densify_for() fills them."""
    req: np.ndarray            # [B, R] resource request channels
    nonzero_req: np.ndarray    # [B, 2] (cpu milli, mem MiB) with defaults
    limits: np.ndarray         # [B, R] resource limit channels
    kv_ids: np.ndarray         # [B, ML] i32 label (key,value) vocab ids, -1 pad
    key_ids: np.ndarray        # [B, ML] i32 label key vocab ids, -1 pad
    kv_hot: Optional[np.ndarray]   # [B, L] bool — filled on device
    key_hot: Optional[np.ndarray]  # [B, K] bool — filled on device
    ns_hot: np.ndarray         # [B, NS] f32 one-hot namespace
    node_name_kvid: np.ndarray  # [B] i32 kv id of (__field__metadata.name, spec.nodeName); -1 unset
    has_node_name: np.ndarray  # [B] bool
    ports_hot: np.ndarray      # [B, P] f32 — ids the pod *probes* for conflicts
    ports_asnode_hot: np.ndarray  # [B, P] f32 — ids the pod *registers* once
                               # placed (for intra-batch conflicts in the scan)
    tolerated: np.ndarray      # [B, T] bool over taint vocab
    priority: np.ndarray       # [B] i32
    images_hot: np.ndarray     # [B, I] f32 — container images (non-init)
    n_containers: np.ndarray   # [B] f32 — len(spec.containers) for ImageLocality
    avoid_id: np.ndarray       # [B] i32 — (controllerRef kind, uid) vocab id, -1 if
                               #   not controlled by an RC/RS (NodePreferAvoidPods)
    tolerates_unschedulable: np.ndarray  # [B] bool — tolerates the
                               #   node.kubernetes.io/unschedulable:NoSchedule taint
    node_selector: SelectorSet  # [B] spec.nodeSelector as a selector
    rna_sel: SelectorSet       # [B*Tn] required node affinity terms (ORed)
    rna_valid: np.ndarray      # [B, Tn]
    has_rna: np.ndarray        # [B] bool
    pna_sel: SelectorSet       # [B*Tp] preferred node affinity terms
    pna_weight: np.ndarray     # [B, Tp] f32
    pna_valid: np.ndarray      # [B, Tp]
    ra: PodTerms               # required pod affinity
    raa: PodTerms              # required pod anti-affinity
    pref: PodTerms             # preferred affinity and anti (signed weights)
    spread: SpreadConstraints  # hard (DoNotSchedule) constraints
    spread_soft: SpreadConstraints  # soft (ScheduleAnyway) constraints
    spread_selector: SelectorSet  # [B] DefaultPodTopologySpread selector (the
                               # combined service/RC/RS/SS selector; nil => score 0)
    spread_skip: np.ndarray    # [B] bool — pod has explicit spread constraints, so
                               # DefaultPodTopologySpread is skipped entirely
    valid: np.ndarray          # [B] bool padding mask

    @property
    def batch_cap(self) -> int:
        return self.req.shape[0]


def _leaf_to_device(x, device):
    if isinstance(x, SelectorSet):
        return selector_to_device(x, device)
    if isinstance(x, (PodTerms, SpreadConstraints)):
        return type(x)(*[_leaf_to_device(f, device) for f in x])
    return None if x is None else copy_to(x, device)


def batch_to_device(batch: PodBatch, device) -> PodBatch:
    """Copy every leaf of a host PodBatch to ``device`` (always a copy)."""
    return PodBatch(*[_leaf_to_device(f, device) for f in batch])


def batch_from_numpy(d, device) -> PodBatch:
    """Build a device PodBatch from the leaves of a JAX-package PodBatch
    given as a (nested) dict of numpy arrays with the same field names
    (kv_hot/key_hot may be None or dense) — the tests feed both packages
    identical state this way."""
    nested = {"ra": PodTerms, "raa": PodTerms, "pref": PodTerms,
              "spread": SpreadConstraints, "spread_soft": SpreadConstraints}
    sels = ("node_selector", "rna_sel", "pna_sel", "spread_selector")

    def build(cls, x):
        x = dict(x)
        if "sel" in x:
            x["sel"] = SelectorSet(**dict(x["sel"]))
        return cls(**x)

    d = dict(d)
    for f, cls in nested.items():
        d[f] = build(cls, d[f])
    for f in sels:
        d[f] = SelectorSet(**dict(d[f]))
    return batch_to_device(PodBatch(**d), device)


def densify_for(cluster, batch: "PodBatch") -> "PodBatch":
    """Materialize the [B, L]/[B, K] pod-label one-hots from the id lists,
    sized to the cluster tensors' vocab capacities (idempotent).  Ids at or
    beyond the cluster capacity (interned after the snapshot arrays were
    sized) are dropped — such labels exist nowhere in the cluster, so they
    can never match."""
    if batch.kv_hot is not None:
        return batch
    L, K = cluster.kv.shape[1], cluster.keymask.shape[1]
    return batch._replace(kv_hot=_densify_ids(batch.kv_ids, L),
                          key_hot=_densify_ids(batch.key_ids, K))


class PodBatchBuilder:
    def __init__(self, table: InternTable):
        self.table = table
        self.compiler = SelectorCompiler(table)

    def build(self, pods: Sequence[PodInfo], pad_b: Optional[int] = None,
              spread_selectors: Optional[Sequence] = None) -> PodBatch:
        """spread_selectors: per-pod combined service/RC/RS/SS selector for
        DefaultPodTopologySpread (reference: plugins/helper/spread.go
        DefaultSelector), or None per pod when nothing selects it."""
        t = self.table
        B = pad_b if pad_b is not None else pow2_bucket(len(pods), 8)
        if B < len(pods):
            raise ValueError("pad_b smaller than batch")
        R = N_FIXED_CHANNELS + t.rname.cap
        L, K, NS, P = t.kv.cap, t.key.cap, t.ns.cap, t.port.cap
        T, I = t.taint.cap, t.image.cap

        req = np.zeros((B, R), np.float32)
        nonzero = np.zeros((B, 2), np.float32)
        limits = np.zeros((B, R), np.float32)
        ML = pow2_bucket(max((len(pi.pod.metadata.labels) for pi in pods),
                             default=0), 4)
        kv_ids = np.full((B, ML), -1, np.int32)
        key_ids = np.full((B, ML), -1, np.int32)
        ns_hot = np.zeros((B, NS), np.float32)
        node_name_kvid = np.full((B,), -1, np.int32)
        has_node_name = np.zeros((B,), bool)
        ports_hot = np.zeros((B, P), np.float32)
        ports_asnode_hot = np.zeros((B, P), np.float32)
        tolerated = np.zeros((B, T), bool)
        priority = np.zeros((B,), np.int32)
        images_hot = np.zeros((B, I), np.float32)
        n_containers = np.zeros((B,), np.float32)
        avoid_id = np.full((B,), -1, np.int32)
        tolerates_unschedulable = np.zeros((B,), bool)
        valid = np.zeros((B,), bool)

        node_selectors: List = []
        rna_terms: List[List[api.NodeSelectorTerm]] = []
        pna_terms: List[List[api.PreferredSchedulingTerm]] = []

        for i, pi in enumerate(pods):
            p = pi.pod
            valid[i] = True
            req[i] = resource_to_channels(pi.resource, t, R, intern_new=False)
            req[i, CH_PODS] = 1.0
            nonzero[i, 0] = pi.non_zero_cpu
            nonzero[i, 1] = pi.non_zero_mem / MIB
            limits[i] = resource_to_channels(compute_pod_resource_limits(p), t, R,
                                             intern_new=False)
            for li, (k, v) in enumerate(p.metadata.labels.items()):
                kv_ids[i, li] = t.kv.get((k, v))
                key_ids[i, li] = t.key.get(k)
            jn = t.ns.get(p.namespace)
            if jn >= 0:
                ns_hot[i, jn] = 1.0
            if p.spec.node_name:
                has_node_name[i] = True
                node_name_kvid[i] = t.kv.get(
                    (FIELD_PREFIX + "metadata.name", p.spec.node_name))
            for c in p.spec.containers:
                for port in c.ports:
                    if port.host_port <= 0:
                        continue
                    triple = (port.protocol or "TCP", port.host_ip or "0.0.0.0",
                              port.host_port)
                    for pid in port_ids_pod(triple):
                        j = t.port.get(pid)
                        if j >= 0:
                            ports_hot[i, j] = 1.0
                    from ..state.tensors import _port_ids_node
                    for pid in _port_ids_node(triple):
                        j = t.port.get(pid)
                        if j >= 0:
                            ports_asnode_hot[i, j] = 1.0
                if c.image:
                    j = t.image.get(_norm_image(c.image))
                    if j >= 0:
                        images_hot[i, j] = 1.0
            for ti in range(len(t.taint)):
                k, v, effect = t.taint.key(ti)
                taint = api.Taint(key=k, value=v, effect=effect)
                tolerated[i, ti] = api.tolerations_tolerate_taint(
                    p.spec.tolerations, taint)
            priority[i] = p.priority()
            n_containers[i] = len(p.spec.containers)
            # reference: nodepreferavoidpods/node_prefer_avoid_pods.go:57 —
            # only RC/RS controllers participate; others score MaxNodeScore.
            for ref in p.metadata.owner_references:
                if ref.controller and ref.kind in ("ReplicationController", "ReplicaSet"):
                    avoid_id[i] = t.avoid.get((ref.kind, ref.uid))
                    break
            # reference: nodeunschedulable/node_unschedulable.go:56
            tolerates_unschedulable[i] = api.tolerations_tolerate_taint(
                p.spec.tolerations,
                api.Taint(key="node.kubernetes.io/unschedulable",
                          effect=api.TAINT_EFFECT_NO_SCHEDULE))

            node_selectors.append(dict(p.spec.node_selector)
                                  if p.spec.node_selector else {})
            aff = p.spec.affinity
            na = aff.node_affinity if aff else None
            # nil-vs-empty matters: a PRESENT required NodeSelector with an
            # empty (or nil) terms list matches NO node (reference:
            # helpers.go:180 MatchNodeSelectorTerms over zero terms), while
            # an absent selector matches every node
            rna = (na.required_during_scheduling_ignored_during_execution
                   if na else None)
            rna_terms.append(list(rna.node_selector_terms)
                             if rna is not None else None)
            pna_terms.append(list(
                na.preferred_during_scheduling_ignored_during_execution)
                if na else [])

        node_selector = self.compiler.compile(
            node_selectors + [None] * (B - len(pods)), pad_s=B, intern_new=False)

        Tn = pow2_bucket(max((len(x) for x in rna_terms if x is not None),
                             default=0), 1)
        rna_flat: List = []
        rna_valid = np.zeros((B, Tn), bool)
        has_rna = np.zeros((B,), bool)
        for i in range(B):
            terms = rna_terms[i] if i < len(pods) else None
            has_rna[i] = terms is not None   # present selector, even empty
            terms = terms or []
            for j in range(Tn):
                if j < len(terms):
                    rna_flat.append(terms[j])
                    rna_valid[i, j] = True
                else:
                    rna_flat.append(None)
        rna_sel = self.compiler.compile(rna_flat, pad_s=B * Tn, intern_new=False)

        Tp = pow2_bucket(max((len(x) for x in pna_terms), default=0), 1)
        pna_flat: List = []
        pna_weight = np.zeros((B, Tp), np.float32)
        pna_valid = np.zeros((B, Tp), bool)
        for i in range(B):
            terms = pna_terms[i] if i < len(pods) else []
            for j in range(Tp):
                if j < len(terms) and terms[j].weight != 0:
                    # Preferred terms use only matchExpressions, and an empty
                    # preference matches every node (reference:
                    # nodeaffinity/node_affinity.go:81-99).
                    exprs = terms[j].preference.match_expressions
                    if exprs:
                        pna_flat.append(api.NodeSelectorTerm(match_expressions=exprs))
                    else:
                        pna_flat.append(api.LabelSelector())
                    pna_weight[i, j] = terms[j].weight
                    pna_valid[i, j] = True
                else:
                    pna_flat.append(None)
        pna_sel = self.compiler.compile(pna_flat, pad_s=B * Tp, intern_new=False)

        if spread_selectors is None:
            spread_selectors = [None] * len(pods)
        spread_sel_list = list(spread_selectors) + [None] * (B - len(pods))
        spread_selector = self.compiler.compile(spread_sel_list, pad_s=B,
                                                intern_new=False)
        spread_skip = np.zeros((B,), bool)
        for i, pi in enumerate(pods):
            spread_skip[i] = bool(pi.pod.spec.topology_spread_constraints)

        ra = self._build_pod_terms(pods, B, "required_affinity")
        raa = self._build_pod_terms(pods, B, "required_anti")
        pref = self._build_pod_terms(pods, B, "preferred")
        spread_hard = self._build_spread(pods, B, hard=True)
        spread_soft = self._build_spread(pods, B, hard=False)

        return PodBatch(req=req, nonzero_req=nonzero, limits=limits,
                        kv_ids=kv_ids, key_ids=key_ids,
                        kv_hot=None, key_hot=None,
                        ns_hot=ns_hot, node_name_kvid=node_name_kvid,
                        has_node_name=has_node_name, ports_hot=ports_hot,
                        ports_asnode_hot=ports_asnode_hot,
                        tolerated=tolerated, priority=priority, images_hot=images_hot,
                        n_containers=n_containers, avoid_id=avoid_id,
                        tolerates_unschedulable=tolerates_unschedulable,
                        node_selector=node_selector,
                        rna_sel=rna_sel, rna_valid=rna_valid, has_rna=has_rna,
                        pna_sel=pna_sel, pna_weight=pna_weight, pna_valid=pna_valid,
                        ra=ra, raa=raa, pref=pref, spread=spread_hard,
                        spread_soft=spread_soft, spread_selector=spread_selector,
                        spread_skip=spread_skip, valid=valid)

    def _term_lists(self, pi: PodInfo, kind: str):
        if kind == "required_affinity":
            return [(term, 1.0) for term in pi.required_affinity_terms]
        if kind == "required_anti":
            return [(term, 1.0) for term in pi.required_anti_affinity_terms]
        out = [(w.term, float(w.weight)) for w in pi.preferred_affinity_terms]
        out += [(w.term, -float(w.weight)) for w in pi.preferred_anti_affinity_terms]
        return out

    def _build_pod_terms(self, pods: Sequence[PodInfo], B: int, kind: str) -> PodTerms:
        t = self.table
        NS = t.ns.cap
        lists = [self._term_lists(pi, kind) for pi in pods]
        T = pow2_bucket(max((len(x) for x in lists), default=0), 1)
        sels: List = []
        ns_hot = np.zeros((B, T, NS), np.float32)
        topo_key = np.zeros((B, T), np.int32)
        topo_known = np.zeros((B, T), bool)
        weight = np.zeros((B, T), np.float32)
        tvalid = np.zeros((B, T), bool)
        self_match = np.zeros((B, T), bool)
        for i in range(B):
            terms = lists[i] if i < len(pods) else []
            for j in range(T):
                if j < len(terms):
                    term, w = terms[j]
                    sels.append(term.selector)
                    for ns in term.namespaces:
                        k = t.ns.get(ns)
                        if k >= 0:
                            ns_hot[i, j, k] = 1.0
                    tk = t.topokey.get(term.topology_key)
                    topo_key[i, j] = max(tk, 0)
                    topo_known[i, j] = tk >= 0
                    weight[i, j] = w
                    tvalid[i, j] = True
                    self_match[i, j] = term.matches(pods[i].pod)
                else:
                    sels.append(None)
        sel = self.compiler.compile(sels, pad_s=B * T, intern_new=False)
        return PodTerms(sel=sel, ns_hot=ns_hot, topo_key=topo_key,
                        topo_known=topo_known, weight=weight, valid=tvalid,
                        self_match=self_match)

    def _build_spread(self, pods: Sequence[PodInfo], B: int, hard: bool) -> SpreadConstraints:
        t = self.table
        want = "DoNotSchedule" if hard else "ScheduleAnyway"
        lists = []
        for pi in pods:
            cs = [c for c in pi.pod.spec.topology_spread_constraints
                  if c.when_unsatisfiable == want]
            lists.append(cs)
        C = pow2_bucket(max((len(x) for x in lists), default=0), 1)
        sels: List = []
        topo_key = np.zeros((B, C), np.int32)
        topo_known = np.zeros((B, C), bool)
        max_skew = np.zeros((B, C), np.float32)
        valid = np.zeros((B, C), bool)
        self_match = np.zeros((B, C), bool)
        for i in range(B):
            cs = lists[i] if i < len(pods) else []
            for j in range(C):
                if j < len(cs):
                    c = cs[j]
                    sels.append(c.label_selector)
                    tk = t.topokey.get(c.topology_key)
                    topo_key[i, j] = max(tk, 0)
                    topo_known[i, j] = tk >= 0
                    max_skew[i, j] = c.max_skew
                    valid[i, j] = True
                    if c.label_selector is not None:
                        self_match[i, j] = c.label_selector.matches(
                            pods[i].pod.metadata.labels)
                else:
                    sels.append(None)
        sel = self.compiler.compile(sels, pad_s=B * C, intern_new=False)
        return SpreadConstraints(sel=sel, topo_key=topo_key, topo_known=topo_known,
                                 max_skew=max_skew, valid=valid, self_match=self_match)
