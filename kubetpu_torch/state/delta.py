"""Incremental delta tensorization: a device-resident cluster updated by
scatter, not rebuilt.

The counterpart of kubetpu/state/delta.py.  The ``DeltaTensorizer`` keeps
ONE ``ClusterTensors`` alive on the device across cycles and, from the
cache's commit/bind/evict/watch churn (per-node ``NodeInfo.generation``
bumps), refills only the dirty rows of its host mirror and scatters them
into the resident tensors (``state/tensors.py ClusterDelta``, applied by
``models/programs.py apply_cluster_delta``).  A full ``build()`` runs only
on the resync triggers, each reported through ``DeltaStats.reason``:

  * ``initial``             — no resident cluster yet
  * ``node-set``            — nodes added/removed/reordered (row ids move)
  * ``vocab-growth``        — an intern-table pow2 cap crossed (tensor
                              widths change), or the topokey vocab grew at
                              all (``topo_pair`` columns are filled from
                              the key LIST, not the cap)
  * ``label-capacity``      — a node/pod outgrew the compact [., ML] id
                              lists
  * ``delta-too-large``     — dirty fraction above KUBETPU_DELTA_MAX_FRAC
                              (off by default)
  * ``anti-entropy``        — KUBETPU_RESYNC_INTERVAL delta cycles elapsed
  * ``pod-axis-growth``     — pod rows exhausted; the mirror pads to the
                              next pow2 bucket and re-uploads WITHOUT the
                              build() walk
  * ``verify-divergence``   — the anti-entropy verifier found the device
                              residents differing from the mirror

Term-carrying pod churn is not a trigger: the flattened ``ExistingTerms``
rebuild from the term OWNERS alone (``_refresh_terms``) and replace
wholesale.  A failing device call is never a trigger either: it raises.

Contract (held by tests/test_torch_delta.py against the JAX package's
DeltaTensorizer): after any sequence of refreshes the resident tensors
equal a from-scratch ``build()`` of the same NodeInfos against the same
InternTable byte for byte, up to the stable-row permutation of the
existing-pod axis (a fresh build packs pods in node-walk order; the delta
path keeps rows stable and reuses freed rows lowest first).

Aliasing: the in-place scatter leaves the previous refresh's
ClusterTensors sharing storage with the new one.  Whatever keeps a
cycle's tensors past the next refresh must clone them;
``safe_to_donate`` is the gate a caller with such cycles in flight asks.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..api import types as api
from ..utils.device import DeviceLike, resolve_device
from ..utils.intern import pow2_bucket
from ..utils.trace import wallclock
from .tensors import (ClusterDelta, HostClusterArrays, SnapshotBuilder,
                      _terms_to_device, clear_pod_row, fill_node_row,
                      fill_pod_row, gather_delta, pod_has_terms,
                      vocab_signature)

RESYNC_INTERVAL_ENV = "KUBETPU_RESYNC_INTERVAL"
MAX_FRAC_ENV = "KUBETPU_DELTA_MAX_FRAC"
# anti-entropy verifier cadence (delta cycles between device/mirror
# fingerprint checks); 0 = off, the default
VERIFY_INTERVAL_ENV = "KUBETPU_VERIFY_INTERVAL"
DEFAULT_RESYNC_INTERVAL = 512
# dirty-fraction fallback OFF by default (1.0 = never): even a fully dirty
# delta skips the intern pass, the term rebuild and the fresh allocation
DEFAULT_MAX_FRAC = 1.0

# pod-axis mirror fields padded on growth (pad value per field)
_POD_FIELDS = (("_pod_kv_ids", -1), ("pod_key", False), ("pod_ns_hot", 0.0),
               ("pod_node", -1), ("pod_valid", False),
               ("pod_terminating", False))

# fields left out of the fingerprint: the dense label one-hots exist only
# on the device (the mirror holds compact id lists); their source ids feed
# pod_key / keymask / topo_pair, which are fingerprinted
_FP_SKIP = ("kv", "pod_kv")
_U32 = 0xFFFFFFFF


def _leaves(x) -> list:
    """The array leaves of a (nested) NamedTuple in field order, None
    dropped — the JAX package's jax.tree.leaves order."""
    if x is None:
        return []
    if hasattr(x, "_fields"):
        return [leaf for f in x for leaf in _leaves(f)]
    return [x]


def _wrapsum_host(x: np.ndarray) -> int:
    """uint32 wrap-sum of a mirror array's element bits: bools count set
    bits, floats sum their f32 bit patterns, ints sum mod 2**32."""
    x = np.asarray(x)
    if x.dtype == np.bool_:
        v = x.astype(np.uint32)
    elif np.issubdtype(x.dtype, np.floating):
        v = np.ascontiguousarray(x.astype(np.float32)).view(np.uint32)
    else:
        v = x.astype(np.uint32)
    return int(v.sum(dtype=np.uint64) & _U32)


def _wrapsum_dev(x: torch.Tensor) -> torch.Tensor:
    """The device twin of _wrapsum_host, exact: each element's 32 bits
    widened to int64 (torch has no reliable uint32 sum), summed in int64
    and masked.  A 0-d int64 tensor."""
    if x.dtype == torch.bool:
        v = x.to(torch.int64)
    elif x.is_floating_point():
        v = x.to(torch.float32).contiguous().view(torch.int32).to(
            torch.int64) & _U32
    else:
        v = x.to(torch.int64) & _U32
    return v.sum() & _U32


class DeltaStats(NamedTuple):
    """One refresh()'s outcome."""
    delta_rows: int                 # node rows + pod rows actually updated
    resync: bool
    reason: str                     # "" on pure delta cycles
    spans: Tuple[Tuple[str, float, float], ...]  # (name, t0, t1)


class DeltaTensorizer:
    """Keeps ClusterTensors resident on ``device`` and updates them by
    bounded scatters from the cycle's cache churn.  The host mirror
    (``HostClusterArrays``) is the source of truth the device tensors
    always equal; a resync re-derives everything from the snapshot.
    Settings default to the JAX package's and its ``KUBETPU_*``
    environment names."""

    def __init__(self, hard_pod_affinity_weight: int = 1,
                 resync_interval: Optional[int] = None,
                 max_delta_frac: Optional[float] = None,
                 verify_interval: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.builder = SnapshotBuilder(
            hard_pod_affinity_weight=hard_pod_affinity_weight)
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.resync_interval = (resync_interval if resync_interval is not None
                                else int(os.environ.get(
                                    RESYNC_INTERVAL_ENV,
                                    str(DEFAULT_RESYNC_INTERVAL))))
        self.max_delta_frac = (max_delta_frac if max_delta_frac is not None
                               else float(os.environ.get(
                                   MAX_FRAC_ENV, str(DEFAULT_MAX_FRAC))))
        self.cluster = None                      # device ClusterTensors
        self.host: Optional[HostClusterArrays] = None
        self.node_names: List[str] = []          # row order
        self.node_gen: Dict[str, int] = {}
        self.node_pods: Dict[str, List[str]] = {}   # name -> uid list
        self.node_terms: Dict[str, bool] = {}    # name -> owns term pods
        self.pod_row: Dict[str, int] = {}        # uid -> row
        self.free_rows: List[int] = []           # kept sorted, pop lowest
        self.next_pod_row = 0
        self.caps = None                         # vocab signature
        self.cycles_since_resync = 0
        self.resync_count = 0
        self.verify_interval = (verify_interval
                                if verify_interval is not None
                                else int(os.environ.get(
                                    VERIFY_INTERVAL_ENV, "0")))
        self.cycles_since_verify = 0
        self.verify_count = 0
        self.divergence_count = 0
        # host seconds the last refresh spent copying to the device (the
        # full upload or the delta's packed copy and scatter); the rest of
        # its time is host tensorize work
        self.upload_s = 0.0

    # ------------------------------------------------------------- helpers

    def signature(self) -> tuple:
        """The tensor-width signature of the current vocab (shared with
        the scheduler's chain guard)."""
        return vocab_signature(self.builder.table)

    def safe_to_donate(self, uncommitted_clusters) -> bool:
        """The in-place scatter may only update the resident tensors when
        no dispatched-but-uncommitted cycle's cluster IS the resident:
        such a cycle's commit-side device work (preemption wave, decision
        audit) still reads it."""
        return not any(c is self.cluster for c in uncommitted_clusters)

    def pod_uid_list(self) -> List[Optional[str]]:
        """Row-ordered uid list sized to the pod-axis capacity (the
        scheduler's chain uid list / CycleContext.pod_rows feed)."""
        if self.host is None:
            return []
        out: List[Optional[str]] = [None] * self.host.arrays[
            "pod_node"].shape[0]
        for uid, r in self.pod_row.items():
            out[r] = uid
        return out

    # ------------------------------------------------------- anti-entropy

    def fingerprint_device(self) -> np.ndarray:
        """[K] uint32 per-table wrap-sums of the DEVICE residents, in one
        small readback."""
        vals = [_wrapsum_dev(leaf)
                for name in type(self.cluster)._fields if name not in _FP_SKIP
                for leaf in _leaves(getattr(self.cluster, name))]
        return torch.stack(vals).cpu().numpy().astype(np.uint32)

    def fingerprint_host(self) -> np.ndarray:
        """The host mirror's twin of fingerprint_device, same leaf order."""
        a = self.host.arrays
        return np.asarray([_wrapsum_host(leaf)
                           for name in type(self.cluster)._fields
                           if name not in _FP_SKIP
                           for leaf in _leaves(a[name])], np.uint32)

    def verify(self) -> bool:
        """One anti-entropy check: True when the device residents match
        the host mirror under the per-table fingerprint."""
        ok = bool(np.array_equal(self.fingerprint_device(),
                                 self.fingerprint_host()))
        self.verify_count += 1
        if not ok:
            self.divergence_count += 1
        return ok

    def _verify_tick(self, node_infos, names, pending):
        """The verifier's cadence: (spans, stats), stats being the
        divergence resync's DeltaStats (reason "verify-divergence") or
        None.  Off (verify_interval 0) this reads two attributes."""
        if not self.verify_interval or self.cluster is None:
            return (), None
        self.cycles_since_verify += 1
        if self.cycles_since_verify < self.verify_interval:
            return (), None
        self.cycles_since_verify = 0
        tv = wallclock()
        ok = self.verify()
        span = (("verify", tv, wallclock()),)
        if ok:
            return span, None
        # the mirror is the source of truth: the repair is a full resync
        _cluster, stats = self._resync(node_infos, names,
                                       "verify-divergence",
                                       wallclock(), pending)
        return span, stats._replace(spans=span + stats.spans)

    # ------------------------------------------------------------- refresh

    def refresh(self, node_infos, pending=(), donate: bool = True):
        """Bring the resident cluster up to date with the snapshot's
        NodeInfos.  Returns (cluster, DeltaStats).  pending: PodInfos of
        this cycle's pending (and nominated) pods, interned HERE so the
        vocab-growth check sees them (and a compacting resync re-interns
        them into its fresh table).  donate=False leaves the previous
        cluster's tensors untouched (apply_cluster_delta clones)."""
        t0 = wallclock()
        self.upload_s = 0.0
        if pending:
            self.builder.intern_pending(pending)
        names = [ni.node_name for ni in node_infos]
        if self.cluster is None:
            return self._resync(node_infos, names, "initial", t0, pending)
        if names != self.node_names:
            return self._resync(node_infos, names, "node-set", t0, pending)
        # before the zero-dirty return: pending pods can grow the vocab
        # with no node churn at all
        if self.signature() != self.caps:
            return self._resync(node_infos, names, "vocab-growth", t0,
                                pending)
        if self.cycles_since_resync >= self.resync_interval:
            return self._resync(node_infos, names, "anti-entropy", t0,
                                pending)
        dirty = [(i, ni) for i, ni in enumerate(node_infos)
                 if ni.generation != self.node_gen.get(ni.node_name)]
        if not dirty:
            self.cycles_since_resync += 1
            # the verifier ticks on zero-dirty cycles too
            vspan, vstats = self._verify_tick(node_infos, names, pending)
            if vstats is not None:
                return self.cluster, vstats
            return self.cluster, DeltaStats(0, False, "", vspan)
        if len(dirty) > self.max_delta_frac * max(len(names), 1):
            return self._resync(node_infos, names, "delta-too-large", t0,
                                pending)
        hw = self.hard_pod_affinity_weight
        terms_dirty = any(
            self.node_terms.get(ni.node_name)
            or any(pod_has_terms(pi, hw) for pi in ni.pods)
            for _, ni in dirty)
        # intern BEFORE the width check so new strings from dirty nodes
        # count against the caps the resident tensors were sized with
        self.builder._intern_node_strings([ni for _, ni in dirty])
        if self.signature() != self.caps:
            return self._resync(node_infos, names, "vocab-growth", t0,
                                pending)
        a = self.host.arrays
        MLn = a["_kv_ids"].shape[1]
        MLp = a["_pod_kv_ids"].shape[1]
        for _, ni in dirty:
            if len(ni.node.metadata.labels) + 1 > MLn:
                return self._resync(node_infos, names, "label-capacity",
                                    t0, pending)
            for pi in ni.pods:
                if len(pi.pod.metadata.labels) > MLp:
                    return self._resync(node_infos, names,
                                        "label-capacity", t0, pending)

        # pod-row churn: free EVERY departed row across all dirty nodes
        # BEFORE scanning for additions (a pod moving to a lower-indexed
        # dirty node must not see its own stale mapping)
        touched_pods: set = set()
        adds: List[Tuple[object, int]] = []    # (PodInfo, node row)
        for _, ni in dirty:
            old = self.node_pods.get(ni.node_name, [])
            new_set = {pi.pod.uid for pi in ni.pods}
            for uid in old:
                if uid not in new_set:
                    row = self.pod_row.pop(uid)
                    clear_pod_row(a, row)
                    touched_pods.add(row)
                    self.free_rows.append(row)
        for i, ni in dirty:
            for pi in ni.pods:
                if pi.pod.uid not in self.pod_row:
                    adds.append((pi, i))
        self.free_rows.sort()
        PP = a["pod_node"].shape[0]
        need = len(adds) - len(self.free_rows)
        grown = False
        if need > 0 and self.next_pod_row + need > PP:
            self._grow_pod_axis(self.next_pod_row + need)
            grown = True
        for pi, n_idx in adds:
            row = (self.free_rows.pop(0) if self.free_rows
                   else self.next_pod_row)
            if row == self.next_pod_row:
                self.next_pod_row += 1
            self.pod_row[pi.pod.uid] = row

        # refill the mirror rows (node + every pod on a dirty node, which
        # covers in-place pod updates)
        t = self.builder.table
        # a dirty node can have interned a NEW taint inside the cap: its
        # [T] vocab-metadata row lands too (ids are append-only)
        for ti in range(len(t.taint)):
            if not a["taint_is_hard"][ti] and not a["taint_is_prefer"][ti]:
                _, _, effect = t.taint.key(ti)
                a["taint_is_hard"][ti] = effect in (
                    api.TAINT_EFFECT_NO_SCHEDULE,
                    api.TAINT_EFFECT_NO_EXECUTE)
                a["taint_is_prefer"][ti] = (
                    effect == api.TAINT_EFFECT_PREFER_NO_SCHEDULE)
        image_nodes = a["_image_nodes"]
        node_rows = []
        for i, ni in dirty:
            old_imgs = set(np.nonzero(a["images"][i])[0].tolist())
            fill_node_row(a, i, ni, t)
            new_imgs = set(np.nonzero(a["images"][i])[0].tolist())
            for ii in old_imgs - new_imgs:
                image_nodes[ii] -= 1
            for ii in new_imgs - old_imgs:
                image_nodes[ii] += 1
            for pi in ni.pods:
                row = self.pod_row[pi.pod.uid]
                fill_pod_row(a, row, pi, i, t)
                touched_pods.add(row)
            self.node_pods[ni.node_name] = [pi.pod.uid for pi in ni.pods]
            self.node_terms[ni.node_name] = any(pod_has_terms(pi, hw)
                                                for pi in ni.pods)
            self.node_gen[ni.node_name] = ni.generation
            node_rows.append(i)
        # images no node carries anymore read 0 in a fresh build
        a["image_size"][image_nodes <= 0] = 0.0
        a["image_spread"] = image_nodes / max(float(len(node_infos)), 1.0)

        term_span = ()
        if terms_dirty:
            t_terms = wallclock()
            self._refresh_terms(node_infos)
            term_span = (("delta-terms", t_terms, wallclock()),)

        pod_rows = sorted(touched_pods)
        if grown:
            # a scatter cannot grow a tensor: re-upload the (already
            # updated) mirror, no build() walk
            self.cycles_since_resync = 0
            self.resync_count += 1
            t_build = wallclock()
            self._upload()
            return self.cluster, DeltaStats(
                len(node_rows) + len(pod_rows), True, "pod-axis-growth",
                (("delta-build", t0, t_build),) + term_span
                + (("resync", t_build, wallclock()),))
        delta = gather_delta(self.host, node_rows, pod_rows)
        t_build = wallclock()
        self.cluster = self._apply(delta, donate=donate,
                                   replace_terms=terms_dirty)
        self.cycles_since_resync += 1
        spans = ((("delta-build", t0, t_build),) + term_span
                 + (("delta-apply", t_build, wallclock()),))
        vspan, vstats = self._verify_tick(node_infos, names, pending)
        if vstats is not None:
            return self.cluster, vstats._replace(spans=spans
                                                 + vstats.spans)
        return self.cluster, DeltaStats(
            len(node_rows) + len(pod_rows), False, "", spans + vspan)

    # ------------------------------------------------------------- resync

    def _resync(self, node_infos, names: List[str], reason: str,
                t0: float, pending=()):
        """The full rebuild behind every trigger, and the vocab
        COMPACTION point: the intern table restarts fresh (ids need only
        be stable between resyncs), and this cycle's pending/nominated
        pods are re-interned before sizing so batch and cluster tensors
        agree on widths."""
        self.builder = SnapshotBuilder(
            hard_pod_affinity_weight=self.hard_pod_affinity_weight)
        if pending:
            self.builder.intern_pending(pending)
        host = self.builder.build(node_infos)
        a = host.arrays
        self.host = host
        self.node_names = list(names)
        self.node_gen = {ni.node_name: ni.generation for ni in node_infos}
        self.node_pods = {ni.node_name: [pi.pod.uid for pi in ni.pods]
                          for ni in node_infos}
        hw = self.hard_pod_affinity_weight
        self.node_terms = {ni.node_name: any(pod_has_terms(pi, hw)
                                             for pi in ni.pods)
                           for ni in node_infos}
        self.pod_row = dict(a["_pod_rows"])
        self.next_pod_row = len(self.pod_row)
        self.free_rows = []
        self.caps = self.signature()
        self.cycles_since_resync = 0
        # a resync re-uploads the mirror wholesale: device == mirror by
        # construction, so the verify cadence restarts
        self.cycles_since_verify = 0
        self.resync_count += 1
        self._upload()
        return self.cluster, DeltaStats(
            0, True, reason, (("resync", t0, wallclock()),))

    def _grow_pod_axis(self, needed: int) -> None:
        """Pad the mirror's pod-axis arrays to the next pow2 bucket with
        rows identical to a fresh build's padding."""
        a = self.host.arrays
        PP = a["pod_node"].shape[0]
        new_pp = pow2_bucket(needed, 8)
        n = new_pp - PP
        if n <= 0:
            return
        for field, fill in _POD_FIELDS:
            arr = a[field]
            pad = np.full((n,) + arr.shape[1:], fill, arr.dtype)
            a[field] = np.concatenate([arr, pad])

    def _upload(self) -> None:
        """Full host->device copy of the mirror (resync, pod-axis
        growth)."""
        t = wallclock()
        self.cluster = self.host.to_device(self.device)
        self.upload_s += wallclock() - t

    def _refresh_terms(self, node_infos) -> None:
        """Term-only rebuild: walk the term OWNERS, recompile the
        flattened ExistingTerms against the persistent table, and stage
        them in the mirror for wholesale replacement.  The owners follow
        build()'s node-walk order, so the rows equal a rebuild's (pod_idx
        points at the stable delta rows)."""
        filter_owners, score_owners = [], []
        for ni in node_infos:
            for pi in ni.pods:
                row = self.pod_row[pi.pod.uid]
                if pi.required_anti_affinity_terms:
                    filter_owners.append((pi, row))
                if (pi.preferred_affinity_terms
                        or pi.preferred_anti_affinity_terms
                        or pi.required_affinity_terms):
                    score_owners.append((pi, row))
        a = self.host.arrays
        a["filter_terms"] = self.builder._build_terms(filter_owners,
                                                      kind="filter")
        a["score_terms"] = self.builder._build_terms(score_owners,
                                                     kind="score")

    def _apply(self, delta: ClusterDelta, donate: bool,
               replace_terms: bool = False):
        from ..models import programs
        t = wallclock()
        cluster = self.cluster
        if replace_terms:
            a = self.host.arrays
            cluster = cluster._replace(
                filter_terms=_terms_to_device(a["filter_terms"],
                                              self.device),
                score_terms=_terms_to_device(a["score_terms"], self.device))
        out = programs.apply_cluster_delta(cluster, delta, donate=donate)
        self.upload_s += wallclock() - t
        return out
