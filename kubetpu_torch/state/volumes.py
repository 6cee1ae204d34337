"""Device-side volume filter family: the [B, N] feasibility mask for
VolumeBinding(Filter) / VolumeZone / NodeVolumeLimits / {EBS,GCEPD,
AzureDisk,Cinder}Limits / VolumeRestrictions, computed for a whole batch
on the cluster's device; the counterpart of kubetpu/state/volumes.py.

The host plugin classes (plugins/volumes.py) remain the source of truth
for semantics: build_volume_overlay (numpy, the JAX package's builder
unchanged) calls THEIR counting and limit-resolution methods, and
volume_mask evaluates the per-node verdicts as f32 products of 0/1
operands, replacing the O(B x N) Python filter loop.  Every product sums
integers below 2^24, so it is exact in any summation order, on the CPU
and the card alike (TF32 stays off, utils/device.py).  The host plugins
still run at commit time (the scheduler's commit-time re-check), so
intra-batch volume races keep the serial guarantees.

Semantics covered (reference files per plugin docstrings):
- VolumeBinding.filter: bound PVC -> PV node-affinity match
  (volumebinding/volume_binding.go FindPodVolumes); unbound PVC ->
  matchable unbound PV on the node, or a WaitForFirstConsumer class
  (provisionable).  "Matchable" pre-filters by the claim's full
  requirement signature at overlay-build time — StorageClass, storage
  request vs PV capacity, access-mode superset (pv_satisfies_claim, the
  host plugin's own matcher).  Known deviation (the JAX package's): claim
  label selectors (spec.selector) are not matched, neither here nor in
  the host plugin, and immediate-binding unbound claims are judged per
  node rather than failing the pod outright.
- VolumeZone: a node with NO zone/region labels passes; otherwise every
  bound PV's zone-ish label value set must contain the node's value
  (volumezone/volume_zone.go:80).
- Limits family: |used-distinct-vols(node, driver) U new(pod, driver)|
  <= resolved limit, checked only for drivers the pod demands
  (nodevolumelimits/{csi,non_csi}.go).
- VolumeRestrictions: a shared conflict token between the pod's probes
  and a node's registered tokens fails the node
  (volumerestrictions/volume_restrictions.go:48).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from ..api import types as api
from ..ops.selectors import (SelectorCompiler, SelectorSet, match_selectors,
                             selector_to_device)
from ..plugins import volumes as vplug
from ..utils.device import copy_to
from ..utils.intern import pow2_bucket

# host filter plugins this mask covers: pods whose only relevant host
# filters are these skip the per-(pod, node) Python loop entirely
DEVICE_COVERED_PLUGINS = frozenset({
    "VolumeBinding", "VolumeZone", "NodeVolumeLimits", "EBSLimits",
    "GCEPDLimits", "AzureDiskLimits", "CinderLimits", "VolumeRestrictions",
})


def _conflict_tokens(v: api.Volume):
    """(probe, register) conflict-token sets for VolumeRestrictions
    (volume_restrictions.go:48 isVolumeConflict), the NodePorts wildcard
    encoding: conflict(v, ev) <=> probe(v) & register(ev) != {}.
    GCE/ISCSI/RBD conflict unless BOTH are read-only; EBS always."""
    for kind, src, ro_exempt in (("gce", v.gce_persistent_disk, True),
                                 ("ebs", v.aws_elastic_block_store, False),
                                 ("iscsi", v.iscsi, True),
                                 ("rbd", v.rbd, True)):
        if not src:
            continue
        vid = (kind, src)
        if not ro_exempt:
            return [(vid, "any")], [(vid, "any")]
        if v.read_only:
            # conflicts only with a read-write holder
            return [(vid, "rw")], [(vid, "any")]
        return [(vid, "any"), (vid, "rw")], [(vid, "any"), (vid, "rw")]
    return [], []

_BIG = np.float32(2 ** 30)


class VolumeOverlay(NamedTuple):
    """Per-cycle host-built (numpy) arrays for the device volume mask.  All string
    ids (volume ids, PV names, StorageClass names, limit drivers) use
    cycle-local vocabularies — nothing is interned globally."""
    # limits: vol vocab V (driver-qualified distinct volume ids)
    pod_vol_ids: np.ndarray    # [B, MV] i32 vol ids the pod demands (-1 pad)
    node_vol_ids: np.ndarray   # [N, MU] i32 vol ids in use on the node
    driver_hot: np.ndarray     # [V, D] f32 one-hot: vol id -> driver
    node_limit: np.ndarray     # [N, D] f32 resolved limit (BIG = none)
    # VolumeRestrictions conflict tokens (ports-style wildcard encoding)
    pod_conf_ids: np.ndarray   # [B, MC] i32 tokens the pod probes
    node_conf_ids: np.ndarray  # [N, MC2] i32 tokens registered on the node
    # VolumeBinding: bound-PV node affinity + unbound-PVC availability
    pv_sel: SelectorSet        # [PVT] per-(pv, term) node selectors
    pv_term_of: np.ndarray     # [PVT] i32 owning PV row (-1 pad)
    pv_no_aff: np.ndarray      # [PVu] bool PV has no nodeAffinity (always ok)
    pod_pv_hot: np.ndarray     # [B, PVu] f32 bound PVs the pod requires
    sc_pv_hot: np.ndarray      # [SC, PVu] f32 unbound PVs per StorageClass
    pod_sc_hot: np.ndarray     # [B, SC] f32 classes the pod needs available
    # VolumeZone
    zone_sel: SelectorSet      # [B] combined zone-label requirements
    pod_has_zone: np.ndarray   # [B] bool pod carries zone constraints
    pod_zone_err: np.ndarray   # [B] bool VolumeZone errors (unbound claim
                               #   without WFFC class / missing PV) — fails
                               #   only nodes that HAVE zone labels (the
                               #   no-zone-labels early pass wins first,
                               #   volume_zone.go:86)
    zone_keyids: np.ndarray    # [ZK] i32 key-vocab ids of the zone keys
    # hard per-pod failures (errors the host plugin turns into statuses)
    pod_all_fail: np.ndarray   # [B] bool


def _limit_plugins(store, enabled: Set[str]):
    out = []
    for cls in (vplug.EBSLimits, vplug.GCEPDLimits, vplug.AzureDiskLimits,
                vplug.CinderLimits):
        if cls.NAME in enabled:
            out.append((cls.NAME, cls(store)))
    return out


def build_volume_overlay(store, node_infos, pods: List[api.Pod], table,
                         enabled: Set[str]) -> Optional[VolumeOverlay]:
    """Build the overlay for a batch, or None when no pod needs it.
    `enabled`: names of the profile's enabled host filter plugins."""
    if store is None:
        return None
    relevant = [bool(p.spec.volumes) for p in pods]
    if not any(relevant):
        return None
    B = pow2_bucket(len(pods), 8)
    N = pow2_bucket(len(node_infos), 8)

    csi = vplug.NodeVolumeLimits(store) \
        if "NodeVolumeLimits" in enabled else None
    intree = _limit_plugins(store, enabled)
    binding = vplug.VolumeBinding(store) if "VolumeBinding" in enabled else None
    zone = vplug.VolumeZone(store) if "VolumeZone" in enabled else None
    restrict = "VolumeRestrictions" in enabled

    # ---- VolumeRestrictions conflict tokens
    conf_ids: Dict[Tuple, int] = {}

    def conf_tokens(pod, register: bool) -> List[int]:
        out: List[int] = []
        if not restrict:
            return out
        for v in pod.spec.volumes:
            probe, reg = _conflict_tokens(v)
            for tok in (reg if register else probe):
                out.append(conf_ids.setdefault(tok, len(conf_ids)))
        return out

    pod_conf_lists = [conf_tokens(p, register=False) if r else []
                      for p, r in zip(pods, relevant)]

    # ---- cycle-local vocabularies
    vol_ids: Dict[Tuple[str, str], int] = {}   # (driver, vol) -> id
    drivers: Dict[str, int] = {}               # driver key -> column

    def vol_id(driver: str, vol: str) -> int:
        d = drivers.setdefault(driver, len(drivers))
        return vol_ids.setdefault((driver, vol), len(vol_ids)), d

    def pod_demands(pod) -> List[int]:
        ids = []
        if csi is not None:
            by_drv: Dict[str, Set[str]] = {}
            csi._count_csi(pod, by_drv)
            for drv, vols in by_drv.items():
                for v in vols:
                    ids.append(vol_id("csi:" + drv, v)[0])
        for name, plug in intree:
            out: Set[str] = set()
            plug._count(pod, out)
            for v in out:
                ids.append(vol_id(name, v)[0])
        return ids

    pod_vol_lists = [pod_demands(p) if r else []
                     for p, r in zip(pods, relevant)]
    # one pass over each node's existing pods covers BOTH the limit vol ids
    # and the conflict tokens — this walk is the O(existing pods) cost of
    # the overlay, so it must not run twice
    node_vol_lists: List[List[int]] = []
    node_conf_lists: List[List[int]] = []
    for ni in node_infos:
        ids: List[int] = []
        toks: List[int] = []
        for pi in ni.pods:
            if pi.pod.spec.volumes:
                ids.extend(pod_demands(pi.pod))
                toks.extend(conf_tokens(pi.pod, register=True))
        node_vol_lists.append(sorted(set(ids)))
        node_conf_lists.append(sorted(set(toks)))

    # min-8 floors: tiny per-cycle fluctuations must not walk an XLA
    # recompile ladder on the serving path
    MC = pow2_bucket(max((len(x) for x in pod_conf_lists), default=0), 8)
    MC2 = pow2_bucket(max((len(x) for x in node_conf_lists), default=0), 8)
    pod_conf_ids = np.full((B, MC), -1, np.int32)
    for i, ids in enumerate(pod_conf_lists):
        pod_conf_ids[i, :len(ids)] = ids
    node_conf_ids = np.full((N, MC2), -1, np.int32)
    for n, ids in enumerate(node_conf_lists):
        node_conf_ids[n, :len(ids)] = ids

    V = pow2_bucket(len(vol_ids), 8)
    D = pow2_bucket(len(drivers), 8)
    MV = pow2_bucket(max((len(x) for x in pod_vol_lists), default=0), 8)
    MU = pow2_bucket(max((len(x) for x in node_vol_lists), default=0), 8)
    pod_vol_ids = np.full((B, MV), -1, np.int32)
    for i, ids in enumerate(pod_vol_lists):
        pod_vol_ids[i, :len(ids)] = ids
    node_vol_ids = np.full((N, MU), -1, np.int32)
    for n, ids in enumerate(node_vol_lists):
        node_vol_ids[n, :len(ids)] = ids
    driver_hot = np.zeros((V, D), np.float32)
    for (drv, _), vid in vol_ids.items():
        driver_hot[vid, drivers[drv]] = 1.0

    node_limit = np.full((N, D), _BIG, np.float32)
    for n, ni in enumerate(node_infos):
        if csi is not None:
            for drv, lim in csi._node_limits(ni).items():
                d = drivers.get("csi:" + drv)
                if d is not None:
                    node_limit[n, d] = lim
        for name, plug in intree:
            d = drivers.get(name)
            if d is not None:
                node_limit[n, d] = plug._max_volumes(ni)

    # ---- VolumeBinding: bound PVs + unbound availability per class
    pv_rows: Dict[str, int] = {}
    pv_objs: List[api.PersistentVolume] = []
    # claim-requirement rows: (class, storage request, access modes) ->
    # row, with an exemplar claim per row for the PV-side matcher
    sc_rows: Dict[Tuple, int] = {}
    sc_claims: List[api.PersistentVolumeClaim] = []

    def pv_row(pv) -> int:
        r = pv_rows.get(pv.metadata.name)
        if r is None:
            r = pv_rows[pv.metadata.name] = len(pv_objs)
            pv_objs.append(pv)
        return r

    pod_bound: List[List[int]] = []
    pod_scs: List[List[int]] = []
    pod_all_fail = np.zeros((B,), bool)
    pod_zone_err = np.zeros((B,), bool)
    zone_reqs: List[Optional[api.LabelSelector]] = []
    pod_has_zone = np.zeros((B,), bool)
    for i, (pod, rel) in enumerate(zip(pods, relevant)):
        bound: List[int] = []
        scs: List[int] = []
        # one requirement PER (PV, zone key): the node must satisfy EVERY
        # bound PV's zone set independently — unioning values across PVs
        # would wrongly admit nodes matching only one of them
        zreq: Set[Tuple[str, frozenset]] = set()
        if rel:
            for v in pod.spec.volumes:
                if not v.persistent_volume_claim:
                    continue
                pvc = store.get_pvc(pod.namespace, v.persistent_volume_claim)
                if pvc is None:
                    # VolumeBinding fails every node (and prefilter fails
                    # the pod first); VolumeZone alone only errors on
                    # zone-labeled nodes
                    if binding is not None:
                        pod_all_fail[i] = True
                    elif zone is not None:
                        pod_zone_err[i] = True
                    continue
                if pvc.volume_name:
                    pv = store.get_pv(pvc.volume_name)
                    if pv is None:
                        if binding is not None:
                            pod_all_fail[i] = True
                        elif zone is not None:
                            pod_zone_err[i] = True
                        continue
                    if binding is not None:
                        bound.append(pv_row(pv))
                    if zone is not None:
                        for k, want in pv.metadata.labels.items():
                            if k in vplug._ZONE_KEYS:
                                zreq.add((k, frozenset(want.split("__"))))
                else:
                    sc_name = pvc.storage_class_name
                    sc = (store.get_storage_class(sc_name)
                          if sc_name else None)
                    wffc = (sc is not None and sc.volume_binding_mode
                            == "WaitForFirstConsumer")
                    if zone is not None and not wffc:
                        # VolumeZone errors on unbound claims without a
                        # WaitForFirstConsumer class (volume_zone.go:109)
                        # — on nodes with zone labels
                        pod_zone_err[i] = True
                    if binding is not None and not wffc:
                        # matchable-PV check, keyed by the claim's FULL
                        # requirement signature — class ("" is a real key:
                        # a classless PVC matches classless PVs), storage
                        # request, access modes — so capacity/access-mode
                        # pre-filtering happens host-side at overlay-build
                        # time and the device mask agrees with the host
                        # plugin's commit-time verdict (a permissive mask
                        # here costs a speculative-chain discard per
                        # commit failure in pipelined mode)
                        sig = (sc_name or "",
                               vplug.claim_storage_request(pvc),
                               frozenset(pvc.access_modes))
                        r = sc_rows.get(sig)
                        if r is None:
                            r = sc_rows[sig] = len(sc_rows)
                            sc_claims.append(pvc)
                        scs.append(r)
        pod_bound.append(bound)
        pod_scs.append(scs)
        if zreq:
            pod_has_zone[i] = True
            # AND of per-(PV, key) In requirements == one label selector
            # (repeated keys are fine: requirements AND-combine)
            zone_reqs.append(api.LabelSelector(match_expressions=[
                api.NodeSelectorRequirement(key=k, operator="In",
                                            values=sorted(vals))
                for k, vals in sorted(zreq,
                                      key=lambda kv: (kv[0],
                                                      sorted(kv[1])))]))
        else:
            zone_reqs.append(None)

    # unbound PVs per claim-requirement row (for the matchable check):
    # ONE scan over the PV list probes every registered requirement
    # signature — rows are few (distinct (class, size, modes) triples in
    # the batch), and pv_satisfies_claim is the host plugin's own
    # matcher, so the device verdict can never be more permissive than
    # the commit-time re-check on this dimension
    sc_pv_pairs: List[Tuple[int, int]] = []
    if binding is not None and sc_rows:
        for pv in store.list_pvs():
            if store.pv_is_bound(pv.metadata.name):
                continue
            for sig, r in sc_rows.items():
                if vplug.pv_satisfies_claim(pv, sc_claims[r]):
                    sc_pv_pairs.append((r, pv_row(pv)))

    PVu = pow2_bucket(len(pv_objs), 8)
    # flatten PV nodeAffinity terms (OR-of-terms, like required node
    # affinity); a PV without affinity matches everywhere
    compiler = SelectorCompiler(table)
    term_sels: List = []
    term_of: List[int] = []
    pv_no_aff = np.zeros((PVu,), bool)
    for r, pv in enumerate(pv_objs):
        if pv.node_affinity is None:
            pv_no_aff[r] = True
            continue
        for term in pv.node_affinity.node_selector_terms:
            term_sels.append(term)
            term_of.append(r)
    PVT = pow2_bucket(len(term_sels), 8)
    pv_sel = compiler.compile(term_sels + [None] * (PVT - len(term_sels)),
                              pad_s=PVT, intern_new=False)
    pv_term_of = np.full((PVT,), -1, np.int32)
    pv_term_of[:len(term_of)] = term_of

    pod_pv_hot = np.zeros((B, PVu), np.float32)
    for i, rows in enumerate(pod_bound):
        for r in rows:
            pod_pv_hot[i, r] = 1.0
    SC = pow2_bucket(len(sc_rows), 8)
    sc_pv_hot = np.zeros((SC, PVu), np.float32)
    for r, row in sc_pv_pairs:
        sc_pv_hot[r, row] = 1.0
    pod_sc_hot = np.zeros((B, SC), np.float32)
    for i, rows in enumerate(pod_scs):
        for r in rows:
            pod_sc_hot[i, r] = 1.0

    zone_sel = compiler.compile(zone_reqs + [None] * (B - len(zone_reqs)),
                                pad_s=B, intern_new=False)
    zone_keyids = np.asarray(
        [table.key.get(k) for k in vplug._ZONE_KEYS], np.int32)

    return VolumeOverlay(
        pod_vol_ids=pod_vol_ids, node_vol_ids=node_vol_ids,
        driver_hot=driver_hot, node_limit=node_limit,
        pod_conf_ids=pod_conf_ids, node_conf_ids=node_conf_ids,
        pv_sel=pv_sel, pv_term_of=pv_term_of, pv_no_aff=pv_no_aff,
        pod_pv_hot=pod_pv_hot, sc_pv_hot=sc_pv_hot, pod_sc_hot=pod_sc_hot,
        zone_sel=zone_sel, pod_has_zone=pod_has_zone,
        pod_zone_err=pod_zone_err, zone_keyids=zone_keyids,
        pod_all_fail=pod_all_fail)


def volume_mask(cluster, overlay: VolumeOverlay) -> torch.Tensor:
    """[B, N] bool feasibility from the volume family, on the cluster's
    device.  Reads only the node-label tensors of the cluster.  The
    overlay is numpy, so the loops below run over the drivers and the
    conflict-token columns it really holds (a padded driver column
    demands nothing and a padded token column probes nothing, so
    neither changes the result) without a device read."""
    dev = cluster.kv.device
    drivers = np.flatnonzero(overlay.driver_hot.any(axis=0)).tolist()
    n_conf = int((overlay.pod_conf_ids >= 0).any(axis=0).sum())
    ov = VolumeOverlay(**{
        f: (selector_to_device(v, dev) if isinstance(v, SelectorSet)
            else copy_to(v, dev))
        for f, v in overlay._asdict().items()})
    return _volume_mask(cluster.kv, cluster.keymask, cluster.num, ov,
                        drivers, n_conf)


def _dense(ids: torch.Tensor, V: int) -> torch.Tensor:
    """[X, V] f32 one-hot rows of the id lists ``ids`` [X, M] (-1 pad):
    the max-scatter of kubetpu/state/volumes.py _dense, with the validity
    mask as the source, so a padded id writes 0 and never sums."""
    valid = ((ids >= 0) & (ids < V)).float()
    out = torch.zeros((ids.shape[0], V), dtype=torch.float32,
                      device=ids.device)
    return out.scatter_reduce_(1, ids.clamp(0, V - 1).long(), valid,
                               reduce="amax")


def _volume_mask(kv, keymask, num, ov: VolumeOverlay, drivers: List[int],
                 n_conf: int) -> torch.Tensor:
    B = ov.pod_vol_ids.shape[0]
    N = kv.shape[0]

    # ---- VolumeBinding: bound-PV node affinity (OR over terms)
    m = match_selectors(ov.pv_sel, kv, keymask, num)          # [PVT, N]
    PVu = ov.pv_no_aff.shape[0]
    term_ok = m.float() * (ov.pv_term_of >= 0).float()[:, None]
    pv_ok = torch.zeros((PVu, N), dtype=torch.float32, device=kv.device)
    pv_ok.scatter_reduce_(
        0, ov.pv_term_of.clamp(0, PVu - 1).long()[:, None].expand(-1, N),
        term_ok, reduce="amax")
    pv_ok = torch.maximum(pv_ok, ov.pv_no_aff[:, None].float())
    bound_fail = (ov.pod_pv_hot @ (1.0 - pv_ok)) > 0.5
    # unbound claims: every referenced class needs >=1 matchable PV here
    sc_ok = (ov.sc_pv_hot @ pv_ok) > 0.5
    unbound_fail = (ov.pod_sc_hot @ (1.0 - sc_ok.float())) > 0.5

    # ---- VolumeZone
    zid_ok = ov.zone_keyids >= 0
    zk = ov.zone_keyids.clamp(0, keymask.shape[1] - 1).long()
    has_any_zone = (keymask[:, zk] & zid_ok[None, :]).any(dim=1)   # [N]
    zmatch = match_selectors(ov.zone_sel, kv, keymask, num)[:B]   # [B, N]
    zone_ok = torch.where(ov.pod_has_zone[:, None],
                          zmatch | ~has_any_zone[None, :],
                          torch.ones_like(zmatch))
    zone_ok = zone_ok & ~(ov.pod_zone_err[:, None] & has_any_zone[None, :])

    # ---- limits: |used U new| <= limit per driver the pod demands
    ok = torch.ones((B, N), dtype=torch.bool, device=kv.device)
    if drivers:
        V = ov.driver_hot.shape[0]
        pod_vols = _dense(ov.pod_vol_ids, V)      # [B, V]
        node_used = _dense(ov.node_vol_ids, V)    # [N, V]
        node_free_t = (1.0 - node_used).T         # [V, N]
        for d in drivers:
            vm = ov.driver_hot[:, d]                               # [V]
            pv_d = pod_vols * vm[None, :]
            extra = pv_d @ node_free_t                             # [B, N]
            cnt = node_used @ vm                                   # [N]
            demand = pv_d.sum(dim=1) > 0.5
            ok_d = (cnt[None, :] + extra) <= ov.node_limit[:, d][None, :]
            ok = ok & (~demand[:, None] | ok_d)

    # ---- VolumeRestrictions: any shared conflict token fails; one token
    # column of the pod at a time, so the largest temporary is
    # [B, N, MC2] (the JAX package's 4-D equality fuses under XLA)
    conflict = torch.zeros((B, N), dtype=torch.bool, device=kv.device)
    nc = ov.node_conf_ids
    for c in range(n_conf):
        pc = ov.pod_conf_ids[:, c]
        hit = (pc[:, None, None] == nc[None, :, :]).any(dim=2)
        conflict |= hit & (pc >= 0)[:, None]

    return (ok & ~bound_fail & ~unbound_fail & zone_ok & ~conflict
            & ~ov.pod_all_fail[:, None])
