"""Host-side volume plugin family; a copy of kubetpu/plugins/volumes.py.

These stay host plugins (not kernels) because they read/write API objects
(PVCs/PVs) and their per-pod work is small and gated on the pod actually
using volumes — mirroring where the reference put its complexity:
  VolumeBinding      reference: volumebinding/volume_binding.go +
                     pkg/controller/volume/scheduling (SchedulerVolumeBinder)
  VolumeRestrictions reference: volumerestrictions/volume_restrictions.go
  VolumeZone         reference: volumezone/volume_zone.go
  NodeVolumeLimits   reference: nodevolumelimits/{csi,non_csi}.go

The framework runner calls .relevant(pod) first and skips the whole plugin
for volume-less pods, so the device path is untouched.  The scheduler
evaluates the Filter half of the family for a whole batch as one [B, N]
device mask (state/volumes.py), which calls the counting and
limit-resolution methods below, and runs these filters again per pod at
commit.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

from ..api import types as api
from ..framework import interface as fw
from ..framework.interface import CycleState, Status

ERR_REASON_BIND_CONFLICT = "node(s) didn't find available persistent volumes to bind"
ERR_REASON_NODE_CONFLICT = "node(s) had volume node affinity conflict"
ERR_REASON_DISK_CONFLICT = "node(s) had no available disk"
ERR_REASON_ZONE_CONFLICT = "node(s) had no available volume zone"
ERR_REASON_MAX_VOLUME_COUNT = "node(s) exceed max volume count"

# zone/region label keys checked by VolumeZone (reference: volume_zone.go:41)
_ZONE_KEYS = (api.LABEL_ZONE, api.LABEL_REGION, api.LABEL_ZONE_LEGACY,
              api.LABEL_REGION_LEGACY)


def _quantity_or_none(q) -> Optional[float]:
    """Parse a quantity, treating a malformed string as absent: one bad
    object in the store must degrade to an unconstrained match, not
    raise out of the per-cycle overlay build / commit-time re-check."""
    from ..api.resource import parse_quantity
    try:
        return float(parse_quantity(q))
    except ValueError:
        return None


def claim_storage_request(pvc: api.PersistentVolumeClaim) -> float:
    """Requested storage bytes (0 = unconstrained)."""
    q = pvc.resources.requests.get("storage")
    if not q:
        return 0.0
    return _quantity_or_none(q) or 0.0


def pv_satisfies_claim(pv: api.PersistentVolume,
                       pvc: api.PersistentVolumeClaim) -> bool:
    """Node-independent half of findMatchingVolume (reference:
    pkg/controller/volume/persistentvolume/pv_controller checkVolumeSatisfy
    ClaimSpec): same StorageClass, capacity >= the claim's storage
    request, and access modes a SUPERSET of the claim's.  A PV without a
    declared capacity is treated as unbounded and a claim without access
    modes as unconstrained (back-compat with minimal objects).  Shared by
    the host plugin's _find_matching_pv and the device overlay's
    matchable-PV pre-filter (state/volumes.py) so commit-time re-checks
    can never disagree with the device mask on this dimension."""
    if pv.storage_class_name != pvc.storage_class_name:
        return False
    want = claim_storage_request(pvc)
    if want > 0:
        cap = pv.capacity.get("storage")
        got = _quantity_or_none(cap) if cap is not None else None
        if got is not None and got < want:
            return False
    if pvc.access_modes and not set(pvc.access_modes) <= set(pv.access_modes):
        return False
    return True

class _VolumePlugin(fw.Plugin):
    def __init__(self, store=None):
        self.store = store

    def relevant(self, pod: api.Pod) -> bool:
        return bool(pod.spec.volumes)

    def _pvc(self, pod: api.Pod, claim: str) -> Optional[api.PersistentVolumeClaim]:
        if self.store is None:
            return None
        return self.store.get_pvc(pod.namespace, claim)

    def _pv(self, name: str) -> Optional[api.PersistentVolume]:
        if self.store is None or not name:
            return None
        return self.store.get_pv(name)


class VolumeBinding(_VolumePlugin, fw.PreFilterPlugin, fw.FilterPlugin,
                    fw.ReservePlugin, fw.UnreservePlugin, fw.PreBindPlugin,
                    fw.PostBindPlugin):
    """Delayed PVC binding (reference: volumebinding/volume_binding.go:223;
    FindPodVolumes/AssumePodVolumes/BindPodVolumes from
    pkg/controller/volume/scheduling/scheduler_binder.go)."""
    NAME = "VolumeBinding"
    STATE_KEY = "PreFilterVolumeBinding"

    def pre_filter(self, state: CycleState, pod: api.Pod) -> Status:
        # PVC existence is a basic check (reference:
        # generic_scheduler.go:1084 podPassesBasicChecks)
        for v in pod.spec.volumes:
            if v.persistent_volume_claim:
                pvc = self._pvc(pod, v.persistent_volume_claim)
                if pvc is None:
                    return Status.unresolvable(
                        f'persistentvolumeclaim "{v.persistent_volume_claim}" '
                        "not found")
                if pvc.metadata.deletion_timestamp is not None:
                    return Status.unresolvable(
                        f'persistentvolumeclaim "{v.persistent_volume_claim}" '
                        "is being deleted")
        return Status.success()

    def filter(self, state: CycleState, pod: api.Pod, node_info) -> Status:
        """FindPodVolumes (reference: scheduler_binder.go:220): bound PVCs
        must have node-compatible PVs; unbound PVCs must be matchable or
        provisionable on this node."""
        node = node_info.node
        for v in pod.spec.volumes:
            if not v.persistent_volume_claim:
                continue
            pvc = self._pvc(pod, v.persistent_volume_claim)
            if pvc is None:
                return Status.unresolvable("pvc not found")
            if pvc.volume_name:
                pv = self._pv(pvc.volume_name)
                if pv is None or not _pv_matches_node(pv, node):
                    return Status.unschedulable(ERR_REASON_NODE_CONFLICT)
            else:
                if not self._find_matching_pv(pvc, node) \
                        and not self._provisionable(pvc):
                    return Status.unschedulable(ERR_REASON_BIND_CONFLICT)
        return Status.success()

    def _find_matching_pv(self, pvc, node) -> Optional[api.PersistentVolume]:
        if self.store is None:
            return None
        for pv in self.store.list_pvs():
            if (pv_satisfies_claim(pv, pvc)
                    and _pv_matches_node(pv, node)
                    and not self.store.pv_is_bound(pv.metadata.name)):
                return pv
        return None

    def _provisionable(self, pvc) -> bool:
        if self.store is None:
            return False
        sc = self.store.get_storage_class(pvc.storage_class_name)
        return sc is not None and sc.volume_binding_mode == "WaitForFirstConsumer"

    def reserve(self, state: CycleState, pod: api.Pod, node_name: str) -> Status:
        """AssumePodVolumes: pick PVs for unbound claims and cache the
        decision for pre_bind (reference: volume_binding.go Reserve)."""
        decisions: List[Tuple[str, str]] = []  # (pvc name, pv name|"" provision)
        if self.store is not None:
            node = self.store.get_node(node_name)
            if node is None:
                # node deleted between snapshot and commit
                return Status.error(f"node {node_name} no longer exists")
            for v in pod.spec.volumes:
                if not v.persistent_volume_claim:
                    continue
                pvc = self._pvc(pod, v.persistent_volume_claim)
                if pvc is None:
                    return Status.error("pvc disappeared during reserve")
                if pvc.volume_name:
                    continue
                pv = self._find_matching_pv(pvc, node)
                if pv is not None:
                    self.store.assume_pv_binding(pv.metadata.name,
                                                 pvc.metadata.name)
                    decisions.append((pvc.metadata.name, pv.metadata.name))
                elif self._provisionable(pvc):
                    # delayed provisioning: record the claim so pre_bind can
                    # stamp the selected node (reference: scheduler_binder
                    # AssumePodVolumes provisioning decisions)
                    decisions.append((pvc.metadata.name, ""))
                else:
                    # the PV another batch pod just claimed is gone and the
                    # class can't provision: fail reserve -> requeue
                    # (reference: AssumePodVolumes error path)
                    for _, assumed_pv in decisions:
                        if assumed_pv:
                            self.store.forget_pv_binding(assumed_pv)
                    return Status.error(
                        f"no persistent volume available for claim "
                        f"{pvc.metadata.name} on {node_name}")
        state.write(self.STATE_KEY, decisions)
        return Status.success()

    def unreserve(self, state: CycleState, pod: api.Pod, node_name: str) -> None:
        try:
            decisions = state.read(self.STATE_KEY)
        except KeyError:
            return
        if self.store is not None:
            for _, pv_name in decisions:
                if pv_name:
                    self.store.forget_pv_binding(pv_name)
        state.delete(self.STATE_KEY)

    def pre_bind(self, state: CycleState, pod: api.Pod, node_name: str) -> Status:
        """BindPodVolumes: write the assumed bindings through the API
        (reference: volume_binding.go PreBind)."""
        try:
            decisions = state.read(self.STATE_KEY)
        except KeyError:
            return Status.success()
        if self.store is not None:
            for pvc_name, pv_name in decisions:
                try:
                    self.store.bind_pvc(pod.namespace, pvc_name, pv_name,
                                        node_name)
                except Exception as e:
                    return Status.error(f"binding volumes: {e}")
        return Status.success()

    def post_bind(self, state: CycleState, pod: api.Pod, node_name: str) -> None:
        state.delete(self.STATE_KEY)


class VolumeRestrictions(_VolumePlugin, fw.FilterPlugin):
    """Read-write conflict rules for GCE-PD / EBS / ISCSI / RBD
    (reference: volumerestrictions/volume_restrictions.go:134)."""
    NAME = "VolumeRestrictions"

    def relevant(self, pod: api.Pod) -> bool:
        return any(v.gce_persistent_disk or v.aws_elastic_block_store
                   or v.iscsi or v.rbd for v in pod.spec.volumes)

    def filter(self, state: CycleState, pod: api.Pod, node_info) -> Status:
        for v in pod.spec.volumes:
            for existing in node_info.pods:
                for ev in existing.pod.spec.volumes:
                    if _volume_conflict(v, ev):
                        return Status.unschedulable(ERR_REASON_DISK_CONFLICT)
        return Status.success()


def _volume_conflict(v: api.Volume, ev: api.Volume) -> bool:
    """reference: volume_restrictions.go:48 isVolumeConflict."""
    if v.gce_persistent_disk and ev.gce_persistent_disk:
        if (v.gce_persistent_disk == ev.gce_persistent_disk
                and not (v.read_only and ev.read_only)):
            return True
    if v.aws_elastic_block_store and ev.aws_elastic_block_store:
        if v.aws_elastic_block_store == ev.aws_elastic_block_store:
            return True
    if v.iscsi and ev.iscsi:
        if v.iscsi == ev.iscsi and not (v.read_only and ev.read_only):
            return True
    if v.rbd and ev.rbd:
        if v.rbd == ev.rbd and not (v.read_only and ev.read_only):
            return True
    return False


class VolumeZone(_VolumePlugin, fw.FilterPlugin):
    """Bound PV zone/region labels must match the node
    (reference: volumezone/volume_zone.go:185)."""
    NAME = "VolumeZone"

    def filter(self, state: CycleState, pod: api.Pod, node_info) -> Status:
        """reference: volume_zone.go:80 Filter — a node with NO zone labels
        always fits (fast path); an unbound claim is skipped only under a
        WaitForFirstConsumer class; zone/region mismatch is
        UnschedulableAndUnresolvable (no preemption can move a node's
        zone)."""
        if not pod.spec.volumes:
            return Status.success()
        node = node_info.node
        node_constraints = {k: v for k, v in node.metadata.labels.items()
                            if k in _ZONE_KEYS}
        if not node_constraints:
            return Status.success()
        for v in pod.spec.volumes:
            if not v.persistent_volume_claim:
                continue
            pvc = self._pvc(pod, v.persistent_volume_claim)
            if pvc is None:
                return Status.error("PersistentVolumeClaim was not found: "
                                    f"{v.persistent_volume_claim!r}")
            if not pvc.volume_name:
                sc = (self.store.get_storage_class(pvc.storage_class_name)
                      if self.store and pvc.storage_class_name else None)
                if sc is not None and \
                        sc.volume_binding_mode == "WaitForFirstConsumer":
                    continue   # unbound, delayed binding: skip
                return Status.error(
                    "PersistentVolumeClaim had no pv name and no "
                    "WaitForFirstConsumer storageClass")
            pv = self._pv(pvc.volume_name)
            if pv is None:
                return Status.error("PersistentVolume was not found: "
                                    f"{pvc.volume_name!r}")
            for key, want in pv.metadata.labels.items():
                if key not in _ZONE_KEYS:
                    continue
                # PV zone labels may hold a __ separated set
                allowed = set(want.split("__"))
                if node_constraints.get(key) not in allowed:
                    return Status.unresolvable(ERR_REASON_ZONE_CONFLICT)
        return Status.success()


class NodeVolumeLimits(_VolumePlugin, fw.FilterPlugin):
    """CSI attachable-volume count limits (reference: nodevolumelimits/
    csi.go:62 — CSIName == "NodeVolumeLimits").  Counts CSI-sourced
    volumes (PVC -> PV -> spec.csi) per driver against the node's CSINode
    allocatable; a driver with no CSINode entry has no limit (csi.go:263).
    In-tree sources are the per-driver plugins' job (EBSLimits etc.);
    CSI-migration double-counting translation is not implemented."""
    NAME = "NodeVolumeLimits"

    def relevant(self, pod: api.Pod) -> bool:
        return any(v.persistent_volume_claim for v in pod.spec.volumes)

    def filter(self, state: CycleState, pod: api.Pod, node_info) -> Status:
        new: Dict[str, Set[str]] = {}
        self._count_csi(pod, new)
        if not new:
            return Status.success()
        limits = self._node_limits(node_info)
        if not limits:
            return Status.success()
        counts: Dict[str, Set[str]] = {}
        for pi in node_info.pods:
            self._count_csi(pi.pod, counts)
        for driver, vols in new.items():
            limit = limits.get(driver)
            if limit is None:
                continue
            total = counts.get(driver, set()) | vols
            if len(total) > limit:
                return Status.unschedulable(ERR_REASON_MAX_VOLUME_COUNT)
        return Status.success()

    def _count_csi(self, pod: api.Pod, out: Dict[str, Set[str]]) -> None:
        """PVC -> PV -> csi source (reference: csi.go:180
        filterAttachableVolumes)."""
        for v in pod.spec.volumes:
            if not v.persistent_volume_claim:
                continue
            pvc = self._pvc(pod, v.persistent_volume_claim)
            pv = self._pv(pvc.volume_name) if pvc else None
            if pv is not None and pv.csi_driver:
                out.setdefault(pv.csi_driver, set()).add(
                    pv.csi_volume_handle or pv.metadata.name)

    def _node_limits(self, node_info) -> Dict[str, int]:
        if self.store is not None and node_info.node is not None:
            csinode = self.store.get_csinode(node_info.node.name)
            if csinode is not None:
                return dict(csinode.driver_allocatable)
        return {}


class _NonCSILimits(_VolumePlugin, fw.FilterPlugin):
    """One in-tree volume type's attachable count limit (reference:
    nodevolumelimits/non_csi.go:126 nonCSILimits + the four filter types).
    Limit resolution order (non_csi.go:310 getMaxVolLimit):
    node.status.allocatable[<attachable-volumes-key>] ->
    $KUBE_MAX_PD_VOLS -> the per-type default.  A PVC that cannot be
    resolved counts against the limit (non_csi.go:230 — unbound claims are
    assumed to need this type)."""
    NAME = ""
    LIMIT_KEY = ""       # volumeutil.*VolumeLimitKey
    DEFAULT_LIMIT = 0
    PROVISIONER = ""     # in-tree provisioner this filter owns

    def _source(self, v) -> Optional[str]:
        raise NotImplementedError

    def relevant(self, pod: api.Pod) -> bool:
        return any(self._source(v) or v.persistent_volume_claim
                   for v in pod.spec.volumes)

    def _match_provisioner(self, pvc: api.PersistentVolumeClaim) -> bool:
        """Does this PVC's StorageClass belong to the running filter?
        (reference: non_csi.go:328 matchProvisioner — nil StorageClassName
        or a missing class both mean NO)."""
        if not pvc.storage_class_name or self.store is None:
            return False
        sc = self.store.get_storage_class(pvc.storage_class_name)
        return sc is not None and sc.provisioner == self.PROVISIONER

    def _count(self, pod: api.Pod, out: Set[str]) -> None:
        """reference: non_csi.go:272 filterVolumes — an unresolvable PVC is
        counted ONLY when its StorageClass provisioner matches this filter's
        type; a PVC that cannot be looked up at all is never counted."""
        for v in pod.spec.volumes:
            src = self._source(v)
            if src:
                out.add(src)
                continue
            if not v.persistent_volume_claim:
                continue
            pvc = (self.store.get_pvc(pod.namespace,
                                      v.persistent_volume_claim)
                   if self.store else None)
            if pvc is None:
                # no guarantee the claim belongs to this predicate
                # (non_csi.go:287-291)
                continue
            pv_id = f"{pod.namespace}/{v.persistent_volume_claim}"
            if not pvc.volume_name:
                # unbound claim: counted iff its class provisions this type
                # (non_csi.go:294-303)
                if self._match_provisioner(pvc):
                    out.add(pv_id)
                continue
            pv = self._pv(pvc.volume_name)
            if pv is None:
                # bound to a deleted PV: same provisioner rule
                # (non_csi.go:306-314)
                if self._match_provisioner(pvc):
                    out.add(pv_id)
                continue
            src = self._source(pv)
            if src:
                out.add(src)

    def filter(self, state: CycleState, pod: api.Pod, node_info) -> Status:
        new: Set[str] = set()
        self._count(pod, new)
        if not new:
            return Status.success()
        used: Set[str] = set()
        for pi in node_info.pods:
            self._count(pi.pod, used)
        if len(used | new) > self._max_volumes(node_info):
            return Status.unschedulable(ERR_REASON_MAX_VOLUME_COUNT)
        return Status.success()

    def _max_volumes(self, node_info) -> int:
        import os
        node = node_info.node
        if node is not None and self.LIMIT_KEY in node.status.allocatable:
            try:
                return int(node.status.allocatable[self.LIMIT_KEY])
            except (TypeError, ValueError):
                pass
        env = os.environ.get("KUBE_MAX_PD_VOLS")
        if env:
            try:
                return int(env)
            except ValueError:
                pass
        return self._default_limit(node)

    def _default_limit(self, node) -> int:
        return self.DEFAULT_LIMIT


# reference: pkg/volume/util/attach_limit.go:30-37.  Go's
# regexp.MatchString is an unanchored SEARCH (only the first alternative
# carries an explicit ^) — compiled once, used with .search()
EBS_NITRO_LIMIT_REGEX = re.compile(r"^[cmr]5.*|t3|z1d")
DEFAULT_MAX_EBS_NITRO_VOLUME_LIMIT = 25
LABEL_INSTANCE_TYPE = "beta.kubernetes.io/instance-type"
LABEL_INSTANCE_TYPE_STABLE = "node.kubernetes.io/instance-type"


class EBSLimits(_NonCSILimits):
    """reference: non_csi.go:86 EBSName; default 39 (non_csi.go:41), 25 on
    Nitro instance types (non_csi.go:509 getMaxEBSVolume)."""
    NAME = "EBSLimits"
    LIMIT_KEY = "attachable-volumes-aws-ebs"
    DEFAULT_LIMIT = 39
    PROVISIONER = "kubernetes.io/aws-ebs"

    def _source(self, v):
        return v.aws_elastic_block_store

    def _default_limit(self, node) -> int:
        itype = ""
        if node is not None:
            labels = node.metadata.labels
            itype = (labels.get(LABEL_INSTANCE_TYPE)
                     or labels.get(LABEL_INSTANCE_TYPE_STABLE) or "")
        if itype and EBS_NITRO_LIMIT_REGEX.search(itype):
            return DEFAULT_MAX_EBS_NITRO_VOLUME_LIMIT
        return self.DEFAULT_LIMIT


class GCEPDLimits(_NonCSILimits):
    """reference: non_csi.go:95 GCEPDName; default 16 (non_csi.go:45)."""
    NAME = "GCEPDLimits"
    LIMIT_KEY = "attachable-volumes-gce-pd"
    DEFAULT_LIMIT = 16
    PROVISIONER = "kubernetes.io/gce-pd"

    def _source(self, v):
        return v.gce_persistent_disk


class AzureDiskLimits(_NonCSILimits):
    """reference: non_csi.go:68 AzureDiskName; default 16 (non_csi.go:49)."""
    NAME = "AzureDiskLimits"
    LIMIT_KEY = "attachable-volumes-azure-disk"
    DEFAULT_LIMIT = 16
    PROVISIONER = "kubernetes.io/azure-disk"

    def _source(self, v):
        return v.azure_disk


class CinderLimits(_NonCSILimits):
    """reference: non_csi.go:77 CinderName; default 256
    (volume_stats.go DefaultMaxCinderVolumes)."""
    NAME = "CinderLimits"
    LIMIT_KEY = "attachable-volumes-cinder"
    DEFAULT_LIMIT = 256
    PROVISIONER = "kubernetes.io/cinder"

    def _source(self, v):
        return v.cinder


def _pv_matches_node(pv: api.PersistentVolume, node: api.Node) -> bool:
    """PV .spec.nodeAffinity check (reference:
    pkg/volume/util.CheckNodeAffinity)."""
    if pv.node_affinity is None:
        return True
    labels = node.metadata.labels
    for term in pv.node_affinity.node_selector_terms:
        ok = True
        for req in term.match_expressions:
            val = labels.get(req.key)
            if req.operator == "In":
                ok = ok and val in req.values
            elif req.operator == "NotIn":
                # a node missing the key matches NotIn (reference:
                # apimachinery labels/selector.go Requirement.Matches rule 4)
                ok = ok and (val is None or val not in req.values)
            elif req.operator == "Exists":
                ok = ok and val is not None
            elif req.operator == "DoesNotExist":
                ok = ok and val is None
            else:
                ok = False
        if ok:
            return True
    return False
