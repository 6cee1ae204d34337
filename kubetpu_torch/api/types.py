"""Core object model: the subset of the Kubernetes API surface the scheduler
consumes, re-designed as plain Python dataclasses.

reference: staging/src/k8s.io/api/core/v1/types.go (Pod, Node, Affinity,
Toleration, TopologySpreadConstraint, ...).  Only scheduler-relevant fields
are modeled; everything is immutable-by-convention once handed to the
scheduler (snapshots never mutate objects — the analog of the reference's
informer-cache read-only discipline).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# meta


_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class OwnerReference:
    # reference: apimachinery/pkg/apis/meta/v1/types.go (OwnerReference)
    api_version: str = "v1"
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None
    owner_references: List[OwnerReference] = field(default_factory=list)


# ---------------------------------------------------------------------------
# selectors / affinity


@dataclass
class LabelSelectorRequirement:
    # reference: apimachinery/pkg/apis/meta/v1/types.go (LabelSelectorRequirement)
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    def requirements(self) -> List[LabelSelectorRequirement]:
        reqs = [LabelSelectorRequirement(k, "In", [v])
                for k, v in sorted(self.match_labels.items())]
        reqs.extend(self.match_expressions)
        return reqs

    def matches(self, labels: Dict[str, str]) -> bool:
        # reference: apimachinery/pkg/labels/selector.go (internalSelector.Matches)
        for r in self.requirements():
            if not _req_matches(r, labels):
                return False
        return True

    def is_empty(self) -> bool:
        return not self.match_labels and not self.match_expressions


def _req_matches(r: LabelSelectorRequirement, labels: Dict[str, str]) -> bool:
    has = r.key in labels
    if r.operator == "In":
        return has and labels[r.key] in r.values
    if r.operator == "NotIn":
        return not has or labels[r.key] not in r.values
    if r.operator == "Exists":
        return has
    if r.operator == "DoesNotExist":
        return not has
    if r.operator in ("Gt", "Lt"):
        if not has:
            return False
        try:
            lv = int(labels[r.key]); rv = int(r.values[0])
        except (ValueError, IndexError):
            return False
        return lv > rv if r.operator == "Gt" else lv < rv
    raise ValueError(f"unknown operator {r.operator}")


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    # Terms are ORed; requirements within a term are ANDed.
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)
    match_fields: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class NodeSelector:
    node_selector_terms: List[NodeSelectorTerm] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1  # 1..100
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class NodeAffinity:
    required_during_scheduling_ignored_during_execution: Optional[NodeSelector] = None
    preferred_during_scheduling_ignored_during_execution: List[PreferredSchedulingTerm] = \
        field(default_factory=list)


@dataclass
class PodAffinityTerm:
    # reference: api/core/v1/types.go (PodAffinityTerm)
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)  # empty => pod's own namespace
    topology_key: str = ""


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1  # 1..100
    pod_affinity_term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required_during_scheduling_ignored_during_execution: List[PodAffinityTerm] = \
        field(default_factory=list)
    preferred_during_scheduling_ignored_during_execution: List[WeightedPodAffinityTerm] = \
        field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required_during_scheduling_ignored_during_execution: List[PodAffinityTerm] = \
        field(default_factory=list)
    preferred_during_scheduling_ignored_during_execution: List[WeightedPodAffinityTerm] = \
        field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


# ---------------------------------------------------------------------------
# taints / tolerations


TAINT_EFFECT_NO_SCHEDULE = "NoSchedule"
TAINT_EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_EFFECT_NO_EXECUTE = "NoExecute"


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = TAINT_EFFECT_NO_SCHEDULE


@dataclass
class Toleration:
    key: str = ""  # empty + Exists => tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty => all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        # reference: api/core/v1/toleration.go:28 (ToleratesTaint)
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator in ("", "Equal"):
            return self.value == taint.value
        if self.operator == "Exists":
            return True
        return False


def tolerations_tolerate_taint(tolerations: List[Toleration], taint: Taint) -> bool:
    # reference: pkg/apis/core/v1/helper/helpers.go (TolerationsTolerateTaint)
    return any(t.tolerates(taint) for t in tolerations)


# ---------------------------------------------------------------------------
# pods


@dataclass
class ContainerPort:
    host_ip: str = ""
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"


@dataclass
class ResourceRequirements:
    requests: Dict[str, Any] = field(default_factory=dict)
    limits: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Container:
    name: str = ""
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: List[ContainerPort] = field(default_factory=list)


@dataclass
class Volume:
    name: str = ""
    # Exactly one of these sources is set (scheduler-relevant subset).
    persistent_volume_claim: Optional[str] = None  # claim name
    gce_persistent_disk: Optional[str] = None      # pd name
    aws_elastic_block_store: Optional[str] = None  # volume id
    azure_disk: Optional[str] = None               # disk name
    cinder: Optional[str] = None                   # volume id
    iscsi: Optional[Tuple[str, int, str]] = None   # (target portal, lun, iqn)
    rbd: Optional[Tuple[str, str, str]] = None     # (monitors-key, pool, image)
    read_only: bool = False
    host_path: Optional[str] = None
    empty_dir: bool = False


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"  # DoNotSchedule | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None


@dataclass
class PodSpec:
    node_name: str = ""
    scheduler_name: str = "default-scheduler"
    priority: Optional[int] = None
    priority_class_name: str = ""
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: Dict[str, Any] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    volumes: List[Volume] = field(default_factory=list)
    host_network: bool = False
    service_account_name: str = ""


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""  # True | False | Unknown
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"

POD_SCHEDULED = "PodScheduled"  # condition type
REASON_UNSCHEDULABLE = "Unschedulable"


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    nominated_node_name: str = ""
    conditions: List[PodCondition] = field(default_factory=list)


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    kind: str = "Pod"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def full_name(self) -> str:
        # reference: pkg/scheduler/util/utils.go (GetPodFullName)
        return f"{self.metadata.name}_{self.metadata.namespace}"

    def priority(self) -> int:
        # reference: pkg/api/v1/pod/util.go (PodPriority)
        return self.spec.priority if self.spec.priority is not None else 0


# ---------------------------------------------------------------------------
# nodes


@dataclass
class ContainerImage:
    names: List[str] = field(default_factory=list)
    size_bytes: int = 0


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)
    provider_id: str = ""


@dataclass
class NodeCondition:
    type: str = ""
    status: str = ""


@dataclass
class NodeStatus:
    capacity: Dict[str, Any] = field(default_factory=dict)
    allocatable: Dict[str, Any] = field(default_factory=dict)
    images: List[ContainerImage] = field(default_factory=list)
    conditions: List[NodeCondition] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)
    kind: str = "Node"

    @property
    def name(self) -> str:
        return self.metadata.name


# Well-known labels (reference: pkg/apis/core/v1/well_known_labels.go).
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"
LABEL_ZONE_LEGACY = "failure-domain.beta.kubernetes.io/zone"
LABEL_REGION_LEGACY = "failure-domain.beta.kubernetes.io/region"

# Annotation consumed by NodePreferAvoidPods
# (reference: pkg/apis/core/v1/helper/helpers.go:239 GetAvoidPodsFromNodeAnnotations).
PREFER_AVOID_PODS_ANNOTATION_KEY = "scheduler.alpha.kubernetes.io/preferAvoidPods"


# ---------------------------------------------------------------------------
# misc cluster objects the plugins consume


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    volume_name: str = ""          # bound PV name ("" => unbound)
    storage_class_name: str = ""
    phase: str = "Pending"
    # matching requirements an unbound claim imposes on candidate PVs
    # (reference: pv_controller findMatchingVolume): requested storage
    # under resources.requests["storage"], and the claim's access modes —
    # a PV must offer a SUPERSET.  Empty = unconstrained (back-compat).
    access_modes: List[str] = field(default_factory=list)
    resources: ResourceRequirements = field(
        default_factory=ResourceRequirements)
    kind: str = "PersistentVolumeClaim"


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: Dict[str, Any] = field(default_factory=dict)
    access_modes: List[str] = field(default_factory=list)
    node_affinity: Optional[NodeSelector] = None
    storage_class_name: str = ""
    # volume source (scheduler-relevant subset, for NodeVolumeLimits)
    aws_elastic_block_store: Optional[str] = None   # volume id
    gce_persistent_disk: Optional[str] = None       # pd name
    azure_disk: Optional[str] = None                # disk name
    cinder: Optional[str] = None                    # volume id
    csi_driver: Optional[str] = None                # driver name
    csi_volume_handle: Optional[str] = None
    kind: str = "PersistentVolume"


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    volume_binding_mode: str = "Immediate"  # Immediate | WaitForFirstConsumer
    provisioner: str = ""  # e.g. kubernetes.io/aws-ebs
    kind: str = "StorageClass"


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)
    kind: str = "Service"


@dataclass
class ReplicaSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: LabelSelector = field(default_factory=LabelSelector)
    kind: str = "ReplicaSet"


@dataclass
class ReplicationController:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)
    kind: str = "ReplicationController"


@dataclass
class StatefulSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: LabelSelector = field(default_factory=LabelSelector)
    kind: str = "StatefulSet"


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: LabelSelector = field(default_factory=LabelSelector)
    disruptions_allowed: int = 0
    kind: str = "PodDisruptionBudget"


@dataclass
class CSINode:
    """Per-node CSI driver allocatable counts
    (reference: staging/src/k8s.io/api/storage/v1/types.go CSINode)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)  # name == node name
    driver_allocatable: Dict[str, int] = field(default_factory=dict)  # driver -> count
    kind: str = "CSINode"
