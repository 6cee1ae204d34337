"""Scheduler data model: NodeInfo, PodInfo, QueuedPodInfo.

reference: pkg/scheduler/framework/v1alpha1/types.go (NodeInfo :171,
Resource :262, PodInfo :70, QueuedPodInfo :43, AffinityTerm :79).

NodeInfo is the host-side aggregated per-node state, updated incrementally
by the scheduler cache with a monotonically increasing Generation used for
incremental snapshotting (reference: types.go:208).  The tensor snapshot
(kubetpu_torch/state/tensors.py) is built *from* NodeInfos, row-per-node.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..api import types as api
from ..utils.trace import wallclock
from ..api.resource import (DEFAULT_MEMORY_REQUEST, DEFAULT_MILLI_CPU_REQUEST,
                            Resource)

_generation = itertools.count(1)


def next_generation() -> int:
    # reference: types.go:160 (nextGeneration)
    return next(_generation)


# ---------------------------------------------------------------------------
# pod resource requests


def compute_pod_resource_request(pod: api.Pod) -> Resource:
    """requests = max(sum(app containers), max(init containers)) + overhead.

    reference: pkg/scheduler/framework/plugins/noderesources/fit.go:112-129
    (computePodResourceRequest) and types.go:432 (calculateResource).
    """
    r = Resource()
    for c in pod.spec.containers:
        r.add_resource_list(c.resources.requests)
    for ic in pod.spec.init_containers:
        r.set_max(ic.resources.requests)
    if pod.spec.overhead:
        r.add_resource_list(pod.spec.overhead)
    return r


def compute_pod_resource_limits(pod: api.Pod) -> Resource:
    """Same shape as requests but over .limits
    (reference: noderesources/resource_limits.go getResourceLimits)."""
    r = Resource()
    for c in pod.spec.containers:
        r.add_resource_list(c.resources.limits)
    for ic in pod.spec.init_containers:
        r.set_max(ic.resources.limits)
    return r


def non_zero_request(pod: api.Pod) -> Tuple[int, int]:
    """(milli_cpu, memory) where each *container* with an UNSET request is
    defaulted to 100m / 200MB — "override if un-set, but not if explicitly
    set to zero" — aggregated with the same max(sum(containers), init) +
    overhead rule.

    reference: pkg/scheduler/util/non_zero.go:50-63
    (GetNonzeroRequestForResource, applied per container in
    types.go:432 calculateResource and
    noderesources/resource_allocation.go:118 calculatePodResourceRequest).
    """
    from ..api.resource import to_int, to_milli

    def one(requests):
        c = (to_milli(requests["cpu"]) if "cpu" in requests
             else DEFAULT_MILLI_CPU_REQUEST)
        m = (to_int(requests["memory"]) if "memory" in requests
             else DEFAULT_MEMORY_REQUEST)
        return c, m

    cpu = mem = 0
    for c in pod.spec.containers:
        ccpu, cmem = one(c.resources.requests)
        cpu += ccpu
        mem += cmem
    for ic in pod.spec.init_containers:
        ccpu, cmem = one(ic.resources.requests)
        cpu = max(cpu, ccpu)
        mem = max(mem, cmem)
    if pod.spec.overhead:
        cpu += to_milli(pod.spec.overhead.get("cpu", 0))
        mem += to_int(pod.spec.overhead.get("memory", 0))
    return cpu, mem


# ---------------------------------------------------------------------------
# pre-parsed pod info


@dataclass
class AffinityTerm:
    """A pre-processed pod affinity term.
    reference: types.go:79 (AffinityTerm)."""
    selector: api.LabelSelector
    namespaces: Set[str]
    topology_key: str

    def matches(self, pod: api.Pod) -> bool:
        return (pod.namespace in self.namespaces
                and self.selector.matches(pod.metadata.labels))


@dataclass
class WeightedAffinityTerm:
    term: AffinityTerm
    weight: int


def _get_affinity_terms(pod: api.Pod,
                        terms: List[api.PodAffinityTerm]) -> List[AffinityTerm]:
    # reference: types.go:96 (getAffinityTerms / newAffinityTerm)
    out = []
    for t in terms:
        ns = set(t.namespaces) if t.namespaces else {pod.namespace}
        sel = t.label_selector or api.LabelSelector()
        out.append(AffinityTerm(selector=sel, namespaces=ns, topology_key=t.topology_key))
    return out


def _get_weighted_terms(pod: api.Pod,
                        terms: List[api.WeightedPodAffinityTerm]) -> List[WeightedAffinityTerm]:
    out = []
    for wt in terms:
        at = _get_affinity_terms(pod, [wt.pod_affinity_term])[0]
        out.append(WeightedAffinityTerm(term=at, weight=wt.weight))
    return out


class PodInfo:
    """Pod wrapper with pre-computed affinity terms and resource vectors.
    reference: types.go:70 (PodInfo)."""

    __slots__ = ("pod", "required_affinity_terms", "required_anti_affinity_terms",
                 "preferred_affinity_terms", "preferred_anti_affinity_terms",
                 "resource", "non_zero_cpu", "non_zero_mem")

    def __init__(self, pod: api.Pod):
        self.pod = pod
        aff = pod.spec.affinity
        self.required_affinity_terms: List[AffinityTerm] = []
        self.required_anti_affinity_terms: List[AffinityTerm] = []
        self.preferred_affinity_terms: List[WeightedAffinityTerm] = []
        self.preferred_anti_affinity_terms: List[WeightedAffinityTerm] = []
        if aff is not None:
            if aff.pod_affinity is not None:
                self.required_affinity_terms = _get_affinity_terms(
                    pod, aff.pod_affinity.required_during_scheduling_ignored_during_execution)
                self.preferred_affinity_terms = _get_weighted_terms(
                    pod, aff.pod_affinity.preferred_during_scheduling_ignored_during_execution)
            if aff.pod_anti_affinity is not None:
                self.required_anti_affinity_terms = _get_affinity_terms(
                    pod, aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution)
                self.preferred_anti_affinity_terms = _get_weighted_terms(
                    pod, aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution)
        self.resource = compute_pod_resource_request(pod)
        self.non_zero_cpu, self.non_zero_mem = non_zero_request(pod)

    def with_pod(self, pod: api.Pod) -> "PodInfo":
        """Rewrap a pod object that shares this one's parsed spec content
        (e.g. the scheduler's assumed shallow-copy with node_name set) —
        shares the parsed terms/resources instead of re-parsing.  Term and
        resource parsing dominates PodInfo cost (quantity parsing is
        string work), and the commit path would otherwise re-do it for
        every scheduled pod."""
        pi = PodInfo.__new__(PodInfo)
        pi.pod = pod
        pi.required_affinity_terms = self.required_affinity_terms
        pi.required_anti_affinity_terms = self.required_anti_affinity_terms
        pi.preferred_affinity_terms = self.preferred_affinity_terms
        pi.preferred_anti_affinity_terms = self.preferred_anti_affinity_terms
        pi.resource = self.resource
        pi.non_zero_cpu = self.non_zero_cpu
        pi.non_zero_mem = self.non_zero_mem
        return pi


@dataclass
class QueuedPodInfo:
    """Queue bookkeeping for a pending pod.
    reference: types.go:43 (QueuedPodInfo)."""
    pod: api.Pod
    # wallclock, not time.time: queue durations are differences of stamps
    timestamp: float = field(default_factory=wallclock)
    attempts: int = 0
    initial_attempt_timestamp: float = field(default_factory=wallclock)
    # queue.scheduling_cycle captured when this pod was popped (reference:
    # scheduler.go:515 podSchedulingCycle := SchedulingQueue.SchedulingCycle()
    # is read at pop time, not at failure time)
    scheduling_cycle: int = 0
    # when the pod was popped into its current cycle: stamped by the
    # queue ONLY while the SLO tracker (utils/slo.py) is armed; 0.0 means
    # "never stamped" and the SLO layer skips the pod
    pop_timestamp: float = 0.0
    # the SLO layer already recorded an "unresolvable" vector for this
    # pod: requeued pods retry, and re-recording every failing cycle
    # would multi-count the pod in the sketches
    slo_unres_observed: bool = False


# ---------------------------------------------------------------------------
# NodeInfo


def pod_with_affinity(pod: api.Pod) -> bool:
    # reference: types.go:492 (podWithAffinity)
    a = pod.spec.affinity
    return a is not None and (a.pod_affinity is not None or a.pod_anti_affinity is not None)


def pod_with_required_anti_affinity(pod: api.Pod) -> bool:
    a = pod.spec.affinity
    return (a is not None and a.pod_anti_affinity is not None
            and bool(a.pod_anti_affinity.required_during_scheduling_ignored_during_execution))


class NodeInfo:
    """Aggregated per-node scheduling state.
    reference: types.go:171 (NodeInfo)."""

    __slots__ = ("node", "pods", "pods_with_affinity", "pods_with_required_anti_affinity",
                 "used_ports", "requested", "non_zero_requested", "allocatable",
                 "image_states", "generation")

    def __init__(self, node: Optional[api.Node] = None):
        self.node: Optional[api.Node] = None
        self.pods: List[PodInfo] = []
        self.pods_with_affinity: List[PodInfo] = []
        self.pods_with_required_anti_affinity: List[PodInfo] = []
        # (protocol, host_ip, host_port) triples, mirroring HostPortInfo
        # (reference: types.go:660 HostPortInfo.Add).
        self.used_ports: Set[Tuple[str, str, int]] = set()
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = Resource()
        self.image_states: Dict[str, int] = {}  # image name -> size bytes
        self.generation = next_generation()
        if node is not None:
            self.set_node(node)

    @property
    def node_name(self) -> str:
        return self.node.name if self.node else ""

    def set_node(self, node: api.Node) -> None:
        # reference: types.go:553 (SetNode)
        self.node = node
        self.allocatable = Resource.from_resource_list(node.status.allocatable)
        self.image_states = {}
        for img in node.status.images:
            for name in img.names:
                self.image_states[name] = img.size_bytes
        self.generation = next_generation()

    def add_pod(self, pod: api.Pod, pinfo: Optional[PodInfo] = None) -> None:
        # reference: types.go:456 (AddPod).  pinfo: optional pre-parsed
        # PodInfo wrapping THIS pod object (callers on the hot path pass it
        # to skip re-parsing terms/resources).
        pi = pinfo if pinfo is not None and pinfo.pod is pod else PodInfo(pod)
        self.pods.append(pi)
        if pod_with_affinity(pod):
            self.pods_with_affinity.append(pi)
        if pod_with_required_anti_affinity(pod):
            self.pods_with_required_anti_affinity.append(pi)
        self.requested.add(pi.resource)
        self.non_zero_requested.milli_cpu += pi.non_zero_cpu
        self.non_zero_requested.memory += pi.non_zero_mem
        self._update_used_ports(pod, add=True)
        self.generation = next_generation()

    def remove_pod(self, pod: api.Pod) -> bool:
        # reference: types.go:483 (RemovePod); returns False if absent
        for i, pi in enumerate(self.pods):
            if pi.pod.uid == pod.uid:
                del self.pods[i]
                self.pods_with_affinity = [p for p in self.pods_with_affinity
                                           if p.pod.uid != pod.uid]
                self.pods_with_required_anti_affinity = [
                    p for p in self.pods_with_required_anti_affinity if p.pod.uid != pod.uid]
                self.requested.sub(pi.resource)
                self.non_zero_requested.milli_cpu -= pi.non_zero_cpu
                self.non_zero_requested.memory -= pi.non_zero_mem
                self._update_used_ports(pod, add=False)
                self.generation = next_generation()
                return True
        return False

    def _update_used_ports(self, pod: api.Pod, add: bool) -> None:
        for c in pod.spec.containers:
            for p in c.ports:
                if p.host_port <= 0:
                    continue
                triple = (p.protocol or "TCP", p.host_ip or "0.0.0.0", p.host_port)
                if add:
                    self.used_ports.add(triple)
                else:
                    self.used_ports.discard(triple)

    def clone(self) -> "NodeInfo":
        # reference: types.go:380 (Clone) — used by preemption simulation
        ni = NodeInfo()
        ni.node = self.node
        ni.pods = list(self.pods)
        ni.pods_with_affinity = list(self.pods_with_affinity)
        ni.pods_with_required_anti_affinity = list(self.pods_with_required_anti_affinity)
        ni.used_ports = set(self.used_ports)
        ni.requested = self.requested.clone()
        ni.non_zero_requested = self.non_zero_requested.clone()
        ni.allocatable = self.allocatable.clone()
        ni.image_states = dict(self.image_states)
        ni.generation = self.generation
        return ni
