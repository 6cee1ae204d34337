"""In-tree plugin declarations and the registry.

reference: pkg/scheduler/framework/plugins/registry.go:47-74
(NewInTreeRegistry); the counterpart of kubetpu/plugins/intree.py.  The
tensorized plugins' Filter and Score algorithms are device kernels
(ops/kernels.py): a class here only declares the kernel names the
framework routes into the programs' ProgramConfig, and, for the
configurable scorers, resolves its arguments against the intern table
(``kernel_args``).  The host-side plugins are ServiceAffinity, the binder,
the preemption PostFilter and the volume family (plugins/volumes.py).
"""

from __future__ import annotations

from typing import Callable, Dict

from ..framework import interface as fw
from ..framework.interface import Status, TensorPlugin
from ..utils import chaos


class PrioritySort(fw.QueueSortPlugin):
    """reference: queuesort/priority_sort.go:40-45."""
    NAME = "PrioritySort"

    def less(self, a, b) -> bool:
        return self.sort_key(a) < self.sort_key(b)

    def sort_key(self, qp) -> tuple:
        return (-qp.pod.priority(), qp.timestamp)


class NodeResourcesFit(TensorPlugin, fw.PreFilterPlugin, fw.FilterPlugin):
    """reference: noderesources/fit.go."""
    NAME = "NodeResourcesFit"
    FILTER_KERNEL = "NodeResourcesFit"


class NodeResourcesLeastAllocated(TensorPlugin, fw.ScorePlugin):
    """reference: noderesources/least_allocated.go."""
    NAME = "NodeResourcesLeastAllocated"
    SCORE_KERNEL = "NodeResourcesLeastAllocated"


class NodeResourcesMostAllocated(TensorPlugin, fw.ScorePlugin):
    """reference: noderesources/most_allocated.go."""
    NAME = "NodeResourcesMostAllocated"
    SCORE_KERNEL = "NodeResourcesMostAllocated"


class NodeResourcesBalancedAllocation(TensorPlugin, fw.ScorePlugin):
    """reference: noderesources/balanced_allocation.go."""
    NAME = "NodeResourcesBalancedAllocation"
    SCORE_KERNEL = "NodeResourcesBalancedAllocation"


class NodeName(TensorPlugin, fw.FilterPlugin):
    """reference: nodename/node_name.go."""
    NAME = "NodeName"
    FILTER_KERNEL = "NodeName"


class NodePorts(TensorPlugin, fw.PreFilterPlugin, fw.FilterPlugin):
    """reference: nodeports/node_ports.go."""
    NAME = "NodePorts"
    FILTER_KERNEL = "NodePorts"


class NodeAffinity(TensorPlugin, fw.FilterPlugin, fw.ScorePlugin):
    """reference: nodeaffinity/node_affinity.go."""
    NAME = "NodeAffinity"
    FILTER_KERNEL = "NodeAffinity"
    SCORE_KERNEL = "NodeAffinity"


class NodeUnschedulable(TensorPlugin, fw.FilterPlugin):
    """reference: nodeunschedulable/node_unschedulable.go."""
    NAME = "NodeUnschedulable"
    FILTER_KERNEL = "NodeUnschedulable"


class NodePreferAvoidPods(TensorPlugin, fw.ScorePlugin):
    """reference: nodepreferavoidpods/node_prefer_avoid_pods.go."""
    NAME = "NodePreferAvoidPods"
    SCORE_KERNEL = "NodePreferAvoidPods"


class TaintToleration(TensorPlugin, fw.FilterPlugin, fw.PreScorePlugin,
                      fw.ScorePlugin):
    """reference: tainttoleration/taint_toleration.go."""
    NAME = "TaintToleration"
    FILTER_KERNEL = "TaintToleration"
    SCORE_KERNEL = "TaintToleration"


class InterPodAffinity(TensorPlugin, fw.PreFilterPlugin, fw.FilterPlugin,
                       fw.PreScorePlugin, fw.ScorePlugin):
    """reference: interpodaffinity/plugin.go."""
    NAME = "InterPodAffinity"
    FILTER_KERNEL = "InterPodAffinity"
    SCORE_KERNEL = "InterPodAffinity"

    def __init__(self, hard_pod_affinity_weight: int = 1):
        self.hard_pod_affinity_weight = hard_pod_affinity_weight


class PodTopologySpread(TensorPlugin, fw.PreFilterPlugin, fw.FilterPlugin,
                        fw.PreScorePlugin, fw.ScorePlugin):
    """reference: podtopologyspread/plugin.go."""
    NAME = "PodTopologySpread"
    FILTER_KERNEL = "PodTopologySpread"
    SCORE_KERNEL = "PodTopologySpread"


class DefaultPodTopologySpread(TensorPlugin, fw.PreScorePlugin,
                               fw.ScorePlugin):
    """reference: defaultpodtopologyspread/default_pod_topology_spread.go."""
    NAME = "DefaultPodTopologySpread"
    SCORE_KERNEL = "DefaultPodTopologySpread"


class ImageLocality(TensorPlugin, fw.ScorePlugin):
    """reference: imagelocality/image_locality.go."""
    NAME = "ImageLocality"
    SCORE_KERNEL = "ImageLocality"


class RequestedToCapacityRatio(TensorPlugin, fw.ScorePlugin):
    """The user-shaped bin-packing scorer (reference:
    noderesources/requested_to_capacity_ratio.go)."""
    NAME = "RequestedToCapacityRatio"
    SCORE_KERNEL = "RequestedToCapacityRatio"

    def __init__(self, args=None):
        args = args or {}
        shape = args.get("shape") or [{"utilization": 0, "score": 0},
                                      {"utilization": 100, "score": 10}]
        # config scores live on the 0..MaxCustomPriorityScore (10) scale;
        # the plugin rescales them to MaxNodeScore at construction
        # (requested_to_capacity_ratio.go:60-66)
        scale = fw.MAX_NODE_SCORE // 10
        self.shape = tuple((int(p["utilization"]), int(p["score"]) * scale)
                           for p in shape)
        # weight 0 means the default weight 1 (:71-75)
        self.resources = [(r["name"], int(r.get("weight", 1)) or 1)
                          for r in args.get("resources")
                          or [{"name": "cpu", "weight": 1},
                              {"name": "memory", "weight": 1}]]

    def kernel_args(self, table) -> tuple:
        """(shape, ((kind, channel, weight), ...)).  A resource the
        cluster does not know resolves as the JAX package resolves it, to
        the first extended channel (N_FIXED_CHANNELS + max(-1, 0)); the
        upstream plugin scores it as capacity 0 (ROADMAP queue 3: a
        deviation of the JAX package the port inherits)."""
        from ..state.tensors import N_FIXED_CHANNELS
        resolved = []
        for name, weight in self.resources:
            if name == "cpu":
                resolved.append((0, 0, weight))
            elif name == "memory":
                resolved.append((1, 0, weight))
            else:
                ch = table.rname.get(name)
                resolved.append((2, N_FIXED_CHANNELS + max(ch, 0), weight))
        return (self.shape, tuple(resolved))


class NodeResourceLimits(TensorPlugin, fw.PreScorePlugin, fw.ScorePlugin):
    """reference: noderesources/resource_limits.go."""
    NAME = "NodeResourceLimits"
    SCORE_KERNEL = "NodeResourceLimits"


class NodeLabel(TensorPlugin, fw.FilterPlugin, fw.ScorePlugin):
    """Configured label presence and absence (reference:
    nodelabel/node_label.go)."""
    NAME = "NodeLabel"
    FILTER_KERNEL = "NodeLabel"
    SCORE_KERNEL = "NodeLabel"

    def __init__(self, args=None):
        args = args or {}
        self.present = list(args.get("presentLabels", []))
        self.absent = list(args.get("absentLabels", []))
        self.present_pref = list(args.get("presentLabelsPreference", []))
        self.absent_pref = list(args.get("absentLabelsPreference", []))

    def kernel_args(self, table) -> tuple:
        """(present key ids, absent key ids, ((key id, want present),
        ...)); -1 for a key no node carries."""
        prefs = tuple([(table.key.get(k), True) for k in self.present_pref]
                      + [(table.key.get(k), False) for k in self.absent_pref])
        return (tuple(table.key.get(k) for k in self.present),
                tuple(table.key.get(k) for k in self.absent),
                prefs)


def _selects(selector, labels) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


class ServiceAffinity(fw.PreFilterPlugin, fw.FilterPlugin, fw.ScorePlugin):
    """Legacy host plugin: a service's pods go to nodes with equal values
    of the configured labels (reference: serviceaffinity/
    service_affinity.go:428)."""
    NAME = "ServiceAffinity"
    STATE_KEY = "PreFilterServiceAffinity"
    SCORE_STATE_KEY = "ScoreServiceAffinity"

    def __init__(self, store=None, args=None):
        self.store = store
        args = args or {}
        self.affinity_labels = list(args.get("affinityLabels", []))
        self.antiaffinity_labels = list(
            args.get("antiAffinityLabelsPreference", []))

    def relevant(self, pod) -> bool:
        return bool(self.affinity_labels or self.antiaffinity_labels)

    def _matching_pods(self, pod):
        """Bound pods of the pod's services, cluster-wide, each once
        (reference: service_affinity.go:169 createPreFilterState)."""
        if self.store is None:
            return []
        seen = set()
        out = []
        for svc in self.store.list("Service"):
            if (svc.metadata.namespace != pod.namespace or not svc.selector
                    or not _selects(svc.selector, pod.metadata.labels)):
                continue
            for other in self.store.list("Pod"):
                if (other.uid not in seen
                        and other.namespace == pod.namespace
                        and other.spec.node_name
                        and _selects(svc.selector, other.metadata.labels)):
                    seen.add(other.uid)
                    out.append(other)
        return out

    def pre_filter(self, state, pod) -> Status:
        state.write(self.STATE_KEY, self._matching_pods(pod))
        return Status.success()

    def filter(self, state, pod, node_info) -> Status:
        """reference: service_affinity.go:214 Filter — the node must carry
        the affinity labels' values of the nodes of the service's other
        pods."""
        if not self.affinity_labels:
            return Status.success()
        try:
            matching = state.read(self.STATE_KEY)
        except KeyError:
            matching = self._matching_pods(pod)
        wanted = {}
        for other in matching:
            other_node = (self.store.get_node(other.spec.node_name)
                          if self.store else None)
            if other_node is None:
                continue
            for lab in self.affinity_labels:
                if lab in other_node.metadata.labels:
                    wanted[lab] = other_node.metadata.labels[lab]
        labels = node_info.node.metadata.labels
        for lab, val in wanted.items():
            if labels.get(lab) != val:
                return Status.unschedulable(
                    "node(s) didn't match service affinity")
        return Status.success()

    def score(self, state, pod, node_name):
        """reference: service_affinity.go:269 Score — the count of the
        node's same-namespace, non-terminating pods that the pod's first
        service selects; taken once per pod and kept in the cycle
        state."""
        try:
            counts = state.read(self.SCORE_STATE_KEY)
        except KeyError:
            counts = {}
            selector = None
            if self.store is not None:
                for svc in self.store.list("Service"):
                    if (svc.metadata.namespace == pod.namespace
                            and svc.selector
                            and _selects(svc.selector, pod.metadata.labels)):
                        selector = dict(svc.selector)
                        break
            if selector:
                for other in self.store.list("Pod"):
                    if (other.namespace == pod.namespace
                            and other.spec.node_name
                            and other.metadata.deletion_timestamp is None
                            and _selects(selector, other.metadata.labels)):
                        counts[other.spec.node_name] = \
                            counts.get(other.spec.node_name, 0) + 1
            state.write(self.SCORE_STATE_KEY, counts)
        return counts.get(node_name, 0), Status.success()

    def score_extensions(self):
        return self

    def normalize_score(self, state, pod, scores):
        """reference: service_affinity.go:305 NormalizeScore and :331
        updateNodeScoresForLabel — per anti-affinity label, MaxNodeScore
        times the share of the service's pods not on the node's label
        value, averaged over the labels; a node without the label scores
        nothing for it."""
        reduced = {n: 0.0 for n, _ in scores}
        num_service_pods = sum(s for _, s in scores)
        for label in self.antiaffinity_labels:
            counts: Dict[str, float] = {}
            label_of: Dict[str, str] = {}
            for n, s in scores:
                node = self.store.get_node(n) if self.store else None
                if node is None or label not in node.metadata.labels:
                    continue
                v = node.metadata.labels[label]
                label_of[n] = v
                counts[v] = counts.get(v, 0.0) + s
            for n, _ in scores:
                v = label_of.get(n)
                if v is None:
                    continue
                f = float(fw.MAX_NODE_SCORE)
                if num_service_pods > 0:
                    f = (fw.MAX_NODE_SCORE
                         * (num_service_pods - counts[v]) / num_service_pods)
                reduced[n] += f / len(self.antiaffinity_labels)
        return ([(n, int(reduced[n])) for n, _ in scores],
                Status.success())


class DefaultBinder(fw.BindPlugin):
    """POST pods/<name>/binding through the store (reference:
    defaultbinder/default_binder.go:50-61)."""
    NAME = "DefaultBinder"

    def __init__(self, client=None):
        self.client = client

    def bind(self, state, pod, node_name: str) -> Status:
        try:
            # chaos seam (utils/chaos.py "bind"): a transient binding
            # transport error, caught below like any real one; the
            # scheduler's bind retry ladder recovers it
            chaos.raise_or_stall("bind")
            self.client.bind(pod, node_name)
        except Exception as e:  # the store rejects gone / already-bound pods
            return Status.error(f"binding rejected: {e}")
        return Status.success()


class DefaultPreemption(fw.PostFilterPlugin):
    """Preemption as the PostFilter extension point (for this vintage the
    behavior is generic_scheduler.go:252 Preempt, invoked from
    scheduler.go:391).  The Preemptor is late-bound by the Scheduler; the
    cycle's shared tensors arrive through CycleState under
    CYCLE_CONTEXT_KEY."""
    NAME = "DefaultPreemption"
    CYCLE_CONTEXT_KEY = "kubetpu.io/cycle-context"

    def __init__(self, handle=None):
        self.handle = handle
        self.preemptor = None   # set by Scheduler.__init__

    def post_filter(self, state, pod, filtered_node_status):
        if self.preemptor is None:
            return None, Status.unschedulable("preemption disabled")
        try:
            cycle = state.read(self.CYCLE_CONTEXT_KEY)
        except KeyError:
            cycle = None
        nominated = self.preemptor.preempt(self.handle, state, pod,
                                           cycle=cycle)
        if nominated:
            return fw.PostFilterResult(nominated), Status.success()
        return None, Status.unschedulable(
            "preemption: 0/%d nodes are available" %
            len(filtered_node_status or {}))


Registry = Dict[str, Callable[..., fw.Plugin]]


def new_in_tree_registry() -> Registry:
    """reference: plugins/registry.go:47-74.  A factory takes (args,
    handle): the plugin's arguments and the Framework that owns it."""
    from . import volumes

    def plain(cls):
        return lambda args=None, handle=None: cls()

    reg: Registry = {cls.NAME: plain(cls) for cls in (
        PrioritySort, NodeResourcesFit, NodeResourcesLeastAllocated,
        NodeResourcesMostAllocated, NodeResourcesBalancedAllocation,
        NodeName, NodePorts, NodeAffinity, NodeUnschedulable,
        NodePreferAvoidPods, TaintToleration, PodTopologySpread,
        DefaultPodTopologySpread, ImageLocality, NodeResourceLimits)}
    for cls in (RequestedToCapacityRatio, NodeLabel):
        reg[cls.NAME] = (lambda c: lambda args=None, handle=None: c(args))(
            cls)
    reg[ServiceAffinity.NAME] = lambda args=None, handle=None: \
        ServiceAffinity(store=handle.client if handle else None, args=args)
    reg[InterPodAffinity.NAME] = lambda args=None, handle=None: \
        InterPodAffinity(hard_pod_affinity_weight=(args or {}).get(
            "hardPodAffinityWeight", 1))
    reg[DefaultBinder.NAME] = lambda args=None, handle=None: DefaultBinder(
        client=handle.client if handle else None)
    reg[DefaultPreemption.NAME] = lambda args=None, handle=None: \
        DefaultPreemption(handle=handle)
    for cls in (volumes.VolumeBinding, volumes.VolumeRestrictions,
                volumes.VolumeZone, volumes.NodeVolumeLimits,
                volumes.EBSLimits, volumes.GCEPDLimits,
                volumes.AzureDiskLimits, volumes.CinderLimits):
        reg[cls.NAME] = (lambda c: lambda args=None, handle=None: c(
            store=handle.client if handle else None))(cls)
    return reg
