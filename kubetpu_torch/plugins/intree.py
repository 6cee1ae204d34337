"""In-tree plugin declarations and the registry of the default set.

reference: pkg/scheduler/framework/plugins/registry.go:47-74
(NewInTreeRegistry); the counterpart of kubetpu/plugins/intree.py.  The
tensorized plugins' Filter and Score algorithms are device kernels
(ops/kernels.py): a class here only declares the kernel names the
framework routes into the programs' ProgramConfig.  The host-side plugins
are the binder and the preemption PostFilter.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..framework import interface as fw
from ..framework.interface import Status, TensorPlugin


class PrioritySort(fw.QueueSortPlugin):
    """reference: queuesort/priority_sort.go:40-45."""
    NAME = "PrioritySort"

    def sort_key(self, qp) -> tuple:
        return (-qp.pod.priority(), qp.timestamp)


class NodeResourcesFit(TensorPlugin, fw.FilterPlugin):
    """reference: noderesources/fit.go."""
    NAME = "NodeResourcesFit"
    FILTER_KERNEL = "NodeResourcesFit"


class NodeResourcesLeastAllocated(TensorPlugin, fw.ScorePlugin):
    """reference: noderesources/least_allocated.go."""
    NAME = "NodeResourcesLeastAllocated"
    SCORE_KERNEL = "NodeResourcesLeastAllocated"


class NodeResourcesBalancedAllocation(TensorPlugin, fw.ScorePlugin):
    """reference: noderesources/balanced_allocation.go."""
    NAME = "NodeResourcesBalancedAllocation"
    SCORE_KERNEL = "NodeResourcesBalancedAllocation"


class NodeName(TensorPlugin, fw.FilterPlugin):
    """reference: nodename/node_name.go."""
    NAME = "NodeName"
    FILTER_KERNEL = "NodeName"


class NodePorts(TensorPlugin, fw.FilterPlugin):
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


class TaintToleration(TensorPlugin, fw.FilterPlugin, fw.ScorePlugin):
    """reference: tainttoleration/taint_toleration.go."""
    NAME = "TaintToleration"
    FILTER_KERNEL = "TaintToleration"
    SCORE_KERNEL = "TaintToleration"


class InterPodAffinity(TensorPlugin, fw.FilterPlugin, fw.ScorePlugin):
    """reference: interpodaffinity/plugin.go."""
    NAME = "InterPodAffinity"
    FILTER_KERNEL = "InterPodAffinity"
    SCORE_KERNEL = "InterPodAffinity"

    def __init__(self, hard_pod_affinity_weight: int = 1):
        self.hard_pod_affinity_weight = hard_pod_affinity_weight


class PodTopologySpread(TensorPlugin, fw.FilterPlugin, fw.ScorePlugin):
    """reference: podtopologyspread/plugin.go."""
    NAME = "PodTopologySpread"
    FILTER_KERNEL = "PodTopologySpread"
    SCORE_KERNEL = "PodTopologySpread"


class DefaultPodTopologySpread(TensorPlugin, fw.ScorePlugin):
    """reference: defaultpodtopologyspread/default_pod_topology_spread.go."""
    NAME = "DefaultPodTopologySpread"
    SCORE_KERNEL = "DefaultPodTopologySpread"


class ImageLocality(TensorPlugin, fw.ScorePlugin):
    """reference: imagelocality/image_locality.go."""
    NAME = "ImageLocality"
    SCORE_KERNEL = "ImageLocality"


class DefaultBinder(fw.BindPlugin):
    """POST pods/<name>/binding through the store (reference:
    defaultbinder/default_binder.go:50-61)."""
    NAME = "DefaultBinder"

    def __init__(self, client=None):
        self.client = client

    def bind(self, state, pod, node_name: str) -> Status:
        try:
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
    """reference: plugins/registry.go:47-74, the default set's plugins.
    A factory takes (args, handle): the plugin's arguments and the
    Framework that owns it."""
    def plain(cls):
        return lambda args=None, handle=None: cls()

    reg: Registry = {cls.NAME: plain(cls) for cls in (
        PrioritySort, NodeResourcesFit, NodeResourcesLeastAllocated,
        NodeResourcesBalancedAllocation, NodeName, NodePorts, NodeAffinity,
        NodeUnschedulable, NodePreferAvoidPods, TaintToleration,
        PodTopologySpread, DefaultPodTopologySpread, ImageLocality)}
    reg[InterPodAffinity.NAME] = lambda args=None, handle=None: \
        InterPodAffinity(hard_pod_affinity_weight=(args or {}).get(
            "hardPodAffinityWeight", 1))
    reg[DefaultBinder.NAME] = lambda args=None, handle=None: DefaultBinder(
        client=handle.client if handle else None)
    reg[DefaultPreemption.NAME] = lambda args=None, handle=None: \
        DefaultPreemption(handle=handle)
    return reg
