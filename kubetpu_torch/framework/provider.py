"""Algorithm providers: the default enabled-plugin matrix.

reference: pkg/scheduler/algorithmprovider/registry.go — getDefaultConfig
:77-160 (plugin sets and weights), NewRegistry :60 (DefaultProvider, and
ClusterAutoscalerProvider, which swaps LeastAllocated for MostAllocated);
the counterpart of kubetpu/framework/provider.py, the volume family
(VolumeBinding at PreFilter, Filter, Reserve, Unreserve, PreBind and
PostBind, and the volume filters) included.
"""

from __future__ import annotations

from ..apis.config import Plugin, PluginSet, Plugins

DEFAULT_PROVIDER = "DefaultProvider"
CLUSTER_AUTOSCALER_PROVIDER = "ClusterAutoscalerProvider"

def default_plugins() -> Plugins:
    """reference: algorithmprovider/registry.go:77-160."""
    return Plugins(
        queue_sort=PluginSet(enabled=[Plugin("PrioritySort")]),
        pre_filter=PluginSet(enabled=[
            Plugin("NodeResourcesFit"),
            Plugin("NodePorts"),
            Plugin("PodTopologySpread"),
            Plugin("InterPodAffinity"),
            Plugin("VolumeBinding"),
        ]),
        filter=PluginSet(enabled=[
            Plugin("NodeUnschedulable"),
            Plugin("NodeResourcesFit"),
            Plugin("NodeName"),
            Plugin("NodePorts"),
            Plugin("NodeAffinity"),
            Plugin("VolumeRestrictions"),
            Plugin("TaintToleration"),
            Plugin("EBSLimits"),
            Plugin("GCEPDLimits"),
            Plugin("NodeVolumeLimits"),
            Plugin("AzureDiskLimits"),
            Plugin("VolumeBinding"),
            Plugin("VolumeZone"),
            Plugin("PodTopologySpread"),
            Plugin("InterPodAffinity"),
        ]),
        post_filter=PluginSet(enabled=[Plugin("DefaultPreemption")]),
        pre_score=PluginSet(enabled=[
            Plugin("InterPodAffinity"),
            Plugin("DefaultPodTopologySpread"),
            Plugin("PodTopologySpread"),
            Plugin("TaintToleration"),
        ]),
        score=PluginSet(enabled=[
            Plugin("NodeResourcesBalancedAllocation", weight=1),
            Plugin("ImageLocality", weight=1),
            Plugin("InterPodAffinity", weight=1),
            Plugin("NodeResourcesLeastAllocated", weight=1),
            Plugin("NodeAffinity", weight=1),
            Plugin("NodePreferAvoidPods", weight=10000),
            Plugin("PodTopologySpread", weight=2),
            Plugin("DefaultPodTopologySpread", weight=1),
            Plugin("TaintToleration", weight=1),
        ]),
        reserve=PluginSet(enabled=[Plugin("VolumeBinding")]),
        unreserve=PluginSet(enabled=[Plugin("VolumeBinding")]),
        pre_bind=PluginSet(enabled=[Plugin("VolumeBinding")]),
        post_bind=PluginSet(enabled=[Plugin("VolumeBinding")]),
        bind=PluginSet(enabled=[Plugin("DefaultBinder")]),
    )


def cluster_autoscaler_plugins() -> Plugins:
    """reference: algorithmprovider/registry.go:49 (ClusterAutoscalerProvider):
    MostAllocated replaces LeastAllocated."""
    p = default_plugins()
    p.score.enabled = [
        Plugin("NodeResourcesMostAllocated", weight=1)
        if pl.name == "NodeResourcesLeastAllocated" else pl
        for pl in p.score.enabled]
    return p


PROVIDERS = {
    DEFAULT_PROVIDER: default_plugins,
    CLUSTER_AUTOSCALER_PROVIDER: cluster_autoscaler_plugins,
}
