"""The default enabled-plugin matrix.

reference: pkg/scheduler/algorithmprovider/registry.go:77-160
getDefaultConfig, the counterpart of kubetpu/framework/provider.py.  The
port refuses pods with volumes (ROADMAP queue 1, volumes), so the volume
family (VolumeBinding, VolumeRestrictions, VolumeZone and the volume
limits) is not in its set, and neither are the Reserve/Unreserve/PreBind/
PostBind points, which only VolumeBinding fills.  The tensorized
plugins' PreFilter and PreScore halves are part of their kernels, so
those points, which run nothing else by default, are not listed either.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# extension point -> enabled plugins, as (name, weight) (weights only for
# Score)
Plugins = Dict[str, List[Tuple[str, int]]]


def default_plugins() -> Plugins:
    """reference: algorithmprovider/registry.go:77-160, without volumes."""
    return {
        "queue_sort": [("PrioritySort", 0)],
        "filter": [("NodeUnschedulable", 0), ("NodeResourcesFit", 0),
                   ("NodeName", 0), ("NodePorts", 0), ("NodeAffinity", 0),
                   ("TaintToleration", 0), ("PodTopologySpread", 0),
                   ("InterPodAffinity", 0)],
        "post_filter": [("DefaultPreemption", 0)],
        "score": [("NodeResourcesBalancedAllocation", 1),
                  ("ImageLocality", 1), ("InterPodAffinity", 1),
                  ("NodeResourcesLeastAllocated", 1), ("NodeAffinity", 1),
                  ("NodePreferAvoidPods", 10000), ("PodTopologySpread", 2),
                  ("DefaultPodTopologySpread", 1), ("TaintToleration", 1)],
        "bind": [("DefaultBinder", 0)],
    }
