"""kube-scheduler v1.19 NodeResourcesLeastAllocated
(pkg/scheduler/framework/plugins/noderesources/least_allocated.go): cpu and
memory at weight 1, ``(capacity - requested) * 100 / capacity`` in integer
division, 0 where the request passes the capacity."""

import numpy as np

MAX_NODE_SCORE = 100


def least_allocated(req, cap):
    return np.where((cap <= 0) | (req > cap), 0,
                    (cap - req) * MAX_NODE_SCORE // np.maximum(cap, 1))


def score(world, usage):
    return (least_allocated(usage.cpu, world.alloc_cpu)
            + least_allocated(usage.mem, world.alloc_mem)) // 2
