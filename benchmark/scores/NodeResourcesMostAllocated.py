"""kube-scheduler v1.19 NodeResourcesMostAllocated
(pkg/scheduler/framework/plugins/noderesources/most_allocated.go): cpu and
memory at weight 1, ``requested * 100 / capacity`` in integer division, 0
where the request passes the capacity."""

import numpy as np

MAX_NODE_SCORE = 100


def most_allocated(req, cap):
    return np.where((cap <= 0) | (req > cap), 0,
                    req * MAX_NODE_SCORE // np.maximum(cap, 1))


def score(world, usage):
    return (most_allocated(usage.cpu, world.alloc_cpu)
            + most_allocated(usage.mem, world.alloc_mem)) // 2
