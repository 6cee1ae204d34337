"""kube-scheduler v1.19 NodeResourcesBalancedAllocation
(pkg/scheduler/framework/plugins/noderesources/balanced_allocation.go):
``(1 - |cpu fraction - memory fraction|) * 100`` truncated, 0 where either
fraction reaches 1."""

import numpy as np

MAX_NODE_SCORE = 100


def balanced_allocation(req_cpu, req_mem, cap_cpu, cap_mem):
    cf = req_cpu / np.maximum(cap_cpu, 1).astype(np.float64)
    mf = req_mem / np.maximum(cap_mem, 1).astype(np.float64)
    s = np.floor((1.0 - np.abs(cf - mf)) * MAX_NODE_SCORE)
    return np.where((cf >= 1.0) | (mf >= 1.0), 0, s).astype(np.int64)


def score(world, usage):
    return balanced_allocation(usage.cpu, usage.mem, world.alloc_cpu,
                               world.alloc_mem)
