"""Hollow cluster generation: synthetic node fleets and pod workloads.

A copy of the JAX package's node/pod makers (its open-loop arrival
streams and restart worlds are not needed by the port).  The analog of
kubemark's hollow nodes (reference:
cmd/kubemark/hollow-node.go, pkg/kubemark/hollow_kubelet.go:35) and the
scheduler_perf node-prepare strategies (reference:
test/utils/runners.go:951-1121 TrivialNodePrepareStrategy/LabelNodeStrategy)
plus the benchmark node shape (reference:
test/integration/scheduler_perf/scheduler_test.go:52-66 — 110 pods, 4 CPU,
32 Gi per fake node).  Used by chip_smoke.py and the port's tests to
synthesize clusters without machines.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..api import types as api


BENCH_NODE_CPU_MILLI = 4000          # scheduler_test.go:57 "4" cpu
BENCH_NODE_MEM_BYTES = 32 * (1 << 30)  # "32Gi"
BENCH_NODE_PODS = 110                # "110" pods


def make_node(name: str, zone: Optional[str] = None,
              region: Optional[str] = None,
              cpu_milli: int = BENCH_NODE_CPU_MILLI,
              mem: int = BENCH_NODE_MEM_BYTES,
              pods: int = BENCH_NODE_PODS,
              labels: Optional[Dict[str, str]] = None) -> api.Node:
    lab = {api.LABEL_HOSTNAME: name}
    if zone:
        lab[api.LABEL_ZONE] = zone
    if region:
        lab[api.LABEL_REGION] = region
    if labels:
        lab.update(labels)
    alloc = {"cpu": f"{cpu_milli}m", "memory": str(mem), "pods": str(pods)}
    return api.Node(
        metadata=api.ObjectMeta(name=name, labels=lab),
        status=api.NodeStatus(allocatable=dict(alloc), capacity=dict(alloc)))


def make_nodes(n: int, zones: int = 0, prefix: str = "node-",
               **kw) -> List[api.Node]:
    out = []
    for i in range(n):
        zone = f"zone-{i % zones}" if zones else None
        region = "region-0" if zones else None
        out.append(make_node(f"{prefix}{i}", zone=zone, region=region, **kw))
    return out


def make_pod(name: str, namespace: str = "default",
             cpu_milli: int = 100, mem: int = 256 << 20,
             labels: Optional[Dict[str, str]] = None,
             priority: int = 0) -> api.Pod:
    req = {"cpu": f"{cpu_milli}m", "memory": str(mem)}
    return api.Pod(
        metadata=api.ObjectMeta(name=name, namespace=namespace,
                                labels=dict(labels or {})),
        spec=api.PodSpec(
            priority=priority,
            containers=[api.Container(
                name="c", image="k8s.gcr.io/pause:3.2",
                resources=api.ResourceRequirements(requests=req))]))


def make_pods(n: int, prefix: str = "pod-", namespace: str = "default",
              group_labels: int = 0, rng: Optional[random.Random] = None,
              **kw) -> List[api.Pod]:
    """group_labels > 0 assigns each pod a label app=app-<i%groups> so
    affinity/spread workloads have selector targets."""
    rng = rng or random.Random(0)
    out = []
    for i in range(n):
        labels = {}
        if group_labels:
            labels["app"] = f"app-{i % group_labels}"
        out.append(make_pod(f"{prefix}{i}", namespace=namespace,
                            labels=labels, **kw))
    return out


def with_anti_affinity(pod: api.Pod, topo_key: str = api.LABEL_HOSTNAME,
                       match: Optional[Dict[str, str]] = None) -> api.Pod:
    term = api.PodAffinityTerm(
        label_selector=api.LabelSelector(match_labels=dict(
            match or pod.metadata.labels)),
        topology_key=topo_key)
    aff = pod.spec.affinity or api.Affinity()
    if aff.pod_anti_affinity is None:
        aff.pod_anti_affinity = api.PodAntiAffinity()
    aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution \
        .append(term)
    pod.spec.affinity = aff
    return pod
