"""Hollow cluster generation: synthetic node fleets and pod workloads.

A copy of kubetpu/harness/hollow.py: the node/pod makers, the term
helpers, the warm-restart world and the open-loop arrival streams (a
seeded ``random.Random`` gives the JAX package's event list).  The
analog of
kubemark's hollow nodes (reference:
cmd/kubemark/hollow-node.go, pkg/kubemark/hollow_kubelet.go:35) and the
scheduler_perf node-prepare strategies (reference:
test/utils/runners.go:951-1121 TrivialNodePrepareStrategy/LabelNodeStrategy)
plus the benchmark node shape (reference:
test/integration/scheduler_perf/scheduler_test.go:52-66 — 110 pods, 4 CPU,
32 Gi per fake node).  Used by chip_smoke.py, the perf harness
(harness/perf.py) and the port's tests to synthesize clusters without
machines.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

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


def restart_world(n_nodes: int, existing_per_node: int = 2,
                  zones: int = 8):
    """The deterministic warm-restart world: n_nodes zoned nodes, each
    carrying existing_per_node bound pods with 16 app-group labels (the
    same store insertion order, label vocab and selector diversity as the
    JAX package's world of the same shape)."""
    from ..client.store import ClusterStore
    store = ClusterStore()
    for i, n in enumerate(make_nodes(n_nodes, zones=zones)):
        store.add(n)
        for p in make_pods(existing_per_node, prefix=f"ex-{i}-",
                           group_labels=16):
            p.spec.node_name = n.name
            store.add(p)
    return store


def restart_wave(wave: int, prefix: str = "restart-") -> List[api.Pod]:
    """The arriving wave of the warm-restart case: 16 app groups, 1/3
    soft zone spread, 1/5 hostname anti-affinity (the blended
    scheduler_perf topology mix)."""
    pods = make_pods(wave, prefix=prefix, group_labels=16)
    for i, p in enumerate(pods):
        if i % 3 == 0:
            with_spread(p, api.LABEL_ZONE, when="ScheduleAnyway")
        if i % 5 == 0:
            with_anti_affinity(p)
    return pods


# -- sustained arrival/departure streams (the open-loop load vocabulary) --
#
# Every generator below returns a SEEDED, fully materialized event list
# [{"t": seconds-from-stream-start, "kind": "add"|"delete", "pod": Pod},
# ...] sorted by t — pure data, no clocks, no side effects — so the same
# (seed, rate, duration) tuple always yields the same stream and the
# armed-vs-disarmed parity check can replay it deterministically.  The
# open-loop injection itself (fire each event at its wall deadline
# REGARDLESS of scheduler backpressure — the coordinated-omission
# defense) lives in harness/perf.py SustainedLoadRunner.


def _stream_pod(i: int, rng: random.Random, prefix: str,
                namespace: str, group_labels: int,
                spread_frac: float) -> api.Pod:
    labels = {"app": f"app-{i % group_labels}"} if group_labels else {}
    pod = make_pod(f"{prefix}{i}", namespace=namespace, labels=labels)
    # a slice of the stream carries SOFT zone spread (ScheduleAnyway):
    # the topology scoring path stays exercised under churn without
    # making any arrival infeasible (the steady-state gate expects
    # offered ~= completed and zero demotions on a healthy run)
    if spread_frac > 0 and rng.random() < spread_frac:
        with_spread(pod, api.LABEL_ZONE, when="ScheduleAnyway")
    return pod


def _with_departures(events: List[Dict[str, Any]], rng: random.Random,
                     mean_dwell_s: Optional[float]
                     ) -> List[Dict[str, Any]]:
    if not mean_dwell_s:
        return sorted(events, key=lambda e: e["t"])
    out = list(events)
    for e in events:
        if e["kind"] != "add":
            continue
        out.append({"t": e["t"] + rng.expovariate(1.0 / mean_dwell_s),
                    "kind": "delete", "pod": e["pod"]})
    return sorted(out, key=lambda e: e["t"])


def poisson_stream(rate: float, duration_s: float, seed: int = 0,
                   mean_dwell_s: Optional[float] = None,
                   prefix: str = "arr-", namespace: str = "default",
                   group_labels: int = 16,
                   spread_frac: float = 0.25) -> List[Dict[str, Any]]:
    """Homogeneous Poisson arrivals at ``rate`` pods/s for
    ``duration_s`` seconds (exponential inter-arrival gaps).  With
    ``mean_dwell_s``, each arrival also emits a departure event after
    an exponential dwell — continuous churn instead of monotone fill."""
    rng = random.Random(seed)
    events: List[Dict[str, Any]] = []
    t, i = 0.0, 0
    while True:
        t += rng.expovariate(rate)
        if t >= duration_s:
            break
        events.append({"t": t, "kind": "add",
                       "pod": _stream_pod(i, rng, prefix, namespace,
                                          group_labels, spread_frac)})
        i += 1
    return _with_departures(events, rng, mean_dwell_s)


def burst_stream(rate: float, duration_s: float, seed: int = 0,
                 burst_every_s: float = 10.0, burst_size: int = 64,
                 mean_dwell_s: Optional[float] = None,
                 prefix: str = "burst-", namespace: str = "default",
                 group_labels: int = 16,
                 spread_frac: float = 0.25) -> List[Dict[str, Any]]:
    """Baseline Poisson arrivals at ``rate`` plus a ``burst_size``-pod
    spike every ``burst_every_s`` seconds — the thundering-herd shape
    (deployment rollouts, cron fan-outs) that stresses queue depth and
    the recovery ladder rather than mean throughput."""
    rng = random.Random(seed)
    events: List[Dict[str, Any]] = []
    t, i = 0.0, 0
    while True:
        t += rng.expovariate(rate)
        if t >= duration_s:
            break
        events.append({"t": t, "kind": "add",
                       "pod": _stream_pod(i, rng, prefix, namespace,
                                          group_labels, spread_frac)})
        i += 1
    bt = burst_every_s
    while bt < duration_s:
        for _ in range(burst_size):
            events.append({"t": bt, "kind": "add",
                           "pod": _stream_pod(i, rng, prefix, namespace,
                                              group_labels, spread_frac)})
            i += 1
        bt += burst_every_s
    return _with_departures(events, rng, mean_dwell_s)


def diurnal_stream(rate: float, duration_s: float, seed: int = 0,
                   period_s: float = 60.0, amplitude: float = 0.5,
                   mean_dwell_s: Optional[float] = None,
                   prefix: str = "diurnal-", namespace: str = "default",
                   group_labels: int = 16,
                   spread_frac: float = 0.25) -> List[Dict[str, Any]]:
    """Nonhomogeneous Poisson arrivals whose instantaneous rate follows
    a sinusoid — ``rate * (1 + amplitude * sin(2*pi*t/period_s))`` —
    generated by thinning against the peak rate: the compressed-day
    shape (period_s plays 24 h) that exposes whether steady-state
    detection tracks a moving operating point instead of latching onto
    one plateau."""
    rng = random.Random(seed)
    peak = rate * (1.0 + abs(amplitude))
    events: List[Dict[str, Any]] = []
    t, i = 0.0, 0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            break
        rate_t = rate * (1.0 + amplitude * math.sin(
            2.0 * math.pi * t / period_s))
        if rng.random() * peak >= max(rate_t, 0.0):
            continue
        events.append({"t": t, "kind": "add",
                       "pod": _stream_pod(i, rng, prefix, namespace,
                                          group_labels, spread_frac)})
        i += 1
    return _with_departures(events, rng, mean_dwell_s)


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


def with_spread(pod: api.Pod, topo_key: str, max_skew: int = 1,
                when: str = "DoNotSchedule",
                match: Optional[Dict[str, str]] = None) -> api.Pod:
    pod.spec.topology_spread_constraints.append(api.TopologySpreadConstraint(
        max_skew=max_skew, topology_key=topo_key, when_unsatisfiable=when,
        label_selector=api.LabelSelector(match_labels=dict(
            match or pod.metadata.labels))))
    return pod


def with_affinity(pod: api.Pod, topo_key: str = api.LABEL_ZONE,
                  match: Optional[Dict[str, str]] = None) -> api.Pod:
    term = api.PodAffinityTerm(
        label_selector=api.LabelSelector(match_labels=dict(
            match or pod.metadata.labels)),
        topology_key=topo_key)
    aff = pod.spec.affinity or api.Affinity()
    if aff.pod_affinity is None:
        aff.pod_affinity = api.PodAffinity()
    aff.pod_affinity.required_during_scheduling_ignored_during_execution \
        .append(term)
    pod.spec.affinity = aff
    return pod
