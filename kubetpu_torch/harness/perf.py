"""scheduler_perf: YAML-driven scheduling benchmark harness.

reference: kubetpu/harness/perf.py, after test/integration/scheduler_perf/
(BenchmarkPerfScheduling, scheduler_perf_test.go:117, reads
config/performance-config.yaml, runs an in-process apiserver+scheduler
(util.go:60-68), samples 1-second throughput and scheduler histograms
(util.go:216-255) and emits perf-dashboard JSON DataItems
(scheduler_perf_types.go)).  The in-process ClusterStore plays the
apiserver, hollow.make_* synthesize the fleet (kubemark analog), and the
same JSON shape comes out.  ``run_workload`` serves the JAX package's
configuration (gang, ``chain_cycles``, the pool binder, the default
``kernel_backend``) through ``Scheduler.run()`` on ``device`` (the CUDA
card unless the caller names another; a missing card raises), and reads
the flight recorder when it is armed.  ``SustainedLoadRunner`` drives an
open-loop arrival stream (hollow.poisson_stream and its kin) against a
serving scheduler and takes its latency verdict from the load-telemetry
ring (utils/telemetry.py).

Run:  python -m kubetpu_torch.harness.perf [--config
      config/performance-config.yaml] [--only NAME] [--out FILE]
      [--verbose] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..api import types as api
from ..apis.config import KubeSchedulerConfiguration, KubeSchedulerProfile
from ..client.store import ClusterStore
from ..scheduler import Scheduler
from ..utils import trace as _utrace
from ..utils.device import DeviceLike
from ..utils.metrics import SchedulerMetrics
from . import hollow


def host_share(device_wait_s: float, elapsed_s: float) -> float:
    """The fraction of wall time NOT spent blocked on the per-cycle
    packed readback, i.e. the host-side share of a drain (the JAX
    package's one definition, shared by its reporting surfaces)."""
    return round(1.0 - device_wait_s / max(elapsed_s, 1e-9), 3)


@dataclass
class Workload:
    """One benchmark case (reference: performance-config.yaml template +
    params; scheduler_perf_test.go:64 testCase)."""
    name: str
    num_nodes: int = 100
    num_init_pods: int = 0
    num_pods_to_schedule: int = 100
    # pod template features
    pod_anti_affinity: bool = False          # required, hostname
    pod_affinity: bool = False               # required, zone
    preferred_pod_affinity: bool = False
    preferred_pod_anti_affinity: bool = False
    topology_spread: bool = False            # hard, zone
    preferred_topology_spread: bool = False  # soft, zone
    pvs: bool = False                        # one pre-bound in-tree PV/PVC
    secrets: bool = False                    # secret volume (no constraint)
    csi_pvs: bool = False                    # CSI PV/PVC + CSINode limits
    migrated_pvs: bool = False               # in-tree PV under CSINode limits
                                             # (CSI-migration translation is a
                                             # documented deviation; counts
                                             # land on the in-tree filter)
    node_affinity: bool = False              # required node affinity on zone
    preemption: bool = False                 # init: low-priority fillers;
                                             # measured: high-priority pods
    unschedulable: bool = False              # init: node-sized cpu hogs
    skip_wait_init: bool = False             # don't wait for init pods
                                             # (reference: Unschedulable's
                                             # skipWaitUntilInitPodsScheduled)
    group_labels: int = 10
    zones: int = 8
    batch_size: int = 256
    timeout_s: float = 300.0   # per-phase scheduling deadline
    mode: str = "gang"         # serving default; "sequential" = exact
                               # serial-replay oracle
    # mixed mode: measured pods cycle through all enabled features
    mixed: bool = False


@dataclass
class DataItem:
    """reference: scheduler_perf_types.go DataItem."""
    data: Dict[str, float]
    unit: str
    labels: Dict[str, str]

    def to_doc(self):
        return {"data": self.data, "unit": self.unit, "labels": self.labels}


def _make_pod(w: Workload, i: int, prefix: str, store: ClusterStore) -> api.Pod:
    # special init/measured template splits (reference: Preemption and
    # Unschedulable templates use different init vs measured pod YAMLs)
    if w.preemption and prefix == "init":
        # low-priority fillers, four per 4-cpu node (reference:
        # pod-low-priority.yaml; 2000 init / 500 nodes)
        return hollow.make_pod(f"{prefix}-{i}", cpu_milli=900,
                               mem=250 << 20, priority=-10,
                               labels={"group": prefix})
    if w.unschedulable and prefix == "init":
        # cpu ask EXCEEDS a whole node (reference: pod-large-cpu.yaml asks
        # more than node capacity) — these pods must stay pending and
        # churn the unschedulable queue while measured pods flow
        return hollow.make_pod(f"{prefix}-{i}", cpu_milli=4900,
                               mem=250 << 20, labels={"group": prefix})
    # preemption's measured pods ask for more cpu than the fillers leave
    # free, so every placement must evict a victim (PostFilter path)
    preempting = w.preemption and prefix == "measured"
    p = hollow.make_pod(f"{prefix}-{i}",
                        cpu_milli=600 if preempting else 100,
                        mem=250 << 20,
                        priority=100 if preempting else 0,
                        labels={"app": f"app-{i % w.group_labels}",
                                "group": prefix})
    features = []
    if w.pod_anti_affinity:
        features.append("anti")
    if w.pod_affinity:
        features.append("aff")
    if w.preferred_pod_affinity:
        features.append("paff")
    if w.preferred_pod_anti_affinity:
        features.append("panti")
    if w.topology_spread:
        features.append("spread")
    if w.preferred_topology_spread:
        features.append("pspread")
    if w.pvs:
        features.append("pv")
    if w.secrets:
        features.append("secret")
    if w.csi_pvs:
        features.append("csipv")
    if w.migrated_pvs:
        features.append("migpv")
    if w.node_affinity:
        features.append("nodeaff")
    if w.mixed:
        # reference MixedSchedulingBasePod: INIT pods cycle through the
        # feature templates; MEASURED pods are plain default pods
        features = ([features[i % len(features)]]
                    if prefix == "init" and features else [])
    for f in features:
        if f == "anti":
            hollow.with_anti_affinity(p, api.LABEL_HOSTNAME,
                                      match={"app": p.metadata.labels["app"]})
        elif f == "aff":
            hollow.with_affinity(p, api.LABEL_ZONE,
                                 match={"group": prefix})
            # seed pods must exist for required affinity to be satisfiable;
            # the bootstrap rule covers the first pod per selector
        elif f in ("paff", "panti"):
            aff = p.spec.affinity or api.Affinity()
            term = api.WeightedPodAffinityTerm(
                weight=10,
                pod_affinity_term=api.PodAffinityTerm(
                    label_selector=api.LabelSelector(
                        match_labels={"app": p.metadata.labels["app"]}),
                    topology_key=api.LABEL_ZONE))
            if f == "paff":
                aff.pod_affinity = aff.pod_affinity or api.PodAffinity()
                aff.pod_affinity.preferred_during_scheduling_ignored_during_execution.append(term)
            else:
                aff.pod_anti_affinity = aff.pod_anti_affinity or api.PodAntiAffinity()
                aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution.append(term)
            p.spec.affinity = aff
        elif f == "spread":
            hollow.with_spread(p, api.LABEL_ZONE, max_skew=2,
                               when="DoNotSchedule",
                               match={"group": prefix})
        elif f == "pspread":
            hollow.with_spread(p, api.LABEL_ZONE, max_skew=1,
                               when="ScheduleAnyway",
                               match={"group": prefix})
        elif f in ("pv", "csipv", "migpv"):
            pv_name = f"pv-{prefix}-{i}"
            pvc_name = f"pvc-{prefix}-{i}"
            pv = api.PersistentVolume(
                metadata=api.ObjectMeta(name=pv_name),
                storage_class_name="perf")
            if f == "csipv":
                # reference: pv-csi.yaml + csiNodeAllocatable 39/node
                pv.csi_driver = "ebs.csi.aws.com"
                pv.csi_volume_handle = pv_name
            else:
                # in-tree EBS source; "migpv" keeps the in-tree source but
                # the cluster also carries CSINode limits (the migration
                # TRANSLATION itself is a documented deviation)
                pv.aws_elastic_block_store = pv_name
            store.add(pv)
            store.add(api.PersistentVolumeClaim(
                metadata=api.ObjectMeta(name=pvc_name),
                storage_class_name="perf", volume_name=pv_name))
            p.spec.volumes.append(api.Volume(
                name="v", persistent_volume_claim=pvc_name))
        elif f == "secret":
            # a secret volume constrains nothing at scheduling time — the
            # workload measures the volume-bearing fast path (reference:
            # pod-with-secret-volume.yaml)
            p.spec.volumes.append(api.Volume(name="secret"))
        elif f == "nodeaff":
            # required node affinity on the zone label (reference:
            # pod-with-node-affinity.yaml In [zone-0 zone-1])
            aff = p.spec.affinity or api.Affinity()
            aff.node_affinity = api.NodeAffinity(
                required_during_scheduling_ignored_during_execution=(
                    api.NodeSelector(node_selector_terms=[
                        api.NodeSelectorTerm(match_expressions=[
                            api.NodeSelectorRequirement(
                                key=api.LABEL_ZONE, operator="In",
                                values=["zone-0", "zone-1"])])])))
            p.spec.affinity = aff
    return p


class ThroughputCollector:
    """1 Hz samples of pods scheduled per second
    (reference: util.go:216 throughputCollector)."""

    def __init__(self, store: ClusterStore, group: str):
        self.store = store
        self.group = group
        self.samples: List[float] = []

    def bound_count(self) -> int:
        return sum(1 for p in self.store.list("Pod")
                   if p.spec.node_name
                   and p.metadata.labels.get("group") == self.group)

    def run_until(self, target: int, timeout: float = 300.0,
                  interval: float = 1.0) -> bool:
        last = self.bound_count()
        deadline = time.time() + timeout
        while time.time() < deadline:
            time.sleep(interval)
            now = self.bound_count()
            self.samples.append((now - last) / interval)
            last = now
            if now >= target:
                return True
        return False


def _p50(xs: List[int]) -> int:
    return sorted(xs)[len(xs) // 2] if xs else 0


def _stats(samples: List[float]) -> Dict[str, float]:
    if not samples:
        return {"Average": 0.0, "Perc50": 0.0, "Perc90": 0.0, "Perc99": 0.0}
    s = sorted(samples)

    def perc(q):
        import math
        idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
        return s[idx]
    return {"Average": round(statistics.mean(s), 2),
            "Perc50": round(perc(0.50), 2),
            "Perc90": round(perc(0.90), 2),
            "Perc99": round(perc(0.99), 2)}


class SustainedLoadRunner:
    """OPEN-LOOP sustained-load injector: fires a seeded arrival/departure
    event stream (hollow.poisson_stream / burst_stream / diurnal_stream)
    at its WALL DEADLINES against a live serving scheduler — each event
    fires when its timestamp says, REGARDLESS of scheduler backpressure.
    That is the coordinated-omission defense: a closed-loop injector that
    waits for the scheduler before offering the next pod silently
    excludes exactly the requests a slow scheduler would have made wait,
    so its latency numbers flatter every stall.  Here the OFFERED rate
    is fixed by the stream and the COMPLETED rate is measured
    separately; the gap between them (plus ``behind_max_s``, how far the
    injector itself fell behind its deadlines) is reported, never
    hidden.

    The latency verdict comes from the windowed telemetry ring
    (utils/telemetry.py, armed by the caller): per-window e2e p99 with
    warmup excluded by the steady-state slope test, not a run-cumulative
    quantile that averages warmup (kernel builds, first allocations) into
    the steady number."""

    def __init__(self, store: ClusterStore, sched: Scheduler,
                 events: List[Dict[str, Any]], duration_s: float,
                 settle_s: float = 30.0):
        self.store = store
        self.sched = sched
        self.events = events
        self.duration_s = float(duration_s)
        self.settle_s = float(settle_s)

    def run(self) -> Dict[str, Any]:
        from ..utils import telemetry as _telemetry
        offered = deletes = completed_deleted = 0
        behind_max = 0.0
        added: List[tuple] = []
        t0 = time.time()
        for e in self.events:
            deadline = t0 + e["t"]
            now = time.time()
            if deadline > now:
                time.sleep(deadline - now)
            else:
                behind_max = max(behind_max, now - deadline)
            pod = e["pod"]
            if e["kind"] == "add":
                self.store.add(pod)
                offered += 1
                added.append((pod.namespace, pod.metadata.name))
            else:
                cur = self.store.get_pod(pod.namespace, pod.metadata.name)
                if cur is not None:
                    # a pod bound before its departure still COMPLETED —
                    # the churn deletes it from the cluster, not from
                    # the ledger
                    if cur.spec.node_name:
                        completed_deleted += 1
                    self.store.delete(cur)
                    deletes += 1

        def bound_now() -> int:
            n = 0
            for ns, name in added:
                p = self.store.get_pod(ns, name)
                if p is not None and p.spec.node_name:
                    n += 1
            return n

        # settle: the tail of the stream drains CLOSED-loop (arrivals
        # have stopped; this phase is excluded from the offered-rate
        # denominator and, via the slope test, from steady-state windows)
        settle_deadline = time.time() + self.settle_s
        completed = completed_deleted + bound_now()
        while completed < offered and time.time() < settle_deadline:
            time.sleep(0.2)
            completed = completed_deleted + bound_now()
        self.sched.wait_for_inflight_binds()
        completed = completed_deleted + bound_now()
        out: Dict[str, Any] = {
            "duration_s": round(self.duration_s, 3),
            "offered": offered,
            "offered_rate": round(offered / max(self.duration_s, 1e-9), 2),
            "completed": completed,
            "completed_rate": round(
                completed / max(self.duration_s, 1e-9), 2),
            "completed_frac": round(completed / max(offered, 1), 4),
            "deletes": deletes,
            "behind_max_s": round(behind_max, 3),
        }
        tel = _telemetry.ring()
        if tel is not None:
            # close the tail window so the last arrivals land in a
            # recorded window, then read the steady-state verdict
            tel.force_roll(self.sched)
            out["load"] = tel.digest()
        return out


def workload_store(w: Workload) -> ClusterStore:
    """The store ``run_workload`` starts from (kubetpu/harness/perf.py:
    363-372): the workload's nodes, a CSINode allowing 39
    ebs.csi.aws.com volumes per node for the CSI and migrated workloads
    (reference: nodeAllocatableStrategy csiNodeAllocatable), and the
    ``perf`` StorageClass for every PV workload."""
    store = ClusterStore()
    for n in hollow.make_nodes(w.num_nodes, zones=w.zones):
        store.add(n)
        if w.csi_pvs or w.migrated_pvs:
            store.add(api.CSINode(
                metadata=api.ObjectMeta(name=n.name),
                driver_allocatable={"ebs.csi.aws.com": 39}))
    if w.pvs or w.csi_pvs or w.migrated_pvs:
        store.add(api.StorageClass(metadata=api.ObjectMeta(name="perf")))
    return store


def run_workload(w: Workload, verbose: bool = False,
                 device: DeviceLike = None) -> List[DataItem]:
    """reference: kubetpu/harness/perf.py:361 (scheduler_perf_test.go:117
    perfScheduling).  device: the Scheduler's (default the CUDA card)."""
    store = workload_store(w)
    metrics = SchedulerMetrics()
    cfg = KubeSchedulerConfiguration(profiles=[KubeSchedulerProfile()],
                                     batch_size=w.batch_size, mode=w.mode,
                                     chain_cycles=True)
    sched = Scheduler(store, config=cfg, metrics=metrics, async_binding=True,
                      device=device)
    thread = sched.run()
    try:
        # phase 1: init pods (not measured)
        if w.num_init_pods:
            for i in range(w.num_init_pods):
                store.add(_make_pod(w, i, "init", store))
            if w.skip_wait_init:
                # reference: skipWaitUntilInitPodsScheduled — some init
                # pods may be unschedulable by design; give the queue one
                # flush interval to absorb them
                time.sleep(2.0)
            else:
                coll = ThroughputCollector(store, "init")
                if not coll.run_until(w.num_init_pods,
                                      timeout=w.timeout_s):
                    raise RuntimeError(
                        f"{w.name}: init pods did not schedule "
                        f"({coll.bound_count()}/{w.num_init_pods})")
        # phase 2: measured pods
        device_wait0 = sched.device_wait_s
        cycles0 = sched.cycle_count
        resyncs0 = sched.resync_count
        delta0 = sched.delta_cycle_count
        t_measured = time.time()
        for i in range(w.num_pods_to_schedule):
            store.add(_make_pod(w, i, "measured", store))
        coll = ThroughputCollector(store, "measured")
        done = coll.run_until(w.num_pods_to_schedule,
                              timeout=w.timeout_s)
        sched.wait_for_inflight_binds()
        elapsed = time.time() - t_measured
        scheduled = coll.bound_count()
        if verbose:
            print(f"  {w.name}: {scheduled}/{w.num_pods_to_schedule} "
                  f"scheduled", flush=True)
        device_wait = sched.device_wait_s - device_wait0
        items = [
            DataItem(data=_stats(coll.samples), unit="pods/s",
                     labels={"Name": w.name, "Metric": "SchedulingThroughput"}),
            # measured-phase scheduler internals: committed cycles, wall
            # time spent blocked on the per-cycle packed readback, and the
            # host share of the measured phase
            DataItem(data={"Cycles": float(sched.cycle_count - cycles0),
                           "DeviceWaitS": round(device_wait, 3),
                           "HostShare": host_share(device_wait,
                                                   elapsed),
                           # incremental-tensorization health (state/delta)
                           # over the MEASURED phase only, like Cycles:
                           # rows the scatter path updated per delta cycle
                           # + how often the blessed full rebuild ran
                           # the measured-phase tail of the bounded ring:
                           # the monotonic cycle counter stays correct
                           # even after the deque evicts warm-up entries
                           "Resyncs": float(sched.resync_count - resyncs0),
                           "DeltaRowsP50": float(_p50(
                               list(sched.delta_rows)[
                                   -(sched.delta_cycle_count - delta0):]
                               if sched.delta_cycle_count > delta0
                               else []))},
                     unit="mixed",
                     labels={"Name": w.name, "Metric": "SchedulerStats"}),
        ]
        fr = _utrace.flight_recorder()
        if fr is not None:
            # flight-recorder health next to the perf numbers: how many of
            # the run's cycles the ring still holds and how many it shed
            items.append(DataItem(
                data={"Cycles": float(len(fr.cycles())),
                      "Dropped": float(fr.dropped())},
                unit="count",
                labels={"Name": w.name, "Metric": "FlightRecorder"}))
        for metric, hist in (
                ("scheduling_algorithm_duration_seconds",
                 metrics.scheduling_algorithm_duration),
                ("binding_duration_seconds", metrics.binding_duration),
                ("e2e_scheduling_duration_seconds",
                 metrics.e2e_scheduling_duration),
                ("pod_scheduling_duration_seconds",
                 metrics.pod_scheduling_duration)):
            n = hist.count()
            items.append(DataItem(
                data={"Average": round(hist.sum() / n, 6) if n else 0.0,
                      "Perc50": hist.percentile(0.50),
                      "Perc90": hist.percentile(0.90),
                      "Perc99": hist.percentile(0.99)},
                unit="s", labels={"Name": w.name, "Metric": metric}))
        if not done:
            items[0].labels["Incomplete"] = "true"
        return items
    finally:
        sched.close()


# the reference's workload matrix, scaled for one-box runs
# (reference: config/performance-config.yaml:1-120)
DEFAULT_WORKLOADS: List[Workload] = [
    Workload(name="SchedulingBasic", num_nodes=100, num_init_pods=100,
             num_pods_to_schedule=300),
    Workload(name="SchedulingPodAntiAffinity", num_nodes=100,
             num_init_pods=100, num_pods_to_schedule=150,
             pod_anti_affinity=True, group_labels=100),
    Workload(name="SchedulingPodAffinity", num_nodes=100, num_init_pods=100,
             num_pods_to_schedule=300, pod_affinity=True),
    Workload(name="SchedulingPreferredPodAffinity", num_nodes=100,
             num_init_pods=100, num_pods_to_schedule=300,
             preferred_pod_affinity=True),
    Workload(name="SchedulingPreferredPodAntiAffinity", num_nodes=100,
             num_init_pods=100, num_pods_to_schedule=300,
             preferred_pod_anti_affinity=True),
    Workload(name="TopologySpreading", num_nodes=100, num_init_pods=100,
             num_pods_to_schedule=300, topology_spread=True),
    Workload(name="PreferredTopologySpreading", num_nodes=100,
             num_init_pods=100, num_pods_to_schedule=300,
             preferred_topology_spread=True),
    Workload(name="SchedulingInTreePVs", num_nodes=100, num_init_pods=50,
             num_pods_to_schedule=100, pvs=True),
    Workload(name="SchedulingSecrets", num_nodes=100, num_init_pods=100,
             num_pods_to_schedule=300, secrets=True),
    Workload(name="SchedulingCSIPVs", num_nodes=100, num_init_pods=50,
             num_pods_to_schedule=100, csi_pvs=True),
    Workload(name="SchedulingMigratedInTreePVs", num_nodes=100,
             num_init_pods=50, num_pods_to_schedule=100, migrated_pvs=True),
    Workload(name="SchedulingNodeAffinity", num_nodes=100, num_init_pods=100,
             num_pods_to_schedule=300, node_affinity=True),
    Workload(name="MixedSchedulingBasePod", num_nodes=100, num_init_pods=200,
             num_pods_to_schedule=300, pod_anti_affinity=True,
             pod_affinity=True, preferred_pod_affinity=True,
             topology_spread=True, mixed=True),
    Workload(name="Preemption", num_nodes=100, num_init_pods=400,
             num_pods_to_schedule=100, preemption=True),
    Workload(name="Unschedulable", num_nodes=100, num_init_pods=40,
             num_pods_to_schedule=200, unschedulable=True,
             skip_wait_init=True),
]


def _write_doc(path: str, items: List[DataItem]) -> None:
    """Atomic checkpoint write: a crash mid-matrix must not lose (or
    truncate) the completed workloads' results."""
    import os
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": "v1",
                   "dataItems": [it.to_doc() for it in items]}, f, indent=2)
    os.replace(tmp, path)


def load_workloads(path: str) -> List[Workload]:
    import yaml
    with open(path) as f:
        docs = yaml.safe_load(f)
    if not isinstance(docs, list) or not all(isinstance(d, dict)
                                             for d in docs):
        raise SystemExit(f"{path}: expected a YAML list of workload "
                         "mappings (see config/performance-config.yaml)")
    out = []
    for d in docs:
        try:
            out.append(Workload(**d))
        except TypeError as e:
            raise SystemExit(f"{path}: bad workload {d.get('name', d)}: {e}")
    return out


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="YAML workload list (default: built-in matrix)")
    ap.add_argument("--only", default=None, help="substring workload filter")
    ap.add_argument("--out", default=None, help="write DataItems JSON here")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the scheduler (default cuda; cpu "
                         "runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    workloads = (load_workloads(args.config) if args.config
                 else DEFAULT_WORKLOADS)
    if args.only:
        workloads = [w for w in workloads if args.only.lower() in
                     w.name.lower()]
    all_items = []
    failed: List[str] = []
    for w in workloads:
        if args.verbose:
            print(f"running {w.name} ({w.num_nodes} nodes, "
                  f"{w.num_pods_to_schedule} pods)...", flush=True)
        try:
            items = run_workload(w, verbose=args.verbose,
                                 device=args.device)
        except Exception as e:
            # one failed workload must not lose the rest of the matrix —
            # record it, keep going, and exit non-zero at the end
            print(f"  {w.name} FAILED: {e}", file=sys.stderr, flush=True)
            failed.append(w.name)
            items = [DataItem(data=_stats([]), unit="pods/s",
                              labels={"Name": w.name,
                                      "Metric": "SchedulingThroughput",
                                      "Error": str(e)})]
        all_items.extend(items)
        if args.out:
            _write_doc(args.out, all_items)
    if args.out and not workloads:
        # zero workloads ran (e.g. --only matched nothing): still refresh
        # the file so a stale previous run can't masquerade as current
        _write_doc(args.out, all_items)
    doc = {"version": "v1",
           "dataItems": [it.to_doc() for it in all_items]}
    print(json.dumps(doc, indent=2))
    if failed:
        print(f"{len(failed)} workload(s) failed: {', '.join(failed)}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
