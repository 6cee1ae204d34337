"""scheduler_perf's world-building half: the workload matrix and the
stores its workloads start from; the counterpart of kubetpu/harness/perf.py
(reference: test/integration/scheduler_perf/ — scheduler_perf_test.go:64
testCase, config/performance-config.yaml, scheduler_perf_types.go).

Ported: ``Workload``, ``DataItem``, the pod templates (``_make_pod``),
``load_workloads`` and the store setup of ``run_workload``
(``workload_store``).  ``run_workload``, ``ThroughputCollector``,
``SustainedLoadRunner`` and ``main`` drive ``Scheduler.run()``, the
scheduler's metrics and the flight recorder, which wait for ROADMAP queue 1
items 7 and 9; until then chip_smoke.py and the tests drain these worlds
through ``Scheduler.schedule_pending``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..api import types as api
from ..client.store import ClusterStore
from . import hollow


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
