"""Volume pods through the port's Scheduler against kubetpu.scheduler.Scheduler.

Each scenario is built in both packages' API types and driven through
both schedulers cycle by cycle (tests/torch_port_util.drive, on a fake
clock).  After every cycle the outcomes, the victims deleted, every pod's
node, nomination and PodScheduled condition (failure messages included)
and the queues are equal; after the drive, every claim's bound volume and
annotations (the ``selected-node`` stamp of delayed provisioning) are
equal.

Here: seeded kubetpu_torch/harness/volume_worlds.py worlds in both modes
(gang under both backends); scheduler_perf's four volume workloads
(SchedulingSecrets, SchedulingInTreePVs, SchedulingMigratedInTreePVs,
SchedulingCSIPVs) at 64 nodes, their 64 init pods bound one per node and
128 measured pods; the contended volume backlog at a small size; a
preemption world whose preemptors carry claims; the per-(pod, node) host
filter loop skipped for pods whose filters the device mask covers; and
the port's scheduler_perf pod templates field-equal to the JAX package's
for every workload of config/performance-config.yaml.
"""
import dataclasses
import os

import pytest

import kubetpu.api.types as japi
import kubetpu.harness.perf as jperf
import kubetpu_torch.harness.perf as tperf
from kubetpu_torch.harness import volume_worlds as VW
from tests.torch_port_util import drive, packages
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def claims(sched):
    return sorted((c.metadata.name, c.volume_name, c.phase,
                   tuple(sorted(c.metadata.annotations.items())))
                  for c in sched.store.list("PersistentVolumeClaim"))


def run_both(scenario, **kw):
    """The scenario through both schedulers; every cycle's view and the
    claims at the end equal.  Returns the port's views and scheduler."""
    jp, tp = packages()
    want, js = drive(jp, scenario, **kw)
    got, ts = drive(tp, scenario, **kw)
    assert len(got) == len(want), (len(got), len(want))
    for c, (w, g) in enumerate(zip(want, got)):
        for field in w:
            assert g[field] == w[field], (
                "cycle %d: %s differs\n jax  %s\n port %s"
                % (c, field, w[field], g[field]))
    assert claims(ts) == claims(js)
    assert ts.preempt_wave_failures == 0
    return got, ts


def bound(views):
    return sum(1 for _, node, _, _ in views[-1]["pods"] if node)


# ---------------------------------------------------------------------------
# seeded worlds

ROUTES = [("sequential", "pallas"), ("gang", "pallas"), ("gang", "lax")]


def world_scenario(seed):
    def scenario(A, H, store, sched):
        VW.populate(store, VW.world(A, seed, n_nodes=10, n_pending=16,
                                    max_existing=3), pending=True)
        yield
    return scenario


@pytest.mark.parametrize("mode,backend", ROUTES)
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_world(seed, mode, backend):
    views, sched = run_both(world_scenario(seed), mode=mode, backend=backend,
                            max_cycles=3)
    failures = [o for v in views for o in v["outcomes"] if not o[1]]
    assert bound(views) and failures
    if mode == "gang":
        assert {b for b, _ in sched.gang_backends} == {backend}


def test_delayed_provisioning_stamps_selected_node():
    """Unbound WaitForFirstConsumer claims on seed 0: the bound pods'
    claims carry the selected node in both packages."""
    _, sched = run_both(world_scenario(0), mode="sequential", max_cycles=2)
    stamped = [c for c in claims(sched) if c[3]]
    assert stamped and all(
        k == "volume.kubernetes.io/selected-node" for c in stamped
        for k, _ in c[3])


# ---------------------------------------------------------------------------
# scheduler_perf's volume workloads (config/performance-config.yaml:27-70)

WORKLOADS = ("SchedulingSecrets", "SchedulingInTreePVs",
             "SchedulingMigratedInTreePVs", "SchedulingCSIPVs")


def workload(name, nodes=64, init=64, measured=128):
    flags = {"SchedulingSecrets": "secrets", "SchedulingInTreePVs": "pvs",
             "SchedulingMigratedInTreePVs": "migrated_pvs",
             "SchedulingCSIPVs": "csi_pvs"}
    return dict(name=name, num_nodes=nodes, num_init_pods=init,
                num_pods_to_schedule=measured, **{flags[name]: True})


def jax_workload_store(w, store):
    """kubetpu/harness/perf.py:363-372, run_workload's store setup."""
    from kubetpu.harness import hollow
    for n in hollow.make_nodes(w.num_nodes, zones=w.zones):
        store.add(n)
        if w.csi_pvs or w.migrated_pvs:
            store.add(japi.CSINode(
                metadata=japi.ObjectMeta(name=n.name),
                driver_allocatable={"ebs.csi.aws.com": 39}))
    if w.pvs or w.csi_pvs or w.migrated_pvs:
        store.add(japi.StorageClass(metadata=japi.ObjectMeta(name="perf")))


def workload_scenario(spec):
    """The workload's store, its init pods bound one per node in order
    (the cut chip_smoke.py makes), then its measured pods."""
    def scenario(A, H, store, sched):
        perf = jperf if A is japi else tperf
        w = perf.Workload(**spec)
        if A is japi:
            jax_workload_store(w, store)
        else:
            src = perf.workload_store(w)
            for kind in ("Node", "CSINode", "StorageClass"):
                for obj in src.list(kind):
                    store.add(obj)
        for i in range(w.num_init_pods):
            p = perf._make_pod(w, i, "init", store)
            p.spec.node_name = f"node-{i % w.num_nodes}"
            store.add(p)
        for i in range(w.num_pods_to_schedule):
            store.add(perf._make_pod(w, i, "measured", store))
        yield
    return scenario


@pytest.mark.parametrize("mode", ["sequential", "gang"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_perf_volume_workload(name, mode):
    views, sched = run_both(workload_scenario(workload(name)), mode=mode,
                            backend="pallas", batch=128, max_cycles=3)
    assert bound(views) == 64 + 128
    if mode == "gang":
        assert {b for b, _ in sched.gang_backends} == {"pallas"}


def test_port_workload_store_matches_run_workload():
    """tperf.workload_store holds what run_workload's setup adds."""
    from kubetpu.client.store import ClusterStore as JStore
    for name in WORKLOADS:
        spec = workload(name, nodes=8)
        js = JStore()
        jax_workload_store(jperf.Workload(**spec), js)
        ts = tperf.workload_store(tperf.Workload(**spec))
        for kind in ("Node", "CSINode", "StorageClass"):
            assert (sorted(_fields(o) for o in ts.list(kind))
                    == sorted(_fields(o) for o in js.list(kind))), kind


def _fields(obj):
    """An API object as nested plain data, without its uid, resource
    version and creation time (counters and a clock, which differ between
    two stores)."""
    d = dataclasses.asdict(obj)

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k not in ("uid", "resource_version",
                                 "creation_timestamp")}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return repr(strip(d))


def test_make_pod_matches_reference_for_every_workload():
    """Every workload of config/performance-config.yaml: the port's pod
    templates (init and measured) give field-equal pods, PVs and PVCs."""
    from kubetpu.client.store import ClusterStore as JStore
    from kubetpu_torch.client.store import ClusterStore as TStore
    path = os.path.join(ROOT, "config", "performance-config.yaml")
    jws, tws = jperf.load_workloads(path), tperf.load_workloads(path)
    assert [dataclasses.asdict(w) for w in jws] == \
        [dataclasses.asdict(w) for w in tws]
    assert len(tws) == 31
    for jw, tw in zip(jws, tws):
        js, ts = JStore(), TStore()
        for prefix in ("init", "measured"):
            for i in range(3):
                assert (_fields(tperf._make_pod(tw, i, prefix, ts))
                        == _fields(jperf._make_pod(jw, i, prefix, js))), \
                    (tw.name, prefix, i)
        for kind in ("PersistentVolume", "PersistentVolumeClaim"):
            assert (sorted(_fields(o) for o in ts.list(kind))
                    == sorted(_fields(o) for o in js.list(kind))), \
                (tw.name, kind)


# ---------------------------------------------------------------------------
# the contended backlog, preemption with claims


def backlog_scenario(A, H, store, sched):
    w = VW.backlog(A, H, n_nodes=16, n_pods=80)
    VW.populate(store, w, pending=True)
    yield


@pytest.mark.parametrize("backend", ["pallas", "lax"])
def test_volume_backlog(backend):
    """The attach limits race inside the batch: the commit-time re-check
    turns the extra placements away, and later cycles place them where
    the mask allows; both packages agree on every cycle."""
    views, sched = run_both(backlog_scenario, mode="gang", backend=backend,
                            batch=64, max_cycles=6)
    msgs = {o[2] for v in views for o in v["outcomes"] if not o[1]}
    assert "node(s) exceed max volume count" in msgs
    assert max(sched.gang_rounds) > 1


def preempt_scenario(A, H, store, sched):
    """8 nodes in 4 zones, CSINode limit 2.  Nodes 0 and 4 hold two
    priority-50 pods whose claims fill the limit; the others hold three
    priority -10 fillers of 900m with one claim each.  Six priority-100
    preemptors of 1,500m each mount a claim whose PV has node affinity on
    zone i % 4."""
    drv = "ebs.csi.aws.com"

    def claim(pod, zone):
        name = pod.metadata.name
        store.add(A.PersistentVolume(
            metadata=A.ObjectMeta(name=f"pv-{name}"),
            node_affinity=A.NodeSelector(node_selector_terms=[
                A.NodeSelectorTerm(match_expressions=[
                    A.NodeSelectorRequirement(
                        key=A.LABEL_ZONE, operator="In", values=[zone])])]),
            csi_driver=drv, csi_volume_handle=f"vol-{name}"))
        store.add(A.PersistentVolumeClaim(
            metadata=A.ObjectMeta(name=f"pvc-{name}"),
            volume_name=f"pv-{name}"))
        pod.spec.volumes = [A.Volume(name="v",
                                     persistent_volume_claim=f"pvc-{name}")]

    for i, n in enumerate(H.make_nodes(8, zones=4)):
        store.add(n)
        store.add(A.CSINode(metadata=A.ObjectMeta(name=n.name),
                            driver_allocatable={drv: 2}))
        zone = n.metadata.labels[A.LABEL_ZONE]
        keep = i % 4 == 0
        for j in range(2 if keep else 3):
            p = H.make_pod(f"e-{i}-{j}", cpu_milli=300 if keep else 900,
                           priority=50 if keep else -10)
            p.metadata.creation_timestamp = float(j)
            p.spec.node_name = n.name
            if keep or j == 0:
                claim(p, zone)
            store.add(p)
    for i in range(6):
        p = H.make_pod(f"pre-{i}", cpu_milli=1500, priority=100)
        p.metadata.creation_timestamp = 100.0 + i
        claim(p, f"zone-{i % 4}")
        store.add(p)
    yield


@pytest.mark.parametrize("mode", ["sequential", "gang"])
def test_preemptors_with_claims(mode):
    views, _ = run_both(preempt_scenario, mode=mode, max_cycles=6)
    deleted = [d for v in views for d in v["deleted"]]
    assert deleted and all(d.startswith("e-") for d in deleted)
    # the priority-50 pods of nodes 0 and 4 are never victims
    assert not [d for d in deleted if d.startswith(("e-0-", "e-4-"))]
    assert any(v["nominated"] for v in views)


# ---------------------------------------------------------------------------
# the host filter loop


def test_covered_pods_skip_the_host_filter_loop():
    """A batch whose pods' relevant host filters are all covered by the
    device volume mask never calls run_filter_plugins before the device
    program: the only calls are the commit-time re-checks, one per
    placed pod."""
    _, tp = packages()
    import kubetpu_torch.scheduler as tsched
    from tests.torch_port_util import make_scheduler
    store = tp.store.ClusterStore()
    w = VW.backlog(tp.api, tp.hollow, n_nodes=16, n_pods=40)
    VW.populate(store, w, pending=True)
    sched = make_scheduler(tp, store, mode="gang", batch=64)
    fwk = next(iter(sched.profiles.values()))
    from kubetpu_torch.state.volumes import DEVICE_COVERED_PLUGINS
    assert all(fwk.has_relevant_host_filters(p) and not
               fwk.has_relevant_host_filters(p, exclude=DEVICE_COVERED_PLUGINS)
               for p in w.pending)
    calls = []
    orig = fwk.run_filter_plugins

    def spy(state, pod, ni):
        calls.append((pod.metadata.name, ni.node_name))
        return orig(state, pod, ni)
    fwk.run_filter_plugins = spy
    commits = []
    orig_commit = tsched.Scheduler._commit

    def commit(self, fwk_, qp, state, pinfo, node_name, n_feas, rel):
        commits.append((qp.pod.metadata.name, node_name, rel))
        return orig_commit(self, fwk_, qp, state, pinfo, node_name, n_feas,
                           rel)
    sched._commit = commit.__get__(sched)
    out = sched.schedule_pending(timeout=0.0)
    sched.close()
    assert len(out) == 40 and all(rel for _, _, rel in commits)
    assert calls == [(name, node) for name, node, _ in commits]
