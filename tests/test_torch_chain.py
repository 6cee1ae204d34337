"""Cycle chaining in the port (kubetpu_torch/scheduler.py with
models/gang.materialize_assigned) on the CPU: twins of tests/test_chain.py,
materialize_assigned against the JAX program, and chained gang drains of
seeded churn worlds through both packages' schedulers — the same cycles,
placements, evictions and nominations, the same chain uses and the same
resync reasons."""
import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import kubetpu.state.delta as jdelta
from kubetpu.models import gang as jgang
from kubetpu_torch.api import types as api
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.harness import preempt_worlds as PW
from kubetpu_torch.models import gang as tgang
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.state import delta as tdelta
from kubetpu_torch.state import tensors as tensors_mod
from tests.torch_port_util import (assert_same, build_jax, carry,
                                   framework_packages, jax_process,
                                   new_scheduler, outcome_view, packages,
                                   drive)


@pytest.fixture(autouse=True)
def _release_jax_programs():
    """The JAX drives here compile the JAX scheduler's programs afresh
    (torch_port_util.drive re-jits its auction) and keep ~180 MB of them
    per drive in the process: release them after each test, so a test
    worker does not accumulate them."""
    yield
    jax.clear_caches()


def gang_sched(store, batch_size):
    cfg = KubeSchedulerConfiguration(profiles=[KubeSchedulerProfile()],
                                     batch_size=batch_size, mode="gang",
                                     chain_cycles=True)
    return Scheduler(store, config=cfg, device="cpu")


def drain(sched, max_cycles=12):
    out = []
    for _ in range(max_cycles):
        got = sched.schedule_pending(timeout=0.0)
        if not got:
            break
        out.extend(got)
    return out


def count_builds(monkeypatch):
    calls = [0]
    orig = tensors_mod.SnapshotBuilder.build

    def counted(self, *a, **kw):
        calls[0] += 1
        return orig(self, *a, **kw)
    monkeypatch.setattr(tensors_mod.SnapshotBuilder, "build", counted)
    return calls


# ---------------------------------------------------------------------------
# tests/test_chain.py twins


def test_chained_drain_tensorizes_rarely(monkeypatch):
    calls = count_builds(monkeypatch)
    store = ClusterStore()
    for n in hollow.make_nodes(8, zones=4):
        store.add(n)
    sched = gang_sched(store, batch_size=8)
    for p in hollow.make_pods(30, group_labels=4):
        store.add(p)
    out = drain(sched)
    assert len(out) == 30
    assert all(o.node for o in out), [(o.pod.metadata.name, o.err)
                                      for o in out if not o.node]
    assert calls[0] <= 2, f"expected <=2 tensorizes, saw {calls[0]}"
    assert "chain" in sched.cluster_sources
    bound = {}
    for p in store.list("Pod"):
        bound.setdefault(p.spec.node_name, 0)
        bound[p.spec.node_name] += 1
    assert sum(bound.values()) == 30
    sched.close()


def test_chained_capacity_respected_across_cycles():
    store = ClusterStore()
    for i in range(6):
        n = hollow.make_node(f"n{i}")
        n.status.allocatable["pods"] = "1"
        store.add(n)
    sched = gang_sched(store, batch_size=2)
    for p in hollow.make_pods(9):
        store.add(p)
    out = drain(sched)
    placed = [o for o in out if o.node]
    assert len(placed) == 6
    per_node = {}
    for o in placed:
        per_node[o.node] = per_node.get(o.node, 0) + 1
    assert max(per_node.values()) == 1, per_node
    sched.close()


def test_external_event_rebuilds(monkeypatch):
    calls = count_builds(monkeypatch)
    store = ClusterStore()
    n = hollow.make_node("n0")
    n.status.allocatable["pods"] = "2"
    store.add(n)
    sched = gang_sched(store, batch_size=2)
    for p in hollow.make_pods(4):
        store.add(p)
    first = sched.schedule_pending(timeout=0.0)
    assert sum(1 for o in first if o.node) == 2
    builds_before = calls[0]
    n1 = hollow.make_node("n1")
    n1.status.allocatable["pods"] = "2"
    store.add(n1)
    sched.queue.flush_backoff_completed()
    out = drain(sched)
    assert sum(1 for o in out if o.node == "n1") == 2
    assert calls[0] > builds_before
    assert "node-set" in sched.cluster_sources
    sched.close()


def test_chain_equivalent_to_fresh_rebuild_under_churn():
    """Randomized drain with event churn between cycles: placements equal
    with chaining on and off."""
    def seed_world(store):
        rng = random.Random(41)
        for i, n in enumerate(hollow.make_nodes(10, zones=3)):
            n.status.allocatable["pods"] = str(rng.randint(3, 6))
            store.add(n)
        pods = hollow.make_pods(40, group_labels=5)
        for i, p in enumerate(pods):
            if i % 4 == 0:
                hollow.with_anti_affinity(p, api.LABEL_HOSTNAME)
            if i % 3 == 0:
                hollow.with_spread(p, api.LABEL_ZONE, when="ScheduleAnyway")
            if i % 7 == 0:
                hollow.with_affinity(p, api.LABEL_ZONE)
        return pods

    def churn(store, cycle):
        if cycle == 0:
            n = hollow.make_node("late-n", zone="z9")
            n.status.allocatable["pods"] = "4"
            store.add(n)
        elif cycle == 1:
            foreign = hollow.make_pod("foreign-0", labels={"app": "f"})
            foreign.spec.node_name = "node-0"
            store.add(foreign)
        elif cycle == 2:
            n0 = store.get("Node", "node-1")
            upd = hollow.make_node("node-1", zone="z9")
            upd.status.allocatable = dict(n0.status.allocatable)
            store.update(upd)
        elif cycle == 3:
            victim = store.get("Pod", "default/foreign-0")
            if victim is not None:
                store.delete(victim)

    def run(chain):
        store = ClusterStore()
        pods = seed_world(store)
        cfg = KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()], batch_size=8, mode="gang",
            chain_cycles=chain)
        sched = Scheduler(store, config=cfg, device="cpu")
        for p in pods:
            store.add(p)
        placements = {}
        for cycle in range(14):
            got = sched.schedule_pending(timeout=0.0)
            if not got:
                break
            for o in got:
                placements[o.pod.metadata.name] = o.node
            churn(store, cycle)
        sched.close()
        return placements, sched.cluster_sources

    (on, src_on), (off, src_off) = run(True), run(False)
    assert on == off, {k: (on.get(k), off.get(k))
                       for k in set(on) | set(off) if on.get(k) != off.get(k)}
    assert sum(1 for v in on.values() if v) >= 30
    assert "chain" not in src_off


def test_chained_anti_affinity_repels_across_cycles():
    store = ClusterStore()
    for i in range(2):
        store.add(hollow.make_node(f"n{i}"))
    sched = gang_sched(store, batch_size=1)
    pods = [hollow.with_anti_affinity(
        hollow.make_pod(f"p{i}", labels={"app": "x"}), api.LABEL_HOSTNAME)
        for i in range(3)]
    for p in pods:
        store.add(p)
    out = drain(sched)
    nodes = [o.node for o in out if o.node]
    assert len(nodes) == 2
    assert len(set(nodes)) == 2
    failed = [o for o in out if not o.node]
    assert len(failed) == 1
    sched.close()


# ---------------------------------------------------------------------------
# materialize_assigned against the JAX program


@pytest.mark.parametrize("extend,pads", [(False, False), (True, False),
                                         (True, True)])
def test_materialize_assigned_matches_jax(extend, pads):
    """A term-bearing world's auction placements folded into the cluster
    by both packages' materialize_assigned: every leaf bitwise equal."""
    jcl, jb, _, _ = build_jax(5, 24, 20, terms=True)
    tcl, tb, jbd = carry(jcl, jb)
    B = jb.valid.shape[0]
    N = jcl.allocatable.shape[0]
    r = np.random.default_rng(5)
    chosen = np.where(r.random(B) < 0.7, r.integers(0, 24, B), -1).astype(
        np.int32)
    req = (np.asarray(jcl.requested)
           + r.integers(0, 3, np.asarray(jcl.requested).shape)).astype(
               np.float32)
    nz = np.asarray(jcl.nonzero_requested) + 1.0
    ports = (r.random((N, jcl.ports.shape[1])) < 0.1).astype(np.float32)
    P0 = jcl.pod_valid.shape[0]
    E0 = jcl.filter_terms.valid.shape[0]
    kw = dict(extend_score_terms=extend, hard_pod_affinity_weight=3.0)
    if pads:
        kw.update(pad_pods_to=2 * (P0 + B),
                  pad_terms_to=2 * (E0 + B * jb.raa.valid.shape[1]))
    want = jgang.materialize_assigned(
        jcl, jax.tree.map(jnp.asarray, jb), jnp.asarray(chosen),
        jnp.asarray(req), jnp.asarray(nz), jnp.asarray(ports), **kw)
    import torch
    got = tgang.materialize_assigned(
        tcl, tb, torch.from_numpy(chosen), torch.from_numpy(req),
        torch.from_numpy(nz), torch.from_numpy(ports), **kw)
    for f in want._fields:
        wl, gl = tdelta._leaves(getattr(want, f)), tdelta._leaves(
            getattr(got, f))
        assert len(wl) == len(gl), f
        for i, (a, b) in enumerate(zip(wl, gl)):
            assert_same(a, b.contiguous(), f"{f}[{i}]")


# ---------------------------------------------------------------------------
# chained gang drains of churn worlds, both schedulers


def churn_scenario(seed, uses, sources):
    """A seeded preemption world (preempt_worlds: packed nodes, binding
    PDBs, parked nominations, preemptors) plus small pods that fit, and
    churn between cycles: an external bind, a node label update, a
    deletion, a new taint, a node added.  ``uses`` / ``sources`` receive
    each cycle's chain use and its cluster's source."""
    def scenario(A, H, store, sched):
        _spy(sched, uses, sources)
        r = random.Random(seed)
        w = PW.world(A, seed, 16, 10)
        PW.populate(store, w)
        for p, nn in w.parked:
            sched.queue.add_nominated_pod(p, nn)
        for p in w.pending:
            store.add(p)
        for i in range(96):
            store.add(H.make_pod(f"small-{i}", cpu_milli=100, mem=64 << 20,
                                 labels={"app": r.choice("abc")}))
        yield
        yield
        ext = H.make_pod("ext-0", cpu_milli=100, labels={"app": "e"})
        ext.spec.node_name = f"n{r.randrange(16)}"
        store.add(ext)
        yield
        n = copy.deepcopy(store.get("Node", f"n{r.randrange(16)}"))
        n.metadata.labels["disk"] = "ssd"
        store.update(n)
        yield
        yield
        store.delete(store.get("Pod", "default/ext-0"))
        yield
        n = copy.deepcopy(store.get("Node", f"n{r.randrange(16)}"))
        n.spec.taints.append(A.Taint(key="dedicated", value="x",
                                     effect="PreferNoSchedule"))
        store.update(n)
        yield
        late = A.Node(metadata=A.ObjectMeta(
            name="n-late", labels={A.LABEL_HOSTNAME: "n-late",
                                   A.LABEL_ZONE: "z0"}),
            status=A.NodeStatus(allocatable={"cpu": "4", "memory": "8Gi",
                                             "pods": "110"}))
        store.add(late)
        yield
    return scenario


def _spy(sched, uses, sources):
    """Record each cycle's chain use and cluster source."""
    if hasattr(sched, "cluster_sources"):
        sched.cluster_sources = sources
        return
    orig_prep = sched._prepare_group

    def prepare(*a, **kw):
        prep, out = orig_prep(*a, **kw)
        if prep is not None:
            uses.append(prep.used_chain)
            if prep.used_chain:
                sources.append("chain")
        return prep, out
    sched._prepare_group = prepare


def _jax_sources(monkeypatch, sources):
    """The JAX DeltaTensorizer's refresh outcome per call, in the port's
    cluster_sources words."""
    orig = jdelta.DeltaTensorizer.refresh

    def refresh(self, *a, **kw):
        cluster, st = orig(self, *a, **kw)
        sources.append(st.reason if st.resync else
                       "delta" if st.delta_rows else "clean")
        return cluster, st
    monkeypatch.setattr(jdelta.DeltaTensorizer, "refresh", refresh)


@pytest.fixture(scope="module")
def jax_proc():
    with jax_process() as ex:
        yield ex


def _jax_churn_drain(seed, backend):
    """The JAX scheduler's chained churn drain (run in jax_proc): its
    per-cycle views, chain uses and cluster sources."""
    jp, _ = packages()
    juses, jsrc = [], []
    mp = pytest.MonkeyPatch()
    try:
        _jax_sources(mp, jsrc)
        want, _ = drive(jp, churn_scenario(seed, juses, jsrc),
                        max_cycles=24, mode="gang", backend=backend, batch=8)
    finally:
        mp.undo()
    return want, juses, jsrc


@pytest.mark.parametrize("backend", ["pallas", "lax"])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_chained_churn_drain_equals_jax(seed, backend, jax_proc):
    _, tp = packages()
    want, juses, jsrc = jax_proc.submit(_jax_churn_drain, seed,
                                        backend).result()
    tsrc = []
    got, sched = drive(tp, churn_scenario(seed, [], tsrc), max_cycles=24,
                       mode="gang", backend=backend, batch=8)
    assert len(got) == len(want)
    for c, (w, g) in enumerate(zip(want, got)):
        for field in w:
            assert g[field] == w[field], (
                "cycle %d: %s differs\n jax  %s\n port %s"
                % (c, field, w[field], g[field]))
    assert tsrc == jsrc
    assert [s == "chain" for s in tsrc] == juses
    assert len(got) > 8        # the churn script ran to its end
    assert "chain" in tsrc and "node-set" in tsrc
    assert any(v["deleted"] for v in got)
    assert any(v["nominated"] for v in got)
    assert sched.preempt_wave_failures == 0


# ---------------------------------------------------------------------------
# a failed commit discards the chain


def _fail_reserve_registry(P, victim):
    fw = P.fw

    class FailReserve(fw.ReservePlugin, fw.UnreservePlugin):
        def name(self):
            return "FailReserve"

        def reserve(self, state, pod, node_name):
            if pod.metadata.name == victim:
                return fw.Status.error("injected reserve failure")
            return fw.Status.success()

        def unreserve(self, state, pod, node_name):
            pass

    registry = dict(P.intree.new_in_tree_registry())
    registry["FailReserve"] = lambda args, handle: FailReserve()
    C = P.conf
    prof = C.KubeSchedulerProfile(plugins=C.Plugins(
        reserve=C.PluginSet(enabled=[C.Plugin("FailReserve")]),
        unreserve=C.PluginSet(enabled=[C.Plugin("FailReserve")])))
    return registry, prof


def test_failed_commit_discards_the_chain(monkeypatch):
    """Cycle 2's auction places pod-9, whose Reserve fails: both packages
    drop the chain, so cycle 3 refreshes the resident cluster instead of
    chaining."""
    views, uses, sources = {}, {}, {}
    for P in framework_packages():
        store = P.store.ClusterStore()
        for n in P.hollow.make_nodes(4):
            store.add(n)
        registry, prof = _fail_reserve_registry(P, "pod-9")
        sched = new_scheduler(P, store, registry=registry, profiles=[prof],
                              batch_size=8, mode="gang")
        u, src = [], []
        if P.name == "jax":
            _jax_sources(monkeypatch, src)
        _spy(sched, u, src)
        out = []
        for i in range(24):
            store.add(P.hollow.make_pod(f"pod-{i}"))
        for _ in range(3):
            out.extend(sched.schedule_pending(timeout=0.0))
        sched.close()
        views[P.name] = outcome_view(store, out)
        uses[P.name] = (u if P.name == "jax"
                        else [s == "chain" for s in src])
        sources[P.name] = src
    assert views["port"] == views["jax"]
    assert uses["port"] == uses["jax"] == [False, True, False]
    assert sources["port"] == sources["jax"]
    assert sources["port"][0] == "initial"
    failed = [o for o in views["port"]["outcomes"] if not o[1]]
    assert [o[0] for o in failed] == ["pod-9"]
