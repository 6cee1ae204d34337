"""The port's depth-k pipelined executor (kubetpu_torch/pipeline.py) on
the CPU: twins of tests/test_pipeline.py, and depth parity against the
JAX package's pipelined drain.

The parity worlds are term-free and contended (more pods than fit), so
the gang route is the propose kernel's ("pallas", its plain version on
the CPU, Pallas in interpret mode on the JAX side) and later rounds
launch it; each is drained through both packages' schedulers at depths
1, 2 and 4 and must return the same outcomes from every
``schedule_pending`` call, the same cluster source per prepare (chain,
delta, clean or a resync reason) and the same ring high-water mark.  The
JAX drains run in a spawned child (torch_port_util.jax_process).

Not twinned here: the ring-slot tag on flight-recorder cycle records and
the bench's northstar gate, which wait for the flight recorder and the
benchmark (ROADMAP queue 1 items 11 and 5)."""
from types import SimpleNamespace

import pytest

from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.apis.load import ConfigError, load_config
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.pipeline import (GATHER_WINDOW_S, InflightRing,
                                    PipelinedExecutor, depth_from_env)
from kubetpu_torch.scheduler import Scheduler
from tests.torch_port_util import jax_process
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

CHILD_TIMEOUT = 600.0


def _world(n_nodes=16, n_pods=64, group_labels=4):
    store = ClusterStore()
    for n in hollow.make_nodes(n_nodes, zones=4):
        store.add(n)
    return store, hollow.make_pods(n_pods, group_labels=group_labels)


def _sched(store, depth, batch_size=8, **kw):
    cfg = KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=batch_size,
        mode="gang", chain_cycles=True, pipeline_cycles=True,
        pipeline_depth=depth, **kw)
    return Scheduler(store, config=cfg, device="cpu")


def _drain(sched, max_cycles=80):
    out = []
    for _ in range(max_cycles):
        got = sched.schedule_pending(timeout=0.0)
        if not got:
            break
        out.extend(got)
    out.extend(sched.flush_pipeline())
    return out


# ------------------------------------------------- parity with the JAX drain

# (n_nodes, node cpu milli, pods, pod cpu milli, batch): contended worlds,
# so auctions run past round 0 and some pods stay unschedulable
PARITY_WORLDS = {
    "contended": (6, 1000, 30, 300, 8),
}


def _parity_world(A, hollow_mod, store_mod, world):
    n_nodes, node_milli, n_pods, pod_milli, _ = PARITY_WORLDS[world]
    store = store_mod.ClusterStore()
    for i in range(n_nodes):
        store.add(hollow_mod.make_node(f"n{i}", zone=f"zone-{i % 3}",
                                       cpu_milli=node_milli))
    return store, hollow_mod.make_pods(n_pods, group_labels=3,
                                       cpu_milli=pod_milli)


def _pipelined_drive(P, world, depth, pipelined=True):
    """Drain a parity world at ``depth`` through package P's scheduler
    (pipelined=False: its synchronous drain): the outcomes of every
    schedule_pending call, the cluster source of every prepare, and the
    ring's high-water mark."""
    store, pods = _parity_world(P.api, P.hollow, P.store, world)
    cfg = P.conf.KubeSchedulerConfiguration(
        profiles=[P.conf.KubeSchedulerProfile()],
        batch_size=PARITY_WORLDS[world][4], mode="gang",
        kernel_backend="pallas", chain_cycles=True,
        pipeline_cycles=pipelined, pipeline_depth=depth)
    sched = P.sched.Scheduler(store, config=cfg, **P.kw)
    sources = []
    if P.name == "jax":
        orig = P.delta.DeltaTensorizer.refresh

        def refresh(self, *a, **kw):
            cluster, st = orig(self, *a, **kw)
            sources.append(st.reason if st.resync else
                           "delta" if st.delta_rows else "clean")
            return cluster, st
        P.delta.DeltaTensorizer.refresh = refresh
        prepare = sched._prepare_group

        def prepare_spy(*a, **kw):
            prep, out = prepare(*a, **kw)
            if prep is not None and prep.used_chain:
                sources.append("chain")
            return prep, out
        sched._prepare_group = prepare_spy
    try:
        for p in pods:
            store.add(p)
        calls = []
        for _ in range(60):
            got = sched.schedule_pending(timeout=0.0)
            if not got:
                break
            calls.append([(o.pod.metadata.name, o.node, o.err)
                          for o in got])
        calls.append([(o.pod.metadata.name, o.node, o.err)
                      for o in sched.flush_pipeline()])
        high = sched._pipeline.ring.high_water
    finally:
        sched.close()
        if P.name == "jax":
            P.delta.DeltaTensorizer.refresh = orig
    routes = rounds = None
    if P.name == "port":
        sources = list(sched.cluster_sources)
        routes = {b for b, _ in sched.gang_backends}
        rounds = list(sched.gang_rounds)
    bound = sorted((p.metadata.name, p.spec.node_name)
                   for p in store.list("Pod"))
    return dict(calls=calls, sources=sources, high=high, bound=bound,
                routes=routes, rounds=rounds)


def _package(name):
    if name == "jax":
        import kubetpu.api.types as A
        import kubetpu.apis.config as conf
        import kubetpu.client.store as store
        import kubetpu.harness.hollow as hol
        import kubetpu.scheduler as sched
        import kubetpu.state.delta as delta
        return SimpleNamespace(name=name, api=A, conf=conf, store=store,
                               hollow=hol, sched=sched, delta=delta,
                               kw=dict(async_binding=False))
    import kubetpu_torch.api.types as A
    import kubetpu_torch.apis.config as conf
    import kubetpu_torch.client.store as store
    import kubetpu_torch.harness.hollow as hol
    import kubetpu_torch.scheduler as sched
    import kubetpu_torch.state.delta as delta
    return SimpleNamespace(name=name, api=A, conf=conf, store=store,
                           hollow=hol, sched=sched, delta=delta,
                           kw=dict(device="cpu"))


def _jax_pipelined(world, depth):
    """The JAX package's pipelined drain (run in the spawned child)."""
    import jax
    try:
        return _pipelined_drive(_package("jax"), world, depth)
    finally:
        jax.clear_caches()


@pytest.fixture(scope="module")
def jax_proc():
    with jax_process() as ex:
        yield ex


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("world", sorted(PARITY_WORLDS))
def test_depth_parity_matches_jax(world, depth, jax_proc):
    """Port and JAX package, pipelined at the same depth on a pallas
    world: the same outcomes call by call, the same chain uses and
    refreshes, the same ring depth, the same bindings; and the port's
    depth-k drain binds what its synchronous drain binds."""
    fut = jax_proc.submit(_jax_pipelined, world, depth)
    got = _pipelined_drive(_package("port"), world, depth)
    want = fut.result(timeout=CHILD_TIMEOUT)
    # every auction on the kernel's route, and some past round 0
    assert got["routes"] == {"pallas"}
    assert max(got["rounds"]) > 1, "the world never reached the kernel"
    assert len(got["calls"]) == len(want["calls"])
    for c, (w, g) in enumerate(zip(want["calls"], got["calls"])):
        assert g == w, "call %d differs\n jax  %s\n port %s" % (c, w, g)
    assert got["sources"] == want["sources"]
    assert got["high"] == want["high"] == (
        min(depth - 1, 3) if depth > 1 else 0)
    assert got["bound"] == want["bound"]
    sync = _pipelined_drive(_package("port"), world, depth, pipelined=False)
    assert sync["bound"] == got["bound"]


# --------------------------------------------- tests/test_pipeline.py twins


def test_depth_parity_placements_bit_identical():
    placements = {}
    for depth in (1, 2, 4):
        store, pods = _world()
        sched = _sched(store, depth)
        for p in pods:
            store.add(p)
        out = _drain(sched)
        assert len(out) == 64, f"depth={depth}: {len(out)} outcomes"
        assert all(o.node for o in out), [
            (o.pod.metadata.name, o.err) for o in out if not o.node]
        assert len({o.pod.uid for o in out}) == 64, "a pod committed twice"
        hw = sched._pipeline.ring.high_water
        assert hw <= depth - 1, f"ring overfilled: {hw} at depth {depth}"
        placements[depth] = {o.pod.metadata.name: o.node for o in out}
        sched.close()
    assert placements[1] == placements[2] == placements[4]


def test_depth4_ring_actually_fills():
    store, pods = _world(n_pods=64)
    sched = _sched(store, 4)
    for p in pods:
        store.add(p)
    out = _drain(sched)
    assert len(out) == 64
    assert sched._pipeline.ring.high_water >= 2
    sched.close()


def test_depth1_is_synchronous_no_outcome_lag():
    store, pods = _world(n_pods=8)
    sched = _sched(store, 1, batch_size=8)
    for p in pods:
        store.add(p)
    first = sched.schedule_pending(timeout=0.0)
    assert len(first) == 8
    assert all(o.node for o in first)
    assert len(sched._pipeline.ring) == 0
    assert sched._pipeline.ring.high_water == 0
    assert sched.flush_pipeline() == []
    sched.close()


def test_pop_timeout_gates_gather_window_on_free_slots():
    ex = PipelinedExecutor(None, depth=4)   # pop_timeout needs no sched

    def slot():
        return SimpleNamespace(parked_t=0.0, host_exempt_s=0.0)

    assert ex.pop_timeout(0.2) == 0.2
    assert ex.pop_timeout(None) is None
    assert ex.pop_timeout(0.0) == 0.0
    ex.ring.append(slot(), None)
    assert ex.pop_timeout(0.2) == GATHER_WINDOW_S
    assert ex.pop_timeout(0.005) == 0.005
    assert ex.pop_timeout(None) == GATHER_WINDOW_S
    assert ex.pop_timeout(0.0) == 0.0
    ex.ring.append(slot(), None)
    assert ex.pop_timeout(0.2) == GATHER_WINDOW_S
    ex.ring.append(slot(), None)
    assert ex.pop_timeout(0.2) == 0.0
    assert ex.pop_timeout(None) == 0.0
    ex1 = PipelinedExecutor(None, depth=1)
    assert ex1.pop_timeout(0.2) == 0.2


def test_drain_passes_gated_timeouts_to_pop_batch(monkeypatch):
    store, pods = _world(n_pods=48)
    sched = _sched(store, 4, batch_size=4)
    seen = []
    orig = sched.queue.pop_batch

    def spy(max_batch, timeout=None):
        seen.append((len(sched._pipeline.ring), timeout))
        return orig(max_batch, timeout=timeout)

    monkeypatch.setattr(sched.queue, "pop_batch", spy)
    for p in pods:
        store.add(p)
    out = _drain(sched)
    assert len(out) == 48
    cap = sched._pipeline.ring.capacity
    for ring_len, timeout in seen:
        if ring_len == 0:
            assert timeout == 0.0
        elif ring_len >= cap:
            assert timeout == 0.0
        else:
            assert 0.0 <= timeout <= GATHER_WINDOW_S
    sched.close()


def test_ring_park_unpark_exempt_accounting():
    ring = InflightRing(capacity=3)
    a = SimpleNamespace(parked_t=0.0, host_exempt_s=0.0)
    b = SimpleNamespace(parked_t=0.0, host_exempt_s=0.0)
    ring.append(a, None)
    ring.append(b, None)
    ring.park(100.0)
    assert a.parked_t == 100.0 and b.parked_t == 100.0
    ring.exempt(5.0)
    assert a.host_exempt_s == 0.0 and b.host_exempt_s == 0.0
    ring.unpark(101.5)
    assert a.host_exempt_s == pytest.approx(1.5)
    assert b.host_exempt_s == pytest.approx(1.5)
    assert a.parked_t == 0.0
    ring.exempt(0.25)
    assert a.host_exempt_s == pytest.approx(1.75)
    assert b.host_exempt_s == pytest.approx(1.75)
    assert ring.pop_oldest()[0] is a
    assert [p for p, _ in ring.detach_all()] == [b]
    assert len(ring) == 0


def test_inflight_cycles_accrue_exemptions_at_depth():
    store, pods = _world(n_pods=48)
    sched = _sched(store, 4, batch_size=4)
    exempts = []
    orig = sched._commit_group

    def spy(prep, packed):
        exempts.append(prep.host_exempt_s)
        return orig(prep, packed)

    sched._commit_group = spy
    for p in pods:
        store.add(p)
    out = _drain(sched)
    assert len(out) == 48
    assert any(e > 0 for e in exempts), \
        "no in-flight cycle accrued commit/park exemptions at depth 4"
    sched.close()


def test_config_decode_and_validate_pipeline_depth():
    cfg = load_config({
        "apiVersion": "kubescheduler.config.k8s.io/v1beta1",
        "kind": "KubeSchedulerConfiguration",
        "mode": "gang", "pipelineCycles": True, "pipelineDepth": 4,
    })
    assert cfg.pipeline_cycles is True
    assert cfg.pipeline_depth == 4
    with pytest.raises(ConfigError, match="pipelineDepth"):
        load_config({
            "apiVersion": "kubescheduler.config.k8s.io/v1beta1",
            "kind": "KubeSchedulerConfiguration",
            "pipelineDepth": 0,
        })


def test_env_depth_override(monkeypatch):
    monkeypatch.setenv("KUBETPU_PIPELINE_DEPTH", "5")
    assert depth_from_env(2) == 5
    store, _ = _world(n_pods=0)
    sched = _sched(store, 2)
    assert sched._pipeline.depth == 5
    assert sched._pipeline.ring.capacity == 4
    sched.close()
    monkeypatch.setenv("KUBETPU_PIPELINE_DEPTH", "0")
    assert depth_from_env(2) == 1
    monkeypatch.setenv("KUBETPU_PIPELINE_DEPTH", "junk")
    assert depth_from_env(3) == 3
    monkeypatch.delenv("KUBETPU_PIPELINE_DEPTH")
    assert depth_from_env(2) == 2


def test_flush_pipeline_returns_every_parked_outcome():
    store, pods = _world(n_pods=32)
    sched = _sched(store, 4, batch_size=4)
    for p in pods:
        store.add(p)
    out = []
    for _ in range(4):
        out.extend(sched.schedule_pending(timeout=0.0))
    out.extend(sched.flush_pipeline())
    assert len(sched._pipeline.ring) == 0
    out.extend(_drain(sched))
    assert len(out) == 32
    assert all(o.node for o in out)
    assert len({o.pod.uid for o in out}) == 32
    sched.close()


def test_inflight_resident_is_never_scattered_in_place():
    """Donation withholding: a cycle's cluster does not change between
    its dispatch and its commit, though an external bind between calls
    makes the next prepare refresh the resident by delta while a cycle
    that reads it is in flight: that refresh clones instead of scattering
    in place (DeltaTensorizer.safe_to_donate gets the ring's clusters)."""
    store, pods = _world(n_pods=48)
    sched = _sched(store, 2, batch_size=4)

    def digest(cluster):
        return tuple(float(x.double().sum()) for x in (
            cluster.requested, cluster.nonzero_requested,
            cluster.pod_valid, cluster.pod_node))

    at_dispatch, withheld = {}, []
    dispatch, commit = sched._dispatch_group, sched._commit_group
    cluster_for = sched._cluster_for

    def dispatch_spy(prep, *a, **kw):
        at_dispatch[id(prep)] = digest(prep.cluster)
        return dispatch(prep, *a, **kw)

    def commit_spy(prep, packed):
        assert digest(prep.cluster) == at_dispatch[id(prep)]
        return commit(prep, packed)

    def cluster_for_spy(fwk, node_infos, pending, chain_seq0, uncommitted,
                        t):
        delta = sched._delta.get(fwk.profile_name)
        held = delta is not None and not delta.safe_to_donate(
            [p.cluster for p in uncommitted])
        out = cluster_for(fwk, node_infos, pending, chain_seq0, uncommitted,
                          t)
        if held:
            withheld.append(sched.cluster_sources[-1])
        return out

    sched._dispatch_group = dispatch_spy
    sched._commit_group = commit_spy
    sched._cluster_for = cluster_for_spy
    for p in pods:
        store.add(p)
    out = []
    for i in range(80):
        got = sched.schedule_pending(timeout=0.0)
        if not got:
            break
        out.extend(got)
        ext = hollow.make_pod(f"ext-{i}")
        ext.spec.node_name = f"node-{i % 16}"
        store.add(ext)
    out.extend(sched.flush_pipeline())
    assert len(out) == 48 and all(o.node for o in out)
    assert "delta" in withheld, withheld
    sched.close()
