"""The port's chaos registry (kubetpu_torch/utils/chaos.py) and its seams,
on the CPU: twins of tests/test_chaos.py, each fault armed through the
registry and recovered under the port's rules (no pod lost, none bound
twice, the device residents equal to the host mirror after a resync, the
kernel route never demoted), and the verify-resync recovery's metrics
against the JAX scheduler's after the same injected drain (in a spawned
child, torch_port_util.jax_process).

Not twinned: the deadline's first-compile exemption (:196; eager torch
compiles nothing per bucket, and tests/test_torch_serving.py holds the
port's kernel-build exemption), the mirror-aliasing regression (:322;
the port's residents never alias the mirror: tests/test_torch_delta.py)
and the AOT cases (:411, :441, :468; the port has no AOT artifacts).
The pallas demotion case (:219) becomes the port's rule: the route is
kept."""
import os
import time

import pytest

from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.rest import APIServer, RestClusterStore
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.utils import chaos
from kubetpu_torch.utils import pallas_backend as PB
from kubetpu_torch.utils.metrics import SchedulerMetrics
from tests.torch_port_util import jax_process, metrics_scrape
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

CHILD_TIMEOUT = 600.0


@pytest.fixture(autouse=True)
def _disarm():
    """Chaos and the pallas demotion latch are process-global: every test
    starts and ends disarmed."""
    chaos.disarm()
    PB.reset_demotion()
    yield
    chaos.disarm()
    PB.reset_demotion()


class CountingStore(ClusterStore):
    """A ClusterStore that counts bind calls per pod: the no-double-bind
    oracle."""

    def __init__(self):
        super().__init__()
        self.bind_calls = []

    def bind(self, pod, node_name):
        self.bind_calls.append(pod.metadata.name)
        super().bind(pod, node_name)


def _sched(store, metrics=None, **kw):
    kw.setdefault("profiles", [KubeSchedulerProfile()])
    kw.setdefault("mode", "gang")
    # a fast retry ladder, so recovered pods clear backoff in the test
    kw.setdefault("pod_initial_backoff_seconds", 0.01)
    kw.setdefault("pod_max_backoff_seconds", 0.05)
    return Scheduler(store, config=KubeSchedulerConfiguration(**kw),
                     device="cpu", metrics=metrics)


def _drain(sched, max_idle=4, max_calls=200):
    """Drain including requeued pods: flushes the backoff queue between
    pops (the queue's periodic flush threads are not running)."""
    outs = []
    idle = 0
    for _ in range(max_calls):
        if idle >= max_idle:
            break
        sched.queue.flush_backoff_completed()
        got = sched.schedule_pending(timeout=0.0)
        if got:
            outs.extend(got)
            idle = 0
        else:
            idle += 1
            time.sleep(0.03)
    return outs


def _placed(outs):
    return {o.pod.metadata.name: o.node for o in outs if o.node}


# ------------------------------------------------------------ spec parsing


def test_spec_parsing_and_determinism():
    reg = chaos.parse_spec("seed=7,dispatch:error:n=1,delta:corrupt:p=0.5")
    assert reg.decide("dispatch") == ("error", chaos.DEFAULT_STALL_S)
    assert reg.decide("dispatch") is None          # n=1 exhausted
    assert reg.counts() == {"dispatch": 1}
    # p=0.5 draws are deterministic for a given seed
    seq_a = [reg.decide("delta") is not None for _ in range(16)]
    reg2 = chaos.parse_spec("seed=7,delta:corrupt:p=0.5")
    seq_b = [reg2.decide("delta") is not None for _ in range(16)]
    assert seq_a == seq_b and any(seq_a) and not all(seq_a)


@pytest.mark.parametrize("spec", [
    "seed=7,dispatch:error:n=1,delta:corrupt:p=0.5",
    "seed=3,bind:error:p=0.3,rest:error:p=0.6,watch:error:n=2",
    "extender:error:p=0.45,journal:truncate:p=0.5,aot-load:corrupt"])
def test_decisions_match_jax(spec):
    """The same spec in both packages: the same fire decisions per
    point, draw by draw (each point's PRNG is seeded by (seed, point))."""
    from kubetpu.utils import chaos as jchaos
    jreg, treg = jchaos.parse_spec(spec), chaos.parse_spec(spec)
    points = sorted(chaos.POINTS)
    assert points == sorted(jchaos.POINTS)
    for k in range(64):
        point = points[k % len(points)]
        assert treg.decide(point) == jreg.decide(point), (k, point)
    assert treg.counts() == jreg.counts()


def test_spec_rejects_typos():
    with pytest.raises(ValueError):
        chaos.parse_spec("dispatchh:error")
    with pytest.raises(ValueError):
        chaos.parse_spec("dispatch:corrupt")       # mode not supported
    with pytest.raises(ValueError):
        chaos.parse_spec("dispatch:error:bogus=1")


def test_maybe_arm_from_env(monkeypatch):
    monkeypatch.setenv(chaos.ENV, "seed=3,bind:error:n=2")
    reg = chaos.maybe_arm_from_env()
    assert reg is not None and chaos.active() is reg
    assert reg.decide("bind") is not None
    chaos.disarm()


def test_scheduler_arms_from_env(monkeypatch):
    """KUBETPU_CHAOS arms the registry at Scheduler construction, and a
    typo fails the construction."""
    monkeypatch.setenv(chaos.ENV, "seed=4,dispatch:error:n=1")
    store = ClusterStore()
    sched = _sched(store)
    reg = chaos.active()
    assert reg is not None and reg.seed == 4
    sched.close()
    chaos.disarm()
    monkeypatch.setenv(chaos.ENV, "dispatch:eror")
    with pytest.raises(ValueError):
        _sched(ClusterStore())


# --------------------------------------------------- dispatch error / stall


def test_dispatch_error_requeues_and_places_exactly_once():
    """Point ``dispatch``, mode error: the cycle is recovered (pods
    requeued, residents dropped) and the retry places every pod exactly
    once; the fire count reaches faults_injected."""
    store = CountingStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    m = SchedulerMetrics()
    sched = _sched(store, metrics=m, batch_size=4)
    try:
        for p in hollow.make_pods(4, prefix="d-"):
            store.add(p)
        chaos.arm(chaos.ChaosRegistry(seed=1).arm_point(
            "dispatch", "error", n=1))
        outs = _drain(sched)
        placed = _placed(outs)
        assert len(placed) == 4                     # no pod lost
        assert sorted(store.bind_calls) == sorted(placed)   # exactly once
        recovered = [o for o in outs
                     if o.err and "dispatch recovered" in o.err]
        assert len(recovered) == 4
        assert [e["kind"] for e in sched.recovery_log] == ["dispatch-error"]
        assert "injected error fault at 'dispatch'" in \
            sched.recovery_log[0]["reason"]
        assert m.recoveries.value("dispatch-error") == 1
        assert m.faults_injected.value("dispatch") == 1
    finally:
        sched.close()


def test_dispatch_stall_blows_deadline_and_recovers():
    """Point ``dispatch``, mode stall, with the deadline armed: the late
    cycle is discarded before its commit (dispatch-deadline) and its pods
    place on the retry, never lost, never bound twice."""
    store = CountingStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    m = SchedulerMetrics()
    sched = _sched(store, metrics=m, batch_size=2)
    try:
        # a warm wave first, so the stall is the only slow thing left
        warm = hollow.make_pods(2, prefix="w-")
        for p in warm:
            store.add(p)
        assert len(_placed(_drain(sched))) == 2
        for p in warm:
            store.delete(p)
        sched._dispatch_deadline = 0.2
        chaos.arm(chaos.ChaosRegistry(seed=2).arm_point(
            "dispatch", "stall", n=1, delay=0.5))
        for p in hollow.make_pods(2, prefix="s-"):
            store.add(p)
        outs = _drain(sched)
        placed = _placed(outs)
        assert all(f"s-{i}" in placed for i in range(2))
        assert sorted(store.bind_calls) == sorted(set(store.bind_calls))
        kinds = [e["kind"] for e in sched.recovery_log]
        assert "dispatch-deadline" in kinds
        assert m.recoveries.value("dispatch-deadline") == 1
        assert m.faults_injected.value("dispatch") == 1
    finally:
        sched.close()


def test_dispatch_error_keeps_pallas_route():
    """tests/test_chaos.py:219 under the port's rule: a pallas-routed
    profile that takes a dispatch fault recovers the cycle and keeps the
    kernel route (no demotion); every later cycle runs it and places."""
    store = ClusterStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    sched = _sched(store, batch_size=4, kernel_backend="pallas")
    try:
        chaos.arm(chaos.ChaosRegistry(seed=3).arm_point(
            "dispatch", "error", n=1))
        for p in hollow.make_pods(4, prefix="p-", group_labels=0):
            store.add(p)
        outs = _drain(sched)
        assert len(_placed(outs)) == 4
        assert PB.demotion() is None
        assert sched.recovery_log[0]["kind"] == "dispatch-error"
        assert "demoted" not in sched.recovery_log[0]
        assert {b for b, _ in sched.gang_backends} == {"pallas"}
    finally:
        sched.close()


def test_pipelined_dispatch_error_loses_no_pods():
    """The pipelined drain's guarded dispatch: an injected fault still
    requeues and places everything, with no double binds."""
    store = CountingStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    sched = _sched(store, batch_size=4, chain_cycles=True,
                   pipeline_cycles=True)
    try:
        chaos.arm(chaos.ChaosRegistry(seed=4).arm_point(
            "dispatch", "error", n=1))
        for p in hollow.make_pods(8, prefix="pl-"):
            store.add(p)
        outs = _drain(sched)
        outs.extend(sched.flush_pipeline())
        placed = _placed(outs)
        assert len(placed) == 8
        assert sorted(store.bind_calls) == sorted(placed)
        assert any(e["kind"] == "dispatch-error"
                   for e in sched.recovery_log)
    finally:
        sched.close()


# ------------------------------------------------- delta + anti-entropy


def _delta_world(monkeypatch, metrics=None):
    """Gang scheduler with the chain OFF (every cycle takes the
    DeltaTensorizer path) and the verifier on a 1-cycle cadence."""
    monkeypatch.setenv("KUBETPU_VERIFY_INTERVAL", "1")
    store = ClusterStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    sched = _sched(store, metrics=metrics, batch_size=2,
                   chain_cycles=False)
    return store, sched


@pytest.mark.parametrize("mode", ["drop", "corrupt"])
def test_delta_fault_caught_by_verifier(monkeypatch, mode):
    """Point ``delta`` (drop a scatter / corrupt a resident): the
    verifier detects the divergence in the same refresh and resyncs;
    the residents match the mirror afterwards, every pod places, and the
    resync is a recovery (recovery_log, recoveries{verify-resync})."""
    m = SchedulerMetrics()
    store, sched = _delta_world(monkeypatch, metrics=m)
    try:
        for p in hollow.make_pods(2, prefix="a-"):
            store.add(p)
        assert len(_placed(_drain(sched))) == 2
        name = next(iter(sched.profiles))
        delta = sched._delta[name]
        assert delta.divergence_count == 0
        chaos.arm(chaos.ChaosRegistry(seed=5).arm_point("delta", mode,
                                                        n=1))
        for p in hollow.make_pods(2, prefix="b-"):
            store.add(p)
        outs = _drain(sched)
        assert len(_placed(outs)) == 2
        delta = sched._delta[name]
        assert delta.divergence_count == 1
        assert delta.verify()            # consistent after recovery
        assert m.recoveries.value("verify-resync") == 1
        assert [e["kind"] for e in sched.recovery_log] == ["verify-resync"]
        assert "verify-divergence" in sched.cluster_sources
        assert m.faults_injected.value("delta") == 1
    finally:
        sched.close()


def test_corrupt_never_writes_a_tensor_in_flight(monkeypatch):
    """The corrupt mode writes into a fresh tensor: the cluster an
    earlier refresh returned keeps its values."""
    from kubetpu_torch.state.cache import SchedulerCache, Snapshot
    from kubetpu_torch.state.delta import DeltaTensorizer
    cache = SchedulerCache()
    nodes = hollow.make_nodes(3)
    for n in nodes:
        cache.add_node(n)

    def infos():
        snap = Snapshot()
        cache.update_snapshot(snap)
        return snap.node_info_list

    dt = DeltaTensorizer(verify_interval=0, device="cpu")
    first, _ = dt.refresh(infos())
    before = first.requested.clone()
    p = hollow.make_pod("x", cpu_milli=500)
    p.spec.node_name = nodes[1].name
    cache.add_pod(p)
    chaos.arm(chaos.ChaosRegistry(seed=6).arm_point("delta", "corrupt",
                                                    n=1))
    second, st = dt.refresh(infos(), donate=False)
    assert not st.resync and st.delta_rows > 0
    assert first.requested.equal(before)
    assert second.requested[0, 0] == before[0, 0] + 1.0
    assert not dt.verify()


def test_verifier_consistent_run_never_resyncs_for_divergence(monkeypatch):
    """With the verifier on and no fault injected, checks run on cadence
    and never report a divergence."""
    store, sched = _delta_world(monkeypatch)
    try:
        for wave in range(3):
            for p in hollow.make_pods(2, prefix=f"w{wave}-"):
                store.add(p)
            _drain(sched, max_idle=2)
        delta = next(iter(sched._delta.values()))
        assert delta.verify_count >= 2
        assert delta.divergence_count == 0
        assert not sched.recovery_log
    finally:
        sched.close()


def verify_drive(name, mode):
    """_delta_world's drain through package ``name``'s scheduler (the
    port's on the CPU) with the ``delta`` point armed (``mode``, once)
    between the two waves: the metrics scrape, the recovery kinds and the
    placements."""
    old = os.environ.get("KUBETPU_VERIFY_INTERVAL")
    os.environ["KUBETPU_VERIFY_INTERVAL"] = "1"
    if name == "jax":
        from kubetpu.apis import config as C
        from kubetpu.client.store import ClusterStore as Store
        from kubetpu.harness import hollow as H
        from kubetpu.scheduler import Scheduler as S
        from kubetpu.utils import chaos as X
        from kubetpu.utils.metrics import SchedulerMetrics as M
    else:
        from kubetpu_torch.apis import config as C
        from kubetpu_torch.client.store import ClusterStore as Store
        from kubetpu_torch.harness import hollow as H
        from kubetpu_torch.scheduler import Scheduler as S
        from kubetpu_torch.utils import chaos as X
        from kubetpu_torch.utils.metrics import SchedulerMetrics as M
    m = M()
    store = Store()
    for n in H.make_nodes(3):
        store.add(n)
    cfg = C.KubeSchedulerConfiguration(
        profiles=[C.KubeSchedulerProfile()], mode="gang", batch_size=2,
        chain_cycles=False, pod_initial_backoff_seconds=0.01,
        pod_max_backoff_seconds=0.05)
    if name == "jax":
        cfg.prewarm = False
        sched = S(store, config=cfg, async_binding=False, metrics=m)
    else:
        sched = S(store, config=cfg, device="cpu", metrics=m)
    try:
        outs = []
        for wave in ("a-", "b-"):
            if wave == "b-":
                X.arm(X.ChaosRegistry(seed=5).arm_point("delta", mode, n=1))
            for p in H.make_pods(2, prefix=wave):
                store.add(p)
            outs += _drain(sched)
        return dict(scrape=metrics_scrape(m),
                    kinds=[e["kind"] for e in sched.recovery_log],
                    placed=_placed(outs))
    finally:
        sched.close()
        X.disarm()
        if old is None:
            os.environ.pop("KUBETPU_VERIFY_INTERVAL", None)
        else:
            os.environ["KUBETPU_VERIFY_INTERVAL"] = old


def _jax_verify_drive(mode):
    import jax
    try:
        return verify_drive("jax", mode)
    finally:
        jax.clear_caches()


@pytest.fixture(scope="module")
def jax_proc():
    with jax_process() as ex:
        yield ex


@pytest.mark.parametrize("mode", ["drop", "corrupt"])
def test_verify_resync_metrics_match_jax(mode, jax_proc):
    """The injected divergence through both schedulers: the same scrape
    (recoveries{verify-resync}, faults_injected{delta}, the per-point
    duration counts, the attempts), the same recovery kinds and the same
    placements."""
    fut = jax_proc.submit(_jax_verify_drive, mode)
    got = verify_drive("port", mode)
    want = fut.result(timeout=CHILD_TIMEOUT)
    assert got["kinds"] == want["kinds"] == ["verify-resync"]
    assert got["scrape"]['scheduler_recoveries_total{kind="verify-resync"}'] \
        == 1
    assert got["scrape"] == want["scrape"]
    assert got["placed"] == want["placed"]


# ------------------------------------------------------------ bind retry


def test_flaky_bind_retries_and_places_exactly_once():
    """Point ``bind``: a transient bind failure retries on the backoff
    ladder and the placement lands exactly once (the fault fires before
    the store's bind), with one BindRetried Event."""
    store = CountingStore()
    store.add(hollow.make_node("n1"))
    m = SchedulerMetrics()
    sched = _sched(store, metrics=m, batch_size=1, bind_retries=2)
    try:
        chaos.arm(chaos.ChaosRegistry(seed=7).arm_point("bind", "error",
                                                        n=1))
        store.add(hollow.make_pod("flaky"))
        outs = _drain(sched)
        assert _placed(outs) == {"flaky": "n1"}
        assert store.bind_calls == ["flaky"]        # exactly once
        assert store.get_pod("default", "flaky").spec.node_name == "n1"
        assert m.recoveries.value("bind-retry") == 1
        assert [(e.reason, e.message) for e in store.list("Event")] == [
            ("BindRetried", "bind succeeded after 1 retry"),
            ("Scheduled", "Successfully assigned default/flaky to n1")]
        assert m.faults_injected.value("bind") == 1
    finally:
        sched.close()


# -------------------------------------------------------- watch / rest


def test_dead_server_reconnect_backs_off():
    """A dead API server costs capped-exponential sleeps, not a spinning
    core."""
    store = RestClusterStore("http://127.0.0.1:1")   # nothing listens
    try:
        time.sleep(1.0)
        assert 1 <= store._watch_retries <= 12
        assert store._watch_backoff_s > 0.0
    finally:
        store.close()


def test_watch_disconnects_recover_and_mirror_converges():
    """Point ``watch``: injected disconnects ride the same backoff ladder
    and the mirror still converges on the server's state."""
    from kubetpu_torch.api import types as api
    server_store = ClusterStore()
    srv = APIServer(server_store)
    port = srv.start()
    reg = chaos.arm(chaos.ChaosRegistry(seed=9).arm_point(
        "watch", "error", n=3))
    client = RestClusterStore(f"http://127.0.0.1:{port}")
    try:
        assert client.wait_for_cache_sync(5.0)
        server_store.add(hollow.make_node("w1"))
        deadline = time.time() + 10.0
        while time.time() < deadline:
            if client.get("Node", "w1") is not None:
                break
            time.sleep(0.05)
        assert client.get("Node", "w1") is not None
        assert reg.counts().get("watch", 0) >= 1
        assert isinstance(client.get("Node", "w1"), api.Node)
    finally:
        client.close()
        srv.stop()


def test_rest_faults_bind_every_pod_once():
    """Point ``rest``: transient API-server errors on the scheduler's
    requests (binds among them) are recovered by the bind retry ladder
    and the reflector; every pod binds on the server exactly once."""
    server_store = CountingStore()
    for n in hollow.make_nodes(2):
        server_store.add(n)
    srv = APIServer(server_store)
    port = srv.start()
    client = RestClusterStore(f"http://127.0.0.1:{port}")
    sched = None
    try:
        assert client.wait_for_cache_sync(5.0)
        sched = _sched(client, batch_size=4, bind_retries=3)
        for p in hollow.make_pods(4, prefix="r-"):
            server_store.add(p)
        deadline = time.time() + 10.0
        while time.time() < deadline and len(client.list("Pod")) < 4:
            time.sleep(0.02)
        reg = chaos.arm(chaos.ChaosRegistry(seed=12).arm_point(
            "rest", "error", n=2))
        outs = []
        while time.time() < deadline and len(_placed(outs)) < 4:
            sched.queue.flush_backoff_completed()
            outs += sched.schedule_pending(timeout=0.1)
        assert reg.counts() == {"rest": 2}
        bound = {p.metadata.name: p.spec.node_name
                 for p in server_store.list("Pod") if p.spec.node_name}
        assert bound == _placed(outs) and len(bound) == 4
        assert sorted(server_store.bind_calls) == sorted(bound)
    finally:
        if sched is not None:
            sched.close()
        client.close()
        srv.stop()


# ------------------------------------------------------------- extender


def test_extender_transport_fault_fails_pod_and_requeues():
    """Point ``extender``: a transient webhook error; an ignorable
    extender rides through it and the pod places, a required one fails
    the pod (requeued) and the retry places it."""
    store = ClusterStore()
    store.add(hollow.make_node("n1"))
    sched = _sched(store, batch_size=1, mode="sequential",
                   extenders=[{"urlPrefix": "http://127.0.0.1:1",
                               "filterVerb": "filter",
                               "ignorable": True}])
    try:
        chaos.arm(chaos.ChaosRegistry(seed=10).arm_point(
            "extender", "error", n=1))
        store.add(hollow.make_pod("ext"))
        outs = _drain(sched)
        assert _placed(outs) == {"ext": "n1"}
        assert chaos.active().counts() == {"extender": 1}
    finally:
        sched.close()
    from kubetpu_torch.harness import extender_worlds as EW
    store = ClusterStore()
    for n in hollow.make_nodes(2):
        store.add(n)
    with EW.FakeExtender(store, verbs=("filter",)) as ext:
        sched = _sched(store, batch_size=1, mode="sequential",
                       extenders=[ext.config()])
        try:
            chaos.arm(chaos.ChaosRegistry(seed=10).arm_point(
                "extender", "error", n=1))
            store.add(hollow.make_pod("req"))
            outs = _drain(sched)
            assert len(outs) == 1 and not outs[0].node
            assert outs[0].err.startswith("extender filter failed: ")
            # the failure left the pod unschedulable: a cluster event
            # moves it back, and the retry places it (node-0's index is a
            # multiple of 4, so the filter leaves node-1)
            assert len(sched.queue) == 1
            sched.queue.move_all_to_active_or_backoff_queue("NodeAdd")
            outs = _drain(sched)
            assert _placed(outs) == {"req": "node-1"}
            assert dict(ext.calls) == {"filter": 1}
        finally:
            sched.close()


# ------------------------------------------------------ serving survival


def test_serving_thread_survives_chaos_storm():
    """With faults firing across points, the serving THREAD stays alive
    and keeps placing pods."""
    store = CountingStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    sched = _sched(store, batch_size=4, prewarm=False)
    try:
        chaos.arm(chaos.ChaosRegistry(seed=11)
                  .arm_point("dispatch", "error", n=2)
                  .arm_point("bind", "error", n=1))
        t = sched.run()
        for p in hollow.make_pods(6, prefix="storm-"):
            store.add(p)
        deadline = time.time() + 30.0
        while time.time() < deadline:
            bound = sum(1 for p in store.list("Pod") if p.spec.node_name)
            if bound == 6:
                break
            time.sleep(0.1)
        assert t.is_alive()
        bound = [p.metadata.name for p in store.list("Pod")
                 if p.spec.node_name]
        assert len(bound) == 6
        assert sorted(store.bind_calls) == sorted(bound)  # no doubles
    finally:
        sched.close()


# -------------------------------------------------------- disarmed no-op


def test_disarmed_hot_path_is_noop(monkeypatch):
    """Poison test: chaos disarmed and the verifier off, a scheduling
    cycle never makes a registry decision and never computes a
    fingerprint."""
    chaos.disarm()

    def boom(*a, **kw):
        raise AssertionError("disarmed hot path touched the chaos/verify "
                             "machinery")

    from kubetpu_torch.state.delta import DeltaTensorizer
    monkeypatch.setattr(chaos.ChaosRegistry, "decide", boom)
    monkeypatch.setattr(DeltaTensorizer, "fingerprint_device", boom)
    monkeypatch.setattr(DeltaTensorizer, "fingerprint_host", boom)
    monkeypatch.setattr(DeltaTensorizer, "verify", boom)
    monkeypatch.delenv("KUBETPU_VERIFY_INTERVAL", raising=False)
    monkeypatch.delenv(chaos.ENV, raising=False)

    store = ClusterStore()
    for n in hollow.make_nodes(2):
        store.add(n)
    sched = _sched(store, batch_size=2, chain_cycles=False)
    try:
        for p in hollow.make_pods(4, prefix="quiet-"):
            store.add(p)
        outs = _drain(sched, max_idle=2)
        assert len(_placed(outs)) == 4
        assert not sched.recovery_log
    finally:
        sched.close()
