"""The port's serving runtime on the CPU: cycle recovery, the dispatch
deadline, the kernel route kept through a recovery, the bind retry
ladder, and ``Scheduler.run`` served through ``SchedulerServer``.

Twins of tests/test_chaos.py's dispatch error, stall past the deadline,
first-compile exemption, pallas demotion, pipelined dispatch error,
flaky bind, lost bind response and exhausted retries.  The JAX package
injects those faults through its chaos registry (kubetpu/utils/chaos.py),
as tests/test_torch_chaos.py does through the port's; here each fault is
injected by monkeypatching the port's own seam: the scheduler module's
``run_auction`` (the auction the dispatch runs), ``Scheduler.
_dispatch_group`` and the store's ``bind``.  Every recovery must lose no
pod and bind none twice.  Where the JAX package demotes pallas to lax on
a recovery, the port keeps the kernel route, and an error of the kernel
path (a failed build or launch, a CUDA error, a broken invariant) is not
recovered at all: it raises.  Every wait is bounded."""
import importlib.util
import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

import kubetpu_torch.models.gang as tgang
import kubetpu_torch.scheduler as tsched
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.ops._build import KernelError, note_compile_event
from kubetpu_torch.scheduler import Scheduler, capacity_violations
from kubetpu_torch.server import SchedulerServer
from kubetpu_torch.utils import pallas_backend as PB
from kubetpu_torch.utils.metrics import SchedulerMetrics
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


@pytest.fixture(autouse=True)
def _reset_demotion():
    """The pallas demotion latch is process-wide: every test starts and
    ends without it."""
    PB.reset_demotion()
    yield
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


def _fail_auction(monkeypatch, times=1, exc=RuntimeError("device lost")):
    """The auction raises on its next ``times`` calls."""
    orig = tsched.run_auction
    left = [times]

    def faulty(*a, **kw):
        if left[0] > 0:
            left[0] -= 1
            raise exc
        return orig(*a, **kw)
    monkeypatch.setattr(tsched, "run_auction", faulty)


# --------------------------------------------------- dispatch error / stall


def test_dispatch_error_requeues_and_places_exactly_once(monkeypatch):
    """The auction raises once: the cycle is recovered (pods requeued,
    residents dropped) and the retry places every pod exactly once."""
    store = CountingStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    m = SchedulerMetrics()
    sched = _sched(store, metrics=m, batch_size=4)
    try:
        for p in hollow.make_pods(4, prefix="d-"):
            store.add(p)
        _fail_auction(monkeypatch)
        outs = _drain(sched)
        placed = _placed(outs)
        assert len(placed) == 4
        assert sorted(store.bind_calls) == sorted(placed)
        recovered = [o for o in outs
                     if o.err and "dispatch recovered" in o.err]
        assert len(recovered) == 4
        assert sched.recovery_log[0]["kind"] == "dispatch-error"
        assert m.recoveries.value("dispatch-error") == 1
        assert "dispatch-error" in m.expose_text()
    finally:
        sched.close()


def _slow_auction(monkeypatch, delay, compile_event=False, times=1):
    orig = tsched.run_auction
    left = [times]

    def slow(*a, **kw):
        if left[0] > 0:
            left[0] -= 1
            if compile_event:
                note_compile_event()   # as a kernel build or graph capture
            time.sleep(delay)
        return orig(*a, **kw)
    monkeypatch.setattr(tsched, "run_auction", slow)


def test_dispatch_stall_blows_deadline_and_recovers(monkeypatch):
    """A stalled dispatch past an armed deadline is discarded before its
    commit (kind dispatch-deadline); its pods place on the retry, never
    lost, never bound twice."""
    store = CountingStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    m = SchedulerMetrics()
    sched = _sched(store, metrics=m, batch_size=2)
    try:
        for p in hollow.make_pods(2, prefix="w-"):
            store.add(p)
        t0 = time.perf_counter()
        assert len(_placed(_drain(sched, max_idle=1))) == 2
        # armed well above a healthy cycle on this machine, however busy
        deadline = max(1.0, 10 * (time.perf_counter() - t0))
        sched._dispatch_deadline = deadline
        assert not sched.recovery_log
        _slow_auction(monkeypatch, 2 * deadline)
        for p in hollow.make_pods(2, prefix="s-"):
            store.add(p)
        outs = _drain(sched)
        placed = _placed(outs)
        assert all(f"s-{i}" in placed for i in range(2))
        assert sorted(store.bind_calls) == sorted(set(store.bind_calls))
        assert [e["kind"] for e in sched.recovery_log] == [
            "dispatch-deadline"]
        assert m.recoveries.value("dispatch-deadline") == 1
    finally:
        sched.close()


def test_deadline_exempts_first_compile(monkeypatch):
    """A cycle during which a kernel library was built or loaded (or a
    CUDA graph captured) is exempt from the deadline: first-use work must
    never demote a healthy backend."""
    store = CountingStore()
    for n in hollow.make_nodes(5):
        store.add(n)
    sched = _sched(store, batch_size=4, prewarm=False,
                   dispatch_deadline_seconds=0.3)
    try:
        _slow_auction(monkeypatch, 0.6, compile_event=True)
        for p in hollow.make_pods(4, prefix="c-"):
            store.add(p)
        outs = _drain(sched)
        assert len(_placed(outs)) == 4
        assert not any(e["kind"] == "dispatch-deadline"
                       for e in sched.recovery_log)
    finally:
        sched.close()


def test_env_deadline_overrides_config(monkeypatch):
    monkeypatch.setenv("KUBETPU_DISPATCH_DEADLINE", "7.5")
    sched = _sched(ClusterStore(), dispatch_deadline_seconds=1.0)
    assert sched._dispatch_deadline == 7.5
    sched.close()


def test_dispatch_error_keeps_pallas_route(monkeypatch):
    """A pallas-routed cycle that takes a dispatch fault is recovered
    without a demotion: the retry runs the kernel route again and
    places every pod.  (The JAX package demotes to lax here; the port
    never hands a cycle to the plain round because of a fault.)"""
    store = ClusterStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    sched = _sched(store, batch_size=4, kernel_backend="pallas")
    try:
        _fail_auction(monkeypatch)
        for p in hollow.make_pods(4, prefix="p-", group_labels=0):
            store.add(p)
        outs = _drain(sched)
        assert len(_placed(outs)) == 4
        assert [e["kind"] for e in sched.recovery_log] == ["dispatch-error"]
        assert "demoted" not in sched.recovery_log[0]
        assert PB.demotion() is None
        assert sched.gang_backends == [("pallas", None)] * len(
            sched.gang_backends)
        assert len(sched.gang_backends) >= 2
    finally:
        sched.close()


def test_operator_demotion_routes_lax_until_reset():
    """``demote`` is the operator's switch: every later cycle of the
    process runs lax with the reason recorded, until ``reset_demotion``."""
    store = ClusterStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    sched = _sched(store, batch_size=4, kernel_backend="pallas")
    try:
        PB.demote("operator: kernel under investigation")
        for p in hollow.make_pods(4, prefix="o-", group_labels=0):
            store.add(p)
        assert len(_placed(_drain(sched))) == 4
        assert sched.gang_backends[-1] == (
            "lax", "demoted:operator: kernel under investigation")
        PB.reset_demotion()
        for p in hollow.make_pods(4, prefix="r-", group_labels=0):
            store.add(p)
        assert len(_placed(_drain(sched))) == 4
        assert sched.gang_backends[-1] == ("pallas", None)
        assert not sched.recovery_log
    finally:
        sched.close()


KERNEL_FAULTS = {
    "launch": KernelError("propose kernel launch failed: invalid argument"),
    "build": KernelError("nvcc failed for propose"),
    # chip_smoke's GangRounds: the auction synced on the host beyond its
    # one flags read per round (the sync debug mode's error), or the
    # reads, syncs and rounds disagree
    "sync-debug": RuntimeError("called a synchronizing CUDA operation"),
    "rounds": AssertionError("gang auction: 3 flag reads, 2 syncs, 2 rounds"),
    "sticky": RuntimeError("CUDA error: an illegal memory access was "
                           "encountered"),
}


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("fault", sorted(KERNEL_FAULTS))
def test_kernel_fault_raises_and_loses_no_pod(monkeypatch, fault,
                                              pipelined):
    """An error of the kernel path in the second auction is never
    recovered: schedule_pending raises it, nothing is recorded as a
    recovery and no demotion latches.  No pod is lost: the first cycle's
    pods bind (pipelined at depth 2, that cycle is read back but not yet
    committed when the second dispatch raises, and commits first), the
    faulted cycle's go back to the queue, and a drain afterwards binds
    every pod exactly once on the kernel route."""
    store = CountingStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    kw = dict(chain_cycles=True, pipeline_cycles=True,
              pipeline_depth=2) if pipelined else {}
    sched = _sched(store, batch_size=4, kernel_backend="pallas", **kw)
    try:
        orig = tgang._gang_program
        calls = [0]

        def faulty(*a, **k):
            calls[0] += 1
            if calls[0] == 2:
                raise KERNEL_FAULTS[fault]
            return orig(*a, **k)
        monkeypatch.setattr(tgang, "_gang_program", faulty)
        for p in hollow.make_pods(12, prefix="k-", group_labels=0):
            store.add(p)
        with pytest.raises(type(KERNEL_FAULTS[fault])) as info:
            for _ in range(8):
                sched.schedule_pending(timeout=0.0)
        assert info.value is KERNEL_FAULTS[fault]
        assert calls[0] == 2
        assert not sched.recovery_log
        assert PB.demotion() is None
        assert len(store.bind_calls) == 4
        _drain(sched)
        sched.flush_pipeline()
        bound = sorted(p.metadata.name for p in store.list("Pod")
                       if p.spec.node_name)
        assert bound == sorted(f"k-{i}" for i in range(12))
        assert sorted(store.bind_calls) == bound
        assert {b for b, _ in sched.gang_backends} == {"pallas"}
        assert capacity_violations(store) == []
    finally:
        sched.close()


def test_out_of_memory_is_recovered(monkeypatch):
    """A CUDA out-of-memory at the dispatch is not a kernel fault: the
    cycle is recovered and its pods place on the retry."""
    store = CountingStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    sched = _sched(store, batch_size=4, kernel_backend="pallas")
    try:
        _fail_auction(monkeypatch, exc=torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB"))
        for p in hollow.make_pods(4, prefix="m-", group_labels=0):
            store.add(p)
        placed = _placed(_drain(sched))
        assert len(placed) == 4
        assert sorted(store.bind_calls) == sorted(placed)
        assert [e["kind"] for e in sched.recovery_log] == ["dispatch-error"]
        assert PB.demotion() is None
    finally:
        sched.close()


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", ["sync-debug", "recovered"])
def test_chip_smoke_drain_fails_on_fault(monkeypatch, fault):
    """chip_smoke.py's drains fail the run on a fault of the auction: a
    sync-debug error raised inside it (as GangRounds raises on the card)
    propagates out of the drain, and a fault the scheduler did recover
    still fails the drain, by its recovery log."""
    cs = _chip_smoke()
    store = ClusterStore()
    for n in hollow.make_nodes(4):
        store.add(n)
    pods = hollow.make_pods(8, prefix="cs-", group_labels=0)
    if fault == "sync-debug":
        orig = tgang._gang_program
        armed = [True]

        def faulty(*a, **k):
            if armed[0]:
                armed[0] = False
                raise KERNEL_FAULTS["sync-debug"]
            return orig(*a, **k)
        monkeypatch.setattr(tgang, "_gang_program", faulty)
        with pytest.raises(RuntimeError, match="synchronizing CUDA"):
            cs.drain(store, pods, "pallas", 4, "cpu")
    else:
        _fail_auction(monkeypatch)
        with pytest.raises(AssertionError, match="recover"):
            cs.drain(store, pods, "pallas", 4, "cpu")
    assert PB.demotion() is None


@pytest.mark.parametrize("seam", ["auction", "dispatch"])
def test_pipelined_dispatch_error_loses_no_pods(monkeypatch, seam):
    """The pipelined drain: a fault in the auction or in the dispatch
    call itself requeues and places everything, with no double binds,
    and the younger in-flight cycles are re-run."""
    store = CountingStore()
    for n in hollow.make_nodes(3):
        store.add(n)
    sched = _sched(store, batch_size=4, chain_cycles=True,
                   pipeline_cycles=True, pipeline_depth=3)
    try:
        if seam == "auction":
            _fail_auction(monkeypatch)
        else:
            orig = sched._dispatch_group
            left = [1]

            def faulty(prep, *a, **kw):
                if left[0] and "extra_uncommitted" in kw:
                    left[0] -= 1
                    raise RuntimeError("dispatch refused")
                return orig(prep, *a, **kw)
            sched._dispatch_group = faulty
        for p in hollow.make_pods(16, prefix="pl-"):
            store.add(p)
        outs = _drain(sched)
        outs.extend(sched.flush_pipeline())
        placed = _placed(outs)
        assert len(placed) == 16
        assert sorted(store.bind_calls) == sorted(placed)
        assert any(e["kind"] == "dispatch-error"
                   for e in sched.recovery_log)
        assert capacity_violations(store) == []
    finally:
        sched.close()


# ------------------------------------------------------- bind retry ladder


class FlakyStore(CountingStore):
    """Raises a transport error before the bind reaches the store, the
    first ``fail`` times (every time with fail=None)."""

    def __init__(self, fail=1):
        super().__init__()
        self.fail = fail

    def bind(self, pod, node_name):
        if self.fail is None or self.fail > 0:
            if self.fail is not None:
                self.fail -= 1
            raise OSError("connection reset by peer")
        super().bind(pod, node_name)


def test_flaky_bind_retries_and_places_exactly_once():
    store = FlakyStore(fail=1)
    store.add(hollow.make_node("n1"))
    m = SchedulerMetrics()
    sched = _sched(store, metrics=m, batch_size=1, bind_retries=2)
    try:
        store.add(hollow.make_pod("flaky"))
        outs = _drain(sched)
        assert _placed(outs) == {"flaky": "n1"}
        assert store.bind_calls == ["flaky"]
        assert store.get_pod("default", "flaky").spec.node_name == "n1"
        assert m.recoveries.value("bind-retry") == 1
    finally:
        sched.close()


def test_lost_bind_response_recovers_without_double_bind():
    """Bind is not idempotent: a bind that landed with its response lost
    is detected through the store, not re-POSTed into a conflict."""
    class LostResponseStore(CountingStore):
        def __init__(self):
            super().__init__()
            self.lose = 1

        def bind(self, pod, node_name):
            super().bind(pod, node_name)       # the store applied it...
            if self.lose:
                self.lose -= 1                 # ...but the response died
                raise OSError("connection reset by peer")

    store = LostResponseStore()
    store.add(hollow.make_node("n1"))
    m = SchedulerMetrics()
    sched = _sched(store, metrics=m, batch_size=1, bind_retries=2)
    try:
        store.add(hollow.make_pod("lost"))
        outs = _drain(sched)
        assert _placed(outs) == {"lost": "n1"}
        assert store.bind_calls == ["lost"]
        assert store.get_pod("default", "lost").spec.node_name == "n1"
        assert m.recoveries.value("bind-retry") == 1
    finally:
        sched.close()


def test_bind_retries_exhausted_fails_pod_cleanly():
    store = FlakyStore(fail=None)
    store.add(hollow.make_node("n1"))
    sched = _sched(store, batch_size=1, bind_retries=1)
    try:
        store.add(hollow.make_pod("doomed"))
        out = sched.schedule_pending(timeout=0.0)
        assert len(out) == 1 and out[0].err
        assert store.bind_calls == []
        assert store.get_pod("default", "doomed").spec.node_name == ""
        assert len(sched.queue) == 1
    finally:
        sched.close()


# ------------------------------------------------------------------ served


def _get(port, path, timeout=10.0):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("pipelined", [False, True])
def test_run_serves_and_closes(pipelined):
    """Scheduler.run on its serving thread with SchedulerServer: every
    schedulable pod binds, one oversized pod stays pending, and the
    endpoints answer (/healthz, /metrics with the cycle counters,
    /debug/explain for a bound and an unschedulable pod, the recorders
    the port lacks as the JAX server answers with them disarmed); close
    joins within its bound."""
    store = ClusterStore()
    for n in hollow.make_nodes(12, zones=3):
        store.add(n)
    m = SchedulerMetrics()
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], mode="gang", batch_size=8,
        kernel_backend="pallas", pipeline_cycles=pipelined,
        pipeline_depth=2), device="cpu", metrics=m, async_binding=True)
    server = SchedulerServer(sched, port=0)
    port = server.start()
    try:
        pods = hollow.make_pods(40, prefix="s-", group_labels=4)
        pods.append(hollow.make_pod("huge", cpu_milli=10 ** 6))
        for p in pods:
            store.add(p)
        sched.run()
        deadline = time.time() + 120
        while time.time() < deadline:
            bound = sum(1 for p in store.list("Pod") if p.spec.node_name)
            if bound == 40 and sched.decisions.get("huge") is not None:
                break
            time.sleep(0.05)
        assert bound == 40
        assert store.get_pod("default", "huge").spec.node_name == ""
        assert capacity_violations(store) == []
        assert _get(port, "/healthz") == (200, "ok")
        code, text = _get(port, "/metrics")
        assert code == 200
        assert "scheduler_device_batch_size_count" in text
        assert 'scheduler_schedule_attempts_total{result="scheduled"} 40.0' \
            in text
        code, body = _get(port, "/debug/explain?pod=s-0")
        assert code == 200 and json.loads(body)["outcome"] == "scheduled"
        code, body = _get(port, "/debug/explain?pod=huge")
        assert code == 200
        assert json.loads(body)["outcome"] == "unschedulable"
        code, body = _get(port, "/configz")
        assert code == 200
        assert json.loads(body)["pipeline_cycles"] is pipelined
        assert _get(port, "/debug/flightz")[0] == 200
        assert _get(port, "/debug/journal")[0] == 200
        for path in ("/debug/slo", "/debug/devicez", "/debug/loadz"):
            code, body = _get(port, path)
            assert code == 404 and json.loads(body)["armed"] is False
    finally:
        t0 = time.time()
        sched.close()
        server.stop()
    assert time.time() - t0 < 10.0
    assert sched._serve_thread is None
