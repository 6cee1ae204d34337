"""The port's cycle flight recorder (kubetpu_torch/utils/trace.py) on the
CPU: the cycle records of one seeded drain equal the JAX package's
records of the same drain (gang, sequential and pipelined: name, fields,
queue depths, meta, and every span and event in recording order with
its parent link; times left out), the per-plugin rejection counter the
decision audit feeds equal to the JAX scheduler's, and twins of
tests/test_flightrecorder.py: the ring wraps and counts drops, span tree
linkage and thread tags (binds on the binder pool), the Chrome export's
schema, the /debug/flightz round trip armed and disarmed, armed and
disarmed placements identical, and the disarmed hot path a no-op.

The JAX drains run in a spawned child (torch_port_util.jax_process)."""
import json
import urllib.error
import urllib.request

import pytest

from kubetpu_torch.api import types as api
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.server import SchedulerServer
from kubetpu_torch.utils import trace as utrace
from kubetpu_torch.utils.decisions import DecisionLog
from kubetpu_torch.utils.metrics import SchedulerMetrics
from tests.torch_port_util import jax_process
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)
from tests.torch_recorder_util import recorded_drain

CHILD_TIMEOUT = 600.0


@pytest.fixture
def flight():
    """Armed recorder with a tiny ring; always disarmed on exit (the
    recorder is module-global)."""
    utrace.disarm_flight_recorder()
    fr = utrace.arm_flight_recorder(capacity=4)
    try:
        yield fr
    finally:
        utrace.disarm_flight_recorder()


@pytest.fixture(scope="module")
def jax_proc():
    with jax_process() as ex:
        yield ex


def _drain(sched):
    outs = []
    while True:
        got = sched.schedule_pending(timeout=0.0)
        if not got:
            break
        outs.extend(got)
    sched.wait_for_inflight_binds()
    return outs


def _world(n_nodes=2, n_pods=6, batch=1, metrics=None, infeasible=True,
           async_binding=False, mode="sequential"):
    store = ClusterStore()
    for n in hollow.make_nodes(n_nodes):
        store.add(n)
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=batch, mode=mode),
        async_binding=async_binding, metrics=metrics, device="cpu")
    for p in hollow.make_pods(n_pods):
        store.add(p)
    if infeasible:
        store.add(hollow.make_pod("too-big", cpu_milli=999999))
    return store, sched


# ------------------------------------------------- parity with the JAX records


DRAINS = {"gang": dict(mode="gang"), "sequential": dict(mode="sequential"),
          "pipelined": dict(mode="gang", pipelined=True)}


def _drain_kw(kind):
    return dict(backend="pallas", batch=8, **DRAINS[kind])


_JAX_DRAINS = {}


def _jax_drain(jax_proc, kind):
    """The JAX scheduler's recorded drain of ``kind`` (in the child),
    once per test process."""
    if kind not in _JAX_DRAINS:
        _JAX_DRAINS[kind] = jax_proc.submit(
            recorded_drain, "jax", **_drain_kw(kind)).result(CHILD_TIMEOUT)
    return _JAX_DRAINS[kind]


@pytest.mark.parametrize("kind", sorted(DRAINS))
def test_cycle_records_equal_jax(kind, jax_proc):
    """One seeded preemption drain (evictions, nominations, a pod that
    fits nowhere, an unresolvable one) through both schedulers with the
    recorder armed: the same cycle records, field by field, and the same
    placements; the records carry every stage the JAX scheduler records
    (the pipelined ones their ring slot and depth)."""
    want = _jax_drain(jax_proc, kind)
    got = recorded_drain("port", **_drain_kw(kind))
    assert got["views"] == want["views"]
    assert got["flight"]["dropped"] == want["flight"]["dropped"] == 0
    assert len(got["flight"]["cycles"]) == len(want["flight"]["cycles"])
    for g, w in zip(got["flight"]["cycles"], want["flight"]["cycles"]):
        assert g == w, (g["seq"], g, w)
    names = {s[2] for c in got["flight"]["cycles"] for s in c["spans"]}
    assert {"Scheduling", "dispatch", "packed-readback", "commit", "bind",
            "preemption-wave", "whatif-readback",
            "decision-audit"} <= names
    metas = [c["meta"] for c in got["flight"]["cycles"]]
    if kind == "pipelined":
        # every chain break re-prepares the cycle (the discarded record);
        # each dispatched one carries its slot and the depth
        assert any(m.get("discarded") for m in metas)
        assert all(m.get("discarded") or (m["pipeline_depth"] == 2
                                          and m["ring_slot"] == 0)
                   for m in metas)
    if kind != "sequential":
        assert all("auction_rounds" in m for m in metas
                   if not m.get("discarded"))


def test_framework_rejections_equal_jax(jax_proc):
    """The repair: the decision audit bumps
    scheduler_framework_rejections_total{plugin} as the JAX scheduler
    does, the blocking plugins of each failed pod, or, where no plugin
    blocks alone, the one failing the most nodes: equal per plugin on a
    failing world, with the recorder armed or not."""
    want = _jax_drain(jax_proc, "sequential")
    got = recorded_drain("port", arm=(), **_drain_kw("sequential"))
    assert got["views"] == want["views"]
    assert got["rejections"] == want["rejections"]
    assert got["rejections"][("NodeResourcesFit",)] > 0
    assert got["rejections"][("NodeAffinity",)] > 0


def test_joint_infeasibility_attributed_to_widest_filter():
    """No single filter blocks alone (every node fails two): the counter
    names the plugin that fails the most nodes
    (kubetpu/scheduler.py:2384-2390)."""
    m = SchedulerMetrics()
    store = ClusterStore()
    for i in range(3):
        store.add(hollow.make_node(f"plain-{i}", cpu_milli=500))
    tainted = hollow.make_node("tainted", labels={"disk": "ssd"},
                               cpu_milli=500)
    tainted.spec.taints = [api.Taint(key="dedicated", value="x",
                                     effect="NoSchedule")]
    store.add(tainted)
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=4), device="cpu",
        metrics=m)
    pod = hollow.make_pod("joint", cpu_milli=1000)
    pod.spec.node_selector = {"disk": "ssd"}
    store.add(pod)
    try:
        _drain(sched)
        d = sched.decisions.get("joint")
        assert d.blocking == []
        assert d.rejections == {"NodeResourcesFit": 4, "NodeAffinity": 3,
                                "TaintToleration": 1}
        assert m.framework_rejections.value("NodeResourcesFit") == 1
        assert m.framework_rejections.value("NodeAffinity") == 0
    finally:
        sched.close()


# ---------------------------------------------------------------- ring buffer


def test_ring_wraps_and_counts_drops(flight):
    """A multi-cycle run overflows the 4-slot ring: only the last 4 cycle
    records survive, every older one is counted in dropped() and the
    metric, and each surviving record carries its span tree."""
    m = SchedulerMetrics()
    store, sched = _world(batch=1, metrics=m)
    try:
        outs = _drain(sched)          # 7 pods x batch 1 => 7 cycles
        assert len(outs) == 7
        cycles = flight.cycles()
        assert len(cycles) == 4
        assert flight.dropped() == 3
        assert m.flight_recorder_dropped.value() == 3
        seqs = [c.seq for c in cycles]
        assert seqs == sorted(seqs) and seqs[-1] - seqs[0] == 3
        names = {s.name for c in cycles for s in c.spans()}
        assert {"Scheduling", "dispatch", "packed-readback",
                "commit"} <= names
        rb = [s for c in cycles for s in c.spans()
              if s.name == "packed-readback"]
        assert rb and all("device_wait_s" in s.args for s in rb)
        assert all(set(c.queue_depths) == {"active", "backoff",
                                           "unschedulable"}
                   for c in cycles)
    finally:
        sched.close()


def test_span_drops_counted_past_the_cap():
    """The per-record span cap: spans past it are dropped and counted."""
    rec = utrace.FlightRecorder(capacity=2, max_spans_per_cycle=3) \
        .begin_cycle("c")
    for i in range(5):
        rec.record_span(f"s{i}", 0.0, 1.0)
    for i in range(4):
        rec.event("e")
    assert [s.name for s in rec.spans()] == ["s0", "s1", "s2"]
    assert rec.span_drops == 2
    assert len(rec.events()) == 3 and rec.event_drops == 1


@pytest.mark.parametrize("async_binding", [False, True])
def test_span_tree_linkage_and_threads(flight, async_binding):
    """One root per cycle, every parent link inside the record, a thread
    on every span; the bind spans ride the cycle record, from the binder
    pool's threads when binding is asynchronous."""
    store, sched = _world(batch=8, n_pods=3, infeasible=False,
                          async_binding=async_binding)
    try:
        _drain(sched)
        rec = flight.cycles()[-1]
        spans = rec.spans()
        root = [s for s in spans if s.parent_id == 0 and s.name != "bind"]
        assert len(root) == 1 and root[0].name == "Scheduling"
        ids = {s.span_id for s in spans}
        assert all(s.parent_id in ids for s in spans if s.parent_id)
        assert all(s.thread for s in spans)
        binds = [s for s in spans if s.name == "bind"]
        assert len(binds) == 3
        if async_binding:
            assert all(s.thread.startswith("binder") for s in binds)
            assert all(s.parent_id == 0 for s in binds)
        else:
            commit = [s for s in spans if s.name == "commit"][0]
            assert all(s.parent_id == commit.span_id for s in binds)
    finally:
        sched.close()


# ------------------------------------------------------------- Chrome export


def _validate_chrome(doc):
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    assert evs, "empty traceEvents"
    for e in evs:
        assert e["ph"] in ("X", "M", "C", "i"), e
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert isinstance(e["name"], str) and e["name"]
        if e["ph"] == "X":
            assert isinstance(e["ts"], int) and e["ts"] >= 0
            assert isinstance(e["dur"], int) and e["dur"] >= 0
        elif e["ph"] in ("C", "i"):
            assert isinstance(e["ts"], int)
    named_pids = {e["pid"] for e in evs
                  if e["ph"] == "M" and e["name"] == "process_name"}
    named_tids = {(e["pid"], e["tid"]) for e in evs
                  if e["ph"] == "M" and e["name"] == "thread_name"}
    for e in evs:
        if e["ph"] == "X":
            assert e["pid"] in named_pids
            assert (e["pid"], e["tid"]) in named_tids
    return [e for e in evs if e["ph"] == "X"]


def test_chrome_trace_schema_and_span_total(flight):
    store, sched = _world(batch=2)
    try:
        _drain(sched)
        chrome = flight.to_chrome_trace()
        json.loads(json.dumps(chrome))
        xs = _validate_chrome(chrome)
        pipe = flight.to_pipeline_doc("test")
        assert len(xs) == pipe["span_total"] == len(pipe["spans"])
        assert pipe["device_wait_s"] >= 0.0
        # one root span per cycle
        roots = [e for e in xs if e["name"] == "Scheduling"]
        assert len(roots) == len(flight.cycles())
    finally:
        sched.close()


# ------------------------------------------------------------------- HTTP


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}") as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_flightz_http_roundtrip(flight):
    store, sched = _world(batch=8)
    srv = SchedulerServer(sched, port=0)
    port = srv.start()
    try:
        _drain(sched)
        code, doc = _get(port, "/debug/flightz")
        assert code == 200 and doc["armed"] is True
        assert doc["capacity"] == 4 and len(doc["cycles"]) >= 1
        assert all(c["spans"] for c in doc["cycles"])
        assert "slo" not in doc
        code, chrome = _get(port, "/debug/flightz?format=chrome")
        assert code == 200
        _validate_chrome(chrome)
        code, doc = _get(port, "/debug/explain?pod=too-big")
        assert code == 200 and doc["blocking"] == ["NodeResourcesFit"]
    finally:
        srv.stop()
        sched.close()


def test_flightz_reports_disarmed():
    utrace.disarm_flight_recorder()
    store, sched = _world(n_pods=0, infeasible=False)
    srv = SchedulerServer(sched, port=0)
    port = srv.start()
    try:
        code, doc = _get(port, "/debug/flightz")
        assert code == 200 and doc["armed"] is False
        assert "KUBETPU_FLIGHT" in doc["hint"]
    finally:
        srv.stop()
        sched.close()


# --------------------------------------------------------- disarmed = no-op


@pytest.mark.parametrize("mode", ["sequential", "gang"])
def test_armed_and_disarmed_placements_identical(mode):
    """Arming the recorder changes no placement."""
    def run(arm):
        utrace.disarm_flight_recorder()
        if arm:
            utrace.arm_flight_recorder(capacity=2)
        try:
            store, sched = _world(n_nodes=3, n_pods=12, batch=4, mode=mode)
            try:
                outs = _drain(sched)
                return sorted((o.pod.metadata.name, o.node) for o in outs)
            finally:
                sched.close()
        finally:
            utrace.disarm_flight_recorder()

    disarmed = run(False)
    assert run(True) == disarmed
    assert sum(1 for _, node in disarmed if node) == 12


def test_disarmed_hot_path_is_noop(monkeypatch):
    """Recorder disarmed and audit off: a scheduling cycle constructs no
    CycleRecord, never reads queue depths, takes no DecisionLog lock and
    runs no audit program."""
    utrace.disarm_flight_recorder()

    def boom(*a, **kw):
        raise AssertionError("hot path touched the disarmed recorder")

    monkeypatch.setattr(utrace.FlightRecorder, "begin_cycle", boom)
    monkeypatch.setattr(utrace.CycleRecord, "__init__", boom)
    monkeypatch.setattr(DecisionLog, "record", boom)
    from kubetpu_torch.schedqueue.queue import SchedulingQueue
    monkeypatch.setattr(SchedulingQueue, "depths", boom)
    from kubetpu_torch.models import programs
    monkeypatch.setattr(programs, "explain_verdicts", boom)

    store, sched = _world(batch=8)
    sched.decisions.enabled = False
    try:
        outs = _drain(sched)
        assert sum(1 for o in outs if o.node) == 6
        assert len(sched.decisions) == 0
    finally:
        sched.close()


def test_trace_commits_an_aborted_cycle(flight):
    """A cycle that unwound without finishing still commits its record,
    marked aborted (Trace.__del__)."""
    t = utrace.Trace("Scheduling", pods=1)
    t.step("step")
    del t
    (rec,) = flight.cycles()
    assert rec.meta == {"pods": 1, "aborted": True}
    assert [s.name for s in rec.spans()] == ["Scheduling", "step"]


def test_capture_device_trace_annotates_cycle_phases(tmp_path):
    """capture_device_trace writes a torch.profiler Chrome trace into its
    directory, with each cycle phase a record_function range."""
    store, sched = _world(batch=8, infeasible=False)
    try:
        with utrace.capture_device_trace(str(tmp_path)) as path:
            _drain(sched)
        with open(path) as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]}
        assert "Scheduling:begin" in names
        assert ("Scheduling:Snapshotting scheduler cache and node infos "
                "done") in names
        assert not utrace._PROFILE_ACTIVE
    finally:
        sched.close()
