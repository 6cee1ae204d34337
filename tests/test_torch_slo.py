"""The port's per-pod latency SLO layer (kubetpu_torch/utils/slo.py) on
the CPU: the bucket ladder and QuantileSketch equal the JAX package's on
10,000 seeded samples (counts, totals and every quantile, bitwise), one
seeded drain leaves the same per-pod outcomes and per-stage counts in
both packages' trackers (times are never compared), the exporters render
the JAX package's /metrics lines for the same tracker and ring, and
twins of tests/test_slo.py: bounded memory, exemplar linkage to the
flight recorder and the audit, the unresolvable pod recorded once, the
/debug/slo round trip armed and disarmed, the stage histograms on
/metrics, armed and disarmed placements identical, and the disarmed hot
path a no-op.

The JAX drain runs in a spawned child (torch_port_util.jax_process)."""
import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

import kubetpu.utils.metrics as jmetrics
import kubetpu.utils.slo as jslo
import kubetpu.utils.telemetry as jtel
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.server import SchedulerServer
from kubetpu_torch.utils import metrics as tmetrics
from kubetpu_torch.utils import slo as uslo
from kubetpu_torch.utils import telemetry as utel
from kubetpu_torch.utils import trace as utrace
from kubetpu_torch.utils.slo import BUCKET_EDGES, QuantileSketch, SloTracker
from tests.torch_port_util import jax_process
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)
from tests.torch_recorder_util import recorded_drain

CHILD_TIMEOUT = 600.0


@pytest.fixture
def slo():
    """Armed tracker; always disarmed on exit (module-global)."""
    uslo.disarm_slo_tracker()
    trk = uslo.arm_slo_tracker(max_exemplars=4)
    try:
        yield trk
    finally:
        uslo.disarm_slo_tracker()


@pytest.fixture
def flight():
    utrace.disarm_flight_recorder()
    fr = utrace.arm_flight_recorder(capacity=8)
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


def _world(n_nodes=2, n_pods=6, batch=8, metrics=None, infeasible=False,
           mode="sequential"):
    store = ClusterStore()
    for n in hollow.make_nodes(n_nodes):
        store.add(n)
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=batch, mode=mode),
        metrics=metrics, device="cpu")
    for p in hollow.make_pods(n_pods):
        store.add(p)
    if infeasible:
        store.add(hollow.make_pod("too-big", cpu_milli=999999))
    return store, sched


# ------------------------------------------------- the sketch against JAX's


def test_bucket_edges_equal_jax():
    assert np.array_equal(BUCKET_EDGES, jslo.BUCKET_EDGES)
    assert BUCKET_EDGES.dtype == jslo.BUCKET_EDGES.dtype
    assert not BUCKET_EDGES.flags.writeable
    assert uslo.BUCKET_RATIO == jslo.BUCKET_RATIO
    assert uslo.STAGES == jslo.STAGES


def _samples(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(np.log(0.05), 1.5, size=10_000)
    if kind == "uniform":
        return rng.uniform(0.0, 20.0, size=10_000)
    # edges, zeros and the overflow bucket mixed in
    v = rng.choice(BUCKET_EDGES, size=10_000)
    v[::7] = 0.0
    v[::11] = 3e4
    v[::13] *= 1.0 + 1e-12
    return v


@pytest.mark.parametrize("kind,seed", [("lognormal", 1), ("uniform", 2),
                                       ("edges", 3)])
def test_sketch_equals_jax_on_seeded_samples(kind, seed):
    """10,000 seeded samples into both packages' sketches: the same count
    vector, total, sum, min and max, and every quantile bitwise."""
    tk, jk = QuantileSketch(), jslo.QuantileSketch()
    for v in _samples(kind, seed).tolist():
        tk.observe(v)
        jk.observe(v)
    assert np.array_equal(tk.counts, jk.counts)
    assert (tk.total, tk.sum_s, tk.min_s, tk.max_s) == \
        (jk.total, jk.sum_s, jk.min_s, jk.max_s)
    for q in (0.0, 0.001, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert tk.quantile(q) == jk.quantile(q), q
    assert tk.to_dict() == jk.to_dict()


def test_tracker_documents_equal_jax():
    """The same seeded vectors into both trackers: the same /debug/slo
    document (quantiles, shares, exemplars with their links)."""
    rng = np.random.default_rng(5)
    tt, jt = SloTracker(max_exemplars=4), jslo.SloTracker(max_exemplars=4)
    for i in range(500):
        e2e = float(rng.lognormal(-2.0, 1.0))
        stages = {"queue_wait": e2e / 3, "bind": e2e / 7, "e2e": e2e}
        kw = dict(pod=f"p{i}", namespace="default", uid=f"u{i}",
                  outcome="bound" if i % 9 else "unresolvable",
                  attempts=1 + i % 3, cycle=i // 8, flight_seq=i // 8)
        tt.observe_pod(stages, **kw)
        jt.observe_pod(stages, **kw)
    assert tt.to_dict() == jt.to_dict()
    snap_t, snap_j = tt.counts_snapshot(), jt.counts_snapshot()
    assert snap_t["pods"] == snap_j["pods"]
    for name, blk in snap_t["stages"].items():
        assert np.array_equal(blk["counts"], snap_j["stages"][name]["counts"])


def test_metrics_exposition_equals_jax():
    """The SLO histograms and the telemetry window series render the JAX
    package's lines for the same tracker and ring contents: the same
    series names, label sets and values (the window gauges' values are
    left out of the comparison only where they are times)."""
    rng = np.random.default_rng(9)
    draws = [float(v) for v in rng.lognormal(-1.0, 1.0, size=300)]
    lines = []
    for S, T, M in ((uslo, utel, tmetrics), (jslo, jtel, jmetrics)):
        S.disarm_slo_tracker()
        T.disarm_telemetry()
        trk = S.arm_slo_tracker()
        ring = T.arm_telemetry(window_s=3600.0, capacity=8)
        try:
            for i, v in enumerate(draws):
                trk.observe_pod({"e2e": v, "bind": v / 10, "queue_wait": v},
                                pod=f"p{i}", uid=f"u{i}")
                if i % 100 == 99:
                    ring.force_roll(None)
            text = M.SchedulerMetrics().expose_text().splitlines()
        finally:
            S.disarm_slo_tracker()
            T.disarm_telemetry()
        lines.append([ln for ln in text
                      if "pod_stage_duration" in ln or "scheduler_load" in ln])
    port, jax = lines
    assert port == jax
    assert any(ln.startswith("scheduler_pod_stage_duration_seconds_bucket")
               for ln in port)
    assert "scheduler_load_windows_total 3" in port


# ------------------------------------------------ a drain against JAX's


def test_drain_outcomes_and_stage_counts_equal_jax(jax_proc):
    """One seeded preemption drain (evictions, a pod that fits nowhere, an
    unresolvable one that retries) with the tracker and the recorder
    armed in both packages: the same per-pod observations (pod, outcome,
    attempts, cycle, flight-record seq, stages present) in the same
    order, and the same per-stage counts; the unresolvable pod once."""
    kw = dict(arm=("flight", "slo"), backend="pallas", batch=8,
              mode="gang")
    want = jax_proc.submit(recorded_drain, "jax", **kw).result(CHILD_TIMEOUT)
    got = recorded_drain("port", **kw)
    assert got["views"] == want["views"]
    assert got["slo"] == want["slo"]
    assert got["slo_counts"] == want["slo_counts"]
    outcomes = [o[1] for o in got["slo"]]
    assert outcomes.count("unresolvable") == 1
    assert outcomes.count("bound") == got["slo_counts"]["pods"] - 1
    assert [o[0] for o in got["slo"]
            if o[1] == "unresolvable"] == ["nowhere"]


# --------------------------------------------------------------- twins


def test_sketch_edge_cases():
    sk = QuantileSketch()
    assert sk.quantile(0.99) == 0.0
    sk.observe(0.0)
    sk.observe(1e9)
    assert sk.total == 2
    assert sk.quantile(0.999) == pytest.approx(1e9)
    d = sk.to_dict()
    assert d["count"] == 2 and d["max_s"] == pytest.approx(1e9)


def test_bounded_memory_wrap():
    trk = SloTracker(max_exemplars=4)
    rng = np.random.default_rng(0)
    for i in range(10000):
        e2e = float(rng.uniform(0.001, 10.0))
        trk.observe_pod({"queue_wait": e2e / 3, "bind": e2e / 5,
                         "e2e": e2e},
                        pod=f"p{i}", namespace="default", uid=f"u{i}",
                        attempts=1, cycle=i)
    doc = trk.to_dict()
    assert doc["pods"] == 10000
    for st in doc["stages"].values():
        assert st["count"] == 10000
    ex = doc["exemplars"]
    assert len(ex) == 4
    assert [e["e2e_s"] for e in ex] == sorted(
        (e["e2e_s"] for e in ex), reverse=True)
    assert min(e["e2e_s"] for e in ex) > 9.0
    for sk in trk._sketches.values():
        assert sk.counts.shape == (len(BUCKET_EDGES) + 1,)
    assert "e2e" not in doc["shares"]
    assert sum(doc["shares"].values()) == pytest.approx(1.0, abs=0.01)


def test_zero_exemplars_is_quantiles_only():
    trk = SloTracker(max_exemplars=0)
    trk.observe_pod({"bind": 0.01, "e2e": 0.5}, pod="p", uid="u")
    trk.observe_pod({"bind": 0.02, "e2e": 0.7}, pod="q", uid="v")
    doc = trk.to_dict()
    assert doc["pods"] == 2 and doc["exemplars"] == []


@pytest.mark.parametrize("mode", ["sequential", "gang"])
def test_bound_pods_yield_stage_vectors(slo, mode):
    store, sched = _world(mode=mode)
    try:
        outs = _drain(sched)
        assert sum(1 for o in outs if o.node) == 6
        doc = slo.to_dict()
        assert doc["pods"] == 6
        stages = doc["stages"]
        for name in ("queue_wait", "backoff", "cycle_wait", "dispatch",
                     "device", "commit", "bind", "e2e"):
            assert stages[name]["count"] == 6, name
        assert not any(k.startswith("_") for k in stages)
        assert stages["e2e"]["max_s"] >= stages["bind"]["max_s"] - 1e-9
        ex = doc["exemplars"]
        assert ex and all(e["outcome"] == "bound" for e in ex)
        assert all(set(e["stages_s"]) == {"queue_wait", "backoff",
                                          "cycle_wait", "dispatch",
                                          "device", "commit", "bind"}
                   for e in ex)
    finally:
        sched.close()


def test_exemplar_links_to_flight_record_and_audit(flight, slo):
    store, sched = _world(batch=2)
    try:
        _drain(sched)
        seqs = {c.seq for c in flight.cycles()}
        ex = slo.exemplars()
        assert ex
        for e in ex:
            assert e["flight_seq"] in seqs
            d = sched.decisions.get(e["pod"], namespace=e["namespace"])
            assert d is not None and d.outcome == "scheduled"
            assert e["explain"].startswith("/debug/explain?pod=")
    finally:
        sched.close()


def test_unresolvable_pod_recorded_once(slo):
    store, sched = _world(n_pods=2)
    nowhere = hollow.make_pod("nowhere")
    nowhere.spec.node_selector = {"no-such-label": "x"}
    store.add(nowhere)
    try:
        _drain(sched)
        for _ in range(3):
            sched.queue.move_all_to_active_or_backoff_queue("test")
            _drain(sched)
        doc = slo.to_dict()
        assert doc["unresolvable"] == 1
        assert doc["pods"] == 2 + 1
    finally:
        sched.close()


def test_disarmed_hot_path_is_noop(monkeypatch):
    """Tracker disarmed: a scheduling cycle (with failures) constructs no
    SloTracker, observes no sketch, builds no stage vector and stamps no
    pop time."""
    uslo.disarm_slo_tracker()

    def boom(*a, **kw):
        raise AssertionError("hot path touched the disarmed SLO layer")

    monkeypatch.setattr(uslo.SloTracker, "__init__", boom)
    monkeypatch.setattr(uslo.SloTracker, "observe_pod", boom)
    monkeypatch.setattr(uslo.QuantileSketch, "observe", boom)
    monkeypatch.setattr(Scheduler, "_slo_prefix", boom)
    store, sched = _world(infeasible=True)
    popped = []
    orig = sched.queue.pop_batch

    def pop_batch(*a, **kw):
        out = orig(*a, **kw)
        popped.extend(out)
        return out
    sched.queue.pop_batch = pop_batch
    try:
        outs = _drain(sched)
        assert sum(1 for o in outs if o.node) == 6
        assert popped and all(qp.pop_timestamp == 0.0 for qp in popped)
    finally:
        sched.close()


@pytest.mark.parametrize("mode", ["sequential", "gang"])
def test_armed_and_disarmed_placements_identical(mode):
    def run(arm):
        uslo.disarm_slo_tracker()
        if arm:
            uslo.arm_slo_tracker()
        try:
            store, sched = _world(n_nodes=3, n_pods=12, batch=4,
                                  infeasible=True, mode=mode)
            try:
                outs = _drain(sched)
                return sorted((o.pod.metadata.name, o.node) for o in outs)
            finally:
                sched.close()
        finally:
            uslo.disarm_slo_tracker()

    disarmed = run(False)
    assert run(True) == disarmed
    assert sum(1 for _, node in disarmed if node) == 12


# ------------------------------------------------------------------- HTTP


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}") as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_debug_slo_http_roundtrip(slo, flight):
    store, sched = _world()
    srv = SchedulerServer(sched, port=0)
    port = srv.start()
    try:
        _drain(sched)
        code, doc = _get(port, "/debug/slo")
        assert code == 200 and doc["armed"] is True
        assert doc["pods"] == 6
        assert doc["stages"]["e2e"]["count"] == 6
        assert {"p50_s", "p90_s", "p99_s", "p999_s"} <= set(
            doc["stages"]["e2e"])
        assert doc["shares"] and doc["exemplars"]
        code, doc = _get(port, "/debug/slo?stage=bind&n=1")
        assert code == 200
        assert set(doc["stages"]) == {"bind"}
        assert len(doc["exemplars"]) == 1
        code, doc = _get(port, "/debug/slo?stage=no-such-stage")
        assert code == 400 and "unknown stage" in doc["error"]
        code, doc = _get(port, "/debug/slo?n=not-a-number")
        assert code == 400 and "error" in doc
        # the flightz dump carries the slo block while both are armed
        code, doc = _get(port, "/debug/flightz")
        assert code == 200 and doc["slo"]["stages"]["e2e"]["count"] == 6
    finally:
        srv.stop()
        sched.close()


def test_debug_slo_disarmed_404():
    uslo.disarm_slo_tracker()
    store, sched = _world(n_pods=0)
    srv = SchedulerServer(sched, port=0)
    port = srv.start()
    try:
        code, doc = _get(port, "/debug/slo")
        assert code == 404 and doc["armed"] is False
        assert "KUBETPU_SLO" in doc["hint"]
    finally:
        srv.stop()
        sched.close()


def test_stage_histograms_on_metrics(slo):
    """The armed tracker's ladders render as Prometheus histograms:
    cumulative le, +Inf == _count, a _sum per stage; no line disarmed."""
    m = tmetrics.SchedulerMetrics()
    store, sched = _world(metrics=m)
    try:
        _drain(sched)
        body = m.expose_text()
        name = "scheduler_pod_stage_duration_seconds"
        assert f"# TYPE {name} histogram" in body
        for stage in ("e2e", "bind", "queue_wait"):
            pat = re.compile(
                name + r'_bucket\{stage="' + stage +
                r'",le="([^"]+)"\} (\d+)')
            buckets = [(le, int(n)) for le, n in pat.findall(body)]
            assert buckets and buckets[-1][0] == "+Inf"
            counts = [n for _, n in buckets]
            assert counts == sorted(counts)
            cnt = re.search(
                name + r'_count\{stage="' + stage + r'"\} (\d+)', body)
            assert cnt and int(cnt.group(1)) == buckets[-1][1] == 6
            assert f'{name}_sum{{stage="{stage}"}}' in body
        uslo.disarm_slo_tracker()
        assert name not in m.expose_text()
    finally:
        sched.close()
