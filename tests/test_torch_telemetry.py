"""The port's load-telemetry ring (kubetpu_torch/utils/telemetry.py) and
open-loop harness (harness/hollow.py streams, harness/perf.py
SustainedLoadRunner) on the CPU: the three arrival streams and the
warm-restart world equal the JAX package's for the same seeds,
``quantile_from_counts`` and ``steady_state_span`` equal the JAX
functions on seeded inputs, the window records of one seeded drain
(a window closed after every cycle) equal the JAX package's in every
count, and twins of tests/test_telemetry.py: window-delta exactness,
ring bounds, recoveries in the window that saw them, /debug/loadz armed
and disarmed, the /metrics window series, the open-loop runner smoke
(the minutes soak stays ``slow``-marked), armed and disarmed placements
identical, and the disarmed hot path a no-op.

The JAX drain runs in a spawned child (torch_port_util.jax_process)."""
import json
import math
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import kubetpu.harness.hollow as jhollow
import kubetpu.utils.telemetry as jtel
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.harness.perf import SustainedLoadRunner
from kubetpu_torch.models import gang as tgang
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.server import SchedulerServer
from kubetpu_torch.utils import slo as uslo
from kubetpu_torch.utils import telemetry as utel
from kubetpu_torch.utils.metrics import SchedulerMetrics
from kubetpu_torch.utils.slo import BUCKET_EDGES, BUCKET_RATIO, QuantileSketch
from kubetpu_torch.utils.telemetry import (TelemetryRing, quantile_from_counts,
                                           steady_state_span)
from tests.torch_port_util import jax_process
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)
from tests.torch_recorder_util import recorded_drain

CHILD_TIMEOUT = 600.0


@pytest.fixture
def slo():
    uslo.disarm_slo_tracker()
    trk = uslo.arm_slo_tracker()
    try:
        yield trk
    finally:
        uslo.disarm_slo_tracker()


@pytest.fixture
def tel():
    """Armed ring with a giant window: rolls happen only via force_roll,
    so tests control window boundaries."""
    utel.disarm_telemetry()
    ring = utel.arm_telemetry(window_s=3600.0, capacity=64)
    try:
        yield ring
    finally:
        utel.disarm_telemetry()


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


def _world(n_nodes=2, n_pods=6, batch=8, metrics=None, mode="sequential",
           **cfg):
    store = ClusterStore()
    for n in hollow.make_nodes(n_nodes):
        store.add(n)
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=batch, mode=mode,
        **cfg), metrics=metrics, device="cpu")
    for p in hollow.make_pods(n_pods):
        store.add(p)
    return store, sched


# ---------------------------------------------- streams against the JAX ones


def _pod_view(p):
    return (p.metadata.name, p.namespace, dict(p.metadata.labels),
            [(c.topology_key, c.max_skew, c.when_unsatisfiable,
              dict(c.label_selector.match_labels))
             for c in p.spec.topology_spread_constraints],
            p.spec.affinity is not None,
            [(c.resources.requests) for c in p.spec.containers])


def _stream_view(events):
    return [(e["t"], e["kind"], _pod_view(e["pod"])) for e in events]


STREAMS = {
    "poisson": dict(rate=40.0, duration_s=5.0),
    "burst": dict(rate=10.0, duration_s=21.0, burst_every_s=10.0,
                  burst_size=16),
    "diurnal": dict(rate=30.0, duration_s=8.0, period_s=4.0),
}


@pytest.mark.parametrize("dwell", [None, 2.0])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_streams_equal_jax(seed, dwell):
    """A seeded random.Random gives the JAX package's event list: the
    same times (bitwise), kinds, pod names, labels and spread
    constraints, for each stream, with and without departures."""
    for name, kw in STREAMS.items():
        got = getattr(hollow, name + "_stream")(seed=seed,
                                                mean_dwell_s=dwell, **kw)
        want = getattr(jhollow, name + "_stream")(seed=seed,
                                                  mean_dwell_s=dwell, **kw)
        assert got and _stream_view(got) == _stream_view(want), name
        if dwell:
            assert any(e["kind"] == "delete" for e in got)


def test_restart_world_and_wave_equal_jax():
    ts, js = hollow.restart_world(12), jhollow.restart_world(12)
    assert ([(n.metadata.name, n.metadata.labels) for n in ts.list("Node")]
            == [(n.metadata.name, n.metadata.labels)
                for n in js.list("Node")])
    assert ([(_pod_view(p), p.spec.node_name) for p in ts.list("Pod")]
            == [(_pod_view(p), p.spec.node_name) for p in js.list("Pod")])
    tw, jw = hollow.restart_wave(30), jhollow.restart_wave(30)
    assert [_pod_view(p) for p in tw] == [_pod_view(p) for p in jw]
    assert ([p.spec.affinity.pod_anti_affinity
             .required_during_scheduling_ignored_during_execution[0]
             .topology_key for p in tw if p.spec.affinity]
            == [p.spec.affinity.pod_anti_affinity
                .required_during_scheduling_ignored_during_execution[0]
                .topology_key for p in jw if p.spec.affinity])


# ------------------------------------------- the window math against JAX's


def test_quantile_from_counts_equals_jax():
    rng = np.random.default_rng(11)
    for _ in range(50):
        counts = rng.integers(0, 5, size=len(BUCKET_EDGES) + 1)
        counts[rng.random(counts.shape) < 0.7] = 0
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert quantile_from_counts(counts, q) == \
                jtel.quantile_from_counts(counts, q)
    zero = np.zeros(len(BUCKET_EDGES) + 1, np.int64)
    assert quantile_from_counts(zero, 0.99) == 0.0 == \
        jtel.quantile_from_counts(zero, 0.99)


def test_steady_state_span_equals_jax():
    rng = np.random.default_rng(12)
    series = [[5.0, 3.0, 1.1, 1.0, 1.05, 1.0, 1.02, 0.98, 1.0],
              [float(i) for i in range(10)], [1.0] * 5, [0.0] * 8]
    for _ in range(40):
        n = int(rng.integers(3, 20))
        warm = list(rng.uniform(2.0, 6.0, size=int(rng.integers(0, 4))))
        series.append(warm + list(rng.normal(1.0, rng.uniform(0.0, 0.3),
                                             size=n)))
    for s in series:
        for kw in ({}, dict(min_windows=3, slope_frac=0.05)):
            assert steady_state_span(s, **kw) == \
                jtel.steady_state_span(s, **kw), s


def test_window_records_equal_jax(jax_proc):
    """One seeded preemption drain in both packages, a window closed with
    force_roll after every cycle (the SLO tracker and the recorder armed
    too): every window's counts, depths, rounds and links equal."""
    kw = dict(arm=("flight", "slo", "telemetry"), roll_every_cycle=True,
              backend="pallas", batch=8, mode="gang")
    want = jax_proc.submit(recorded_drain, "jax", **kw).result(CHILD_TIMEOUT)
    got = recorded_drain("port", **kw)
    assert got["views"] == want["views"]
    assert len(got["windows"]) == len(want["windows"]) >= 3
    for g, w in zip(got["windows"], want["windows"]):
        assert g == w, (g, w)
    assert sum(w["pods"] for w in got["windows"]) == \
        got["slo_counts"]["pods"]
    assert any(w["gang_rounds_last"] > 1 for w in got["windows"])


# ------------------------------------------------- window-delta exactness


def test_quantile_from_counts_matches_order_statistic():
    rng = np.random.default_rng(7)
    for scale in (5e-3, 0.2, 4.0):
        draws = np.sort(rng.lognormal(math.log(scale), 1.0, size=1500))
        sk = QuantileSketch()
        for v in draws:
            sk.observe(float(v))
        n = len(draws)
        for q in (0.5, 0.9, 0.99):
            est = quantile_from_counts(sk.counts, q)
            exact = float(draws[min(max(math.ceil(q * n), 1), n) - 1])
            assert exact <= est * (1 + 1e-9)
            assert est <= exact * BUCKET_RATIO * (1 + 1e-9)


def test_window_delta_isolates_each_window(slo, tel):
    rng = np.random.default_rng(1)
    slow_draws = list(rng.uniform(2.0, 4.0, size=40))
    fast_draws = list(rng.uniform(0.01, 0.02, size=160))
    for v in slow_draws:
        slo.observe_pod({"e2e": v, "bind": v / 10}, pod="a", uid="a")
    tel.force_roll(None)
    for v in fast_draws:
        slo.observe_pod({"e2e": v, "bind": v / 10}, pod="b", uid="b")
    tel.force_roll(None)
    w1, w2 = tel.windows()[-2:]
    assert w1["stages"]["e2e"]["count"] == 40
    assert w2["stages"]["e2e"]["count"] == 160
    assert w2["stages"]["e2e"]["p99_s"] <= 0.02 * BUCKET_RATIO * 1.001
    assert w1["stages"]["e2e"]["p50_s"] >= 2.0
    union = sorted(slow_draws + fast_draws)
    n = len(union)
    start = len(tel.windows()) - 2
    merged_p99 = tel.steady_quantile(start, 2, 0.99)
    exact = union[min(max(math.ceil(0.99 * n), 1), n) - 1]
    assert exact <= merged_p99 * (1 + 1e-9)
    assert merged_p99 <= exact * BUCKET_RATIO * (1 + 1e-9)


def test_delta_survives_midwindow_clear(slo, tel):
    for _ in range(10):
        slo.observe_pod({"e2e": 1.0}, pod="x", uid="x")
    tel.force_roll(None)
    slo.clear()
    slo.observe_pod({"e2e": 0.5}, pod="y", uid="y")
    w = tel.force_roll(None)
    assert w["stages"]["e2e"]["count"] >= 0
    assert w["pods"] >= 0


def test_ring_wrap_and_drop_counting():
    ring = TelemetryRing(window_s=3600.0, capacity=4)
    for _ in range(7):
        ring.force_roll(None)
    wins = ring.windows()
    assert len(wins) == 4
    assert ring.dropped() == 3
    assert [w["seq"] for w in wins] == [4, 5, 6, 7]
    d = ring.to_dict()
    assert d["digest"]["dropped"] == 3
    assert len(d["windows"]) == 4


def test_steady_state_span_cuts_warmup():
    warm = [5.0, 3.0, 1.1, 1.0, 1.05, 1.0, 1.02, 0.98, 1.0]
    start, n = steady_state_span(warm)
    assert start >= 1 and n >= 6 and start + n == len(warm)
    assert steady_state_span([float(i) for i in range(10)]) is None
    assert steady_state_span([1.0] * 5) is None


def test_window_records_have_no_numpy_in_public_form(slo, tel):
    slo.observe_pod({"e2e": 0.2}, pod="p", uid="u")
    tel.force_roll(None)
    assert "_e2e_counts" in tel.windows()[-1]
    json.dumps(tel.to_dict())


def test_recoveries_land_in_firing_window(tel):
    """A dispatch that raises once: the recovery lands in the window open
    when it fired; the windows before and after stay clean (the
    object-identity tail scan on sched.recovery_log)."""
    store, sched = _world(n_nodes=3, n_pods=4, batch=4, mode="gang",
                          pod_initial_backoff_seconds=0.01,
                          pod_max_backoff_seconds=0.05)
    orig = tgang.run_auction
    fired = []

    def flaky(*a, **kw):
        if not fired:
            fired.append(1)
            raise RuntimeError("injected dispatch error")
        return orig(*a, **kw)
    try:
        tel.force_roll(sched)
        assert tel.windows()[-1].get("recoveries", 0) == 0
        import kubetpu_torch.scheduler as S
        S.run_auction = flaky
        try:
            outs, idle = [], 0
            while idle < 4:
                sched.queue.flush_backoff_completed()
                got = sched.schedule_pending(timeout=0.0)
                if got:
                    outs.extend(got)
                    idle = 0
                else:
                    idle += 1
                    time.sleep(0.02)
        finally:
            S.run_auction = orig
        assert sum(1 for o in outs if o.node) == 4
        w = tel.force_roll(sched)
        assert w["recoveries"] == len(sched.recovery_log) == 1
        assert [e["kind"] for e in w["recovery_events"]] == [
            "dispatch-error"]
        assert w["demotions"] == 0
        w2 = tel.force_roll(sched)
        assert w2["recoveries"] == 0 and w2["demotions"] == 0
    finally:
        sched.close()


# ------------------------------------------- disarmed cost + parity golden


def test_disarmed_hot_path_is_noop(monkeypatch):
    utel.disarm_telemetry()

    def boom(*a, **kw):
        raise AssertionError("hot path touched the disarmed telemetry "
                             "plane")

    monkeypatch.setattr(utel.TelemetryRing, "__init__", boom)
    monkeypatch.setattr(utel.TelemetryRing, "maybe_tick", boom)
    monkeypatch.setattr(utel.TelemetryRing, "force_roll", boom)
    store, sched = _world()
    try:
        outs = _drain(sched)
        assert sum(1 for o in outs if o.node) == 6
    finally:
        sched.close()


@pytest.mark.parametrize("mode", ["sequential", "gang"])
def test_armed_and_disarmed_placements_identical(mode):
    """Arming the ring (a window rolled every schedule_pending call)
    changes no placement."""
    def run(arm):
        utel.disarm_telemetry()
        if arm:
            utel.arm_telemetry(window_s=1e-3)
        try:
            store, sched = _world(n_nodes=3, n_pods=12, batch=4, mode=mode)
            try:
                outs = _drain(sched)
                return sorted((o.pod.metadata.name, o.node) for o in outs)
            finally:
                sched.close()
        finally:
            utel.disarm_telemetry()

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


def test_debug_loadz_disarmed_404():
    utel.disarm_telemetry()
    store, sched = _world(n_pods=0)
    srv = SchedulerServer(sched, port=0)
    port = srv.start()
    try:
        code, doc = _get(port, "/debug/loadz")
        assert code == 404 and doc["armed"] is False
        assert "KUBETPU_TELEMETRY" in doc["hint"]
    finally:
        srv.stop()
        sched.close()


def test_debug_loadz_http_roundtrip(slo, tel):
    store, sched = _world()
    srv = SchedulerServer(sched, port=0)
    port = srv.start()
    try:
        _drain(sched)
        tel.force_roll(sched)
        tel.force_roll(sched)
        code, doc = _get(port, "/debug/loadz")
        assert code == 200 and doc["armed"] is True
        assert doc["digest"]["windows"] == len(doc["windows"]) == 2
        w = doc["windows"][0]
        assert w["stages"]["e2e"]["count"] == 6
        assert "queue_depths" in w and "cycles" in w
        assert "_e2e_counts" not in w
        code, doc = _get(port, "/debug/loadz?n=1")
        assert code == 200 and len(doc["windows"]) == 1
        assert doc["windows"][0]["seq"] == 2
        assert _get(port, "/debug/loadz?n=-1")[0] == 400
        assert _get(port, "/debug/loadz?n=bogus")[0] == 400
    finally:
        srv.stop()
        sched.close()


def test_metrics_window_series(slo, tel):
    m = SchedulerMetrics()
    store, sched = _world(metrics=m)
    try:
        _drain(sched)
        tel.force_roll(sched)
        body = m.expose_text()
        assert "scheduler_load_windows_total 1" in body
        assert "scheduler_load_window_pods 6" in body
        assert "scheduler_load_window_e2e_p99_seconds" in body
        utel.disarm_telemetry()
        assert "scheduler_load_" not in m.expose_text()
    finally:
        sched.close()


# ------------------------------------------------- streams + open loop


def test_streams_are_seeded_and_sorted():
    a = hollow.poisson_stream(50.0, 2.0, seed=9, mean_dwell_s=1.0)
    b = hollow.poisson_stream(50.0, 2.0, seed=9, mean_dwell_s=1.0)
    assert _stream_view(a) == _stream_view(b)
    ts = [e["t"] for e in a]
    assert ts == sorted(ts)
    adds = [e for e in a if e["kind"] == "add"]
    dels = [e for e in a if e["kind"] == "delete"]
    assert adds and len(dels) == len(adds)
    first_add = {e["pod"].metadata.name: e["t"] for e in adds}
    assert all(e["t"] > first_add[e["pod"].metadata.name] for e in dels)
    burst = hollow.burst_stream(5.0, 21.0, seed=2, burst_every_s=10.0,
                                burst_size=16)
    assert len([e for e in burst if e["t"] in (10.0, 20.0)]) == 32
    di = hollow.diurnal_stream(30.0, 4.0, seed=3, period_s=2.0)
    assert di and all(0.0 <= e["t"] < 4.0 for e in di)


def test_sustained_runner_open_loop_smoke(slo, tel):
    """Seconds-scale open loop at the JAX test's size: a short seeded
    stream fired at its wall deadlines against a serving scheduler, every
    offered pod completed, the ring's digest on the result."""
    store = ClusterStore()
    for n in hollow.make_nodes(4):
        store.add(n)
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=32, prewarm=False),
        async_binding=True, device="cpu")
    sched.run()
    try:
        events = hollow.poisson_stream(40.0, 0.75, seed=5)
        res = SustainedLoadRunner(store, sched, events, 0.75,
                                  settle_s=30.0).run()
        assert res["offered"] == len(events)
        assert res["completed"] == res["offered"]
        assert res["completed_frac"] == 1.0
        assert res["behind_max_s"] < 30.0
        assert res["load"]["windows"] >= 1
        assert res["load"]["pods"] >= res["offered"]
    finally:
        sched.close()


@pytest.mark.slow
def test_sustained_soak_reaches_steady_state(slo):
    """Minutes-scale soak (tier-1 excludes it via -m 'not slow'): a Poisson
    stream long enough for the slope test to find a steady suffix, no
    demotion, a bounded ring."""
    utel.disarm_telemetry()
    utel.arm_telemetry(window_s=2.0, capacity=512)
    store = ClusterStore()
    for n in hollow.make_nodes(16, zones=4):
        store.add(n)
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=64),
        async_binding=True, device="cpu")
    sched.run()
    try:
        events = hollow.poisson_stream(8.0, 60.0, seed=13, group_labels=8)
        res = SustainedLoadRunner(store, sched, events, 60.0,
                                  settle_s=60.0).run()
        load = res["load"]
        assert load["demotions"] == 0
        assert res["completed_frac"] >= 0.95
        steady = load.get("steady")
        assert steady is not None and steady["windows"] >= 6
        assert steady["p99_s"] > 0
        ring = utel.ring()
        assert len(ring.windows()) <= ring.capacity
    finally:
        sched.close()
        utel.disarm_telemetry()
