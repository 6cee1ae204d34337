"""The port's scheduler_perf runner (kubetpu_torch/harness/perf.py) on
the CPU: twins of tests/test_perf_harness.py's four tests, ``_stats``,
``_p50`` and ``host_share`` equal the JAX functions on seeded inputs,
``run_workload`` on a small workload reports the JAX package's
(Metric, unit) items with the same data keys (the JAX run in a spawned
child, torch_port_util.jax_process; its numbers are times and are not
compared), its FlightRecorder item counts the recorder's cycles, and
``python -m kubetpu_torch.harness.perf --device cpu`` writes the
DataItems document."""
import json
import os
import random
import subprocess
import sys

import pytest

import kubetpu.harness.perf as jperf
from kubetpu_torch.harness.perf import (DEFAULT_WORKLOADS, Workload, _p50,
                                        _stats, host_share, load_workloads,
                                        run_workload)
from kubetpu_torch.utils import trace as utrace
from tests.torch_port_util import jax_process
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

CHILD_TIMEOUT = 600.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MINI = dict(name="MiniBasic", num_nodes=8, num_init_pods=4,
            num_pods_to_schedule=16, batch_size=16, zones=2)


def _shape(items):
    """Each DataItem without its numbers: labels, unit and data keys."""
    return sorted((tuple(sorted(it.labels.items())), it.unit,
                   tuple(sorted(it.data))) for it in items)


def _jax_run_workload(kw):
    """The JAX package's run_workload of Workload(**kw) with the flight
    recorder armed (in the child; no prewarm, whose compile the port does
    not have)."""
    os.environ["KUBETPU_PREWARM"] = "0"
    from kubetpu.utils import trace as jtrace
    jtrace.arm_flight_recorder(capacity=64)
    try:
        return _shape(jperf.run_workload(jperf.Workload(**kw)))
    finally:
        jtrace.disarm_flight_recorder()


# ---------------------------------------------------------------- twins


def test_run_workload_basic_small():
    items = run_workload(Workload(**MINI), device="cpu")
    by_metric = {it.labels["Metric"]: it for it in items}
    tp = by_metric["SchedulingThroughput"]
    assert tp.unit == "pods/s"
    assert "Incomplete" not in tp.labels
    assert by_metric["binding_duration_seconds"].data["Average"] >= 0
    assert "FlightRecorder" not in by_metric     # disarmed
    json.loads(json.dumps([it.to_doc() for it in items]))


def test_run_workload_with_features():
    w = Workload(name="MiniMixed", num_nodes=8, num_init_pods=4,
                 num_pods_to_schedule=12, batch_size=16, zones=2,
                 pod_anti_affinity=True, topology_spread=True,
                 preferred_topology_spread=True, mixed=True,
                 group_labels=12)
    items = run_workload(w, device="cpu")
    tp = [it for it in items
          if it.labels["Metric"] == "SchedulingThroughput"][0]
    assert "Incomplete" not in tp.labels


def test_yaml_config_loads():
    ws = load_workloads(os.path.join(ROOT, "config",
                                     "performance-config.yaml"))
    names = {w.name for w in ws}
    assert "SchedulingBasic" in names
    assert "MixedSchedulingBasePod" in names
    assert all(w.num_pods_to_schedule > 0 for w in ws)
    assert [w.name for w in DEFAULT_WORKLOADS] == [
        w.name for w in jperf.DEFAULT_WORKLOADS]


def test_stats_shape():
    s = _stats([1.0, 2.0, 3.0, 4.0, 10.0])
    assert set(s) == {"Average", "Perc50", "Perc90", "Perc99"}
    assert s["Perc99"] == 10.0


# ------------------------------------------------- against the JAX runner


def test_stats_p50_host_share_equal_jax():
    rng = random.Random(17)
    for n in (0, 1, 2, 5, 17, 100):
        xs = [rng.uniform(0.0, 500.0) for _ in range(n)]
        ints = [rng.randrange(0, 1000) for _ in range(n)]
        assert _stats(xs) == jperf._stats(xs)
        assert _p50(ints) == jperf._p50(ints)
    for _ in range(200):
        a, b = rng.uniform(0.0, 10.0), rng.uniform(0.0, 12.0)
        assert host_share(a, b) == jperf.host_share(a, b)
    assert host_share(1.0, 0.0) == jperf.host_share(1.0, 0.0)


def test_run_workload_items_equal_jax():
    """MiniBasic through both packages' run_workload with the flight
    recorder armed: the same items (labels, unit, data keys); the
    recorder item counts what the ring holds and what it dropped."""
    with jax_process() as ex:
        want = ex.submit(_jax_run_workload, MINI).result(CHILD_TIMEOUT)
    utrace.disarm_flight_recorder()
    fr = utrace.arm_flight_recorder(capacity=2)
    try:
        items = run_workload(Workload(**MINI), device="cpu")
        assert _shape(items) == want
        rec = [it for it in items
               if it.labels["Metric"] == "FlightRecorder"][0]
        assert rec.data["Cycles"] == len(fr.cycles()) == 2
        assert rec.data["Cycles"] + rec.data["Dropped"] >= 3
    finally:
        utrace.disarm_flight_recorder()


def test_perf_cli_writes_dataitems(tmp_path):
    """python -m kubetpu_torch.harness.perf --device cpu on a one-workload
    YAML: exit 0, and the --out document carries the workload's items."""
    cfg = tmp_path / "w.yaml"
    cfg.write_text("- name: CliMini\n  num_nodes: 4\n  num_init_pods: 2\n"
                   "  num_pods_to_schedule: 6\n  batch_size: 8\n")
    out = tmp_path / "out.json"
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "kubetpu_torch.harness.perf", "--config",
         str(cfg), "--only", "climini", "--out", str(out), "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    doc = json.loads(out.read_text())
    metrics = {it["labels"]["Metric"] for it in doc["dataItems"]}
    assert {"SchedulingThroughput", "SchedulerStats",
            "binding_duration_seconds"} <= metrics
    assert json.loads(res.stdout) == doc


def test_run_workload_default_device_needs_a_card():
    """No fallback: without a card the default device raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_workload(Workload(**MINI))


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fails_on_a_fault_the_serving_loop_logged(monkeypatch):
    """Scheduler.run() logs a cycle that raised and goes on serving;
    chip_smoke.py's LoggedFaults, around its runs on the serving loop,
    turns that record into a failure of the phase."""
    import time

    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    from kubetpu_torch.scheduler import Scheduler
    cs = _chip_smoke()
    monkeypatch.setenv("KUBETPU_PREWARM", "0")
    store = ClusterStore()
    for n in hollow.make_nodes(2):
        store.add(n)
    sched = Scheduler(store, device="cpu")
    orig, raised = sched.schedule_pending, []

    def faulty(*a, **kw):
        if not raised:
            raised.append(True)
            raise RuntimeError("injected cycle fault")
        return orig(*a, **kw)
    monkeypatch.setattr(sched, "schedule_pending", faulty)
    with pytest.raises(AssertionError, match="injected cycle fault"):
        with cs.LoggedFaults("serving loop") as faults:
            try:
                sched.run()
                deadline = time.time() + 10.0
                while not faults.records and time.time() < deadline:
                    time.sleep(0.01)
            finally:
                sched.close()
    assert raised
