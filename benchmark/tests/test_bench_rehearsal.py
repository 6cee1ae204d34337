"""Every cell rehearsed on the CPU at a small size through the program's
plain kernels: correct, the metrics BENCHMARK.json gives it, whole-cycle
windows."""

import os

import pytest

from kbench import driver, registry

ROOT = os.path.dirname(registry.HERE)
CELLS = ("k8s5k-default.fill-churn", "k8s5k-default.spread-churn",
         "k8s5k-autoscaler.fill-churn")
SMALL = dict(nodes=48, batch_size=24)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (False, True))
def test_cell_rehearses_correct(cell, trace):
    bench = registry.Benchmark(ROOT)
    runs = []
    out = driver.run_cell(bench, cell, 2 ** 31 + 7, 0.6, trace, "cpu",
                          0.0, shrink=SMALL, log=runs.append)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in bench.metrics_of(cell, trace)}
    got = set(out["metrics"])
    # the device's metrics read nothing on the CPU
    device = {m["name"] for m in bench.spec["per_layer"]
              if m["source"] == "device_trace"}
    assert got <= want and want - got <= device
    assert runs and runs[0]["window_s"] >= 0.6
    if not trace and "pods_per_s" in out["metrics"]:
        info = runs[0]
        binds = out["metrics"]["pods_per_s"]["value"] * info["window_s"]
        assert abs(binds - round(binds)) < 1e-6
        assert info["window_cycles"] == len(info["rounds"])
