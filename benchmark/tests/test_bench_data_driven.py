"""A later change adds a configuration, a traffic mix, a pod feature, a
per-layer metric and a cell by adding files and BENCHMARK.json entries: in
a copy of the benchmark, none of the files already there is edited, and
the new cell runs (rehearsed on the CPU) with its new metric."""

import hashlib
import json
import os
import shutil

import numpy as np

from kbench import driver, registry

ROOT = os.path.dirname(registry.HERE)


def _digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_cell_added_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(registry.HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  ".kernel_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(str(bench_dir))

    cfg = json.load(open(bench_dir / "configs" / "k8s5k-default.json"))
    cfg.update(name="k8s2k-small-nodes",
               source="https://example.org/a-public-deployment",
               nodes=2000, node=dict(cpu_milli=2000, mem_bytes=8 << 30,
                                     pods=110))
    json.dump(cfg, open(bench_dir / "configs" / "k8s2k-small-nodes.json",
                        "w"))
    mix = json.load(open(bench_dir / "traffic" / "fill-churn.json"))
    mix["templates"]["filler"]["cpu_milli"] = 450
    json.dump(mix, open(bench_dir / "traffic" / "half-fill-churn.json", "w"))
    cell = "k8s2k-small-nodes.half-fill-churn"
    json.dump({"wrong": 0, "score_gap": 10},
              open(bench_dir / "limits" / (cell + ".json"), "w"))
    (bench_dir / "metrics" / "binds_per_cycle.py").write_text(
        "def read(run):\n"
        "    return run.window_binds / run.window_cycles\n")
    spec = json.load(open(root / "BENCHMARK.json"))
    spec["configs"].append(dict(name=cfg["name"], source=cfg["source"],
                                file="benchmark/configs/"
                                "k8s2k-small-nodes.json",
                                reduced=[], why="small nodes"))
    spec["workloads"].append(dict(name=cell, config=cfg["name"],
                                  traffic="half-fill-churn", chips=1,
                                  why="half-size fillers on small nodes"))
    spec["per_layer"].append(dict(name="binds_per_cycle", unit="pods",
                                  better="higher", source="program_counter",
                                  layer="gang auction (models/gang.py)",
                                  moves="pods_per_s", workloads=[cell]))
    json.dump(spec, open(root / "BENCHMARK.json", "w"))

    after = _digests(str(bench_dir))
    assert {k: v for k, v in after.items() if k in before} == before

    bench = registry.Benchmark(str(root), str(bench_dir))
    out = driver.run_cell(bench, cell, 5, 0.5, True, "cpu", 0.0,
                          shrink=dict(nodes=40, batch_size=20))
    assert out["correct"], out["checks"]
    assert out["metrics"]["binds_per_cycle"]["value"] > 0


NODE_SELECTOR = '''"""A pod's nodeSelector: the node's labels must hold every pair."""

import numpy as np


def to_pod(pod, value, api):
    pod.spec.node_selector = dict(value)


class Ref:
    def __init__(self, world):
        self.world = world
        self._mask = {}

    def nodes(self, t):
        if t.name not in self._mask:
            want = t.feature("node_selector") or {}
            self._mask[t.name] = np.array([
                all(self.world.node_labels(i).get(k) == v
                    for k, v in want.items())
                for i in range(self.world.n_nodes)])
        return self._mask[t.name]

    def place(self, t, node, sign):
        pass

    def snapshot(self):
        return None

    def wrong(self, binds, start, end):
        return sum(1 for t, node in binds if not self.nodes(t)[node])

    def end_fit(self, t, end):
        return self.nodes(t)

    def open_terms(self, t, start, end):
        return [(None, self.nodes(t))]

    def feasible(self, t):
        return self.nodes(t)
'''


def test_a_pod_feature_added_by_files_alone(tmp_path):
    """A traffic mix whose pods carry a feature the benchmark had no file
    for (a nodeSelector): the feature's file, the mix, the cell's limits
    and entries are added, nothing is edited, and the cell rehearses
    correct while the reference holds the program to the feature."""
    from kbench import reference, spec as S
    root = tmp_path / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(registry.HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  ".kernel_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(str(bench_dir))

    (bench_dir / "features" / "node_selector.py").write_text(NODE_SELECTOR)
    mix = json.load(open(bench_dir / "traffic" / "fill-churn.json"))
    zone = json.load(open(bench_dir / "configs" /
                          "k8s5k-default.json"))["zone_names"][1]
    mix["templates"]["picky"] = dict(
        mix["templates"]["filler"],
        node_selector={S.LABEL_ZONE: zone})
    mix["pending"]["template"] = "picky"
    mix["departures"]["templates"] = ["filler", "picky"]
    json.dump(mix, open(bench_dir / "traffic" / "zone-fill-churn.json", "w"))
    cell = "k8s5k-default.zone-fill-churn"
    json.dump({"wrong": 0, "score_gap": 10},
              open(bench_dir / "limits" / (cell + ".json"), "w"))
    spec = json.load(open(root / "BENCHMARK.json"))
    spec["workloads"].append(dict(name=cell, config="k8s5k-default",
                                  traffic="zone-fill-churn", chips=1,
                                  why="fillers pinned to one zone"))
    json.dump(spec, open(root / "BENCHMARK.json", "w"))

    after = _digests(str(bench_dir))
    assert {k: v for k, v in after.items() if k in before} == before

    bench = registry.Benchmark(str(root), str(bench_dir))
    runs = []
    out = driver.run_cell(bench, cell, 6, 0.5, False, "cpu", 0.0,
                          shrink=dict(nodes=48, batch_size=12),
                          log=runs.append)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0

    # the new file's reference part: a bind outside the zone is wrong
    c = bench.cell(cell)
    config, m = S.scaled(bench.config(c["config"]),
                         bench.traffic(c["traffic"]), 48, 12)
    w = S.build_world(config, m, 6, bench.plugins)
    led = reference.Ledger(w)
    rec = led.begin_cycle()
    outside = int(np.flatnonzero(w.node_zone != 1)[0])
    led.pending("x", "picky")
    led.outcome(rec, "x", True)
    led.bind(rec, "x", outside)
    led.end_cycle(rec)
    assert reference.check(led, config["reference_scores"])["wrong"] >= 1
