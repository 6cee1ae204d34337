"""Finds everything of a cell by name.

BENCHMARK.json at the checkout's root names the cells, configurations and
metrics; each lives in a file of its own under ``benchmark/``:

* ``configs/<config>.json``   (the path BENCHMARK.json gives as ``file``)
* ``traffic/<traffic>.json``  a traffic mix
* ``limits/<cell>.json``      the limit of each number that decides correct
* ``metrics/<metric>.py``     a reader: ``read(run) -> float or None``
* ``features/<key>.py``, ``scores/<Plugin>.py``  a pod feature a traffic
  mix names, a score plugin a configuration names (kbench/plugins.py)

A cell or a metric is added by adding files and entries; no file here
changes.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

from .plugins import Plugins, load_module

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    def __init__(self, root: str, bench_dir: str = HERE):
        self.root = root
        self.dir = bench_dir
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))
        self.plugins = Plugins(bench_dir)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in BENCHMARK.json" % name)

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _load_json(os.path.join(self.root, c["file"]))
        raise KeyError("no config %r in BENCHMARK.json" % name)

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.dir, "traffic", name + ".json"))

    def limits(self, cell: str) -> dict:
        return _load_json(os.path.join(self.dir, "limits", cell + ".json"))

    def metrics_of(self, cell: str, trace: bool) -> List[dict]:
        """The end-to-end metrics (trace off) or the per-layer metrics
        (trace on) that a cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str) -> Callable:
        return load_module(os.path.join(self.dir, "metrics", metric + ".py"),
                           "kbench_metric_").read


def read_metrics(bench: Benchmark, cell: str, trace: bool, run
                 ) -> Dict[str, dict]:
    """{name: {value, unit}} of every metric the cell reports whose reader
    found something to read."""
    out: Dict[str, dict] = {}
    for m in bench.metrics_of(cell, trace):
        v: Optional[float] = bench.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    return out
