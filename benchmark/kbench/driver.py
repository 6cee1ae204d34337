"""One run of a cell against ``kubetpu_torch.scheduler.Scheduler``.

Set-up builds the world from the seed, hands it to the store, builds the
scheduler the configuration file describes and loads the kernels
(prewarm).  The closed loop then runs the mix's warm-up cycles and a
measured window of whole cycles: before each cycle the traffic deletes as
many bound pods as the last cycle bound and tops the backlog up; the cycle
is one ``schedule_pending()``.  The window opens at a cycle's start and
closes at the end of the first cycle that ends at or after ``seconds``.
With ``trace`` the mix's traced stretch follows the window under the
profiler (whole cycles, or a run of auction rounds).  After the program's
state is freed, the reference checks every cycle's binds.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import objects, profiling, reference, registry, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "kubetpu")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that a run must not load, compared
    whole (``kubetpu_torch`` is not ``kubetpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float = 0.0
    window_s: float = 0.0
    window_cycles: int = 0
    window_binds: int = 0
    stage_s: Dict[str, float] = field(default_factory=dict)
    rounds: List[int] = field(default_factory=list)
    sources: List[str] = field(default_factory=list)
    trace: Optional[profiling.Trace] = None
    k1_bound_s: List[float] = field(default_factory=list)
    # seconds the interpreter's garbage collector ran inside the window
    gc_s: float = 0.0


class Cell:
    """A cell's world, traffic, reference ledger and the program under
    test, and the closed loop that drives it."""

    def __init__(self, bench: registry.Benchmark, name: str, seed: int,
                 device: str, shrink: Optional[dict] = None):
        cell = bench.cell(name)
        config = bench.config(cell["config"])
        mix = bench.traffic(cell["traffic"])
        if shrink:
            config, mix = spec.scaled(config, mix, **shrink)
        self.config, self.mix = config, mix
        self.world = spec.build_world(config, mix, seed, bench.plugins)
        self.ledger = reference.Ledger(self.world)
        self.loop = spec.ClosedLoop(self.world, seed)
        self.seed = seed
        self.device = device
        self.last_binds = 0
        self._rec = None
        self._departing: set = set()
        # binds and deletions outside a cycle
        self.stray = 0

    def setup(self) -> None:
        from kubetpu_torch.client.store import ClusterStore
        from kubetpu_torch.scheduler import Scheduler
        w = self.world
        store = ClusterStore()
        self.node_index: Dict[str, int] = {}
        for i in range(w.n_nodes):
            node = objects.make_node(w, i)
            store.add(node)
            self.node_index[node.metadata.name] = i
        self.pods = {}
        for name, t, nd in w.bound:
            pod = objects.make_pod(w, name, w.templates[t], w.node_name(nd))
            store.add(pod)
            self.pods[name] = pod
        self.store = store
        self.sched = Scheduler(store, config=objects.scheduler_config(
            self.config), device=self.device, seed=self.seed % (2 ** 31))
        store.subscribe("Pod", self._on_pod)
        self.sched.prewarm()

    def _on_pod(self, event, old, new) -> None:
        """The benchmark's store subscription: every bind the commit
        writes and every deletion the program makes (a preemption's
        victim), with the cycle it belongs to."""
        if event == "delete":
            name = old.metadata.name
            if name in self._departing:
                self._departing.discard(name)
            elif self._rec is None or name not in self.ledger.node_of:
                self.stray += 1
            else:
                self.ledger.evict(self._rec, name)
                self.loop.evicted(name)
                self.pods.pop(name, None)
            return
        if not (event == "update" and not old.spec.node_name
                and new.spec.node_name):
            return
        name = new.metadata.name
        if self._rec is None:
            self.stray += 1
            return
        node = self.node_index.get(new.spec.node_name, -1)
        self.ledger.bind(self._rec, name, node)
        self.loop.bound(name, self.ledger.template_of[name].name)

    def traffic(self) -> None:
        gone, new = self.loop.step(self.last_binds)
        for name in gone:
            self._departing.add(name)
            self.store.delete(self.pods.pop(name))
            self.ledger.remove(name)
        t = self.world.pending_template
        for name in new:
            pod = objects.make_pod(self.world, name, t)
            self.ledger.pending(name, t.name)
            self.store.add(pod)
            self.pods[name] = pod

    def cycle(self) -> reference.CycleRecord:
        """One iteration of the closed loop: traffic, then one cycle."""
        self.traffic()
        rec = self.ledger.begin_cycle()
        self._rec = rec
        try:
            outs = self.sched.schedule_pending()
        finally:
            self._rec = None
        self.ledger.end_cycle(rec)
        for o in outs:
            self.ledger.outcome(rec, o.pod.metadata.name, bool(o.node))
        self.last_binds = len(rec.binds)
        return rec

    def close(self) -> None:
        self.sched.close()
        del self.sched, self.store, self.pods
        gc.collect()


def _capture_k1(launches: list):
    """Wrap the propose kernel's entry so that each launch's inputs are
    kept (by reference: the auction makes new carries every round and
    never writes a bundle in place); returns the undo."""
    from kubetpu_torch.ops import propose as PK
    orig = PK.propose

    def recording(bundle, rows, live, req, nz, ports_used):
        out = orig(bundle, rows, live, req, nz, ports_used)
        launches.append((bundle, rows, live, req, nz, ports_used))
        return out
    recording.launches = orig.launches
    PK.propose = recording

    def undo():
        orig.launches = recording.launches
        PK.propose = orig
    return undo


def _spans(cell):
    """Benchmark spans around the traffic and the scheduler's stages
    (traced runs)."""
    for obj, attr, name in ((cell, "traffic", "traffic"),
                            (cell.sched, "_prepare_group", "prepare"),
                            (cell.sched, "_dispatch_group", "dispatch"),
                            (cell.sched, "_commit_group", "commit")):
        setattr(obj, attr, profiling.span(name, getattr(obj, attr)))


def traced_stretch(cell: Cell, run: Run) -> None:
    """The mix's traced stretch after the window: ``cycles`` whole cycles,
    or ``rounds`` auction rounds after the first ``skip_rounds`` (counted
    at the round's one flags read)."""
    from kubetpu_torch.models import gang as G
    plan = cell.mix["trace"]
    prof = profiling.Profiler(cuda=cell.device == "cuda")
    launches: list = []
    _spans(cell)
    undo = _capture_k1(launches)
    try:
        if "cycles" in plan:
            prof.start()
            for _ in range(int(plan["cycles"])):
                cell.cycle()
            prof.stop()
        else:
            first, n = int(plan["skip_rounds"]), int(plan["rounds"])
            orig = G._read_flags
            state = dict(reads=0)

            def read_flags(flags):
                out = orig(flags)
                state["reads"] += 1
                if state["reads"] == first:
                    prof.start()
                elif state["reads"] == first + n:
                    prof.stop()
                return out
            G._read_flags = read_flags
            try:
                for _ in range(int(plan.get("max_cycles", 3))):
                    cell.cycle()
                    if prof.window_s is not None:
                        break
            finally:
                G._read_flags = orig
            if prof.window_s is None:
                raise RuntimeError("trace: %d rounds ran, fewer than %d"
                                   % (state["reads"], first + n))
    finally:
        undo()
    tr = prof.trace()
    if "cycles" in plan:
        tr.cycles = int(plan["cycles"])
    else:
        tr.rounds = int(plan["rounds"])
    run.trace = tr
    from . import k1_bound
    run.k1_bound_s = [k1_bound.bound_s(*a) for a in launches]


class GcClock:
    """Seconds the interpreter's cyclic garbage collector ran, and its
    collections, per generation, while installed."""

    def __init__(self):
        self.s = [0.0, 0.0, 0.0]
        self.n = [0, 0, 0]
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.s[g] += time.perf_counter() - self._t
            self.n[g] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def run_cell(bench: registry.Benchmark, name: str, seed: int,
             seconds: float, trace: bool, device: str,
             t_process: float, shrink: Optional[dict] = None,
             log=None) -> dict:
    """One run; returns the result line's fields and the reference's
    numbers (``checks``)."""
    import torch
    cell = Cell(bench, name, seed, device, shrink)
    cell.setup()
    with GcClock() as gcc:
        run, info = _closed_window(cell, seconds, trace, t_process, gcc)
    info.update(gc_s=gcc.s, gc_n=gcc.n)
    sched = cell.sched
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    recovered = list(sched.recovery_log)
    cell.close()
    if device == "cuda":
        torch.cuda.empty_cache()

    if log is not None:
        log(dict(cell=name, seed=seed, window_cycles=run.window_cycles,
                 window_s=run.window_s, sources=_runs(run.sources),
                 rounds=run.rounds, stage_s=run.stage_s,
                 recovered=recovered, stray=cell.stray,
                 traced_kinds=run.trace.device_kinds if run.trace else None,
                 **info))
    numbers = reference.check(cell.ledger, cell.config["reference_scores"])
    limits = bench.limits(name)
    correct, checks = reference.verdict(numbers, limits)
    correct = correct and not recovered and cell.stray == 0
    out = dict(correct=correct, attempted=info["attempted"],
               failed=info["failed"],
               metrics=registry.read_metrics(bench, name, trace, run),
               device=dict(platform="gpu" if device == "cuda" else device,
                           kind=(torch.cuda.get_device_name(0)
                                 if device == "cuda" else "cpu"),
                           count=1, memory_peak_bytes=int(peak)))
    if trace:
        out["device"].update(busy_s=run.trace.busy_s,
                             window_s=run.trace.window_s)
        out["breakdown"] = dict(device_ops=run.trace.top_ops(),
                                idle_gaps=run.trace.gaps())
    out["checks"] = checks
    return out


def _window_stats(cell: Cell, run: Run, stage0, c0, k0) -> None:
    sched = cell.sched
    run.stage_s = {k: sched.stage_s[k] - stage0[k] for k in stage0}
    run.rounds = list(sched.gang_rounds[c0:c0 + run.window_cycles])
    run.sources = list(sched.cluster_sources[k0:k0 + run.window_cycles])


def _closed_window(cell: Cell, seconds: float, trace: bool,
                   t_process: float, gcc: GcClock):
    import torch
    cuda = cell.device == "cuda"
    for _ in range(int(cell.mix["warmup_cycles"])):
        cell.cycle()
    if cuda:
        torch.cuda.synchronize()
    run = Run(setup_s=time.time() - t_process)
    sched = cell.sched
    stage0 = dict(sched.stage_s)
    c0, k0 = len(sched.gang_rounds), len(sched.cluster_sources)
    first = len(cell.ledger.cycles)
    gc0 = sum(gcc.s)
    t_open = t = time.perf_counter()
    cycle_s = []
    while True:
        rec = cell.cycle()
        run.window_binds += len(rec.binds)
        run.window_cycles += 1
        cycle_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        if t - t_open >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t_open
    run.gc_s = sum(gcc.s) - gc0
    _window_stats(cell, run, stage0, c0, k0)
    window = cell.ledger.cycles[first:]
    if trace:
        traced_stretch(cell, run)
    info = dict(attempted=sum(r.attempted for r in window),
                failed=sum(len(r.unbound) for r in window),
                cycle_s=cycle_s)
    return run, info


def _runs(xs: List[str]) -> List[list]:
    """[[value, count], ...] of consecutive equal values."""
    out: List[list] = []
    for x in xs:
        if out and out[-1][0] == x:
            out[-1][1] += 1
        else:
            out.append([x, 1])
    return out
