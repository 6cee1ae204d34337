"""Shared helpers of the port's recorder tests (tests/test_torch_
flightrecorder.py, test_torch_slo.py, test_torch_telemetry.py,
test_torch_perf_harness.py): one seeded drain run through either
package's scheduler with its recorders armed, and views of what each
recorder kept that leave out every time, so the two packages' records of
the same drain compare with ``==``.

The drains go through torch_port_util.drive (the queue on a fake clock,
binding in the cycle); the JAX one runs in a spawned child
(torch_port_util.jax_process), so ``recorded_drain`` is a module-level
function that returns plain data."""
from __future__ import annotations

import importlib

from kubetpu_torch.harness import preempt_worlds as PW
from tests.torch_port_util import drive, packages

# span and event arguments that are times
TIME_ARGS = frozenset({"device_wait_s", "seconds"})


def _untimed(args):
    return {k: v for k, v in args.items() if k not in TIME_ARGS}


def flight_view(trace_mod) -> dict:
    """Every cycle record the armed recorder holds, times left out: seq,
    label, queue depths, meta, span and event drops, and each span (id,
    parent id, name, thread, arguments) and event (name, parent, thread,
    arguments) in recording order."""
    fr = trace_mod.flight_recorder()
    cycles = []
    for rec in fr.cycles():
        d = rec.to_dict()
        cycles.append(dict(
            seq=d["seq"], label=d["label"], queue_depths=d["queue_depths"],
            meta=d["meta"], span_drops=d["span_drops"],
            event_drops=d["event_drops"],
            spans=[(s["id"], s["parent"], s["name"], s["thread"],
                    _untimed(s["args"])) for s in d["spans"]],
            events=[(e["name"], e["parent"], e["thread"],
                     _untimed(e["args"])) for e in d["events"]]))
    return dict(dropped=fr.dropped(), cycles=cycles)


def window_view(w: dict) -> dict:
    """One telemetry window, times left out: per-stage counts, terminal
    pods, the scheduler's counters, queue depths, recoveries and the
    flight-recorder links."""
    out = {k: w[k] for k in ("seq", "pods", "unresolvable", "cycles",
                             "delta_cycles", "resyncs", "gang_rounds_last",
                             "queue_depths", "recoveries", "demotions",
                             "flight_dropped", "flight_seq") if k in w}
    out["stages"] = {name: blk["count"]
                     for name, blk in w.get("stages", {}).items()}
    out["keys"] = sorted(k for k in w if not k.startswith("_"))
    return out


def preempt_scenario(seed=21, n_nodes=20, n_pending=12):
    """harness/preempt_worlds' term-free world (fillers, preemptors that
    must evict, parked nominations) plus a pod that fits nowhere and one
    whose node selector matches no node (unresolvable)."""
    def scenario(A, H, store, sched):
        w = PW.world(A, seed, n_nodes, n_pending, terms=False)
        PW.populate(store, w)
        for p, nn in w.parked:
            sched.queue.add_nominated_pod(p, nn)
        for p in w.pending:
            store.add(p)
        store.add(H.make_pod("too-big", cpu_milli=999999))
        nowhere = H.make_pod("nowhere")
        nowhere.spec.node_selector = {"no-such-label": "x"}
        store.add(nowhere)
        yield
    return scenario


def recorded_drain(which: str, arm=("flight",), roll_every_cycle=False,
                   pipelined=False, **drive_kw) -> dict:
    """preempt_scenario drained through package ``which`` ("jax" or
    "port") with the named recorders armed ("flight", "slo",
    "telemetry"; each fresh, disarmed again at the end), and with
    ``roll_every_cycle`` a telemetry window closed after every
    schedule_pending call; ``pipelined``: the depth-2 pipelined executor
    (gang mode, the chain on).  Returns the drive's per-cycle views, the
    flight view, every SLO observation (pod, outcome, attempts, cycle,
    flight seq, stage names), the SLO stage counts, the window views and
    the rejection counter per plugin."""
    jp, tp = packages()
    pkg = jp if which == "jax" else tp
    root = "kubetpu" if which == "jax" else "kubetpu_torch"
    utrace = importlib.import_module(root + ".utils.trace")
    uslo = importlib.import_module(root + ".utils.slo")
    utel = importlib.import_module(root + ".utils.telemetry")
    metrics_mod = importlib.import_module(root + ".utils.metrics")
    utrace.disarm_flight_recorder()
    uslo.disarm_slo_tracker()
    utel.disarm_telemetry()
    if "flight" in arm:
        utrace.arm_flight_recorder(capacity=256)
    trk = uslo.arm_slo_tracker() if "slo" in arm else None
    ring = (utel.arm_telemetry(window_s=3600.0, capacity=256)
            if "telemetry" in arm else None)
    observed = []
    orig_observe = uslo.SloTracker.observe_pod

    def observe(self, stages, **kw):
        observed.append((kw.get("pod"), kw.get("outcome"),
                         kw.get("attempts"), kw.get("cycle"),
                         kw.get("flight_seq"), tuple(sorted(stages))))
        return orig_observe(self, stages, **kw)

    S = pkg.sched.Scheduler
    orig_pending = S.schedule_pending
    orig_init = S.__init__
    metrics = metrics_mod.SchedulerMetrics()

    def init(self, *a, **kw):
        kw.setdefault("metrics", metrics)
        orig_init(self, *a, **kw)
        self.config.pipeline_cycles = pipelined

    def pending(self, *a, **kw):
        out = orig_pending(self, *a, **kw)
        self.wait_for_inflight_binds(timeout=120.0)
        ring.force_roll(self)
        return out

    uslo.SloTracker.observe_pod = observe
    S.__init__ = init
    if roll_every_cycle:
        S.schedule_pending = pending
    try:
        views, _sched = drive(pkg, preempt_scenario(), **drive_kw)
        out = dict(views=views,
                   rejections=dict(metrics.framework_rejections._vals),
                   flight_dropped_metric=metrics.flight_recorder_dropped
                   .value())
        if "flight" in arm:
            out["flight"] = flight_view(utrace)
        if trk is not None:
            out["slo"] = observed
            doc = trk.to_dict()
            out["slo_counts"] = dict(
                pods=doc["pods"], unresolvable=doc["unresolvable"],
                stages={k: v["count"] for k, v in doc["stages"].items()})
        if ring is not None:
            out["windows"] = [window_view(w) for w in ring.windows()]
        return out
    finally:
        uslo.SloTracker.observe_pod = orig_observe
        S.__init__ = orig_init
        S.schedule_pending = orig_pending
        utrace.disarm_flight_recorder()
        uslo.disarm_slo_tracker()
        utel.disarm_telemetry()
