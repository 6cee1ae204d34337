"""Step tracing, the cycle FLIGHT RECORDER, and Perfetto trace export.

reference: kubetpu/utils/trace.py, itself after vendor/k8s.io/utils/trace
(utiltrace.Trace) as used by the scheduling cycle
(core/generic_scheduler.go:147-202: steps "Basic checks done",
"Snapshotting scheduler cache and node infos done", "Computing
predicates done", "Prioritizing done", logged when the cycle exceeds
100 ms).

On top of the reference's threshold log, this module is the structured
observability layer: every ``Trace`` carries a span id, parent linkage and
thread tag, and, when the flight recorder is ARMED, the full span tree
of each scheduling cycle (prepare/tensorize steps, dispatch,
packed-readback with device-wait attribution, commit, preemption wave,
per-pod binds, kernel builds, and the queue depths at cycle start) lands
in a lock-guarded ring buffer of the last N cycles (``KUBETPU_FLIGHT_N``,
default 64).  The ring serializes to the Chrome ``traceEvents`` JSON
format (one pid per component, one tid per thread, ``ph: "X"`` spans)
loadable in Perfetto/chrome://tracing, beside the ``torch.profiler``
capture of ``capture_device_trace``.

Bounded-memory contract: the recorder holds AT MOST ``capacity`` cycle
records (older ones are dropped and counted: ``dropped()`` and the
``scheduler_flight_recorder_dropped_total`` metric) and at most
``KUBETPU_FLIGHT_SPANS`` (default 512) spans AND instant events per
cycle (excess is dropped per record and counted in ``span_drops`` /
``event_drops``).  DISARMED (the default) the recorder is a strict no-op:
``Trace`` takes no lock, allocates no record, and the serving loop skips
the queue-depth read.  Importing this module imports neither torch nor
anything else beyond the standard library.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

LOG = logging.getLogger("kubetpu_torch.trace")

SLOW_CYCLE_THRESHOLD = 0.1  # 100 ms (generic_scheduler.go:148 LogIfLong)

# Monotonic wall clock: perf_counter deltas anchored to the process's
# wall epoch, captured ONCE at import.  Every span and duration stamp of
# the port (the queue's timestamps, the dispatch deadline, device-wait,
# the SLO stages) reads wallclock() instead of time.time(): an NTP step
# moves time.time() but not perf_counter, so a step mid-cycle would
# corrupt every duration.  The epoch anchor keeps the values
# wall-meaningful (Perfetto ``ts`` microseconds line up with real time).
_WALL_EPOCH = time.time() - time.perf_counter()


def wallclock() -> float:
    """time.time()-compatible timestamp that can never run backwards
    (see _WALL_EPOCH).  Use for any pair of stamps whose DIFFERENCE is
    a duration."""
    return _WALL_EPOCH + time.perf_counter()


FLIGHT_ENV = "KUBETPU_FLIGHT"
FLIGHT_N_ENV = "KUBETPU_FLIGHT_N"
FLIGHT_SPANS_ENV = "KUBETPU_FLIGHT_SPANS"
DEFAULT_FLIGHT_N = 64
DEFAULT_FLIGHT_SPANS = 512

# While capture_device_trace runs, every Trace phase also opens a
# torch.profiler.record_function range, so the device kernels group under
# the cycle phase names in the profiler's timeline.
_PROFILE_ACTIVE = False


@contextlib.contextmanager
def capture_device_trace(log_dir: str):
    """Capture a torch.profiler trace (CPU and, where there is a card,
    CUDA activity) of the enclosed serving activity and write it as a
    Chrome trace into ``log_dir`` (the counterpart of the JAX package's
    jax.profiler capture).  Host Trace phases appear as record_function
    ranges inside the capture.  Yields the path the trace is written to
    at exit."""
    global _PROFILE_ACTIVE
    import torch
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, "trace-%d.json" % os.getpid())
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    _PROFILE_ACTIVE = True
    try:
        yield path
    finally:
        _PROFILE_ACTIVE = False
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        # devstats' trace hook: armed, the capture folds into per-program
        # device time (or the reason it cannot); disarmed one read
        from . import devstats as _devstats
        ds = _devstats.devstats()
        if ds is not None:
            ds.ingest_trace(path)


def profile_active() -> bool:
    """True while capture_device_trace runs."""
    return _PROFILE_ACTIVE


# --------------------------------------------------------------------- spans


class FlightSpan:
    """One recorded span: a node of a cycle's span tree."""

    __slots__ = ("span_id", "parent_id", "name", "thread", "t0", "t1",
                 "args")

    def __init__(self, span_id: int, parent_id: int, name: str,
                 thread: str, t0: float, t1: Optional[float] = None,
                 args: Optional[Dict[str, Any]] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.thread = thread
        self.t0 = t0
        self.t1 = t1
        self.args = args if args is not None else {}

    def to_dict(self) -> Dict[str, Any]:
        return {"id": self.span_id, "parent": self.parent_id,
                "name": self.name, "thread": self.thread,
                "t0": round(self.t0, 6),
                "t1": round(self.t1 if self.t1 is not None else self.t0, 6),
                "args": dict(self.args)}


class _NullSpan:
    """Reusable no-op context manager: the disarmed hot path allocates
    nothing and takes no lock."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


# thread-local stack of (CycleRecord, FlightSpan) for the spans currently
# OPEN on this thread: parents nested spans and routes instant events
# (note_instant) to the right cycle.  Thread-local, so no lock.
_tls = threading.local()


def _span_stack() -> list:
    st = getattr(_tls, "spans", None)
    if st is None:
        st = []
        _tls.spans = st
    return st


class CycleRecord:
    """The span tree of ONE scheduling cycle.  Spans may be appended from
    multiple threads (serving loop + binder pool), so the lists are
    lock-guarded; the per-record span cap keeps a 4k-pod commit loop from
    ballooning the record (drops are counted, never silent)."""

    def __init__(self, seq: int, label: str,
                 queue_depths: Optional[Dict[str, int]] = None,
                 fields: Optional[Dict[str, Any]] = None,
                 max_spans: int = DEFAULT_FLIGHT_SPANS):
        self.seq = seq
        self.label = label
        self.t0 = wallclock()
        self.t1: Optional[float] = None
        self.queue_depths = dict(queue_depths or {})
        self.meta: Dict[str, Any] = dict(fields or {})
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._spans: List[FlightSpan] = []
        self._events: List[Dict[str, Any]] = []
        self._next_id = 1
        self.span_drops = 0
        self.event_drops = 0

    # -- recording ----------------------------------------------------------

    def begin_span(self, name: str, parent_id: int = 0,
                   t0: Optional[float] = None,
                   **args) -> Optional[FlightSpan]:
        """Open a span; returns None when the per-record cap is hit (the
        drop is counted)."""
        thread = threading.current_thread().name
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.span_drops += 1
                return None
            span = FlightSpan(self._next_id, parent_id, name, thread,
                              t0 if t0 is not None else wallclock(),
                              args=args or {})
            self._next_id += 1
            self._spans.append(span)
        return span

    @staticmethod
    def end_span(span: Optional[FlightSpan],
                 t1: Optional[float] = None) -> None:
        if span is not None:
            span.t1 = t1 if t1 is not None else wallclock()

    def record_span(self, name: str, t0: float, t1: float,
                    parent_id: int = 0, **args) -> Optional[FlightSpan]:
        """Record an already-finished span (e.g. a Trace.step interval)."""
        span = self.begin_span(name, parent_id=parent_id, t0=t0, **args)
        if span is not None:
            span.t1 = t1
        return span

    def event(self, name: str, parent_id: int = 0, **args) -> None:
        """Record an instant event (ph "i" in the Chrome export): kernel
        builds, resyncs, recoveries.  Capped like spans; drops count."""
        ev = {"name": name, "ts": wallclock(), "parent": parent_id,
              "thread": threading.current_thread().name,
              "args": dict(args)}
        with self._lock:
            if len(self._events) >= self.max_spans:
                self.event_drops += 1
                return
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, parent_id: Optional[int] = None, **args):
        """Scoped span: pushes itself on the thread's open-span stack so
        nested spans (and instant events) parent under it.  Yields the
        FlightSpan (or None past the span cap) so callers can attach args
        (e.g. the readback's device_wait_s) before exit."""
        stack = _span_stack()
        if parent_id is None:
            parent_id = (stack[-1][1].span_id
                         if stack and stack[-1][0] is self
                         and stack[-1][1] is not None else 0)
        sp = self.begin_span(name, parent_id=parent_id, **args)
        stack.append((self, sp))
        try:
            yield sp
        finally:
            stack.pop()
            self.end_span(sp)

    # -- introspection ------------------------------------------------------

    def spans(self) -> List[FlightSpan]:
        with self._lock:
            return list(self._spans)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            spans = [s.to_dict() for s in self._spans]
            events = [dict(e) for e in self._events]
            drops = self.span_drops
            ev_drops = self.event_drops
        return {"seq": self.seq, "label": self.label,
                "t0": round(self.t0, 6),
                "t1": round(self.t1 if self.t1 is not None else self.t0, 6),
                "queue_depths": dict(self.queue_depths),
                "meta": dict(self.meta),
                "span_drops": drops, "event_drops": ev_drops,
                "spans": spans, "events": events}


class FlightRecorder:
    """Lock-guarded ring buffer of the last N CycleRecords.

    Bounded-memory contract: at most ``capacity`` records x
    ``max_spans_per_cycle`` spans each are retained; overflow in either
    dimension drops (oldest cycle / newest span) and counts.  Reads
    (``cycles``/``to_dict``/``to_chrome_trace``) snapshot under the lock
    and serialize outside it."""

    def __init__(self, capacity: Optional[int] = None,
                 max_spans_per_cycle: Optional[int] = None):
        self.capacity = capacity or int(
            os.environ.get(FLIGHT_N_ENV, str(DEFAULT_FLIGHT_N)))
        self.max_spans_per_cycle = max_spans_per_cycle or int(
            os.environ.get(FLIGHT_SPANS_ENV, str(DEFAULT_FLIGHT_SPANS)))
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque()
        self._dropped = 0
        self._seq = 0

    def begin_cycle(self, label: str,
                    queue_depths: Optional[Dict[str, int]] = None,
                    fields: Optional[Dict[str, Any]] = None) -> CycleRecord:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return CycleRecord(seq, label, queue_depths=queue_depths,
                           fields=fields,
                           max_spans=self.max_spans_per_cycle)

    def commit_cycle(self, rec: CycleRecord) -> None:
        """Push a finished record into the ring, dropping (and counting)
        the oldest when full."""
        if rec.t1 is None:
            rec.t1 = wallclock()
        with self._lock:
            self._ring.append(rec)
            while len(self._ring) > self.capacity:
                self._ring.popleft()
                self._dropped += 1

    def cycles(self) -> List[CycleRecord]:
        with self._lock:
            return list(self._ring)

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """The /debug/flightz document."""
        recs = self.cycles()
        return {"armed": True, "capacity": self.capacity,
                "max_spans_per_cycle": self.max_spans_per_cycle,
                "dropped": self.dropped(),
                "cycles": [r.to_dict() for r in recs]}

    def to_pipeline_doc(self, workload: str = "") -> Dict[str, Any]:
        """A flat stage/cycle span list of the ring (the JAX package's
        PIPELINE_TRACE.json shape).  ``span_total`` equals the number of
        ``ph: "X"`` events in ``to_chrome_trace()`` for the same ring
        content.  Still-OPEN spans (e.g. an async bind in flight on a
        committed record) are excluded from BOTH exports; the full
        ``to_dict()``/flightz dump still shows them."""
        recs = self.cycles()
        t_base = recs[0].t0 if recs else 0.0
        spans = []
        for rec in recs:
            for s in rec.spans():
                if s.t1 is None:
                    continue
                spans.append({
                    "stage": s.name, "cycle": rec.seq,
                    "thread": s.thread,
                    "span_id": s.span_id, "parent_id": s.parent_id,
                    "start_s": round(s.t0 - t_base, 4),
                    "end_s": round(s.t1 - t_base, 4),
                    **({"args": dict(s.args)} if s.args else {})})
        doc = {"workload": workload,
               "cycles": len(recs),
               "dropped": self.dropped(),
               "span_total": len(spans),
               "device_wait_s": round(sum(
                   s.get("args", {}).get("device_wait_s", 0.0)
                   for s in spans), 3),
               "cycle_meta": [{"seq": r.seq, "label": r.label,
                               "meta": dict(r.meta)} for r in recs],
               "spans": spans}
        if recs:
            doc["total_s"] = round(max((r.t1 or r.t0) for r in recs)
                                   - t_base, 3)
        # the per-pod latency digest (utils/slo.py), the cycle journal's
        # status with its linkage into this ring's live seqs
        # (utils/journal.py), the device block (utils/devstats.py) and the
        # sustained-load digest (utils/telemetry.py) ride the doc when
        # those are armed beside the recorder
        from . import slo as _slo
        trk = _slo.tracker()
        if trk is not None:
            doc["slo"] = {"stages": trk.stage_quantiles(),
                          "shares": trk.shares()}
        from . import journal as _journal
        jr = _journal.journal()
        if jr is not None:
            doc["journal"] = jr.status(flight_seqs={r.seq for r in recs})
        from . import devstats as _devstats
        ds = _devstats.devstats()
        if ds is not None:
            doc["device"] = ds.summary()
        from . import telemetry as _telemetry
        tel = _telemetry.ring()
        if tel is not None:
            doc["load"] = tel.digest()
        return doc

    @staticmethod
    def _component_of(thread: str) -> str:
        if thread.startswith("binder"):
            return "binder"
        if "preempt" in thread:
            return "preemption"
        return "scheduler"

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto/chrome://tracing loadable):
        one pid per component (scheduler/binder/preemption), one tid per
        thread, ``ph: "X"`` complete spans with microsecond timestamps,
        ``ph: "C"`` queue-depth counters at each cycle start, ``ph: "i"``
        instants for events, and ``ph: "M"`` metadata naming processes
        and threads.  The number of "X" events equals
        ``to_pipeline_doc()["span_total"]``."""
        recs = self.cycles()
        events: List[Dict[str, Any]] = []
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[int, str], int] = {}

        def pid_of(component: str) -> int:
            if component not in pids:
                pid = len(pids) + 1
                pids[component] = pid
                events.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": f"kubetpu-{component}"}})
            return pids[component]

        def tid_of(pid: int, thread: str) -> int:
            key = (pid, thread)
            if key not in tids:
                tid = sum(1 for (p, _t) in tids if p == pid) + 1
                tids[key] = tid
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": thread}})
            return tids[key]

        def us(t: float) -> int:
            return int(t * 1e6)

        for rec in recs:
            sched_pid = pid_of("scheduler")
            if rec.queue_depths:
                events.append({"ph": "C", "name": "queue_depth",
                               "pid": sched_pid, "tid": 0,
                               "ts": us(rec.t0),
                               "args": {k: int(v) for k, v
                                        in rec.queue_depths.items()}})
            for s in rec.spans():
                if s.t1 is None:
                    continue   # open span: excluded like to_pipeline_doc
                comp = self._component_of(s.thread)
                pid = pid_of(comp)
                tid = tid_of(pid, s.thread)
                args = {"cycle": rec.seq, "span_id": s.span_id,
                        "parent_id": s.parent_id}
                args.update(s.args)
                events.append({"ph": "X", "name": s.name, "cat": comp,
                               "pid": pid, "tid": tid,
                               "ts": us(s.t0),
                               "dur": max(us(s.t1) - us(s.t0), 0),
                               "args": args})
            for ev in rec.events():
                comp = self._component_of(ev["thread"])
                pid = pid_of(comp)
                tid = tid_of(pid, ev["thread"])
                events.append({"ph": "i", "name": ev["name"], "cat": comp,
                               "pid": pid, "tid": tid, "s": "t",
                               "ts": us(ev["ts"]),
                               "args": dict(ev["args"])})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# module arming state.  The reference is read WITHOUT a lock on the hot
# path (Trace.__init__): rebinding a Python reference is atomic, a racing
# reader sees either the old or the new recorder, and the disarmed fast
# path must not pay a lock acquisition per cycle.  arm/disarm themselves
# serialize through _flight_lock.
_flight: Optional[FlightRecorder] = None
_flight_lock = threading.Lock()


def flight_recorder() -> Optional[FlightRecorder]:
    """The armed recorder, or None (disarmed, the default)."""
    return _flight


def arm_flight_recorder(capacity: Optional[int] = None,
                        max_spans_per_cycle: Optional[int] = None
                        ) -> FlightRecorder:
    """Idempotently arm the flight recorder (returns the existing one if
    already armed)."""
    global _flight
    with _flight_lock:
        if _flight is None:
            _flight = FlightRecorder(
                capacity=capacity,
                max_spans_per_cycle=max_spans_per_cycle)
        return _flight


def disarm_flight_recorder() -> None:
    global _flight
    with _flight_lock:
        _flight = None


def maybe_arm_from_env() -> Optional[FlightRecorder]:
    """Arms the recorder iff KUBETPU_FLIGHT is set to a true value (the
    package's import calls this)."""
    if os.environ.get(FLIGHT_ENV, "0") not in ("", "0", "false", "False"):
        return arm_flight_recorder()
    return None


@contextlib.contextmanager
def flight_span(name: str, **args):
    """Span attached to the CURRENT thread's innermost open cycle span
    (used by code, e.g. the preemption wave's what-if readback, that
    has no handle on the cycle's Trace).  No-op when nothing is open."""
    stack = _span_stack()
    if not stack:
        yield None
        return
    rec, parent = stack[-1]
    with rec.span(name, parent_id=parent.span_id if parent else 0,
                  **args) as sp:
        yield sp


def note_instant(name: str, **args) -> None:
    """Record an instant event on the cycle currently open on this
    thread, the hook for code with no handle on the cycle's Trace.
    Disarmed or outside a cycle this is a no-op."""
    if _flight is None:
        return
    stack = _span_stack()
    if not stack:
        return
    rec, parent = stack[-1]
    rec.event(name, parent_id=parent.span_id if parent else 0, **args)


def note_compile_event(program: str, shapes: str) -> None:
    """Record a kernel build or load (the port's counterpart of an XLA
    compile) as an instant event on the cycle currently open on this
    thread.  Disarmed or outside a cycle this is a no-op."""
    note_instant("xla-compile", program=program, shapes=shapes[:512])


# --------------------------------------------------------------------- Trace


class Trace:
    """The per-cycle step trace (reference: utiltrace.Trace), also the
    flight recorder's cycle handle: when the recorder is armed at
    construction, the Trace owns a CycleRecord, carries a span id, parent
    linkage and thread tag, and every ``step()`` interval becomes a child
    span.  Disarmed, nothing beyond the step list is touched."""

    def __init__(self, name: str, parent: Optional["Trace"] = None,
                 queue_depths: Optional[Dict[str, int]] = None, **fields):
        self.name = name
        self.fields = fields
        self.start = wallclock()
        self.steps: List[Tuple[float, str]] = []
        self.thread = threading.current_thread().name
        self._ann = None
        # flight recorder linkage (no lock taken when disarmed: _flight is
        # read once; None short-circuits everything below)
        fr = _flight
        self._fr = fr
        self.rec: Optional[CycleRecord] = None
        self._root: Optional[FlightSpan] = None
        self.span_id = 0
        self.parent_id = parent.span_id if parent is not None else 0
        if fr is not None:
            self.rec = fr.begin_cycle(name, queue_depths=queue_depths,
                                      fields=dict(fields))
            self._root = self.rec.begin_span(name,
                                             parent_id=self.parent_id)
            if self._root is not None:
                self.span_id = self._root.span_id
        self._last_mark = self.start
        if _PROFILE_ACTIVE:
            self._open_annotation("begin")

    def _close_annotation(self) -> None:
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None

    def _open_annotation(self, label: str) -> None:
        import torch
        self._close_annotation()
        if _PROFILE_ACTIVE:
            self._ann = torch.profiler.record_function(
                f"{self.name}:{label}")
            self._ann.__enter__()

    def step(self, msg: str) -> None:
        now = wallclock()
        self.steps.append((now, msg))
        if self.rec is not None:
            # the interval since the previous mark becomes a child span
            self.rec.record_span(msg, self._last_mark, now,
                                 parent_id=self.span_id)
        self._last_mark = now
        if self._ann is not None or _PROFILE_ACTIVE:
            self._open_annotation(msg)

    def stage(self, name: str, **args):
        """Scoped child span for a cycle stage (dispatch, commit,
        preemption wave...).  Returns a no-op context when disarmed:
        zero allocation, zero locks."""
        if self.rec is None:
            return _NULL_SPAN
        return self.rec.span(name, parent_id=self.span_id, **args)

    def finish(self, **meta) -> None:
        """Commit this cycle's record to the recorder's ring (idempotent;
        no-op when disarmed).  meta lands on the record (e.g.
        discarded=True for a pipelined cycle whose dispatch was thrown
        away)."""
        rec, fr = self.rec, self._fr
        self.rec = None
        if rec is None or fr is None:
            return
        if meta:
            rec.meta.update(meta)
        CycleRecord.end_span(self._root)
        rec.t1 = wallclock()
        fr.commit_cycle(rec)

    def __del__(self):
        # last-resort close so an early-return cycle can never leak an
        # entered record_function range into the rest of the capture
        self._close_annotation()
        # ...and a cycle that unwound on an exception still commits its
        # record: the crashing cycle is exactly the one the flight
        # recorder exists to capture
        try:
            if self.rec is not None:
                self.finish(aborted=True)
        except Exception:
            pass

    def total(self) -> float:
        return wallclock() - self.start

    def log_if_long(self, threshold: float = SLOW_CYCLE_THRESHOLD
                    ) -> Optional[str]:
        self._close_annotation()
        total = self.total()
        if total < threshold:
            return None
        fields = ",".join(f"{k}:{v}" for k, v in self.fields.items())
        lines = [f'Trace "{self.name}" ({fields}) '
                 f'(total {total * 1000:.0f}ms):']
        last = self.start
        for ts, msg in self.steps:
            lines.append(f"  ---\"{msg}\" {(ts - last) * 1000:.0f}ms")
            last = ts
        out = "\n".join(lines)
        LOG.info(out)
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.log_if_long()
        self.finish()
        return False
