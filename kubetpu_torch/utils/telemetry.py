"""Sustained-load telemetry plane: a windowed time-series ring.

reference: kubetpu/utils/telemetry.py, copied.  The flight recorder
(utils/trace.py) and the SLO sketches (utils/slo.py) aggregate over a
WHOLE RUN with no time axis, so neither can state *steady-state*
``pod_e2e_p99_s`` under continuous churn.  This module is that time
axis: on a fixed cadence (``KUBETPU_TELEMETRY_WINDOW`` seconds, default
5) the serving loop's tick seam rolls one WINDOW record into a bounded
ring (default 720 windows ~= 1 h at the default cadence), and each
window carries

  * per-stage latency sketches DELTA-MERGED from the SLO tracker's
    cumulative log-ladder counts: the per-window p50/p99 are exact
    window quantiles over the same bucket ladder, not run-cumulative
    numbers that warmup pollutes forever;
  * queue depths, cycle / delta-cycle / resync counts and the last
    auction round count;
  * recovery events that landed IN this window (tracked by object
    identity against ``sched.recovery_log``'s tail);
  * flight-recorder drop deltas.

The JAX ring's journal and devstats deltas read recorders the port does
not have: their gathers return None, as the JAX ones do with those
recorders disarmed, and the window carries no such keys.

The ring is served at ``/debug/loadz`` (server.py), exported as
Prometheus series on ``/metrics`` (utils/metrics.py), and summarized as
the ``load`` block of the flight recorder's pipeline doc.

Steady-state detection (``steady_state_span``) is the open-loop
harness's gate half: the earliest suffix of the windowed e2e-p99 series
whose least-squares slope is flat relative to its mean; warmup windows
are excluded by the slope test, not by a hand-picked cut.
``harness/perf.py``'s SustainedLoadRunner injects at TARGET rate
regardless of scheduler backpressure and records offered vs. completed
(the coordinated-omission defense), and reads its verdict from this
ring.

Arming mirrors the other recorders (``KUBETPU_TELEMETRY=1`` or
``arm_telemetry()``): DISARMED (the default) the serving loop reads ONE
module attribute per cycle and takes ZERO new locks (the poison test in
tests/test_torch_telemetry.py), and armed-vs-disarmed placements are
identical.
"""

from __future__ import annotations

import math
import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .slo import BUCKET_EDGES
from .trace import wallclock

TELEMETRY_ENV = "KUBETPU_TELEMETRY"
WINDOW_ENV = "KUBETPU_TELEMETRY_WINDOW"
CAPACITY_ENV = "KUBETPU_TELEMETRY_N"
DEFAULT_WINDOW_S = 5.0
DEFAULT_CAPACITY = 720          # ~1 h at the 5 s default cadence

# windows keep the full per-stage delta ladder only for e2e (the gate
# number needs exact cross-window merges); other stages keep scalar
# summaries — a window record stays a few KB, bounding the ring
_QUANTS = (0.5, 0.99)

# at most this many recovery-event dicts ride a window record verbatim
# (counts are always exact; the verbatim entries are the debug sample)
_MAX_RECOVERIES_PER_WINDOW = 8


def quantile_from_counts(counts: np.ndarray, q: float) -> float:
    """Upper-bucket-edge quantile over a raw per-bucket count vector on
    the shared slo.py ladder (``[len(BUCKET_EDGES)+1] int64``; the last
    slot is the overflow bucket, clamped to the last edge).  This is the
    window-delta twin of QuantileSketch.quantile — same rank rule, but
    over SUBTRACTED counts, so two cumulative snapshots one window apart
    yield the exact quantile of that window's observations."""
    total = int(counts.sum())
    if total <= 0:
        return 0.0
    rank = min(max(int(math.ceil(q * total)), 1), total)
    cum = 0
    edges = BUCKET_EDGES
    for i, c in enumerate(counts.tolist()):
        cum += int(c)
        if cum >= rank:
            return float(edges[i] if i < len(edges) else edges[-1])
    return float(edges[-1])


def steady_state_span(p99s: List[float], min_windows: int = 6,
                      slope_frac: float = 0.15
                      ) -> Optional[Tuple[int, int]]:
    """(start index, length) of the EARLIEST suffix of the windowed-p99
    series that is statistically flat — least-squares slope times the
    suffix's span at most ``slope_frac`` of the suffix mean — and at
    least ``min_windows`` long.  None when no suffix qualifies.  This is
    the warmup cut: compiles and cache fills inflate the leading
    windows, and a hand-picked warmup count would either waste steady
    windows or leak warmup into the gate number."""
    n = len(p99s)
    for start in range(0, n - min_windows + 1):
        tail = p99s[start:]
        m = len(tail)
        mean = sum(tail) / m
        if mean <= 0:
            return (start, m)
        xs = range(m)
        xbar = (m - 1) / 2.0
        sxx = sum((x - xbar) ** 2 for x in xs)
        if sxx == 0:
            return (start, m)
        slope = sum((x - xbar) * (y - mean)
                    for x, y in zip(xs, tail)) / sxx
        if abs(slope) * (m - 1) <= slope_frac * mean:
            return (start, m)
    return None


def _stage_block(delta: np.ndarray, sum_s: float) -> Dict[str, Any]:
    """One stage's per-window summary from its DELTA count vector."""
    d = {"count": int(delta.sum()), "sum_s": round(max(sum_s, 0.0), 6)}
    if d["count"]:
        for q in _QUANTS:
            key = "p" + ("%g" % (q * 100)).replace(".", "")
            d[key + "_s"] = round(quantile_from_counts(delta, q), 6)
    return d


def _gather_slo() -> Optional[Dict[str, Any]]:
    """Cumulative SLO snapshot (counts per stage + pods/unresolvable),
    or None when the tracker is disarmed."""
    from . import slo as _slo
    trk = _slo.tracker()
    if trk is None:
        return None
    return trk.counts_snapshot()


def _gather_device() -> Optional[Dict[str, float]]:
    """Cumulative devstats totals: always None, as the JAX gather returns
    with devstats disarmed (devstats is not ported)."""
    return None


def _gather_journal() -> Optional[Dict[str, int]]:
    """Cumulative journal record/drop totals: always None, as the JAX
    gather returns with the journal disarmed (the cycle journal is not
    ported)."""
    return None


def _gather_flight() -> Optional[Dict[str, int]]:
    """Cumulative flight-recorder drop count + newest live cycle seq
    (the window's cross-link into /debug/flightz), or None."""
    from . import trace as _trace
    fr = _trace.flight_recorder()
    if fr is None:
        return None
    recs = fr.cycles()
    return {"dropped": int(fr.dropped()),
            "last_seq": int(recs[-1].seq) if recs else 0}


class TelemetryRing:
    """Bounded ring of window records.  Two locks, strictly ordered
    ``_roll_lock`` -> ``_lock``: the roll lock serializes snapshot
    gathering + delta state (ALL cross-layer I/O happens under it and
    it is only ever taken from the tick seam, never from readers); the
    ring lock guards only the deque append and the reader copies, so a
    /debug/loadz scrape can never stall a roll's gather and vice
    versa."""

    def __init__(self, window_s: Optional[float] = None,
                 capacity: Optional[int] = None):
        if window_s is None:
            window_s = float(os.environ.get(WINDOW_ENV,
                                            str(DEFAULT_WINDOW_S)))
        if capacity is None:
            capacity = int(os.environ.get(CAPACITY_ENV,
                                          str(DEFAULT_CAPACITY)))
        self.window_s = max(float(window_s), 1e-3)
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._roll_lock = threading.Lock()
        self._windows: deque = deque() 
        self._dropped = 0              
        self._seq = 0                  
        # deadline for the next roll: READ LOCK-FREE on the tick fast
        # path (rebinding a float is atomic — a racing reader sees the
        # old or the new deadline, and the roll lock serializes actual
        # rolls), WRITTEN only under _roll_lock
        self._deadline = wallclock() + self.window_s
        # previous cumulative snapshots the next roll subtracts from —
        # only ever touched under _roll_lock
        self._prev_slo: Optional[Dict[str, Any]] = None
        self._prev_sched: Optional[Dict[str, float]] = None
        self._prev_device: Optional[Dict[str, float]] = None
        self._prev_journal: Optional[Dict[str, int]] = None
        self._prev_flight: Optional[Dict[str, int]] = None
        self._last_recovery = None      # identity of the last-seen tail
        self._t_open = wallclock()    

    # -- recording (the serving-loop seam) ------------------------------

    def maybe_tick(self, sched) -> None:
        """Serving-loop seam: roll a window iff the cadence elapsed.
        The fast path is ONE float compare — no locks taken until a roll
        is actually due (once per window, not per cycle)."""
        if wallclock() < self._deadline:
            return
        with self._roll_lock:
            # re-check under the roll lock: a racing ticker may have
            # rolled this window already
            if wallclock() < self._deadline:
                return
            self._roll(sched)

    def force_roll(self, sched=None) -> Dict[str, Any]:
        """Close the current window NOW regardless of cadence (test hook,
        and the open-loop runner's tail window)."""
        with self._roll_lock:
            return self._roll(sched)

    def _roll(self, sched) -> Dict[str, Any]:
        # entered with _roll_lock held.  EVERY gather below runs outside
        # the ring lock; only the final append takes it.
        now = wallclock()
        slo = _gather_slo()
        device = _gather_device()
        journal = _gather_journal()
        flight = _gather_flight()
        sched_tot = self._read_sched(sched)
        depths = None
        if sched is not None:
            # the queue read takes the queue's condition lock — allowed
            # here because telemetry is ARMED (opt-in), mirroring the
            # flight recorder's gated depths read in _prepare_group
            depths = sched.queue.depths()
        rec: Dict[str, Any] = {
            "t0": round(self._t_open, 6),
            "t1": round(now, 6),
            "window_s": round(now - self._t_open, 6),
        }
        rec.update(self._delta_sched(sched_tot))
        rec.update(self._delta_slo(slo))
        rec.update(self._delta_recoveries(sched))
        rec.update(self._delta_io(journal, flight))
        rec.update(self._delta_device(device))
        if depths is not None:
            rec["queue_depths"] = depths
        if flight is not None:
            rec["flight_seq"] = flight["last_seq"]
        self._prev_slo = slo
        self._prev_sched = sched_tot
        self._prev_device = device
        self._prev_journal = journal
        self._prev_flight = flight
        self._t_open = now
        # schedule the NEXT roll relative to now, not the nominal grid:
        # a stalled serving loop then yields one long window (window_s
        # says how long), never a burst of zero-length catch-up windows
        self._deadline = now + self.window_s
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._windows.append(rec)
            if len(self._windows) > self.capacity:
                self._windows.popleft()
                self._dropped += 1
        return rec

    def _read_sched(self, sched) -> Optional[Dict[str, float]]:
        """Racy-but-atomic cumulative counter reads off the scheduler
        (atomic attribute reads, no lock)."""
        if sched is None:
            return None
        return {"cycles": float(sched.cycle_count),
                "delta_cycles": float(sched.delta_cycle_count),
                "resyncs": float(sched.resync_count),
                "device_wait_s": float(sched.device_wait_s),
                "gang_rounds_last": float(sched.last_gang_rounds)}

    def _delta_sched(self, cur) -> Dict[str, Any]:
        if cur is None:
            return {}
        prev = self._prev_sched or {k: 0.0 for k in cur}
        return {"cycles": int(cur["cycles"] - prev.get("cycles", 0.0)),
                "delta_cycles": int(cur["delta_cycles"]
                                    - prev.get("delta_cycles", 0.0)),
                "resyncs": int(cur["resyncs"] - prev.get("resyncs", 0.0)),
                "device_wait_s": round(
                    max(cur["device_wait_s"]
                        - prev.get("device_wait_s", 0.0), 0.0), 6),
                "gang_rounds_last": int(cur["gang_rounds_last"])}

    def _delta_slo(self, cur) -> Dict[str, Any]:
        if cur is None:
            return {}
        prev = self._prev_slo
        stages: Dict[str, Any] = {}
        e2e_delta = None
        for name, blk in cur["stages"].items():
            pblk = (prev or {"stages": {}})["stages"].get(name)
            delta = blk["counts"] - pblk["counts"] if pblk is not None \
                else blk["counts"].copy()
            np.maximum(delta, 0, out=delta)   # clear() mid-window
            dsum = blk["sum_s"] - (pblk["sum_s"] if pblk else 0.0)
            stages[name] = _stage_block(delta, dsum)
            if name == "e2e":
                e2e_delta = delta
        ppods = (prev or {}).get("pods", 0)
        punres = (prev or {}).get("unresolvable", 0)
        out: Dict[str, Any] = {
            "stages": stages,
            "pods": max(int(cur["pods"] - ppods), 0),
            "unresolvable": max(int(cur["unresolvable"] - punres), 0),
        }
        if e2e_delta is not None:
            # the raw e2e delta ladder rides the record (stripped from
            # JSON exports) so steady windows merge to an EXACT
            # steady-state quantile instead of a quantile-of-quantiles
            out["_e2e_counts"] = e2e_delta
        return out

    def _delta_recoveries(self, sched) -> Dict[str, Any]:
        log = getattr(sched, "recovery_log", None)
        if log is None:
            return {}
        entries = list(log)
        start = 0
        if self._last_recovery is not None:
            for i in range(len(entries) - 1, -1, -1):
                if entries[i] is self._last_recovery:
                    start = i + 1
                    break
        new = entries[start:]
        if entries:
            self._last_recovery = entries[-1]
        demoted = sum(len(e.get("demoted") or ()) for e in new)
        out: Dict[str, Any] = {"recoveries": len(new),
                               "demotions": int(demoted)}
        if new:
            out["recovery_events"] = [
                {"kind": e.get("kind", ""), "cycle": int(e.get("cycle", 0)),
                 "demoted": len(e.get("demoted") or ())}
                for e in new[:_MAX_RECOVERIES_PER_WINDOW]]
        return out

    def _delta_io(self, journal, flight) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if journal is not None:
            pj = self._prev_journal or {}
            out["journal_records"] = max(
                journal["records_total"] - pj.get("records_total", 0), 0)
            out["journal_dropped"] = max(
                journal["dropped_total"] - pj.get("dropped_total", 0), 0)
        if flight is not None:
            pf = self._prev_flight or {}
            out["flight_dropped"] = max(
                flight["dropped"] - pf.get("dropped", 0), 0)
        return out

    def _delta_device(self, cur) -> Dict[str, Any]:
        if cur is None:
            return {}
        prev = self._prev_device or {}
        return {"device_time_s": round(
                    max(cur["device_time_s"]
                        - prev.get("device_time_s", 0.0), 0.0), 6),
                "fence_wait_s": round(
                    max(cur["fence_wait_s"]
                        - prev.get("fence_wait_s", 0.0), 0.0), 6),
                "ledger_bytes": int(cur["ledger_bytes"]),
                "ledger_delta_bytes": int(
                    cur["ledger_bytes"] - prev.get("ledger_bytes", 0.0))}

    # -- reads ----------------------------------------------------------

    def windows(self) -> List[Dict[str, Any]]:
        """Oldest-first window records (the raw internal shape — e2e
        delta ladders included; exports strip them)."""
        with self._lock:
            return list(self._windows)

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._roll_lock:
            self._prev_slo = None
            self._prev_sched = None
            self._prev_device = None
            self._prev_journal = None
            self._prev_flight = None
            self._last_recovery = None
            self._t_open = wallclock()
            self._deadline = self._t_open + self.window_s
            with self._lock:
                self._windows.clear()
                self._dropped = 0

    def e2e_p99_series(self) -> List[float]:
        """Per-window e2e p99 seconds — zeros for windows that saw no
        terminal pods (the steady-state slope test's input)."""
        return [w.get("stages", {}).get("e2e", {}).get("p99_s", 0.0)
                for w in self.windows()]

    def steady_quantile(self, start: int, n: int, q: float = 0.99
                        ) -> float:
        """EXACT quantile over the merged raw e2e ladders of windows
        [start, start+n) — the gate number.  Falls back to the max of
        the per-window quantiles when no window kept a ladder (SLO
        tracker disarmed)."""
        wins = self.windows()[start:start + n]
        merged = None
        for w in wins:
            counts = w.get("_e2e_counts")
            if counts is None:
                continue
            merged = counts.copy() if merged is None else merged + counts
        if merged is not None and int(merged.sum()) > 0:
            return quantile_from_counts(merged, q)
        return max((w.get("stages", {}).get("e2e", {}).get("p99_s", 0.0)
                    for w in wins), default=0.0)

    @staticmethod
    def _public(w: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in w.items() if not k.startswith("_")}

    def digest(self) -> Dict[str, Any]:
        """The pipeline-doc ``load`` block: window count + cadence,
        drops, the steady-state span over the e2e-p99 series, the
        steady-state p99 (exact merged), total demotions, and the worst
        window (by e2e p99) with its flight_seq cross-link — everything a
        one-line "load:" digest needs."""
        wins = self.windows()
        d: Dict[str, Any] = {"windows": len(wins),
                             "window_s": self.window_s,
                             "dropped": self.dropped()}
        if not wins:
            return d
        p99s = [w.get("stages", {}).get("e2e", {}).get("p99_s", 0.0)
                for w in wins]
        d["demotions"] = sum(int(w.get("demotions", 0)) for w in wins)
        d["pods"] = sum(int(w.get("pods", 0)) for w in wins)
        worst_i = max(range(len(wins)), key=lambda i: p99s[i])
        d["worst_window"] = {"seq": wins[worst_i].get("seq", 0),
                             "p99_s": round(p99s[worst_i], 6),
                             "flight_seq": wins[worst_i].get(
                                 "flight_seq", 0)}
        span = steady_state_span(p99s)
        if span is not None:
            start, n = span
            d["steady"] = {
                "start": start, "windows": n,
                "p99_s": round(self.steady_quantile(start, n, 0.99), 6),
                "p50_s": round(self.steady_quantile(start, n, 0.5), 6)}
        return d

    def to_dict(self, last: Optional[int] = None) -> Dict[str, Any]:
        """The /debug/loadz document: digest + the (optionally tail-
        limited) window records, raw ladders stripped."""
        wins = [self._public(w) for w in self.windows()]
        if last is not None and last >= 0:
            wins = wins[-last:] if last else []
        return {"armed": True,
                "capacity": self.capacity,
                "digest": self.digest(),
                "windows": wins}


# module arming state — read WITHOUT a lock on the hot path (rebinding a
# Python reference is atomic; a racing reader sees old or new), exactly
# like utils/slo.py's _tracker.  arm/disarm serialize via _tel_lock.
_ring: Optional[TelemetryRing] = None
_tel_lock = threading.Lock()


def ring() -> Optional[TelemetryRing]:
    """The armed telemetry ring, or None (disarmed, the default)."""
    return _ring


def arm_telemetry(window_s: Optional[float] = None,
                  capacity: Optional[int] = None) -> TelemetryRing:
    """Idempotently arm the telemetry ring (returns the existing one if
    already armed — one ring per process)."""
    global _ring
    with _tel_lock:
        if _ring is None:
            _ring = TelemetryRing(window_s=window_s, capacity=capacity)
        return _ring


def disarm_telemetry() -> None:
    global _ring
    with _tel_lock:
        _ring = None


def maybe_arm_from_env() -> Optional[TelemetryRing]:
    """Scheduler-construction hook: arms iff KUBETPU_TELEMETRY=1."""
    if os.environ.get(TELEMETRY_ENV, "0") not in ("", "0", "false",
                                                  "False"):
        return arm_telemetry()
    return None
