"""Per-pod latency SLO layer: streaming quantile sketches + exemplars.

reference: kubetpu/utils/slo.py, copied (the port's counterpart of every
name).  The flight recorder and the decision audit are CYCLE-centric;
this module measures how long an individual pod waited from first queue
admission to bound.  The scheduler threads the timestamps on
``QueuedPodInfo`` (``timestamp``, ``initial_attempt_timestamp``,
``attempts``, ``pop_timestamp``) through pop -> prepare -> dispatch ->
readback -> commit -> bind, and every bound (or terminally
unresolvable) pod lands here as a per-stage latency vector:

  queue_wait   last queue admission -> popped into a cycle
  backoff      first attempt -> last queue admission (retry/backoff debt;
               0 on first-attempt pods)
  cycle_wait   popped -> device dispatch (snapshot, PreFilter, tensorize,
               host masks; includes pipelined parking)
  dispatch     the host share of the dispatch->readback window:
               readback done - dispatch - device - host-exempt, the
               JAX package's formula.  On the card the port's auction
               reads a flag on the host once per round and so returns
               only when its last round is done: this stage then holds
               the round loop's device time too, and ``device`` holds
               only the wait for the packed copy
  device       the cycle's packed-readback block (``device_wait_s``;
               every pod of a cycle shares the cycle's value).  This is
               READBACK-BLOCK host time, not measured device time
  commit       readback done -> this pod's placement committed
  bind         PreBind/Bind/PostBind wall time (binder thread)
  e2e          first attempt -> bound (the SLO number)

Bounded-memory contract: one fixed 128-bucket log-spaced histogram per
stage (numpy int64 counts, no per-pod retention), plus at most
``KUBETPU_SLO_EXEMPLARS`` (default 8) worst-pod exemplars that link back
to the flight-recorder cycle (``flight_seq``) and the decision-audit
entry (``/debug/explain?pod=``) for that pod.  Quantiles are read from
the bucket counts (p50/p90/p99/p999), exact to within one bucket width
(~15.5% relative, 16 buckets per decade).

Arming mirrors the flight recorder (``KUBETPU_SLO=1`` or
``arm_slo_tracker()``): DISARMED (the default) the serving loop reads
one module attribute per cycle and takes ZERO new locks (the poison
test in tests/test_torch_slo.py).  Importing this module imports numpy
only.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np

SLO_ENV = "KUBETPU_SLO"
EXEMPLARS_ENV = "KUBETPU_SLO_EXEMPLARS"
DEFAULT_EXEMPLARS = 8

# the stage keys the scheduler emits, in pipeline order (e2e rides next
# to them but is not a "stage": shares are computed over STAGES only)
STAGES = ("queue_wait", "backoff", "cycle_wait", "dispatch", "device",
          "commit", "bind")

# fixed log-spaced bucket ladder: 16 buckets per decade over
# [100 us, 10^4 s] — 8 decades, 128 edges.  One shared immutable array;
# every sketch is just a [129] int64 count vector against it.
_BUCKETS_PER_DECADE = 16
_EDGE_LO_EXP, _EDGE_HI_EXP = -4, 4
BUCKET_EDGES = np.logspace(
    _EDGE_LO_EXP, _EDGE_HI_EXP,
    num=(_EDGE_HI_EXP - _EDGE_LO_EXP) * _BUCKETS_PER_DECADE + 1)
BUCKET_EDGES.setflags(write=False)
# one bucket's relative width: adjacent edges differ by this ratio
BUCKET_RATIO = float(10 ** (1.0 / _BUCKETS_PER_DECADE))


class QuantileSketch:
    """Bounded-memory streaming quantile estimator over the fixed
    log-spaced ladder: a [len(edges)+1] int64 count vector plus
    sum/min/max.  NOT thread-safe on its own — the owning SloTracker
    serializes access under its lock (like Histogram's per-metric lock,
    but one lock for the whole stage family)."""

    __slots__ = ("counts", "total", "sum_s", "min_s", "max_s")

    def __init__(self):
        self.counts = np.zeros(len(BUCKET_EDGES) + 1, np.int64)
        self.total = 0
        self.sum_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    def observe(self, value: float) -> None:
        v = max(float(value), 0.0)
        # searchsorted('left'): first edge >= v, i.e. the bucket whose
        # UPPER edge bounds v; values past the last edge land in the
        # overflow slot (quantile clamps to max_s)
        self.counts[int(np.searchsorted(BUCKET_EDGES, v))] += 1
        self.total += 1
        self.sum_s += v
        if v < self.min_s:
            self.min_s = v
        if v > self.max_s:
            self.max_s = v

    def quantile(self, q: float) -> float:
        """Upper bucket edge at rank ceil(q * n), clamped to the observed
        [min, max] — within one bucket width of numpy.percentile on the
        same draws (the property test's contract)."""
        if self.total == 0:
            return 0.0
        rank = min(max(int(math.ceil(q * self.total)), 1), self.total)
        cum = 0
        for i, c in enumerate(self.counts.tolist()):
            cum += c
            if cum >= rank:
                edge = (BUCKET_EDGES[i] if i < len(BUCKET_EDGES)
                        else self.max_s)
                return float(min(max(edge, self.min_s), self.max_s))
        return float(self.max_s)

    def to_dict(self, quantiles=(0.5, 0.9, 0.99, 0.999)) -> Dict[str, Any]:
        d: Dict[str, Any] = {"count": int(self.total),
                             "sum_s": round(self.sum_s, 6)}
        if self.total:
            d["min_s"] = round(self.min_s, 6)
            d["max_s"] = round(self.max_s, 6)
            for q in quantiles:
                key = "p" + ("%g" % (q * 100)).replace(".", "")
                d[key + "_s"] = round(self.quantile(q), 6)
        return d


class SloTracker:
    """Per-stage quantile sketches + worst-pod exemplars for bound /
    terminally-unresolvable pods.  Lock-guarded: the serving thread and
    the binder pool both observe (async binds complete on binder
    threads), and /debug/slo reads concurrently."""

    def __init__(self, max_exemplars: Optional[int] = None):
        self.max_exemplars = max_exemplars if max_exemplars is not None \
            else int(os.environ.get(EXEMPLARS_ENV, str(DEFAULT_EXEMPLARS)))
        self._lock = threading.Lock()
        self._sketches: Dict[str, QuantileSketch] = {}
        self._exemplars: List[Dict[str, Any]] = []
        self._pods = 0
        self._unresolvable = 0

    # -- recording ----------------------------------------------------------

    def observe_pod(self, stages: Dict[str, float], *, pod: str = "",
                    namespace: str = "", uid: str = "",
                    outcome: str = "bound", attempts: int = 0,
                    cycle: int = 0, flight_seq: int = 0,
                    journal_seq: int = 0) -> None:
        """Fold one terminal pod's per-stage latency vector in.  stages:
        stage name -> seconds (missing stages are simply not observed);
        an ``e2e`` key is the SLO number and drives exemplar ranking."""
        e2e = float(stages.get("e2e", 0.0))
        with self._lock:
            self._pods += 1
            if outcome != "bound":
                self._unresolvable += 1
            for name, v in stages.items():
                sk = self._sketches.get(name)
                if sk is None:
                    sk = self._sketches[name] = QuantileSketch()
                sk.observe(v)
            ex = self._exemplars
            # second clause only reachable with ex at capacity (> 0):
            # KUBETPU_SLO_EXEMPLARS=0 is the quantiles-only config
            if len(ex) < self.max_exemplars or (
                    ex and e2e > ex[-1]["e2e_s"]):
                entry = {
                    "pod": pod, "namespace": namespace, "uid": uid,
                    "outcome": outcome, "attempts": int(attempts),
                    "e2e_s": round(e2e, 6),
                    "stages_s": {k: round(float(v), 6)
                                 for k, v in stages.items() if k != "e2e"},
                    # the cross-links: the flight-recorder cycle record
                    # (/debug/flightz, CycleRecord.seq), the decision
                    # audit entry (/debug/explain?pod=) and the cycle
                    # journal's record id (0: the journal is not ported)
                    "cycle": int(cycle),
                    "flight_seq": int(flight_seq),
                    "journal_seq": int(journal_seq),
                    "explain": (f"/debug/explain?pod={pod}"
                                f"&namespace={namespace}" if pod else ""),
                }
                ex.append(entry)
                ex.sort(key=lambda e: -e["e2e_s"])
                del ex[self.max_exemplars:]

    def clear(self) -> None:
        with self._lock:
            self._sketches.clear()
            self._exemplars.clear()
            self._pods = 0
            self._unresolvable = 0

    # -- reads --------------------------------------------------------------

    def stage_quantiles(self,
                        quantiles=(0.5, 0.9, 0.99, 0.999)
                        ) -> Dict[str, Dict[str, Any]]:
        # serialize UNDER the lock: a sketch mid-observe is torn
        # (total bumped, min_s still inf -> json Infinity); the whole
        # read is a ~130-bucket walk per stage, cheap enough to hold a
        # debug-endpoint scrape against the observe path
        with self._lock:
            return {name: sk.to_dict(quantiles)
                    for name, sk in sorted(self._sketches.items())}

    def shares(self) -> Dict[str, float]:
        """Each stage's share of the total per-pod latency SUM (e2e
        excluded): the attribution vector that names which stage a
        regression grew in."""
        with self._lock:
            sums = {n: sk.sum_s for n, sk in self._sketches.items()
                    if n != "e2e"}
        total = sum(sums.values())
        if total <= 0:
            return {}
        return {n: round(s / total, 4) for n, s in sorted(sums.items())}

    def exemplars(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._exemplars]

    def counts_snapshot(self) -> Dict[str, Any]:
        """Cumulative raw bucket counts per stage (copies, safe to keep)
        + pod totals, in ONE locked read — the telemetry ring
        (utils/telemetry.py) subtracts two of these one window apart to
        get exact per-window quantiles over the same ladder."""
        with self._lock:
            return {
                "stages": {name: {"counts": sk.counts.copy(),
                                  "sum_s": sk.sum_s}
                           for name, sk in self._sketches.items()},
                "pods": self._pods,
                "unresolvable": self._unresolvable,
            }

    def to_dict(self, quantiles=(0.5, 0.9, 0.99, 0.999)) -> Dict[str, Any]:
        """The /debug/slo document."""
        with self._lock:
            pods, unres = self._pods, self._unresolvable
        return {"armed": True,
                "pods": pods,
                "unresolvable": unres,
                "stages": self.stage_quantiles(quantiles),
                "shares": self.shares(),
                "exemplars": self.exemplars()}


# module arming state — read WITHOUT a lock on the hot path (rebinding a
# Python reference is atomic; a racing reader sees old or new), exactly
# like utils/trace.py's _flight.  arm/disarm serialize via _slo_lock.
_tracker: Optional[SloTracker] = None
_slo_lock = threading.Lock()


def tracker() -> Optional[SloTracker]:
    """The armed tracker, or None (disarmed, the default)."""
    return _tracker


def arm_slo_tracker(max_exemplars: Optional[int] = None) -> SloTracker:
    """Idempotently arm the SLO tracker (returns the existing one if
    already armed)."""
    global _tracker
    with _slo_lock:
        if _tracker is None:
            _tracker = SloTracker(max_exemplars=max_exemplars)
        return _tracker


def disarm_slo_tracker() -> None:
    global _tracker
    with _slo_lock:
        _tracker = None


def maybe_arm_from_env() -> Optional[SloTracker]:
    """Scheduler-construction hook: arms iff KUBETPU_SLO=1."""
    if os.environ.get(SLO_ENV, "0") not in ("", "0", "false", "False"):
        return arm_slo_tracker()
    return None
