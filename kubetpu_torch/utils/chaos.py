"""Chaos harness: a seeded, deterministic fault-injection registry.

A copy of kubetpu/utils/chaos.py.  The reference scheduler survives etcd
hiccups, API-server disconnects and crashed binders by design (informer
resync, backoff queues, idempotent commits).  The port adds state
surfaces the reference never had (the device-resident cluster,
state/delta.py, and the CUDA propose kernel behind the gang auction),
each of which can silently corrupt, hang or diverge.  This module makes
those faults first-class: every failure mode the recovery machinery
claims to survive has a NAMED injection point here, armed
deterministically so tests can assert the recovery invariants (serving
thread alive, no lost pods, no double binds, mirror/device consistency)
scenario by scenario.

Injection points threaded through the port:

  ``dispatch``   scheduler.Scheduler._dispatch_group: raise an error the
                 way a dying device does, or inject a stall (the
                 deadline-guarded dispatch's two failure classes).  The
                 cycle is recovered; the kernel route is never demoted
  ``delta``      state/delta.DeltaTensorizer._apply: drop a ClusterDelta
                 application or corrupt the device residents (what the
                 anti-entropy verifier exists to catch)
  ``bind``       plugins/intree.DefaultBinder.bind: transient bind
                 transport error (the binder retry ladder's test feed)
  ``extender``   extender.HTTPExtender._send: transient webhook error
  ``rest``       client/rest.RestClusterStore._req: transient API-server
                 transport error
  ``watch``      client/rest.RestClusterStore._watch_loop: watch
                 disconnect (drives the capped-backoff reconnect)
  ``journal``    utils/journal.CycleJournal.append: a write error, a
                 record truncated mid-write, or a flipped payload byte
                 (each a counted drop or a skip at read time, never a
                 failed cycle)
  ``aot-load``   utils/aot.AotStore.load: truncate a kernel-library
                 artifact's bytes (its sha256 check fails: a counted miss,
                 recoveries{aot-fallback} at prewarm, and the library
                 builds from source)

Arming: ``KUBETPU_CHAOS=<spec>`` at Scheduler construction (read by
``maybe_arm_from_env``), or programmatically (``arm(registry)``) for
tests.  Spec grammar, comma-separated clauses::

    seed=<int>                        registry seed (default 0)
    <point>:<mode>[:k=v]...           arm one injection point

with per-point keys ``n=<max fires>`` (default unlimited), ``p=<prob>``
(default 1.0, drawn from a per-point PRNG seeded by (seed, point) so
decisions are deterministic and independent of arming order) and
``delay=<seconds>`` (stall length, default 0.05).  Example::

    KUBETPU_CHAOS="seed=7,dispatch:error:n=1,delta:corrupt:p=0.25"

Disarmed (the default) every site helper is ONE module-attribute read:
no lock, no allocation, no branch beyond the None check, as the flight
recorder's arming (utils/trace.py); tests/test_torch_chaos.py's poison
test enforces it.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Optional, Tuple

ENV = "KUBETPU_CHAOS"

# point -> modes it supports (parse-time validation: a typo'd clause must
# fail loudly at arm time, not silently never fire)
POINTS: Dict[str, Tuple[str, ...]] = {
    "dispatch": ("error", "stall"),
    "delta": ("drop", "corrupt"),
    "aot-load": ("corrupt",),
    "bind": ("error",),
    "extender": ("error",),
    "rest": ("error",),
    "watch": ("error",),
    "journal": ("error", "truncate", "corrupt"),
}

DEFAULT_STALL_S = 0.05


class ChaosFault(RuntimeError):
    """The injected failure.  Subclasses RuntimeError so sites that catch
    their transport's error family (every seam here catches at least
    Exception) treat it like the real thing.  Its message never names
    CUDA, so ops/_build.kernel_fault never takes it for a fault of the
    kernel path."""


class _Rule:
    """One armed injection point.  Mutable fire counters are guarded by
    the registry lock; the rule itself is write-once at arm time."""

    __slots__ = ("point", "mode", "n", "prob", "delay", "rng", "fired")

    def __init__(self, point: str, mode: str, n: Optional[int],
                 prob: float, delay: float, seed: int):
        self.point = point
        self.mode = mode
        self.n = n
        self.prob = prob
        self.delay = delay
        # per-point stream seeded by (seed, point): deterministic and
        # independent of arming order / other points' draw counts
        self.rng = random.Random("%d:%s" % (seed, point))
        self.fired = 0


class ChaosRegistry:
    """Seeded rule set + fire accounting.

    ``decide()`` is the single choice point: it draws, counts and
    records the incident (a flight-recorder instant on the open cycle,
    when armed) under the registry lock, and returns ``(mode, delay)``
    for the SITE to act on outside the lock — sleeping or raising under
    the lock would trip kubelint's blocking-under-lock family and stall
    unrelated threads' decisions."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._rules: Dict[str, _Rule] = {}   # kubelint: guarded-by(_lock)
        self._fired: Dict[str, int] = {}     # kubelint: guarded-by(_lock)

    def arm_point(self, point: str, mode: str, n: Optional[int] = None,
                  prob: float = 1.0,
                  delay: float = DEFAULT_STALL_S) -> "ChaosRegistry":
        modes = POINTS.get(point)
        if modes is None:
            raise ValueError("unknown chaos point %r (known: %s)"
                             % (point, ", ".join(sorted(POINTS))))
        if mode not in modes:
            raise ValueError("chaos point %r has no mode %r (supported: %s)"
                             % (point, mode, ", ".join(modes)))
        with self._lock:
            self._rules[point] = _Rule(point, mode, n, prob, delay,
                                       self.seed)
        return self

    def decide(self, point: str) -> Optional[Tuple[str, float]]:
        """(mode, delay) when the point fires this call, else None."""
        with self._lock:
            rule = self._rules.get(point)
            if rule is None:
                return None
            if rule.n is not None and rule.fired >= rule.n:
                return None
            if rule.prob < 1.0 and rule.rng.random() >= rule.prob:
                return None
            rule.fired += 1
            self._fired[point] = self._fired.get(point, 0) + 1
            mode, delay = rule.mode, rule.delay
        # incident breadcrumb OUTSIDE the lock: the trace helper takes
        # the cycle record's own lock
        from .trace import note_instant
        note_instant("chaos", point=point, mode=mode)
        return mode, delay

    def counts(self) -> Dict[str, int]:
        """Monotonic per-point fire counts (the
        scheduler_faults_injected_total feed)."""
        with self._lock:
            return dict(self._fired)

    def total_fired(self) -> int:
        with self._lock:
            return sum(self._fired.values())


def parse_spec(spec: str) -> ChaosRegistry:
    """Build a registry from the KUBETPU_CHAOS grammar (docstring above).
    Raises ValueError on any malformed clause — a typo must not silently
    disarm the harness."""
    seed = 0
    clauses = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        if raw.startswith("seed="):
            seed = int(raw[len("seed="):])
            continue
        clauses.append(raw)
    reg = ChaosRegistry(seed=seed)
    for raw in clauses:
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError("chaos clause %r: want point:mode[:k=v...]"
                             % raw)
        point, mode = parts[0], parts[1]
        kw: Dict[str, float] = {}
        for kv in parts[2:]:
            k, _, v = kv.partition("=")
            if k == "n":
                kw["n"] = int(v)
            elif k == "p":
                kw["prob"] = float(v)
            elif k == "delay":
                kw["delay"] = float(v)
            else:
                raise ValueError("chaos clause %r: unknown key %r"
                                 % (raw, k))
        reg.arm_point(point, mode, **kw)
    return reg


# ---------------------------------------------------------------- arming
#
# Same contract as trace.py's recorder: _active is
# read WITHOUT a lock on the hot path (rebinding a reference is atomic; a
# racing reader sees old or new), arm/disarm serialize through
# _active_lock.

_active: Optional[ChaosRegistry] = None
_active_lock = threading.Lock()


def active() -> Optional[ChaosRegistry]:
    return _active


def arm(registry: ChaosRegistry) -> ChaosRegistry:
    global _active
    with _active_lock:
        _active = registry
    return registry


def disarm() -> None:
    global _active
    with _active_lock:
        _active = None


def maybe_arm_from_env() -> Optional[ChaosRegistry]:
    """Scheduler-construction hook: arms from KUBETPU_CHAOS when set.
    Parse errors RAISE — an operator who armed chaos and typo'd the spec
    must find out now, not after the run proved nothing."""
    spec = os.environ.get(ENV, "")
    if not spec:
        return None
    if _active is not None:
        return _active
    return arm(parse_spec(spec))


# ------------------------------------------------------------ site helpers


def action(point: str) -> Optional[str]:
    """The armed mode for ``point`` if it fires this call, else None.
    For sites that implement the fault themselves (delta drop/corrupt).  Disarmed: one attribute read."""
    reg = _active
    if reg is None:
        return None
    decision = reg.decide(point)
    return decision[0] if decision is not None else None


def raise_or_stall(point: str) -> None:
    """Raise ChaosFault (mode "error") or sleep (mode "stall") when the
    point fires; no-op otherwise.  Disarmed: one attribute read."""
    reg = _active
    if reg is None:
        return
    decision = reg.decide(point)
    if decision is None:
        return
    mode, delay = decision
    if mode == "stall":
        time.sleep(delay)
        return
    raise ChaosFault("injected %s fault at %r" % (mode, point))
