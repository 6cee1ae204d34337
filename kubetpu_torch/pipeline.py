"""Depth-k pipelined serving executor: overlap prepare(k+1) / device(k) /
commit(k-1).

reference: kubetpu/pipeline.py (``depth_from_env``, ``InflightRing``,
``PipelinedExecutor``), ported with its serialisation rules unchanged.
``pipelineDepth`` (apis/config.py, env ``KUBETPU_PIPELINE_DEPTH``) is the
most cycles in flight at once: depth 1 is the synchronous drain (ring
capacity 0: every cycle commits before the next pops), depth k parks up
to k-1 dispatched cycles between ``schedule_pending`` calls.  Placements
equal the synchronous drain's at every depth: every cycle dispatches
against the previous cycle's speculative chained cluster or the
committed cache, never a state that can diverge.

The port's auction is not asynchronous: it reads a progress flag on the
host once per round (models/gang.py, ``GangResult.syncs``), so
``_dispatch_group`` returns only when the auction's last round is done,
with the packed copy to pinned memory still in flight.  The dispatch runs
inline on the serving thread, so every chain read and drop keeps the
reference's program order; what overlaps the older cycle's commit is that
copy.  A device-side round loop (ROADMAP queue 2) is what would give the
ring device work to overlap.  All device work stays on the one default
stream; no tensor crosses streams.

The correctness machinery, as in the reference:

* DONATION WITHHOLDING: ``_prepare_group``'s ``uncommitted=`` is every
  dispatched-but-uncommitted cycle; the DeltaTensorizer's in-place
  scatter is withheld while any of them still reads the resident
  (``DeltaTensorizer.safe_to_donate``), and the refresh clones instead.
* DEADLINE EXEMPTION per ring slot: commit loops and readbacks of OTHER
  cycles land inside a younger cycle's dispatch->readback window and are
  folded into its ``host_exempt_s``, and parked think time between calls
  too, so host work at depth never recovers a healthy cycle.  So is a
  younger cycle's dispatch, which here runs its whole auction on the
  serving thread inside every older slot's window.
* CHAIN-BREAK RECOVERY BY SCATTER: when cycle j's readback recovers
  (a blown deadline) or its commit fails, every YOUNGER in-flight
  cycle was dispatched against placements that never materialized: each
  is discarded and re-prepared against a fresh snapshot over the pods
  that survived its first prepare; no pod is lost, none binds twice.

The flight recorder's ring-slot tag and the reference's northstar gate
wait for ROADMAP queue 1 item 11; the stage calls on ``prep.trace`` are
the recorder's call sites (utils/trace.py).

Threading: the executor is owned by the serving thread; the ring is
lock-guarded so ``flush_pipeline``/``close`` after a join see one
consistent container.  No dispatch, readback or sleep runs under the
ring lock.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from .framework.types import wallclock
from .ops._build import kernel_fault

PIPELINE_DEPTH_ENV = "KUBETPU_PIPELINE_DEPTH"
DEFAULT_PIPELINE_DEPTH = 2
# the queue's burst-gather window (schedqueue/queue.py pop_batch): pops
# with free pipeline slots may wait this long so an arriving burst lands
# in ONE cycle instead of bucket-churning partial waves
GATHER_WINDOW_S = 0.02


def depth_from_env(default: int) -> int:
    """KUBETPU_PIPELINE_DEPTH overrides the config (an operator can
    re-depth a live fleet); clamped to >= 1."""
    raw = os.environ.get(PIPELINE_DEPTH_ENV)
    try:
        depth = int(raw) if raw else int(default)
    except (TypeError, ValueError):
        depth = int(default) if isinstance(default, int) else \
            DEFAULT_PIPELINE_DEPTH
    return max(depth, 1)


class InflightRing:
    """Bounded ring of dispatched-but-uncommitted cycles, oldest first.

    Each slot holds a ``(PreparedCycle, device result)`` pair between its
    dispatch and its readback+commit.  Capacity = pipeline depth - 1 (the
    cycle being prepared is the +1).  Mutations are lock-guarded; the
    per-slot ``parked_t`` / ``host_exempt_s`` stamps implement the
    per-slot deadline-exemption accounting."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 0)
        self._lock = threading.Lock()
        self._slots: List[Tuple[object, object]] = []  # kubelint: guarded-by(_lock)
        self.high_water = 0  # kubelint: guarded-by(_lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def free(self) -> int:
        with self._lock:
            return self.capacity - len(self._slots)

    def append(self, prep, res) -> None:
        with self._lock:
            self._slots.append((prep, res))
            if len(self._slots) > self.high_water:
                self.high_water = len(self._slots)

    def pop_oldest(self):
        with self._lock:
            return self._slots.pop(0) if self._slots else None

    def detach_all(self) -> List[Tuple[object, object]]:
        with self._lock:
            out = list(self._slots)
            self._slots = []
            return out

    def preps(self) -> List[object]:
        with self._lock:
            return [p for p, _ in self._slots]

    def park(self, now: float) -> None:
        """Stamp caller think time's start on every in-flight cycle —
        wall clock between ``schedule_pending`` calls is host time and
        must not count against any slot's dispatch deadline."""
        with self._lock:
            for prep, _ in self._slots:
                if not prep.parked_t:
                    prep.parked_t = now

    def unpark(self, now: float) -> None:
        """Fold parked think time into every slot's exemption (the twin
        of ``park``; ``_readback_guarded`` folds any stamp that survives
        to a flush-path readback)."""
        with self._lock:
            for prep, _ in self._slots:
                if prep.parked_t:
                    prep.host_exempt_s += now - prep.parked_t
                    prep.parked_t = 0.0

    def exempt(self, seconds: float) -> None:
        """Host seconds spent on OTHER cycles (an older cycle's commit
        loop or readback) land inside every in-flight slot's
        dispatch->readback window — exempt them all.  Parked slots are
        skipped: their whole window is already accruing via parked_t."""
        if seconds <= 0:
            return
        with self._lock:
            for prep, _ in self._slots:
                if not prep.parked_t:
                    prep.host_exempt_s += seconds


class PipelinedExecutor:
    """The depth-k drain.  Owns the ring; borrows the Scheduler's cycle
    primitives (_prepare_group / _dispatch_group / _readback_guarded /
    _commit_group / _recover_cycle): the executor is the control flow,
    the scheduler stays the mechanism.  Serving-thread owned."""

    def __init__(self, sched, depth: int):
        self.sched = sched
        self.depth = max(int(depth), 1)
        self.ring = InflightRing(self.depth - 1)
        # discarded-and-re-prepared cycle count (the scatter-recovery
        # telemetry tests and bench read; serving thread only)
        self.reruns = 0

    # ----------------------------------------------------------- introspection

    def inflight_preps(self) -> List[object]:
        """Every dispatched-but-uncommitted PreparedCycle — the donation
        withholding set ``_prepare_group`` consults."""
        return self.ring.preps()

    def pop_timeout(self, timeout: Optional[float]) -> Optional[float]:
        """Gate the queue's 20 ms burst-gather window on FREE pipeline
        slots: a full ring pops non-blocking (the oldest cycle's commit
        must not wait behind an arrival window), while a ring with free
        slots allows the gather window so an arriving burst lands in one
        cycle instead of splitting into bucket-churning partial waves —
        at depth > 2 the old "non-blocking whenever any slot is
        occupied" rule would have split every burst.  An empty ring
        blocks the caller's full timeout (nothing in flight to flush);
        explicit non-blocking pops (timeout == 0) never wait."""
        n = len(self.ring)
        if n == 0:
            return timeout
        if self.ring.capacity - n <= 0:
            return 0.0
        if timeout is None:
            return GATHER_WINDOW_S
        return min(timeout, GATHER_WINDOW_S)

    # ----------------------------------------------------------------- drain

    def drain(self, max_batch: int, timeout: float) -> List:
        """One ``schedule_pending`` call's worth of pipelined work: pop,
        prepare (overlapping the ring's device work), commit the oldest
        slot when the ring is full, dispatch, park.  Returns outcomes —
        lagging up to depth-1 cycles; an empty pop flushes one in-flight
        cycle per call and ``[] means no work`` holds once the ring is
        dry."""
        s = self.sched
        ring = self.ring
        returned: List = []
        cycle_start = wallclock()
        ring.unpark(cycle_start)
        while True:
            qpods = s.queue.pop_batch(max_batch,
                                      timeout=self.pop_timeout(timeout))
            by_profile: Dict[str, List] = {}
            for qp in qpods:
                if s._skip_pod_schedule(qp.pod):
                    continue
                by_profile.setdefault(qp.pod.spec.scheduler_name,
                                      []).append(qp)
            if len(by_profile) != 1:
                # nothing schedulable: commit the OLDEST in-flight cycle
                # (one per call keeps the outcome cadence).  Multi-profile
                # batches flush the whole ring, then fall back to the
                # synchronous path
                if by_profile:
                    outcomes = returned + self.flush()
                    for name, group in by_profile.items():
                        outcomes.extend(s._schedule_group(
                            s.profiles[name], group))
                else:
                    outcomes = returned + self._commit_oldest()
                if s.metrics and outcomes:
                    s.metrics.observe_cycle(len(outcomes),
                                            wallclock() - cycle_start)
                ring.park(wallclock())
                return outcomes
            (name, group), = by_profile.items()
            fwk = s.profiles[name]
            # ONE relevance walk per cycle, shared with _prepare_group's
            # host-mask gates
            relevance = s._host_relevance(fwk, group)
            if len(ring) and any(rel for rel, _ in relevance.values()):
                # host filter masks and the volume overlay build from the
                # CACHE, which excludes every uncommitted in-flight
                # cycle's placements — preparing now could pass a node an
                # in-flight cycle just filled.  Commit the whole ring
                # first; volume-less batches (the fast path) keep the
                # full-depth overlap.
                returned += self.flush()
            # prepare k: host tensorize work that overlaps the ring's
            # device execution.  uncommitted=ring: no in-flight cycle's
            # buffers may be donated away before its commit-side device
            # work (preemption wave, decision audit) runs
            prep, early = s._prepare_group(fwk, group,
                                           uncommitted=ring.preps(),
                                           relevance=relevance)
            returned += early
            if prep is None:
                outcomes = returned + self.flush()
                if s.metrics and outcomes:
                    s.metrics.observe_cycle(len(outcomes),
                                            wallclock() - cycle_start)
                ring.park(wallclock())
                return outcomes
            if len(ring) and not prep.used_chain:
                # chain break (event landed / vocab overflow / bucket
                # compaction): a fresh rebuild while cycles are
                # uncommitted would miss their placements and could
                # oversubscribe nodes.  Serialize: commit the ring, then
                # re-prepare over the SURVIVING pods only (pods already
                # failed in the first prepare have final outcomes in
                # `early`; re-running _fail would duplicate events)
                returned += self.flush()
                prep, early2 = self._reprepare(prep)
                returned += early2
                if prep is None:
                    ring.park(wallclock())
                    return returned
            # ring full: readback + commit the oldest slot around k's
            # dispatch.  The readback precedes the dispatch, so the
            # oldest's packed copy never waits behind k's auction
            oldest = packed_oldest = None
            if len(ring) and ring.free() <= 0:
                oldest = ring.pop_oldest()
                t0 = wallclock()
                packed_oldest, rec_prev = s._readback_guarded(*oldest)
                ring.exempt(wallclock() - t0)
                if rec_prev is not None:
                    # the oldest's dispatch blew its deadline:
                    # it was recovered (pods requeued, residents
                    # invalidated) — every younger in-flight cycle AND
                    # the just-prepared k descend from its chain, so all
                    # are discarded and re-run against fresh snapshots
                    returned += rec_prev
                    returned += self._rerun_discarded(ring.detach_all())
                    oldest = packed_oldest = None
                    prep, early2 = self._reprepare(prep)
                    returned += early2
                    if prep is None:
                        ring.park(wallclock())
                        return returned
            res = None
            t_disp = wallclock()
            with prep.trace.stage(
                    "dispatch",
                    pipelined=oldest is not None or len(ring) > 0):
                try:
                    res = s._dispatch_group(
                        prep,
                        extra_uncommitted=self._uncommitted_pods(oldest))
                except Exception as e:  # fault at the dispatch seam:
                    # recover k (requeue), still commit the ring
                    if oldest is not None and kernel_fault(e):
                        # k's error propagates: the oldest, read back
                        # already, commits first, so no pod of it is lost
                        self._commit_entry(oldest[0], packed_oldest)
                    returned += s._recover_dispatch_error(prep, e)
            # k's auction ran on this thread: another cycle's time inside
            # every in-flight slot's window
            ring.exempt(wallclock() - t_disp)
            if res is None:
                prep.trace.finish(recovered="dispatch-error")
                if oldest is not None:
                    outs, _failed = self._commit_entry(oldest[0],
                                                       packed_oldest)
                    returned += outs
                returned += self.flush()
                if s.metrics and returned:
                    s.metrics.observe_cycle(len(returned),
                                            wallclock() - cycle_start)
                ring.park(wallclock())
                return returned
            s._last_commit_failed = False
            if oldest is not None:
                # the oldest's commit loop runs on the serving thread
                # while k (and the rest of the ring) execute on device;
                # its wall time is host-exempt for every in-flight slot
                outs, failed = self._commit_entry(oldest[0], packed_oldest,
                                                  exempt_prep=prep)
                returned += outs
                if prep.used_chain and failed:
                    # committing the oldest failed: k (and the younger
                    # ring entries, already re-run by _commit_entry) were
                    # dispatched against placements that never
                    # materialized.  Discard and re-run k synchronously
                    # over the surviving pods only
                    prep, early2 = self._reprepare(prep)
                    returned += early2
                    if prep is None:
                        if s.metrics and returned:
                            s.metrics.observe_cycle(
                                len(returned), wallclock() - cycle_start)
                        ring.park(wallclock())
                        return returned
                    with prep.trace.stage("dispatch"):
                        try:
                            res = s._dispatch_group(prep)
                        except Exception as e:
                            returned += s._recover_dispatch_error(prep, e)
                            prep.trace.finish(recovered="dispatch-error")
                            if s.metrics and returned:
                                s.metrics.observe_cycle(
                                    len(returned),
                                    wallclock() - cycle_start)
                            ring.park(wallclock())
                            return returned
            if ring.capacity == 0:
                # depth 1: fully synchronous — the cycle commits before
                # the next pop (no parking, outcomes never lag)
                returned += self._finish_inflight(prep, res)
                if returned:
                    if s.metrics:
                        s.metrics.observe_cycle(len(returned),
                                                wallclock() - cycle_start)
                    return returned
                continue
            ring.append(prep, res)
            if returned:
                if s.metrics:
                    s.metrics.observe_cycle(len(returned),
                                            wallclock() - cycle_start)
                ring.park(wallclock())
                return returned
            # pipe still priming (cycles dispatched, nothing committed
            # yet): loop to pop the next batch so this call still returns
            # outcomes — "[] means no work" stays true for drain loops

    # ----------------------------------------------------------------- flush

    def flush(self) -> List:
        """Commit every in-flight cycle, oldest first (shutdown, chain
        breaks, host-relevant serialization, and callers that need every
        outcome materialized now)."""
        self.ring.unpark(wallclock())
        outs: List = []
        while len(self.ring):
            outs += self._commit_oldest()
        return outs

    def _commit_oldest(self) -> List:
        """Readback + commit the oldest ring slot (no-op on a dry ring)."""
        entry = self.ring.pop_oldest()
        if entry is None:
            return []
        return self._finish_inflight(*entry)

    def _finish_inflight(self, prep, res) -> List:
        """Readback + commit one detached in-flight cycle.  A pre-commit
        recovery (a blown deadline) or a commit failure re-runs every
        younger in-flight cycle by scatter."""
        s = self.sched
        t0 = wallclock()
        packed, rec = s._readback_guarded(prep, res)
        self.ring.exempt(wallclock() - t0)
        if packed is None:
            # recovered pre-commit: nothing was reserved or bound; the
            # younger in-flight cycles were built on its chain/residents
            s._last_commit_failed = True
            outs = list(rec or [])
            if len(self.ring):
                outs += self._rerun_discarded(self.ring.detach_all())
            return outs
        outs, _failed = self._commit_entry(prep, packed)
        return outs

    def _commit_entry(self, prep, packed, exempt_prep=None) -> Tuple[List, bool]:
        """Commit one already-read-back cycle; its commit-loop wall time
        is exempted for every still-in-flight slot (and exempt_prep, the
        just-dispatched cycle not yet ringed).  Returns (outcomes, THIS
        cycle's commit-failed flag) — a failure re-runs every younger
        ring entry here; the caller handles the un-ringed cycle."""
        s = self.sched
        t0 = wallclock()
        with prep.trace.stage("commit"):
            try:
                outs = s._commit_group(prep, packed)
            except BaseException:
                # a plugin raised: the cycle's pods without an outcome go
                # back to the queue, as the synchronous drain's do
                s._requeue_unsettled(prep.live)
                raise
        failed = s._last_commit_failed
        prep.trace.finish()
        dt = wallclock() - t0
        self.ring.exempt(dt)
        if exempt_prep is not None:
            exempt_prep.host_exempt_s += dt
        if failed and len(self.ring):
            outs += self._rerun_discarded(self.ring.detach_all())
        return outs, failed

    # -------------------------------------------------------------- recovery

    def _reprepare(self, prep) -> Tuple[Optional[object], List]:
        """Discard a prepared (possibly dispatched) cycle and prepare it
        again over the pods that SURVIVED the first prepare — pods that
        already failed there have final outcomes and must not fail (and
        emit events / preemption attempts) twice.  Reuses the cycle's
        recorded relevance map, so the host-plugin walk never re-runs."""
        s = self.sched
        stale = prep.trace
        new_prep, early = s._prepare_group(prep.fwk, prep.live,
                                           relevance=prep.relevance)
        stale.finish(discarded=True)
        return new_prep, early

    def _rerun_discarded(self, entries: List[Tuple[object, object]]) -> List:
        """Scatter recovery: cycles dispatched against a chain whose
        placements never materialized are discarded and re-run
        SYNCHRONOUSLY, oldest first — each re-prepare sees every commit
        that landed before it (cache state), so no pod is lost and none
        can double-bind.  The rare path; depth resumes on the next pop."""
        s = self.sched
        outs: List = []
        for i, (prep_i, _res) in enumerate(entries):
            self.reruns += 1
            try:
                new_prep, early = self._reprepare(prep_i)
                outs += early
                if new_prep is None:
                    continue
                with new_prep.trace.stage("dispatch", rerun=True):
                    try:
                        res = s._dispatch_group(new_prep)
                    except Exception as e:
                        outs += s._recover_dispatch_error(new_prep, e)
                        new_prep.trace.finish(recovered="dispatch-error")
                        continue
                outs += s._finish_group(new_prep, res)
            except BaseException:
                # a kernel fault propagates: the discarded cycles not
                # re-run yet go back to the queue
                for prep_j, _ in entries[i + 1:]:
                    s._requeue_unsettled(prep_j.live)
                raise
        return outs

    # --------------------------------------------------------------- helpers

    def _uncommitted_pods(self, oldest) -> int:
        """Pods dispatched in earlier cycles whose commits have not
        landed yet — the chain bucket guard's fresh-rebuild estimate
        (includes an oldest slot popped for commit but not committed)."""
        total = sum(int(p.batch.valid.shape[0]) for p in self.ring.preps())
        if oldest is not None:
            total += int(oldest[0].batch.valid.shape[0])
        return total
