"""Scheduling queue: the reference's 3-queue PriorityQueue design.

reference: pkg/scheduler/internal/queue/scheduling_queue.go —
PriorityQueue :113 with
  activeQ        heap of pods ready to schedule (QueueSort less-func)
  podBackoffQ    heap ordered by backoff expiry (:131-135)
  unschedulableQ map of pods waiting for a cluster event (:46-48)
plus the PodNominator (nominated pods per node, framework/v1alpha1
interface.go:537) which this class embeds like the reference does.

Flow mirrors the reference exactly:
  Pop :378 blocks until activeQ non-empty; increments schedulingCycle.
  AddUnschedulableIfNotPresent :297 routes a failed pod to backoffQ when a
    move request arrived during its scheduling cycle, else unschedulableQ.
  MoveAllToActiveOrBackoffQueue :500 (cluster event) moves unschedulable
    pods to backoffQ (still backing off) or activeQ, bumps moveRequestCycle.
  flush_backoff_completed :241-243 (1 s period) promotes expired backoff.
  flush_unschedulable_leftover (30 s period) moves pods stuck > 60 s.
Backoff is exponential per attempt: 1 s * 2^attempts capped at 10 s
(reference: scheduler.go:205-206 podInitialBackoff/podMaxBackoff,
scheduling_queue.go:803 calculateBackoffDuration).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..api import types as api
from ..framework.types import QueuedPodInfo, pod_with_affinity, wallclock
from ..utils import slo as uslo
from .heap import Heap

DEFAULT_POD_INITIAL_BACKOFF = 1.0   # reference: scheduler.go:205
DEFAULT_POD_MAX_BACKOFF = 10.0      # reference: scheduler.go:206
UNSCHEDULABLE_TIMEOUT = 60.0        # reference: scheduling_queue.go:48
BACKOFF_FLUSH_PERIOD = 1.0          # reference: scheduling_queue.go:243
UNSCHEDULABLE_FLUSH_PERIOD = 30.0   # reference: scheduling_queue.go:46


def default_sort_key(qp: QueuedPodInfo):
    """PrioritySort order: higher priority first, FIFO tie-break on the
    queue timestamp (reference: queuesort/priority_sort.go:40-45).  Sort
    keys are snapshotted at push time (see heap.py) so in-place
    QueuedPodInfo mutation cannot corrupt the heap."""
    return (-qp.pod.priority(), qp.timestamp)


def _pod_key(pod: api.Pod) -> str:
    return f"{pod.namespace}/{pod.metadata.name}"


class PodNominator:
    """Tracks pods nominated to nodes by preemption
    (reference: framework/v1alpha1/interface.go:537 PodNominator,
    scheduling_queue.go:737 nominatedPodMap)."""

    def __init__(self):
        self._nominated: Dict[str, List[api.Pod]] = {}  # kubelint: guarded-by(_lock)
        self._nominated_pod_to_node: Dict[str, str] = {}  # kubelint: guarded-by(_lock)
        self._lock = threading.Lock()

    def add_nominated_pod(self, pod: api.Pod, node_name: str) -> None:
        with self._lock:
            self._add(pod, node_name)

    def _add(self, pod: api.Pod, node_name: str) -> None:
        # always delete first (reference: scheduling_queue.go:756)
        self._delete(pod)
        nn = node_name or pod.status.nominated_node_name
        if not nn:
            return
        self._nominated_pod_to_node[pod.uid] = nn
        lst = self._nominated.setdefault(nn, [])
        if not any(p.uid == pod.uid for p in lst):
            lst.append(pod)

    def delete_nominated_pod_if_exists(self, pod: api.Pod) -> None:
        with self._lock:
            self._delete(pod)

    def _delete(self, pod: api.Pod) -> None:
        nn = self._nominated_pod_to_node.pop(pod.uid, None)
        if nn is None:
            return
        lst = self._nominated.get(nn, [])
        self._nominated[nn] = [p for p in lst if p.uid != pod.uid]
        if not self._nominated[nn]:
            del self._nominated[nn]

    def update_nominated_pod(self, old: api.Pod, new: api.Pod) -> None:
        with self._lock:
            # preserve nomination during update (reference: :774)
            node = self._nominated_pod_to_node.get(old.uid, "")
            self._delete(old)
            self._add(new, node)

    def nominated_pods_for_node(self, node_name: str) -> List[api.Pod]:
        with self._lock:
            return list(self._nominated.get(node_name, []))

    def all_nominated(self) -> List[Tuple[api.Pod, str]]:
        """Every (pod, nominated node) pair.  The reference iterates
        NominatedPodsForNode per candidate node inside addNominatedPods
        (generic_scheduler.go:530); the batched overlay wants them all at
        once."""
        with self._lock:
            return [(p, nn) for nn, pods in self._nominated.items()
                    for p in pods]


class SchedulingQueue(PodNominator):
    """reference: scheduling_queue.go:113 PriorityQueue."""

    def __init__(self,
                 sort_key: Callable[[QueuedPodInfo], tuple] = default_sort_key,
                 pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
                 pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
                 # wallclock, not time.time: backoff is a duration, and
                 # an NTP step must not corrupt it.  Tests can inject a
                 # fake clock.
                 clock: Callable[[], float] = wallclock,
                 metrics=None):
        super().__init__()
        self._clock = clock
        self._initial_backoff = pod_initial_backoff
        self._max_backoff = pod_max_backoff
        self._cond = threading.Condition()
        self._closed = False
        key = lambda qp: _pod_key(qp.pod)
        m = metrics
        self.active_q = Heap(key, sort_key,  # kubelint: guarded-by(_cond)
                             m.active_recorder() if m else None)
        self.backoff_q = Heap(key, self._backoff_time,  # kubelint: guarded-by(_cond)
                              m.backoff_recorder() if m else None)
        self.unschedulable_q: Dict[str, QueuedPodInfo] = {}  # kubelint: guarded-by(_cond)
        self._unschedulable_recorder = m.unschedulable_recorder() if m else None
        self._metrics = metrics
        self.scheduling_cycle = 0           # reference: :120
        self.move_request_cycle = -1        # reference: :125
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- backoff ------------------------------------------------------------

    def _backoff_time(self, qp: QueuedPodInfo) -> float:
        """reference: scheduling_queue.go:795 getBackoffTime /
        :803 calculateBackoffDuration."""
        d = self._initial_backoff
        for _ in range(qp.attempts - 1):
            d *= 2
            if d >= self._max_backoff:
                return qp.timestamp + self._max_backoff
        return qp.timestamp + min(d, self._max_backoff)

    def _is_backing_off(self, qp: QueuedPodInfo) -> bool:
        return self._backoff_time(qp) > self._clock()

    # -- core ops -----------------------------------------------------------

    def add(self, pod: api.Pod) -> None:
        """New pending pod -> activeQ (reference: :270 Add)."""
        with self._cond:
            qp = self._new_queued_pod_info(pod)
            self.active_q.add(qp)
            self.backoff_q.delete(qp)
            self.unschedulable_q.pop(_pod_key(pod), None)
            # via the public wrapper: the nominator maps are _lock-guarded
            # and preemption threads mutate them concurrently — the old
            # direct self._add() bypassed _lock (caught by
            # concurrency/unguarded-access)
            self.add_nominated_pod(pod, "")
            if self._metrics:
                self._metrics.incoming("PodAdd", "active")
            self._cond.notify()

    def _new_queued_pod_info(self, pod: api.Pod) -> QueuedPodInfo:
        now = self._clock()
        return QueuedPodInfo(pod=pod, timestamp=now,
                             initial_attempt_timestamp=now)

    def add_unschedulable_if_not_present(self, qp: QueuedPodInfo,
                                         pod_scheduling_cycle: int) -> None:
        """Failed pod back into the queue (reference: :297)."""
        with self._cond:
            k = _pod_key(qp.pod)
            if k in self.unschedulable_q:
                raise ValueError(f"pod {k} already in unschedulableQ")
            if self.active_q.get(qp) is not None:
                raise ValueError(f"pod {k} already in activeQ")
            if self.backoff_q.get(qp) is not None:
                raise ValueError(f"pod {k} already in backoffQ")
            qp.timestamp = self._clock()
            # a move request happened while this pod was being scheduled:
            # skip unschedulableQ so the new cluster state is retried
            # promptly (reference: :316-326)
            if self.move_request_cycle >= pod_scheduling_cycle:
                self.backoff_q.add(qp)
                if self._metrics:
                    self._metrics.incoming("ScheduleAttemptFailure", "backoff")
            else:
                self.unschedulable_q[k] = qp
                if self._unschedulable_recorder:
                    self._unschedulable_recorder.inc()
                if self._metrics:
                    self._metrics.incoming("ScheduleAttemptFailure",
                                           "unschedulable")
            self.add_nominated_pod(qp.pod, "")
            self._cond.notify()

    def pop(self, timeout: Optional[float] = None) -> Optional[QueuedPodInfo]:
        """Blocks until a pod is available (reference: :378)."""
        with self._cond:
            while len(self.active_q) == 0 and not self._closed:
                if not self._cond.wait(timeout=timeout):
                    return None
            if self._closed and len(self.active_q) == 0:
                return None
            qp = self.active_q.pop()
            qp.attempts += 1
            self.scheduling_cycle += 1
            qp.scheduling_cycle = self.scheduling_cycle
            if uslo.tracker() is not None:
                # SLO queue_wait boundary; disarmed this is one module
                # attribute read: no clock call, no lock
                qp.pop_timestamp = self._clock()
            return qp

    def pop_batch(self, max_batch: int,
                  timeout: Optional[float] = None) -> List[QueuedPodInfo]:
        """Batch extension: drain up to max_batch ready pods in queue order for
        one device batch (the reference pops strictly one, scheduler.go:510;
        batching is our throughput lever — SURVEY.md §7).

        When a BLOCKING pop wakes on the first pod of an arriving burst, a
        short gather window lets the rest of the burst land before the
        drain: waking instantly mid-burst splits one arrival wave into
        arbitrary-sized cycles, which costs an extra serialized device
        cycle AND churns the pow2 pod-axis bucket (a 196/60 split compiles
        two programs where a 256-pod cycle reuses one).  Non-blocking pops
        (timeout == 0) never wait — test/drain semantics are unchanged."""
        out: List[QueuedPodInfo] = []
        first = self.pop(timeout=timeout)
        if first is None:
            return out
        out.append(first)
        if (timeout is None or timeout > 0) and len(out) < max_batch:
            gather = 0.02 if timeout is None else min(0.02, timeout)
            with self._cond:
                # one cond wait instead of a 2 ms poll loop: wakes on the
                # notify that completes the batch, or at the window's end
                self._cond.wait_for(
                    lambda: len(self.active_q) >= max_batch - len(out),
                    timeout=gather)
        with self._cond:
            # one clock read for the whole drained batch (SLO armed only)
            pop_t = self._clock() if uslo.tracker() is not None else 0.0
            while len(out) < max_batch and len(self.active_q) > 0:
                qp = self.active_q.pop()
                qp.attempts += 1
                self.scheduling_cycle += 1
                qp.scheduling_cycle = self.scheduling_cycle
                if pop_t:
                    qp.pop_timestamp = pop_t
                out.append(qp)
        return out

    def update(self, old: Optional[api.Pod], new: api.Pod) -> None:
        """reference: :404 Update — refresh in place; an updated
        unschedulable pod that might now fit moves to active/backoff."""
        with self._cond:
            if old is not None:
                qp = self.active_q.get_by_key(_pod_key(old))
                if qp is not None:
                    self.update_nominated_pod(old, new)
                    qp.pod = new
                    self.active_q.add(qp)
                    self._cond.notify()
                    return
                qp = self.backoff_q.get_by_key(_pod_key(old))
                if qp is not None:
                    self.update_nominated_pod(old, new)
                    qp.pod = new
                    self.backoff_q.add(qp)
                    return
            k = _pod_key(new)
            qp = self.unschedulable_q.get(k)
            if qp is not None:
                self.update_nominated_pod(qp.pod, new)
                if _pod_updates_may_make_schedulable(qp.pod, new):
                    del self.unschedulable_q[k]
                    if self._unschedulable_recorder:
                        self._unschedulable_recorder.dec()
                    qp.pod = new
                    if self._is_backing_off(qp):
                        self.backoff_q.add(qp)
                    else:
                        self.active_q.add(qp)
                        self._cond.notify()
                else:
                    qp.pod = new
                return
            # unknown pod: treat as new
            self.active_q.add(self._new_queued_pod_info(new))
            self.add_nominated_pod(new, "")
            self._cond.notify()

    def delete(self, pod: api.Pod) -> None:
        """reference: :443 Delete."""
        with self._cond:
            self.delete_nominated_pod_if_exists(pod)
            k = _pod_key(pod)
            qp = QueuedPodInfo(pod=pod)
            if not self.active_q.delete(qp):
                self.backoff_q.delete(qp)
                if self.unschedulable_q.pop(k, None) is not None:
                    if self._unschedulable_recorder:
                        self._unschedulable_recorder.dec()

    # -- cluster-event moves ------------------------------------------------

    def move_all_to_active_or_backoff_queue(self, event: str) -> None:
        """reference: :500."""
        with self._cond:
            self._move_pods(list(self.unschedulable_q.values()), event)

    def assigned_pod_added(self, pod: api.Pod) -> None:
        """A bound pod may unblock pods with (anti-)affinity
        (reference: :480 AssignedPodAdded / getUnschedulablePodsWithMatchingAffinityTerm :716)."""
        with self._cond:
            targets = [qp for qp in self.unschedulable_q.values()
                       if pod_with_affinity(qp.pod)]
            self._move_pods(targets, "AssignedPodAdded")

    assigned_pod_updated = assigned_pod_added

    def _move_pods(self, pods: List[QueuedPodInfo], event: str) -> None:
        # reference: :512 movePodsToActiveOrBackoffQueue
        moved = False
        for qp in pods:
            k = _pod_key(qp.pod)
            if k not in self.unschedulable_q:
                continue
            if self._is_backing_off(qp):
                self.backoff_q.add(qp)
                if self._metrics:
                    self._metrics.incoming(event, "backoff")
            else:
                self.active_q.add(qp)
                moved = True
                if self._metrics:
                    self._metrics.incoming(event, "active")
            del self.unschedulable_q[k]
            if self._unschedulable_recorder:
                self._unschedulable_recorder.dec()
        self.move_request_cycle = self.scheduling_cycle
        if moved:
            self._cond.notify_all()

    # -- periodic flushes ---------------------------------------------------

    def flush_backoff_completed(self) -> None:
        """reference: :244 flushBackoffQCompleted."""
        with self._cond:
            moved = False
            while True:
                qp = self.backoff_q.peek()
                if qp is None or self._backoff_time(qp) > self._clock():
                    break
                self.backoff_q.pop()
                self.active_q.add(qp)
                moved = True
                if self._metrics:
                    self._metrics.incoming("BackoffComplete", "active")
            if moved:
                self._cond.notify_all()

    def flush_unschedulable_leftover(self) -> None:
        """reference: :263 flushUnschedulableQLeftover."""
        with self._cond:
            now = self._clock()
            stale = [qp for qp in self.unschedulable_q.values()
                     if now - qp.timestamp > UNSCHEDULABLE_TIMEOUT]
            self._move_pods(stale, "UnschedulableTimeout")

    def run(self) -> None:
        """Start the flush goroutine-equivalents (reference: :241 Run)."""
        def loop(period, fn):
            while not self._stop.wait(period):
                fn()
        for period, fn in ((BACKOFF_FLUSH_PERIOD, self.flush_backoff_completed),
                           (UNSCHEDULABLE_FLUSH_PERIOD,
                            self.flush_unschedulable_leftover)):
            t = threading.Thread(target=loop, args=(period, fn), daemon=True)
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        """Idempotent: stops the flush threads, wakes every blocked pop,
        and joins the flushers (with a timeout — they sleep up to their
        flush period on the stop event) so no daemon thread outlives the
        queue it mutates."""
        self._stop.set()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        # join OUTSIDE the lock: a flusher mid-flush needs _cond to finish
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=2.0)
        self._threads = []

    # -- introspection ------------------------------------------------------

    def depths(self) -> Dict[str, int]:
        """Per-queue depths in one locked read — the flight recorder
        stamps these on each cycle record at cycle start (the serving
        loop only calls this when the recorder is armed)."""
        with self._cond:
            return {"active": len(self.active_q),
                    "backoff": len(self.backoff_q),
                    "unschedulable": len(self.unschedulable_q)}

    def pending_pods(self) -> List[api.Pod]:
        """reference: :601 PendingPods."""
        with self._cond:
            return ([qp.pod for qp in self.active_q.list()]
                    + [qp.pod for qp in self.backoff_q.list()]
                    + [qp.pod for qp in self.unschedulable_q.values()])

    def __len__(self) -> int:
        with self._cond:
            return (len(self.active_q) + len(self.backoff_q)
                    + len(self.unschedulable_q))


def _pod_updates_may_make_schedulable(old: api.Pod, new: api.Pod) -> bool:
    """reference: scheduling_queue.go:422 isPodUpdated — generation-relevant
    fields (spec, labels, annotations) changed, ignoring status/resourceVersion."""
    return (old.spec != new.spec
            or old.metadata.labels != new.metadata.labels
            or old.metadata.annotations != new.metadata.annotations)
