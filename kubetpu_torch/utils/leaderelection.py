"""Leader election over a lease object.

reference: staging/src/k8s.io/client-go/tools/leaderelection/
leaderelection.go:111 (LeaderElector: acquire/renew loop over a
resourcelock) and cmd/kube-scheduler/app/server.go:203-218 (scheduler
exits when it loses the lease).  A copy of kubetpu/utils/
leaderelection.py (pure Python): the device is one logical scheduler;
leader election provides HA of the *host process* exactly as in the
reference.

The lock backend is pluggable; LeaseLock works against any object with
get/update/create semantics — in-process it uses the ClusterStore so
integration tests can run two contending schedulers.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

DEFAULT_LEASE_DURATION = 15.0   # reference: leaderelection defaults
DEFAULT_RENEW_DEADLINE = 10.0
DEFAULT_RETRY_PERIOD = 2.0


@dataclass
class LeaseRecord:
    holder: str = ""
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_duration: float = DEFAULT_LEASE_DURATION


def _acquire_or_renew(rec: LeaseRecord, identity: str, lease_duration: float,
                      now: float) -> bool:
    """The lease decision shared by every lock backend (reference:
    leaderelection.go:326 tryAcquireOrRenew).  Mutates rec on success."""
    expired = now > rec.renew_time + rec.lease_duration
    if rec.holder and rec.holder != identity and not expired:
        return False
    if rec.holder != identity:
        rec.holder = identity
        rec.acquire_time = now
    rec.renew_time = now
    rec.lease_duration = lease_duration
    return True


class InMemoryLock:
    """Shared lock object (the coordination/v1 Lease analog)."""

    def __init__(self):
        self._rec = LeaseRecord()
        self._mu = threading.Lock()

    def get(self) -> LeaseRecord:
        with self._mu:
            return LeaseRecord(**vars(self._rec))

    def try_acquire_or_renew(self, identity: str, lease_duration: float,
                             now: float) -> bool:
        with self._mu:
            return _acquire_or_renew(self._rec, identity, lease_duration, now)

    def release(self, identity: str) -> None:
        with self._mu:
            if self._rec.holder == identity:
                self._rec = LeaseRecord()


class FileLock:
    """Lease record persisted as a JSON file — the cross-PROCESS lock
    backend for `python -m kubetpu_torch` (the coordination/v1 Lease analog for
    standalone runs; reference resourcelock interface:
    client-go/tools/leaderelection/resourcelock/interface.go).  The whole
    read-modify-write runs under an fcntl.flock on a sidecar .lock file, so
    contending PROCESSES serialize exactly like the reference's CAS against
    the apiserver's resourceVersion; record writes are atomic (tmp+rename)
    so readers never see a torn file."""

    def __init__(self, path: str):
        self.path = path
        self._mu = threading.Lock()

    def _read(self) -> LeaseRecord:
        import json
        import os
        if not os.path.exists(self.path):
            return LeaseRecord()
        try:
            with open(self.path) as f:
                return LeaseRecord(**json.load(f))
        except Exception:
            return LeaseRecord()

    def _write(self, rec: LeaseRecord) -> None:
        import json
        import os
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(vars(rec), f)
        os.replace(tmp, self.path)

    def _flocked(self, fn):
        import fcntl
        with self._mu:
            with open(f"{self.path}.lock", "w") as lf:
                # kubelint: ignore[concurrency/blocking-under-lock] holding _mu across flock IS the design: in-process threads serialize behind the same cross-process critical section, mirroring the apiserver CAS
                fcntl.flock(lf, fcntl.LOCK_EX)
                try:
                    return fn()
                finally:
                    # kubelint: ignore[concurrency/blocking-under-lock] LOCK_UN never blocks; same audited critical section as above
                    fcntl.flock(lf, fcntl.LOCK_UN)

    def get(self) -> LeaseRecord:
        return self._flocked(self._read)

    def try_acquire_or_renew(self, identity: str, lease_duration: float,
                             now: float) -> bool:
        def attempt():
            rec = self._read()
            if not _acquire_or_renew(rec, identity, lease_duration, now):
                return False
            self._write(rec)
            return True
        return self._flocked(attempt)

    def release(self, identity: str) -> None:
        def rel():
            if self._read().holder == identity:
                self._write(LeaseRecord())
        self._flocked(rel)


class LeaderElector:
    """reference: leaderelection.go:111 LeaderElector.Run — OnStartedLeading
    / OnStoppedLeading callbacks; stopping leadership is fatal for the
    scheduler process (server.go:217 klog.Fatalf)."""

    def __init__(self, lock: InMemoryLock,
                 on_started_leading: Callable[[], None],
                 on_stopped_leading: Callable[[], None],
                 identity: Optional[str] = None,
                 lease_duration: float = DEFAULT_LEASE_DURATION,
                 retry_period: float = DEFAULT_RETRY_PERIOD,
                 clock: Callable[[], float] = time.time):
        self.lock = lock
        self.identity = identity or f"sched-{uuid.uuid4().hex[:8]}"
        self.on_started = on_started_leading
        self.on_stopped = on_stopped_leading
        self.lease_duration = lease_duration
        self.retry_period = retry_period
        self._clock = clock
        self._stop = threading.Event()
        self.is_leader = False
        self._thread: Optional[threading.Thread] = None

    def run(self, block: bool = False) -> None:
        def loop():
            while not self._stop.is_set():
                ok = self.lock.try_acquire_or_renew(
                    self.identity, self.lease_duration, self._clock())
                if ok and not self.is_leader:
                    self.is_leader = True
                    self.on_started()
                elif not ok and self.is_leader:
                    # lost the lease — fatal for the real process
                    self.is_leader = False
                    self.on_stopped()
                    return
                self._stop.wait(self.retry_period)
        if block:
            loop()
        else:
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()

    def step(self) -> bool:
        """Single non-blocking acquire/renew attempt (for tests)."""
        ok = self.lock.try_acquire_or_renew(
            self.identity, self.lease_duration, self._clock())
        if ok and not self.is_leader:
            self.is_leader = True
            self.on_started()
        elif not ok and self.is_leader:
            self.is_leader = False
            self.on_stopped()
        return self.is_leader

    def release(self) -> None:
        """Idempotent: stops the renew loop, joins it (it sleeps on the
        stop event between attempts), then gives up the lease so another
        elector can acquire immediately."""
        self._stop.set()
        t = self._thread
        if (t is not None and t is not threading.current_thread()
                and t.is_alive()):
            t.join(timeout=2.0)
        self._thread = None
        if self.is_leader:
            self.lock.release(self.identity)
            self.is_leader = False
