"""The port's leader election (kubetpu_torch/utils/leaderelection.py, a
copy of kubetpu/utils/leaderelection.py): twins of
tests/test_leaderelection.py — two elector instances over one lock file,
exactly one leader at any time, a clean handoff when the holder releases,
an expired lease taken over, and an N-way thread race on the raw lock
asserting mutual exclusion of the acquire path itself."""

import threading

from kubetpu_torch.utils.leaderelection import (FileLock, InMemoryLock,
                                                LeaderElector)
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


def _elector(lock, identity, clock, events):
    return LeaderElector(
        lock,
        on_started_leading=lambda: events.append(("started", identity)),
        on_stopped_leading=lambda: events.append(("stopped", identity)),
        identity=identity, lease_duration=15.0, retry_period=0.05,
        clock=clock)


def test_filelock_two_electors_exactly_one_leader(tmp_path):
    lock = FileLock(str(tmp_path / "lease"))
    now = [100.0]
    clock = lambda: now[0]
    events = []
    a = _elector(lock, "sched-a", clock, events)
    b = _elector(FileLock(str(tmp_path / "lease")), "sched-b", clock,
                 events)

    assert a.step() is True
    assert b.step() is False            # lease held and not expired
    assert (a.is_leader, b.is_leader) == (True, False)

    # renewals keep the loser out even as time advances within the lease
    now[0] += 10.0
    assert a.step() is True
    assert b.step() is False
    assert lock.get().holder == "sched-a"


def test_filelock_clean_handoff_on_release(tmp_path):
    lock_a = FileLock(str(tmp_path / "lease"))
    lock_b = FileLock(str(tmp_path / "lease"))
    now = [100.0]
    clock = lambda: now[0]
    events = []
    a = _elector(lock_a, "sched-a", clock, events)
    b = _elector(lock_b, "sched-b", clock, events)

    assert a.step() is True
    assert b.step() is False
    a.release()                          # explicit release, not expiry
    assert lock_a.get().holder == ""
    assert b.step() is True              # immediate takeover
    assert b.is_leader and not a.is_leader
    assert events == [("started", "sched-a"), ("started", "sched-b")]
    b.release()
    assert lock_b.get().holder == ""


def test_filelock_expired_lease_is_taken_over(tmp_path):
    lock = FileLock(str(tmp_path / "lease"))
    now = [100.0]
    clock = lambda: now[0]
    events = []
    a = _elector(lock, "sched-a", clock, events)
    b = _elector(FileLock(str(tmp_path / "lease")), "sched-b", clock,
                 events)
    assert a.step() is True
    now[0] += 16.0                       # past lease_duration: a is dead
    assert b.step() is True
    assert lock.get().holder == "sched-b"
    # a comes back: it lost the lease and must report stopped
    assert a.step() is False
    assert ("stopped", "sched-a") in events


def test_filelock_thread_race_single_winner(tmp_path):
    """8 identities race try_acquire_or_renew at the same instant; the
    flock + in-process mutex must admit exactly one."""
    lock = FileLock(str(tmp_path / "lease"))
    results = {}
    barrier = threading.Barrier(8)

    def contend(i):
        barrier.wait(timeout=10.0)
        results[i] = lock.try_acquire_or_renew(f"id-{i}", 15.0, now=100.0)

    threads = [threading.Thread(target=contend, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    winners = [i for i, ok in results.items() if ok]
    assert len(winners) == 1, results
    assert lock.get().holder == f"id-{winners[0]}"


def test_inmemory_lock_release_only_by_holder():
    lock = InMemoryLock()
    assert lock.try_acquire_or_renew("a", 15.0, now=0.0)
    lock.release("b")                    # not the holder: no-op
    assert lock.get().holder == "a"
    lock.release("a")
    assert lock.get().holder == ""


def test_release_joins_renew_thread(tmp_path):
    """release() is idempotent and leaves no renew thread behind."""
    lock = FileLock(str(tmp_path / "lease"))
    started = threading.Event()
    el = LeaderElector(lock, on_started_leading=started.set,
                       on_stopped_leading=lambda: None,
                       identity="sched-x", retry_period=0.05)
    el.run(block=False)
    assert started.wait(5.0)
    t = el._thread
    el.release()
    assert el._thread is None
    assert t is not None and not t.is_alive()
    el.release()                         # idempotent
    assert lock.get().holder == ""
