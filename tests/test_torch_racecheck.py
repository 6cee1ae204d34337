"""The port's race harness (kubetpu_torch/utils/racecheck.py) against the
JAX package's (kubetpu/utils/racecheck.py): each case of
tests/test_racecheck.py runs through both packages on the same seeded
operations, each under its own armed scope, and both report the same
violations by class, attribute, kind and roles (or none).  Then a port
drain, pipelined at depth 2 with the binder pool, runs clean under the
harness, and the port's GUARDED map equals the rows that kubelint's
static lock graph derives from the port's source for its seven
classes."""
import os
import re
import subprocess
import sys
import threading
import time
from typing import NamedTuple

import pytest

from kubetpu.utils import racecheck as jrc
from kubetpu.utils import sanitize as jsan
from kubetpu_torch.utils import racecheck as trc
from kubetpu_torch.utils import sanitize as tsan
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

ITERATIONS = 10
OPS = 30
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg(NamedTuple):
    api: object
    store: object
    queue: object
    cache: object
    rc: object
    san: object


def _pkg(name) -> Pkg:
    if name == "jax":
        import kubetpu.api.types as api
        import kubetpu.client.store as store
        import kubetpu.schedqueue.queue as queue
        import kubetpu.state.cache as cache
        return Pkg(api, store, queue, cache, jrc, jsan)
    import kubetpu_torch.api.types as api
    import kubetpu_torch.client.store as store
    import kubetpu_torch.schedqueue.queue as queue
    import kubetpu_torch.state.cache as cache
    return Pkg(api, store, queue, cache, trc, tsan)


def _both(case):
    """case(pkg) in the JAX package, then in the port."""
    return {name: case(_pkg(name)) for name in ("jax", "torch")}


def _pod(A, name, node=""):
    p = A.Pod(metadata=A.ObjectMeta(name=name, namespace="d"))
    if node:
        p.spec.node_name = node
    return p


def _node(A, name):
    n = A.Node(metadata=A.ObjectMeta(name=name))
    n.status.allocatable = {"cpu": "4", "memory": "8Gi", "pods": "110"}
    return n


def _view(violations, kinds=None):
    """Violations as (kind, subject): the guarded Class.attr of an
    unguarded mutation, the (acquired, held) roles of a lock-order
    report, the lock of a hold-time report."""
    out = []
    for v in violations:
        if kinds is not None and v.kind not in kinds:
            continue
        if v.kind == "unguarded-mutation":
            m = re.match(r"(\S+) mutated without holding (\S+)", v.message)
            out.append((v.kind, m.group(1), m.group(2)))
        elif v.kind == "lock-order":
            m = re.match(r"acquired (\S+) while holding (\S+),", v.message)
            out.append((v.kind, m.group(1), m.group(2)))
        else:
            out.append((v.kind, v.message.split(" held for ")[0]))
    return out


def _hammer(fns):
    errors = []

    def trap(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=trap, args=(fn,), name=f"h{i}")
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads), "stress thread hung"
    assert not errors, errors


def _stress(P):
    A = P.api
    with P.san.sanitized() as watchdog, \
            P.rc.racechecked(strict=False, hold_ms=5000) as reg:
        for it in range(ITERATIONS):
            store = P.store.ClusterStore()
            cache = P.cache.SchedulerCache()
            queue = P.queue.SchedulingQueue()
            store.subscribe(
                "Pod", lambda ev, old, new:
                queue.add(new) if ev == "add" and new is not None
                and not new.spec.node_name else None)
            for j in range(4):
                cache.add_node(A.Node(metadata=A.ObjectMeta(name=f"n{j}")))

            def pusher(base):
                def run():
                    for k in range(OPS):
                        store.add(_pod(A, f"it{it}-p{base}-{k}"))
                return run

            def popper():
                for _ in range(OPS):
                    for qp in queue.pop_batch(4, timeout=0):
                        queue.add_unschedulable_if_not_present(
                            qp, qp.scheduling_cycle)

            def cache_churn(base):
                def run():
                    for k in range(OPS):
                        p = _pod(A, f"it{it}-c{base}-{k}", node=f"n{k % 4}")
                        cache.assume_pod(p)
                        cache.finish_binding(p, now=0.0)
                        if k % 3 == 0:
                            try:
                                cache.forget_pod(p)
                            except ValueError:
                                pass
                        else:
                            cache.cleanup_assumed_pods(now=1e9)
                return run

            def snapshotter():
                snap = P.cache.Snapshot()
                for _ in range(OPS):
                    cache.update_snapshot(snap)
                    cache.pod_count()

            def nominator():
                for k in range(OPS):
                    p = _pod(A, f"it{it}-nom-{k}")
                    queue.add_nominated_pod(p, f"n{k % 4}")
                    queue.nominated_pods_for_node(f"n{k % 4}")
                    queue.delete_nominated_pod_if_exists(p)
                    len(queue)

            _hammer([pusher(0), pusher(1), popper,
                     cache_churn(0), cache_churn(1), snapshotter, nominator,
                     lambda: [store.list("Pod") for _ in range(OPS)]])
            vs = reg.snapshot()
            assert not vs, "\n".join(str(v) for v in vs)
            queue.close()
            cache.close()
        watchdog.assert_no_recompilation()
        return watchdog.compile_count(), len(reg.snapshot())


def test_stress_8_threads_clean_in_both():
    got = _both(_stress)
    assert got["torch"] == got["jax"] == (0, 0)


def _rogue_mutation(P):
    with P.rc.racechecked(strict=False) as reg:
        cache = P.cache.SchedulerCache()

        def rogue():
            cache.assumed_pods["ghost"] = True      # no lock: violation

        t = threading.Thread(target=rogue)
        t.start()
        t.join()
        return _view(reg.snapshot(), {"unguarded-mutation"})


def test_seeded_unguarded_mutation_reported_in_both():
    got = _both(_rogue_mutation)
    assert got["torch"] == got["jax"] == [
        ("unguarded-mutation", "SchedulerCache.assumed_pods", "_lock")]


def _rebind(P):
    with P.rc.racechecked(strict=False) as reg:
        cache = P.cache.SchedulerCache()
        cache.pod_states = {}       # rebind of a guarded attr, no lock
        return _view(reg.snapshot())


def test_seeded_rebind_reported_in_both():
    got = _both(_rebind)
    assert got["torch"] == got["jax"] == [
        ("unguarded-mutation", "SchedulerCache.pod_states", "_lock")]


def _locked(P):
    with P.rc.racechecked() as reg:
        cache = P.cache.SchedulerCache()
        p = _pod(P.api, "ok", node="n1")
        cache.add_node(_node(P.api, "n1"))
        cache.add_pod(p)
        cache.remove_pod(p)
        return _view(reg.snapshot())


def test_locked_mutations_clean_in_both():
    got = _both(_locked)
    assert got["torch"] == got["jax"] == []


def _inversion(P):
    with P.rc.racechecked(strict=False) as reg:
        a = P.rc._LockProxy(threading._allocate_lock(), "roleA")
        b = P.rc._LockProxy(threading._allocate_lock(), "roleB")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        return _view(reg.snapshot(), {"lock-order"})


def test_lock_order_inversion_reported_in_both():
    got = _both(_inversion)
    assert got["torch"] == got["jax"] == [("lock-order", "roleA", "roleB")]


def _held(P):
    with P.rc.racechecked(strict=False, hold_ms=10) as reg:
        lock = P.rc._LockProxy(threading._allocate_lock(), "slow")
        with lock:
            time.sleep(0.05)
        return _view(reg.snapshot(), {"held-too-long"})


def test_held_too_long_reported_in_both():
    got = _both(_held)
    assert got["torch"] == got["jax"] == [("held-too-long", "slow")]


def _wait(P):
    with P.rc.racechecked(hold_ms=100) as reg:
        queue = P.queue.SchedulingQueue()
        assert isinstance(queue._cond, P.rc._ConditionProxy)

        def late_add():
            time.sleep(0.3)
            queue.add(_pod(P.api, "wakeup"))

        t = threading.Thread(target=late_add)
        t.start()
        got = queue.pop(timeout=5.0)
        t.join()
        assert got is not None
        return _view(reg.snapshot(), {"held-too-long"})


def test_condition_wait_releases_tracking_in_both():
    got = _both(_wait)
    assert got["torch"] == got["jax"] == []


def _disarm(P):
    with P.rc.racechecked(strict=False):
        pass
    lk = threading.Lock()
    cache = P.cache.SchedulerCache()
    cache.assumed_pods["free"] = True       # disarmed: no check
    return (isinstance(lk, P.rc._LockProxy),
            _view(P.rc.registry().snapshot()))


def test_harness_disarms_cleanly_in_both():
    got = _both(_disarm)
    assert got["torch"] == got["jax"] == (False, [])


def test_port_harness_ignores_jax_package_locks():
    """Armed, the port instruments locks built by kubetpu_torch modules
    only: the JAX package's SchedulerCache keeps a plain lock."""
    import kubetpu.state.cache as jcache
    import kubetpu_torch.state.cache as tcache
    with trc.racechecked():
        assert isinstance(tcache.SchedulerCache()._lock, trc._LockProxy)
        assert not isinstance(jcache.SchedulerCache()._lock,
                              (trc._LockProxy, jrc._LockProxy))


def test_pipelined_port_drain_with_binder_pool_is_clean():
    """A port drain pipelined at depth 2, binding on the binder pool,
    built and run inside the armed scope: every pod placed, no
    violation (racechecked() asserts it at exit)."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    from kubetpu_torch.scheduler import Scheduler
    with trc.racechecked() as reg:
        store = ClusterStore()
        for n in hollow.make_nodes(32, zones=4):
            store.add(n)
        sched = Scheduler(store, config=KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()], batch_size=16, mode="gang",
            kernel_backend="pallas", chain_cycles=True,
            pipeline_cycles=True, pipeline_depth=2),
            device="cpu", async_binding=True)
        assert isinstance(sched._chain_lock, trc._LockProxy)
        try:
            for p in hollow.make_pods(96, prefix="pend-", group_labels=8):
                store.add(p)
            outs = []
            while True:
                got = sched.schedule_pending(timeout=0.0)
                if not got:
                    break
                outs.extend(got)
            outs.extend(sched.flush_pipeline())
            sched.wait_for_inflight_binds(timeout=60.0)
        finally:
            sched.close()
        assert sum(1 for o in outs if o.node) == 96
        assert sched.cycle_count >= 6
        assert not reg.snapshot()


def test_guarded_map_equals_kubelint_lock_graph():
    out = subprocess.run(
        [sys.executable, "-m", "tools.kubelint", "kubetpu_torch/",
         "--lock-graph"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    rows = {}
    for line in out.stdout.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) == 4 and cells[0] not in ("class", "---"):
            rows[(cells[0], cells[1])] = tuple(
                sorted(c.strip() for c in cells[3].split(",")))
    assert len(trc.GUARDED) == 7
    for (mod, cls), (lock, attrs) in trc.GUARDED.items():
        assert mod.startswith("kubetpu_torch.")
        assert rows[(cls, lock)] == tuple(sorted(attrs)), cls
    # the same rows as the JAX map, under the port's module names
    assert {(m.replace("kubetpu.", "kubetpu_torch.", 1), c): v
            for (m, c), v in jrc.GUARDED.items()} == trc.GUARDED


@pytest.mark.parametrize("flag", ["1", None])
def test_package_import_arms_from_env(flag):
    env = {k: v for k, v in os.environ.items()
           if k not in ("KUBETPU_SANITIZE", trc.ENV_FLAG)}
    if flag is not None:
        env[trc.ENV_FLAG] = flag
    code = ("import threading, kubetpu_torch\n"
            "from kubetpu_torch.utils import racecheck, sanitize\n"
            "from kubetpu_torch.state.cache import SchedulerCache\n"
            "print(racecheck.registry().armed,"
            " isinstance(SchedulerCache()._lock, racecheck._LockProxy),"
            " sanitize.current_watchdog() is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == (["True", "True", "False"] if flag
                                  else ["False", "False", "False"])
