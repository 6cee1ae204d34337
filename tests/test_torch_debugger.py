"""The port's cache debugger and fake cache (kubetpu_torch/state/
debugger.py, state/fake.py) on the CPU: CacheComparer and CacheDumper give
the JAX package's results on the same drifted cache (nodes and pods the
store holds behind the cache's back, and cache entries the store lost),
the SIGUSR2 handler dumps and compares, and FakeCache's hooks observe the
assume/forget protocol (twins of tests/test_observability.py:95-118 and
tests/test_cache.py:194)."""
import logging
import os
import signal

import kubetpu.state.debugger as jdebugger
from kubetpu_torch.harness import hollow
from kubetpu_torch.state.debugger import (CacheComparer, CacheDebugger,
                                          CacheDumper)
from kubetpu_torch.state.fake import FakeCache
from tests.torch_port_util import make_scheduler, packages
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


def _drifted(pkg):
    """A package's scheduler over a store that drifted from its cache: a
    node and a bound pod added behind the watch, a cached pod removed
    behind it, and pending pods in the queue."""
    store = pkg.store.ClusterStore()
    sched = make_scheduler(pkg, store, mode="gang")
    for n in pkg.hollow.make_nodes(3):
        store.add(n)
    for i, p in enumerate(pkg.hollow.make_pods(4, prefix="bound-")):
        p.spec.node_name = f"node-{i % 3}"
        store.add(p)
    for p in pkg.hollow.make_pods(2, prefix="pending-"):
        store.add(p)
    ghost = pkg.hollow.make_node("ghost")
    store._objs["Node"]["ghost"] = ghost
    sneak = pkg.hollow.make_pod("sneak")
    sneak.spec.node_name = "node-1"
    store._objs["Pod"][store._key(sneak)] = sneak
    gone = store.get("Pod", "default/bound-0")
    del store._objs["Pod"]["default/bound-0"]
    return store, sched, sneak, gone


def test_comparer_and_dumper_equal_jax():
    jp, tp = packages()
    out = {}
    for pkg, mod in ((jp, jdebugger), (tp, None)):
        store, sched, sneak, gone = _drifted(pkg)
        C = (mod.CacheComparer if mod else CacheComparer)
        D = (mod.CacheDumper if mod else CacheDumper)
        try:
            cmp = C(store, sched.cache, sched.queue)
            out[pkg is jp] = dict(
                nodes=cmp.compare_nodes(), pods=cmp.compare_pods(),
                ok=cmp.compare(), uids=(sneak.uid, gone.uid),
                dump=D(sched.cache, sched.queue).dump())
        finally:
            sched.close()
    want, got = out[True], out[False]
    assert got["nodes"] == want["nodes"] == (["ghost"], [])
    # uids differ between the packages' pods: compare by position
    assert got["pods"] == ([got["uids"][0]], [got["uids"][1]])
    assert want["pods"] == ([want["uids"][0]], [want["uids"][1]])
    assert got["ok"] is want["ok"] is False
    assert got["dump"] == want["dump"]
    assert "pending-0" in got["dump"] and "'bound-1'" in got["dump"]


def test_comparer_clean_cache_agrees():
    _, tp = packages()
    store = tp.store.ClusterStore()
    sched = make_scheduler(tp, store)
    try:
        store.add(hollow.make_node("n1"))
        p = hollow.make_pod("p")
        p.spec.node_name = "n1"
        store.add(p)
        cmp = CacheComparer(store, sched.cache, sched.queue)
        assert cmp.compare()
        assert cmp.compare_nodes() == ([], []) == cmp.compare_pods()
    finally:
        sched.close()


def test_sigusr2_dumps_and_compares(caplog):
    _, tp = packages()
    store, sched, _sneak, _gone = _drifted(tp)
    old = signal.getsignal(signal.SIGUSR2)
    try:
        CacheDebugger(store, sched.cache, sched.queue).listen_for_signal()
        with caplog.at_level(logging.INFO,
                             logger="kubetpu_torch.debugger"):
            os.kill(os.getpid(), signal.SIGUSR2)
        text = caplog.text
        assert "Dump of cached NodeInfo" in text
        assert "nodes missed ['ghost']" in text
    finally:
        signal.signal(signal.SIGUSR2, old)
        sched.close()


def test_fake_cache_hooks():
    seen = {"assumed": [], "forgotten": []}
    fake = FakeCache(
        assume_fn=lambda p: seen["assumed"].append(p.metadata.name),
        forget_fn=lambda p: seen["forgotten"].append(p.metadata.name),
        is_assumed_fn=lambda p: p.metadata.name in seen["assumed"],
        get_pod_fn=lambda p: None)
    pod = hollow.make_pod("x")
    fake.assume_pod(pod)
    assert seen["assumed"] == ["x"]
    assert fake.is_assumed_pod(pod)
    fake.forget_pod(pod)
    assert seen["forgotten"] == ["x"]
    assert fake.get_pod(pod) is None
    # everything else is a safe no-op
    fake.add_pod(pod)
    fake.update_pod(pod, pod)
    fake.remove_pod(pod)
    fake.finish_binding(pod)
    fake.update_snapshot(None)
    assert fake.node_count() == 0 and fake.pod_count() == 0
    assert fake.dump() == {"nodes": {}, "assumed_pods": []}
    assert FakeCache().get_pod(pod) is pod
    assert not FakeCache().is_assumed_pod(pod)
