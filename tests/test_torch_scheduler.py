"""The slice end to end: the same term-free hollow store (group_labels=0,
as bench.py's backend_compare case) drained through the JAX package's
Scheduler(mode="gang", kernel_backend="pallas") and through the port's
Scheduler(..., device="cpu") gives every pod the same node.  Plus the
port's entry-point contract (CUDA by default, raising without it; a
default configuration runs the sequential replay; a term-bearing gang
batch runs with intra-batch topology) and its isolation from JAX and the
JAX package."""
import os
import re
import subprocess
import sys

import pytest
import torch

import kubetpu.apis.config as jconf
import kubetpu.client.store as jstore
import kubetpu.harness.hollow as jhollow
import kubetpu.scheduler as jsched
import kubetpu_torch
import kubetpu_torch.api.types as tapi
import kubetpu_torch.apis.config as tconf
import kubetpu_torch.client.store as tstore
import kubetpu_torch.harness.hollow as thollow
import kubetpu_torch.scheduler as tsched
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _world(store_mod, hollow, n_nodes, existing, n_pods, cpu_milli):
    store = store_mod.ClusterStore()
    for i, n in enumerate(hollow.make_nodes(n_nodes, zones=4)):
        store.add(n)
        for p in hollow.make_pods(existing, prefix=f"ex-{i}-",
                                  group_labels=4):
            p.spec.node_name = n.name
            store.add(p)
    pending = hollow.make_pods(n_pods, prefix="pend-", group_labels=0,
                               cpu_milli=cpu_milli)
    return store, pending


def _drain(sched, store, pending):
    for p in pending:
        store.add(p)
    placed = {}
    while True:
        out = sched.schedule_pending()
        if not out:
            break
        for o in out:
            placed[o.pod.metadata.name] = o.node
    return placed


def _jax_drain(n_nodes, existing, n_pods, cpu_milli, batch):
    store, pending = _world(jstore, jhollow, n_nodes, existing, n_pods,
                            cpu_milli)
    cfg = jconf.KubeSchedulerConfiguration(
        profiles=[jconf.KubeSchedulerProfile()], batch_size=batch,
        mode="gang", kernel_backend="pallas")
    s = jsched.Scheduler(store, config=cfg, async_binding=False)
    try:
        return _drain(s, store, pending)
    finally:
        s.close()


def _port_drain(n_nodes, existing, n_pods, cpu_milli, batch, backend):
    store, pending = _world(tstore, thollow, n_nodes, existing, n_pods,
                            cpu_milli)
    cfg = tconf.KubeSchedulerConfiguration(
        profiles=[tconf.KubeSchedulerProfile()], batch_size=batch,
        mode="gang", kernel_backend=backend)
    s = tsched.Scheduler(store, config=cfg, device="cpu")
    try:
        placed = _drain(s, store, pending)
    finally:
        s.close()
    assert tsched.capacity_violations(store) == []
    return placed, s


@pytest.mark.parametrize("n_nodes,existing,n_pods,cpu_milli,batch", [
    (16, 2, 40, 700, 16),     # three cycles, everything fits
    (24, 1, 48, 1900, 48),    # contended: capacity for 48 only after rounds
    (8, 2, 40, 1300, 16),     # over capacity: unschedulable pods requeue
])
def test_port_drain_matches_reference(n_nodes, existing, n_pods, cpu_milli,
                                      batch):
    want = _jax_drain(n_nodes, existing, n_pods, cpu_milli, batch)
    for backend in ("pallas", "lax"):
        got, sched = _port_drain(n_nodes, existing, n_pods, cpu_milli, batch,
                                 backend)
        assert got == want, backend
        assert sched.cycle_count >= 1
        assert all(s == r for s, r in zip(sched.gang_syncs,
                                          sched.gang_rounds))


def test_scheduler_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsched.Scheduler(tstore.ClusterStore(),
                         tconf.KubeSchedulerConfiguration(mode="gang"))


def test_default_config_runs_sequential():
    """A default configuration validates and drains through the
    sequential replay, term-bearing pods included; the start index
    rotates across cycles."""
    cfg = tconf.KubeSchedulerConfiguration(batch_size=8)
    assert cfg.mode == "sequential"
    assert cfg.percentage_of_nodes_to_score == 0
    store, pending = _world(tstore, thollow, 12, 1, 20, 300)
    for p in pending[::3]:
        thollow.with_anti_affinity(p, match={"app": "x"})
        p.metadata.labels["app"] = "x"
    for p in pending[1::3]:
        thollow.with_affinity(p, match={"app": "x"})
    s = tsched.Scheduler(store, cfg, device="cpu")
    placed = _drain(s, store, pending)
    s.close()
    assert s.cycle_count == 3 and s.gang_rounds == []
    assert sum(1 for v in placed.values() if v) == 20
    xs = [placed[p.metadata.name] for p in pending[::3]]
    assert len(set(xs)) == len(xs)       # anti-affinity: one per node
    zone = {n.name: n.metadata.labels[tapi.LABEL_ZONE]
            for n in store.list("Node")}
    # required zone affinity: beside some app=x pod
    assert ({zone[placed[p.metadata.name]] for p in pending[1::3]}
            <= {zone[n] for n in xs})
    assert tsched.capacity_violations(store) == []


def test_gang_topology_batch_runs():
    """A gang batch with a term-bearing pod runs the auction with
    intra-batch topology: both pods placed, the anti-affinity held (its
    empty selector matches every pod, so the two never share a node),
    the cycle routed to lax for the reason the reference gives."""
    store, pending = _world(tstore, thollow, 4, 0, 2, 100)
    thollow.with_anti_affinity(pending[0])
    s = tsched.Scheduler(store, tconf.KubeSchedulerConfiguration(
        mode="gang", kernel_backend="pallas"), device="cpu")
    placed = _drain(s, store, pending)
    s.close()
    assert all(placed.values()) and len(placed) == 2
    assert placed["pend-0"] != placed["pend-1"]
    assert s.gang_backends == [("lax", "intra-batch-topology")]
    assert s.gang_syncs == s.gang_rounds


_ISOLATION = r"""
import sys
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.scheduler import Scheduler
store = ClusterStore()
for n in hollow.make_nodes(6):
    store.add(n)
s = Scheduler(store, KubeSchedulerConfiguration(
    profiles=[KubeSchedulerProfile()], mode="gang", kernel_backend="pallas",
    batch_size=8), device="cpu")
for p in hollow.make_pods(10):
    store.add(p)
placed = 0
while True:
    out = s.schedule_pending()
    if not out:
        break
    placed += sum(1 for o in out if o.node)
assert placed == 10, placed
# the default mode: one term-bearing sequential cycle
s = Scheduler(store, KubeSchedulerConfiguration(batch_size=8), device="cpu")
pods = hollow.make_pods(4, prefix="seq-", group_labels=2)
for p in pods:
    hollow.with_anti_affinity(p)
    store.add(p)
out = s.schedule_pending()
assert len(out) == 4 and all(o.node for o in out), out
assert len({o.node for o in out if o.pod.metadata.labels["app"] == "app-0"}) == 2
# one term-bearing gang cycle: intra-batch topology, routed to lax
s = Scheduler(store, KubeSchedulerConfiguration(
    profiles=[KubeSchedulerProfile()], mode="gang", kernel_backend="pallas",
    batch_size=8), device="cpu")
pods = hollow.make_pods(4, prefix="gang-", group_labels=2)
for p in pods:
    hollow.with_anti_affinity(p)
    store.add(p)
out = s.schedule_pending()
assert len(out) == 4 and all(o.node for o in out), out
assert len({o.node for o in out if o.pod.metadata.labels["app"] == "app-0"}) == 2
assert s.gang_backends == [("lax", "intra-batch-topology")], s.gang_backends
# the failure path: a full node, a higher-priority pod preempts its victim
# (the PostFilter wave), then binds under the nominated-pods overlay
store = ClusterStore()
store.add(hollow.make_node("n1", cpu_milli=1000))
victim = hollow.make_pod("victim", cpu_milli=900)
victim.spec.node_name = "n1"
store.add(victim)
s = Scheduler(store, KubeSchedulerConfiguration(batch_size=8), device="cpu")
store.add(hollow.make_pod("high", cpu_milli=500, priority=100))
out = s.schedule_pending()
assert out[0].err and store.get_pod("default", "victim") is None
assert store.get_pod("default", "high").status.nominated_node_name == "n1"
s.queue.move_all_to_active_or_backoff_queue("test")
s.queue._clock = lambda: 1e12
s.queue.flush_backoff_completed()
out = s.schedule_pending()
assert out[0].node == "n1", out
# the serving surface: the pipelined drain, the REST store, the HTTP
# server, leader election, the metrics and the entry point
import kubetpu_torch.client.rest
import kubetpu_torch.server
import kubetpu_torch.utils.leaderelection
from kubetpu_torch.__main__ import main
store = ClusterStore()
for n in hollow.make_nodes(6):
    store.add(n)
s = Scheduler(store, KubeSchedulerConfiguration(
    profiles=[KubeSchedulerProfile()], mode="gang", kernel_backend="pallas",
    batch_size=4, pipeline_cycles=True, pipeline_depth=3), device="cpu")
for p in hollow.make_pods(12, prefix="pipe-"):
    store.add(p)
placed = 0
for _ in range(20):
    out = s.schedule_pending()
    if not out:
        break
    placed += sum(1 for o in out if o.node)
s.close()
assert placed == 12, placed
assert main(["--once", "--device", "cpu", "--hollow-nodes", "4",
             "--hollow-pods", "6", "--mode", "gang"]) == 0
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "kubetpu" or m.startswith("kubetpu.")]
assert not bad, bad
print("ISOLATED")
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ISOLATED" in out.stdout
    # python -m kubetpu_torch itself loads neither
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "kubetpu_torch",
         "--device", "cpu", "--once", "--hollow-nodes", "2",
         "--hollow-pods", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = [line.rsplit("|", 1)[-1].strip()
              for line in out.stderr.splitlines()
              if line.startswith("import time:")]
    assert "kubetpu_torch.scheduler" in loaded
    assert not [m for m in loaded
                if m.split(".")[0] in ("jax", "jaxlib", "kubetpu")], loaded


def test_port_sources_have_no_reference_imports():
    pkg = os.path.dirname(kubetpu_torch.__file__)
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|kubetpu)(\.|\s|$)")
    hits = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if pat.match(line):
                    hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, hits


def _volume_batch(store_mod, hollow, A):
    """4 nodes and 4 pods, the third with an emptyDir volume."""
    store = store_mod.ClusterStore()
    for n in hollow.make_nodes(4):
        store.add(n)
    pods = [hollow.make_pod(f"p{i}", cpu_milli=300 * (i + 1))
            for i in range(4)]
    pods[2].spec.volumes = [A.Volume(name="scratch", empty_dir=True)]
    return store, pods


def test_refused_volume_pod_loses_nothing():
    """A batch with a volume pod (an emptyDir) is no longer refused: the
    one cycle binds all four pods where the JAX scheduler binds them,
    and nothing is left in the queue.  (Until the volume family was
    ported, the batch was refused and requeued whole; the lost-batch
    guarantee is test_raising_plugin_loses_nothing's.)"""
    from tests.torch_port_util import FakeClock
    store, pods = _volume_batch(tstore, thollow, tapi)
    s = tsched.Scheduler(store, tconf.KubeSchedulerConfiguration(
        profiles=[tconf.KubeSchedulerProfile()], batch_size=8),
        device="cpu")
    s.queue._clock = FakeClock()
    for p in pods:
        store.add(p)
    out = s.schedule_pending()
    s.close()
    got = {o.pod.metadata.name: o.node for o in out}

    import kubetpu.api.types as japi
    jstore_, jpods = _volume_batch(jstore, jhollow, japi)
    js = jsched.Scheduler(jstore_, config=jconf.KubeSchedulerConfiguration(
        profiles=[jconf.KubeSchedulerProfile()], batch_size=8,
        prewarm=False), async_binding=False)
    for p in jpods:
        jstore_.add(p)
    want = {o.pod.metadata.name: o.node for o in js.schedule_pending()}
    js.close()
    assert len(got) == 4 and all(got.values()), got
    assert got == want
    assert len(s.queue) == 0
    assert all(p.spec.node_name for p in store.list("Pod"))


def _raising_plugin_scheduler(point, base, method):
    """A scheduler whose profile runs one plugin at ``point`` that raises
    while ``armed`` (and records every Unreserve), over 4 nodes and 4
    pods whose first pod asks for more cpu than any node has when
    ``point`` is post_filter (so that it fails the filter)."""
    from kubetpu_torch.framework import interface as fw
    from kubetpu_torch.plugins.intree import new_in_tree_registry
    from tests.torch_port_util import FakeClock

    class Raiser(base, fw.UnreservePlugin):
        armed = True
        unreserved = []

        def name(self):
            return "Raiser"

        def unreserve(self, state, pod, node_name):
            Raiser.unreserved.append(pod.metadata.name)

    def boom(self, *args):
        if self.armed:
            raise RuntimeError(f"{point} plugin raised")
        return ((fw.PostFilterResult(""), fw.Status.unschedulable("no"))
                if point == "post_filter" else fw.Status.success())

    setattr(Raiser, method, boom)
    registry = dict(new_in_tree_registry())
    registry["Raiser"] = lambda args, handle: Raiser()
    on = tconf.PluginSet(enabled=[tconf.Plugin("Raiser")])
    plugins = tconf.Plugins(unreserve=on, **{point: on})
    if point == "post_filter":
        plugins.post_filter.disabled = [tconf.Plugin("DefaultPreemption")]
    store = tstore.ClusterStore()
    for n in thollow.make_nodes(4):
        store.add(n)
    big = 10**6 if point == "post_filter" else 300
    pods = [thollow.make_pod(f"p{i}", cpu_milli=big if i == 0 else 300)
            for i in range(4)]
    for p in pods:
        store.add(p)
    s = tsched.Scheduler(store, tconf.KubeSchedulerConfiguration(
        profiles=[tconf.KubeSchedulerProfile(plugins=plugins)],
        batch_size=8), registry=registry, device="cpu",
        async_binding=False)
    s.queue._clock = FakeClock()
    return s, store, pods, Raiser


@pytest.mark.parametrize("point,base,method", [
    ("post_filter", "PostFilterPlugin", "post_filter"),
    ("pre_bind", "PreBindPlugin", "pre_bind"),
])
def test_raising_plugin_loses_nothing(point, base, method):
    """A PostFilter plugin that raises after its pod failed the filter,
    or a PreBind plugin that raises in the cycle's own bind: every popped
    pod is bound or back in the queue, no assume is left in the cache,
    a raised PreBind runs Unreserve, and once the plugin stops raising
    the next cycles settle all four pods."""
    from kubetpu_torch.framework import interface as fw
    s, store, pods, Raiser = _raising_plugin_scheduler(
        point, getattr(fw, base), method)
    with pytest.raises(RuntimeError, match="plugin raised"):
        s.schedule_pending()
    bound = {p.metadata.name for p in store.list("Pod") if p.spec.node_name}
    # every popped pod is bound or back in the queue; the pod whose
    # plugin raised and every pod after it are not bound
    assert len(bound) + len(s.queue) == 4 and "p0" not in bound
    if point == "pre_bind":
        assert len(s.queue) == 4
    assert not any(s.cache.is_assumed_pod(p) for p in pods
                   if p.metadata.name not in bound)
    assert Raiser.unreserved == (["p0"] if point == "pre_bind" else [])
    Raiser.armed = False
    placed = {}
    for _ in range(3):
        s.queue._clock.t += 100.0
        s.queue.flush_backoff_completed()
        for o in s.schedule_pending():
            placed[o.pod.metadata.name] = o.node
    s.close()
    settled = set(placed) | bound
    bound = {p.metadata.name for p in store.list("Pod") if p.spec.node_name}
    assert settled == {"p0", "p1", "p2", "p3"}
    if point == "post_filter":
        # p0 fits nowhere and stays queued; the other three bind
        assert bound == {"p1", "p2", "p3"} and len(s.queue) == 1
        assert placed["p0"] == ""
    else:
        assert bound == {"p0", "p1", "p2", "p3"} and len(s.queue) == 0
