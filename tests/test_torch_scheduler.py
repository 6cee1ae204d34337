"""The slice end to end: the same term-free hollow store (group_labels=0,
as bench.py's backend_compare case) drained through the JAX package's
Scheduler(mode="gang", kernel_backend="pallas") and through the port's
Scheduler(..., device="cpu") gives every pod the same node.  Plus the
port's entry-point contract (CUDA by default, raising without it) and its
isolation from JAX and the JAX package."""
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
import kubetpu_torch.apis.config as tconf
import kubetpu_torch.client.store as tstore
import kubetpu_torch.harness.hollow as thollow
import kubetpu_torch.scheduler as tsched

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


def test_sequential_mode_is_refused():
    with pytest.raises(NotImplementedError, match="sequential"):
        tsched.Scheduler(tstore.ClusterStore(),
                         tconf.KubeSchedulerConfiguration(), device="cpu")


def test_topology_batch_is_refused():
    store, pending = _world(tstore, thollow, 4, 0, 2, 100)
    thollow.with_anti_affinity(pending[0])
    s = tsched.Scheduler(store, tconf.KubeSchedulerConfiguration(
        mode="gang"), device="cpu")
    for p in pending:
        store.add(p)
    with pytest.raises(NotImplementedError, match="intra-batch topology"):
        s.schedule_pending()


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
