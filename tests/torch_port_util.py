"""Shared helpers of the PyTorch-port differential tests (tests/test_torch_*).

The same seeded world is built twice — once from the JAX package's API
types, once from the port's copies — so each package tensorizes it with
its own builder; and JAX-side tensors cross to the port as numpy leaves
(cluster_from_numpy / batch_from_numpy) so both sides can also be fed
identical state.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import multiprocessing
import os
import random
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache as jax_compilation_cache

import kubetpu.api.types as japi
import kubetpu_torch.api.types as tapi
from kubetpu.framework.types import NodeInfo as JNodeInfo, PodInfo as JPodInfo
from kubetpu.models import programs as jprog
from kubetpu.models.batch import PodBatchBuilder as JBatchBuilder
from kubetpu.models.batch import densify_for as jdensify
from kubetpu.state.tensors import SnapshotBuilder as JSnapshotBuilder
from kubetpu_torch.framework.types import NodeInfo as TNodeInfo
from kubetpu_torch.harness import seq_worlds
from kubetpu_torch.framework.types import PodInfo as TPodInfo
from kubetpu_torch.models import programs as tprog
from kubetpu_torch.models.batch import PodBatchBuilder as TBatchBuilder
from kubetpu_torch.models.batch import batch_from_numpy
from kubetpu_torch.state.tensors import SnapshotBuilder as TSnapshotBuilder
from kubetpu_torch.state.tensors import cluster_from_numpy

FULL_FILTERS = jprog.DEFAULT_FILTER_PLUGINS

@pytest.fixture(scope="module", autouse=True)
def port_test_settings():
    """The settings of every test module of the port (each imports this
    fixture), restored when the module's tests end, so the JAX package's
    own tests run in a worker as they would without the port's:

    * one intra-op thread for torch: the port's CPU tests run many small
      ops, and six xdist workers with one torch thread per core each
      oversubscribe the machine; one thread gives the same bits (the
      port's reductions are exact in any order);
    * JAX's persistent compilation cache off.  A JAX Scheduler turns it
      on (kubetpu/utils/compilation.py), and both of its disk paths have
      crashed xdist workers under the port's in-process JAX drives:
      writing an entry serializes the XLA:CPU executable (jax
      compilation_cache.put_executable_and_time aborted), reading one
      back deserializes it (get_executable_and_time segfaulted on a warm
      cache).  The tests compare in-process results, which an in-process
      compile serves the same.  JAX decides once per process whether the
      cache is used; ``reset_cache`` makes it decide again, on entry and
      on exit;
    * on entry and at exit, JAX's compiled programs released
      (``jax.clear_caches``; see release_jax_programs)."""
    threads = torch.get_num_threads()
    enabled = jax.config.jax_enable_compilation_cache
    jax.clear_caches()
    _set_port_settings(1, False)
    yield
    jax.clear_caches()
    _set_port_settings(threads, enabled)


# Each XLA:CPU executable holds memory mappings of its own, and the JAX
# drives of the port's tests compile many (``drive`` re-jits the auction
# per drive): two of these modules in one process reach ~38,000 mappings,
# and a worker past the kernel's limit (vm.max_map_count, 65,530 here)
# segfaults inside its next XLA compile.
MAPPINGS_SOFT_LIMIT = 30000


def _mappings() -> int:
    try:
        with open("/proc/self/maps", "rb") as fh:
            return sum(1 for _ in fh)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def release_jax_programs():
    """After each test of the port's modules (each imports this fixture):
    release JAX's compiled programs once the process holds more than
    MAPPINGS_SOFT_LIMIT memory mappings, whoever compiled them."""
    yield
    if _mappings() > MAPPINGS_SOFT_LIMIT:
        jax.clear_caches()


def _set_port_settings(threads: int, jax_cache: bool) -> None:
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_compilation_cache", jax_cache)
    jax_compilation_cache.reset_cache()


def _node(A, name, labels, cpu, mem, pods, taints, unschedulable):
    return A.Node(
        metadata=A.ObjectMeta(name=name, labels=labels),
        spec=A.NodeSpec(taints=taints, unschedulable=unschedulable),
        status=A.NodeStatus(allocatable={"cpu": cpu, "memory": mem,
                                         "pods": pods}))


def _pod(A, name, labels, cpu, mem, **spec_kw):
    c = A.Container(name="c", image="img:1", resources=A.ResourceRequirements(
        requests={"cpu": cpu, "memory": mem}))
    return A.Pod(metadata=A.ObjectMeta(name=name, namespace="default",
                                       labels=labels),
                 spec=A.PodSpec(containers=[c], **spec_kw))


def churned(A, seed, n_nodes, n_pods, terms=False):
    """Randomized churned world in API module ``A``: heterogeneous
    capacities, zones, taints, unschedulable nodes, hostPort pods,
    tolerations, preferred node affinity, existing pods with preferred pod
    affinity (nonzero InterPodAffinity raw) and required anti-affinity.
    terms=True also gives some pending pods topology terms (for the
    kernel-level filter tests; the auction's supported surface is
    term-free)."""
    r = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {"disk": r.choice(["ssd", "hdd"]),
                  A.LABEL_HOSTNAME: f"n{i}"}
        if r.random() < 0.8:
            labels[A.LABEL_ZONE] = "z%d" % r.randrange(3)
        taints = []
        if r.random() < 0.2:
            taints.append(A.Taint(
                key="dedicated", value="gpu",
                effect=r.choice(["NoSchedule", "PreferNoSchedule"])))
        nodes.append(_node(A, f"n{i}", labels, r.choice(["2", "4", "8"]),
                           r.choice(["4Gi", "16Gi"]),
                           str(r.choice([4, 8, 110])), taints,
                           r.random() < 0.05))
    existing = {}
    for i in range(n_nodes):
        eps = []
        for j in range(r.randrange(0, 4)):
            p = _pod(A, f"e{i}_{j}", {"app": r.choice(["a", "b", "c"])},
                     r.choice(["100m", "500m"]), "128Mi")
            roll = r.random()
            if roll < 0.3:
                p.spec.affinity = A.Affinity(pod_affinity=A.PodAffinity(
                    preferred_during_scheduling_ignored_during_execution=[
                        A.WeightedPodAffinityTerm(
                            weight=r.choice([10, 50]),
                            pod_affinity_term=A.PodAffinityTerm(
                                label_selector=A.LabelSelector(
                                    match_labels={"app": r.choice(["a", "b"])}),
                                topology_key=A.LABEL_ZONE))]))
            elif roll < 0.4:
                p.spec.affinity = A.Affinity(
                    pod_anti_affinity=A.PodAntiAffinity(
                        required_during_scheduling_ignored_during_execution=[
                            A.PodAffinityTerm(
                                label_selector=A.LabelSelector(
                                    match_labels={"app": "c"}),
                                topology_key=A.LABEL_HOSTNAME)]))
            p.spec.node_name = f"n{i}"
            eps.append(p)
        existing[f"n{i}"] = eps
    pending = []
    for i in range(n_pods):
        kw = {}
        if r.random() < 0.25:
            kw["tolerations"] = [A.Toleration(key="dedicated",
                                              operator="Exists")]
        p = _pod(A, f"p{i}", {"app": r.choice(["a", "b", "c"])},
                 r.choice(["100m", "500m", "1"]), r.choice(["64Mi", "512Mi"]),
                 **kw)
        if r.random() < 0.2:
            p.spec.containers[0].ports = [A.ContainerPort(
                container_port=8080, host_port=r.choice([8080, 9090]))]
        if r.random() < 0.15:
            p.spec.affinity = A.Affinity(node_affinity=A.NodeAffinity(
                preferred_during_scheduling_ignored_during_execution=[
                    A.PreferredSchedulingTerm(
                        weight=r.choice([10, 100]),
                        preference=A.NodeSelectorTerm(match_expressions=[
                            A.NodeSelectorRequirement(
                                key="disk", operator="In",
                                values=["ssd"])]))]))
        if terms:
            roll = r.random()
            sel = A.LabelSelector(match_labels={"app": r.choice(["a", "b"])})
            if roll < 0.2:
                p.spec.topology_spread_constraints = [
                    A.TopologySpreadConstraint(
                        max_skew=1, topology_key=A.LABEL_ZONE,
                        when_unsatisfiable=r.choice(
                            ["DoNotSchedule", "ScheduleAnyway"]),
                        label_selector=sel)]
            elif roll < 0.35:
                p.spec.affinity = A.Affinity(
                    pod_anti_affinity=A.PodAntiAffinity(
                        required_during_scheduling_ignored_during_execution=[
                            A.PodAffinityTerm(label_selector=sel,
                                              topology_key=A.LABEL_ZONE)]))
            elif roll < 0.5:
                p.spec.affinity = A.Affinity(pod_affinity=A.PodAffinity(
                    required_during_scheduling_ignored_during_execution=[
                        A.PodAffinityTerm(label_selector=sel,
                                          topology_key=A.LABEL_ZONE)],
                    preferred_during_scheduling_ignored_during_execution=[
                        A.WeightedPodAffinityTerm(
                            weight=20, pod_affinity_term=A.PodAffinityTerm(
                                label_selector=sel,
                                topology_key=A.LABEL_HOSTNAME))]))
        pending.append(p)
    return nodes, existing, pending


def _infos(NodeInfo, nodes, existing):
    out = []
    for n in nodes:
        ni = NodeInfo(n)
        for p in existing.get(n.name, []):
            ni.add_pod(p)
        out.append(ni)
    return out


def build_jax(seed, n_nodes, n_pods, terms=False):
    """(cluster jnp, batch numpy, cfg, host arrays) from the JAX package."""
    return _build_jax_world(*churned(japi, seed, n_nodes, n_pods, terms))


def build_jax_seq(seed, n_nodes, n_pods):
    """The same, for kubetpu_torch/harness/seq_worlds.term_world built in
    the JAX package's API types (every default family live, Service
    selectors included)."""
    nodes, existing, pending = seq_worlds.term_world(japi, seed, n_nodes,
                                                     n_pods)
    return _build_jax_world(nodes, existing, pending,
                            [seq_worlds.spread_selector(japi, p)
                             for p in pending])


def _build_jax_world(nodes, existing, pending, spread_selectors=None,
                     filters=FULL_FILTERS,
                     scores=jprog.DEFAULT_SCORE_PLUGINS):
    sb = JSnapshotBuilder()
    pinfos = [JPodInfo(p) for p in pending]
    sb.intern_pending(pinfos)
    host = sb.build(_infos(JNodeInfo, nodes, existing))
    batch = jax.tree.map(np.asarray, JBatchBuilder(sb.table).build(
        pinfos, spread_selectors=spread_selectors))
    cfg = jprog.ProgramConfig(
        filters=tuple(filters), scores=tuple(scores),
        hostname_topokey=max(sb.table.topokey.get(japi.LABEL_HOSTNAME), 0))
    return host.to_device(), batch, cfg, host


def build_jax_from(nodes, existing, pending, filters, scores):
    """(cluster jnp, batch numpy, cfg) of a world given in the JAX
    package's API types, under the given plugin sets."""
    return _build_jax_world(nodes, existing, pending, filters=filters,
                            scores=scores)[:3]


def build_port_from(nodes, existing, pending, filters, scores):
    """The same world given in the port's API types, tensorized by the
    port's builders: (cluster, batch, cfg) on the CPU."""
    from kubetpu_torch.models.batch import batch_to_device
    sb = TSnapshotBuilder()
    pinfos = [TPodInfo(p) for p in pending]
    sb.intern_pending(pinfos)
    host = sb.build(_infos(TNodeInfo, nodes, existing))
    batch = TBatchBuilder(sb.table).build(pinfos)
    cfg = tprog.ProgramConfig(
        filters=tuple(filters), scores=tuple(scores),
        hostname_topokey=max(sb.table.topokey.get(tapi.LABEL_HOSTNAME), 0))
    return host.to_device("cpu"), batch_to_device(batch, "cpu"), cfg


def build_port(seed, n_nodes, n_pods, terms=False, device="cpu"):
    """The same world through the port's own builders."""
    nodes, existing, pending = churned(tapi, seed, n_nodes, n_pods, terms)
    sb = TSnapshotBuilder()
    pinfos = [TPodInfo(p) for p in pending]
    sb.intern_pending(pinfos)
    host = sb.build(_infos(TNodeInfo, nodes, existing))
    hbatch = TBatchBuilder(sb.table).build(pinfos)
    return host, hbatch


def to_numpy_tree(x):
    """NamedTuple of jax/numpy leaves -> nested dict of numpy arrays."""
    if hasattr(x, "_asdict"):
        return {k: to_numpy_tree(v) for k, v in x._asdict().items()}
    if x is None:
        return None
    return np.asarray(x)


def port_cfg(cfg) -> tprog.ProgramConfig:
    return tprog.ProgramConfig(**cfg._asdict())


def carry(cluster_j, batch_j, device="cpu"):
    """JAX cluster + (densified) batch -> the port's tensors."""
    bj = jdensify(cluster_j, jax.tree.map(jnp.asarray, batch_j))
    return (cluster_from_numpy(to_numpy_tree(cluster_j), device),
            batch_from_numpy(to_numpy_tree(bj), device), bj)


def jax_gumbel(rng, B, N):
    keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(
        jnp.arange(B, dtype=jnp.int32))
    return jax.vmap(lambda k: jax.random.gumbel(k, (N,), jnp.float32))(keys)


def assert_same(a, b, ctx=""):
    """Bitwise equality of a jax/numpy value and a torch tensor: same
    shape, same dtype, same bits."""
    an = np.asarray(a)
    bn = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(b)
    assert an.shape == bn.shape, f"{ctx}: shape {an.shape} != {bn.shape}"
    assert an.dtype == bn.dtype, f"{ctx}: dtype {an.dtype} != {bn.dtype}"
    if an.dtype.kind == "f":
        same = (an.view(np.int32 if an.itemsize == 4 else np.int64)
                == bn.view(np.int32 if bn.itemsize == 4 else np.int64))
        assert same.all(), (
            f"{ctx}: {int((~same).sum())} elements differ; first "
            f"{an[~same][:5]} vs {bn[~same][:5]}")
    else:
        assert np.array_equal(an, bn), f"{ctx}: values differ"



# ---------------------------------------------------------------------------
# preemption: one scenario driven through both packages' Schedulers


class Package(NamedTuple):
    """One package's API, store, hollow and scheduler modules."""
    api: object
    store: object
    hollow: object
    config: object
    sched: object


def packages():
    import kubetpu.apis.config as jconf
    import kubetpu.client.store as jstore
    import kubetpu.harness.hollow as jhollow
    import kubetpu.scheduler as jsched
    import kubetpu_torch.apis.config as tconf
    import kubetpu_torch.client.store as tstore
    import kubetpu_torch.harness.hollow as thollow
    import kubetpu_torch.scheduler as tsched
    return (Package(japi, jstore, jhollow, jconf, jsched),
            Package(tapi, tstore, thollow, tconf, tsched))


class FakeClock:
    """The queue's clock, advanced by the driver: backoff and the
    unschedulable leftover flush then behave the same in both packages."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def make_scheduler(pkg, store, mode="sequential", backend="pallas",
                   batch=8, disable_preemption=False, profile=None,
                   registry=None, async_binding=False):
    """A package's Scheduler on ``store`` with the queue on a FakeClock,
    binding in the cycle unless async_binding; the port's on the CPU.
    profile: a KubeSchedulerProfile of the package (default: the default
    set); registry: its plugin factories (default: the in-tree ones)."""
    kw = dict(profiles=[profile or pkg.config.KubeSchedulerProfile()],
              batch_size=batch, mode=mode, kernel_backend=backend,
              disable_preemption=disable_preemption)
    if pkg.api is japi:
        s = pkg.sched.Scheduler(
            store, config=pkg.config.KubeSchedulerConfiguration(
                prewarm=False, **kw), registry=registry,
            async_binding=async_binding)
    else:
        s = pkg.sched.Scheduler(
            store, config=pkg.config.KubeSchedulerConfiguration(**kw),
            registry=registry, device="cpu", async_binding=async_binding)
    s.queue._clock = FakeClock()
    return s


def spy_deletes(store):
    """Instrument store.delete: the deleted pod names in call order."""
    deleted = []
    orig = store.delete

    def spy(obj, *a, **kw):
        if getattr(obj, "kind", "") == "Pod":
            deleted.append(obj.metadata.name)
        return orig(obj, *a, **kw)
    store.delete = spy
    return deleted


def cycle_view(sched, store, outcomes, deleted):
    """What one cycle left behind, comparable across packages: its
    outcomes, the pods deleted in it (in order), every pod's node,
    nomination and PodScheduled condition, and the queue's contents."""
    pods = sorted(
        (p.metadata.name, p.spec.node_name, p.status.nominated_node_name,
         tuple((c.type, c.status, c.reason, c.message)
               for c in p.status.conditions))
        for p in store.list("Pod"))
    q = sched.queue
    return dict(
        outcomes=[(o.pod.metadata.name, o.node, o.err) for o in outcomes],
        deleted=list(deleted), pods=pods,
        active=[qp.pod.metadata.name for qp in q.active_q.list()],
        backoff=[qp.pod.metadata.name for qp in q.backoff_q.list()],
        unschedulable=[qp.pod.metadata.name
                       for qp in q.unschedulable_q.values()],
        nominated=[(p.metadata.name, nn) for p, nn in q.all_nominated()])


@contextlib.contextmanager
def jax_process():
    """A spawned child process for a test module's JAX scheduler drives
    (submit a module-level function; its result comes back pickled).  The
    JAX programs those drives compile then live in the child and go with
    it when the module ends, instead of accumulating in the test worker,
    and a fault inside XLA ends the child, not the test worker."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=ctx, initializer=_child_init) as ex:
        yield ex


def _child_init() -> None:
    """In a jax_process child: the port's test settings
    (port_test_settings), and let go of the standard streams inherited
    from the test worker.  An xdist worker talks to its controller over
    its stdin and stdout; a child still holding them after the worker
    died would keep the controller from ever seeing the worker go down,
    and the run would hang."""
    _set_port_settings(1, False)
    null = os.open(os.devnull, os.O_RDWR)
    for fd in (0, 1, 2):
        os.dup2(null, fd)
    os.close(null)


def drive(pkg, scenario, max_cycles=12, **sched_kw):
    """Run ``scenario`` (a generator function of (A, hollow, store,
    sched): it sets the world up and yields to run one scheduling cycle)
    and then cycles until the queue is empty or ``max_cycles``.  Before
    every cycle the fake clock advances past every backoff and the
    unschedulable leftover timeout, and both flushes run.  Returns the
    per-cycle views and the scheduler.

    A JAX drive runs the auction through a fresh jit of the same function:
    this jax's dispatch can fail with "Execution supplied N buffers but
    compiled program expected N+1" when the jit object carries entries of
    earlier calls with other static arguments (kubetpu/models/gang.py:
    349-355 documents the bug), and the JAX scheduler would then recover
    the cycle and diverge; jax.clear_caches() does not prevent it.  Its
    per-pod reprieve runs through jax_whatif_reprieve_mapped.  Both are
    restored afterwards."""
    restore = []
    if pkg.api is japi:
        import kubetpu.models.gang as jgang
        import kubetpu.preemption as jpre
        restore = [(jgang, "_schedule_gang", jgang._schedule_gang),
                   (jpre, "_whatif_reprieve", jpre._whatif_reprieve)]
        jgang._schedule_gang = jax.jit(
            jgang._schedule_gang.__wrapped__,
            static_argnames=("cfg", "max_rounds", "intra_batch_topology",
                             "residual_window", "kernel_backend"))
        jpre._whatif_reprieve = jax_whatif_reprieve_mapped
    store = pkg.store.ClusterStore()
    sched = make_scheduler(pkg, store, **sched_kw)
    deleted = spy_deletes(store)
    views = []

    def cycle():
        sched.queue._clock.t += 100.0
        sched.queue.flush_backoff_completed()
        sched.queue.flush_unschedulable_leftover()
        del deleted[:]
        out = sched.schedule_pending(timeout=0.0)
        sched.wait_for_inflight_binds(timeout=120.0)
        views.append(cycle_view(sched, store, out, deleted))
        return out

    try:
        for _ in scenario(pkg.api, pkg.hollow, store, sched):
            cycle()
        while len(sched.queue) and len(views) < max_cycles:
            cycle()
    finally:
        sched.close()
        for mod, name, fn in restore:
            setattr(mod, name, fn)
    return views, sched


def jax_whatif_reprieve_mapped(cluster, batch1, cfg, cand_rows, rm_valid,
                               rm_req, rm_nz, vic_row, vic_req, vic_nz):
    """kubetpu/preemption.py:_whatif_reprieve with its ``jax.vmap`` over
    the candidate clusters replaced by ``jax.lax.map`` — the same
    function, one candidate at a time.  The vmapped original cannot run
    on XLA:CPU (jax 0.9.0): batching the filters' bf16 same-pair
    contractions makes a bf16 x bf16 = f32 batched dot, which the CPU
    runtime does not implement (UNIMPLEMENTED ... DotThunk::Execute).
    The JAX package's own tests never reach this path on the CPU (their
    preemptors carry no terms); the differential tests hold the port
    against this copy instead."""
    return _jax_reprieve_mapped(cluster, batch1, cfg, cand_rows, rm_valid,
                                rm_req, rm_nz, vic_row, vic_req, vic_nz)


def _jax_reprieve_body(cluster, batch1, cfg, cand_rows, rm_valid, rm_req,
                       rm_nz, vic_row, vic_req, vic_nz):
    from kubetpu.models.batch import densify_for
    batch1 = densify_for(cluster, batch1)
    C = cand_rows.shape[0]
    K = vic_row.shape[1]
    base_req = cluster.requested
    base_nz = cluster.nonzero_requested

    def one(args):
        pod_valid, dreq, dnz, row = args
        cl = cluster._replace(
            pod_valid=pod_valid,
            requested=base_req.at[row].add(-dreq),
            nonzero_requested=base_nz.at[row].add(-dnz))
        feas, _, _ = jprog.run_filters(cl, batch1, cfg)
        return feas[0]  # [N]

    def verdicts(pod_valid, dreq, dnz):
        feas = jax.lax.map(one, (pod_valid, dreq, dnz, cand_rows))  # [C, N]
        return jnp.take_along_axis(feas, cand_rows[:, None], 1)[:, 0]

    fits0 = verdicts(rm_valid, rm_req, rm_nz)

    def step(carry, k):
        pod_valid, dreq, dnz, ok = carry
        row = vic_row[:, k]
        exists = (row >= 0) & ok
        e = exists.astype(jnp.float32)
        try_valid = pod_valid.at[jnp.arange(C), jnp.clip(row, 0)].max(exists)
        try_dreq = dreq - vic_req[:, k] * e[:, None]
        try_dnz = dnz - vic_nz[:, k] * e[:, None]
        fit = verdicts(try_valid, try_dreq, try_dnz) & exists
        keep = fit[:, None]
        pod_valid = jnp.where(keep, try_valid, pod_valid)
        dreq = jnp.where(keep, try_dreq, dreq)
        dnz = jnp.where(keep, try_dnz, dnz)
        return (pod_valid, dreq, dnz, ok), fit

    (_, _, _, _), reprieved = jax.lax.scan(
        step, (rm_valid, rm_req, rm_nz, fits0), jnp.arange(K))
    return fits0, reprieved


_jax_reprieve_mapped = jax.jit(_jax_reprieve_body, static_argnames=("cfg",))


# ---------------------------------------------------------------------------
# kube-scheduler's literal tables through the port (tests/harness.py twin)


def to_port(obj):
    """A kubetpu.api object (and the lists, tuples and dicts holding them)
    as the port's API types, field by field."""
    import dataclasses
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(tapi, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


def _port_world(nodes, existing, pending):
    """(SnapshotBuilder, host arrays, PodInfos) of a world given in the
    JAX package's API types, converted and tensorized by the port."""
    infos = []
    for n in nodes:
        ni = TNodeInfo(to_port(n))
        for p in (existing or {}).get(n.name, []):
            tp = to_port(p)
            tp.spec.node_name = n.name
            ni.add_pod(tp)
        infos.append(ni)
    sb = TSnapshotBuilder()
    pinfos = [TPodInfo(to_port(p)) for p in pending]
    sb.intern_pending(pinfos)
    return sb, sb.build(infos), pinfos


class PortResult:
    """tests/harness.Result of the port's schedule_batch (numpy fields)."""

    def __init__(self, res, chosen, n_nodes, n_pods, node_names):
        def cut(x):
            return x.numpy()[:n_pods, :n_nodes]
        self.feasible = cut(res.feasible)
        self.unresolvable = cut(res.unresolvable)
        self.scores = cut(res.scores)
        self.plugin_scores = {k: cut(v)
                              for k, v in res.plugin_scores.items()}
        self.chosen = chosen.numpy()[:n_pods]
        self.node_names = node_names


def port_run_cluster(nodes, existing=None, pending=(),
                     filters=jprog.DEFAULT_FILTER_PLUGINS,
                     scores=jprog.DEFAULT_SCORE_PLUGINS,
                     spread_selectors=None, plugin_args=(),
                     plugin_args_fn=None, seed=0) -> PortResult:
    """tests/harness.run_cluster through the port: the same arguments,
    the world converted to the port's API types, tensorized by its
    builders and run through its schedule_batch on the CPU."""
    from kubetpu_torch.models.batch import batch_to_device
    from kubetpu_torch.utils import prng
    sb, host, pinfos = _port_world(nodes, existing, pending)
    batch = TBatchBuilder(sb.table).build(
        pinfos, spread_selectors=to_port(spread_selectors))
    if plugin_args_fn is not None:
        plugin_args = plugin_args_fn(sb.table)
    cfg = tprog.ProgramConfig(
        filters=tuple(filters), scores=tuple(scores),
        hostname_topokey=sb.table.topokey.get(tapi.LABEL_HOSTNAME),
        plugin_args=tuple(plugin_args))
    res, chosen = tprog.schedule_batch(host.to_device("cpu"),
                                       batch_to_device(batch, "cpu"), cfg,
                                       prng.PRNGKey(seed))
    return PortResult(res, chosen, len(nodes), len(pending),
                      [n.name for n in nodes])


# ---------------------------------------------------------------------------
# scenario twins: one scenario, both packages


def framework_packages():
    """(JAX, port) namespaces of the modules a scenario with custom
    profiles touches."""
    from types import SimpleNamespace

    def ns(name, root):
        mods = {}
        for attr, mod in (("conf", "apis.config"), ("load", "apis.load"),
                          ("store", "client.store"),
                          ("hollow", "harness.hollow"),
                          ("fw", "framework.interface"),
                          ("runtime", "framework.runtime"),
                          ("intree", "plugins.intree"),
                          ("features", "utils.features"),
                          ("sched", "scheduler")):
            mods[attr] = __import__(f"{root}.{mod}", fromlist=["_"])
        return SimpleNamespace(name=name, api=__import__(
            f"{root}.api.types", fromlist=["_"]), **mods)
    return ns("jax", "kubetpu"), ns("port", "kubetpu_torch")


def new_scheduler(P, store, registry=None, async_binding=False, **cfg_kw):
    """A Scheduler of package namespace P (framework_packages) on
    ``store``: the JAX one without prewarm, the port's on the CPU."""
    if P.name == "jax":
        return P.sched.Scheduler(
            store, config=P.conf.KubeSchedulerConfiguration(prewarm=False,
                                                            **cfg_kw),
            registry=registry, async_binding=async_binding)
    return P.sched.Scheduler(
        store, config=P.conf.KubeSchedulerConfiguration(**cfg_kw),
        registry=registry, device="cpu", async_binding=async_binding)


def outcome_view(store, outcomes):
    """What a scenario left behind, comparable across packages: the
    outcomes, and every pod's node and PodScheduled condition."""
    return dict(
        outcomes=[(o.pod.metadata.name, o.node, o.err) for o in outcomes],
        pods=sorted((p.metadata.name, p.spec.node_name,
                     tuple((c.type, c.status, c.reason, c.message)
                           for c in p.status.conditions))
                    for p in store.list("Pod")))
