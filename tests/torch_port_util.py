"""Shared helpers of the PyTorch-port differential tests (tests/test_torch_*).

The same seeded world is built twice — once from the JAX package's API
types, once from the port's copies — so each package tensorizes it with
its own builder; and JAX-side tensors cross to the port as numpy leaves
(cluster_from_numpy / batch_from_numpy) so both sides can also be fed
identical state.
"""
from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

import kubetpu.api.types as japi
import kubetpu_torch.api.types as tapi
from kubetpu.framework.types import NodeInfo as JNodeInfo, PodInfo as JPodInfo
from kubetpu.models import programs as jprog
from kubetpu.models.batch import PodBatchBuilder as JBatchBuilder
from kubetpu.models.batch import densify_for as jdensify
from kubetpu.state.tensors import SnapshotBuilder as JSnapshotBuilder
from kubetpu_torch.framework.types import NodeInfo as TNodeInfo
from kubetpu_torch.framework.types import PodInfo as TPodInfo
from kubetpu_torch.models import programs as tprog
from kubetpu_torch.models.batch import PodBatchBuilder as TBatchBuilder
from kubetpu_torch.models.batch import batch_from_numpy
from kubetpu_torch.state.tensors import SnapshotBuilder as TSnapshotBuilder
from kubetpu_torch.state.tensors import cluster_from_numpy

FULL_FILTERS = jprog.DEFAULT_FILTER_PLUGINS


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
    nodes, existing, pending = churned(japi, seed, n_nodes, n_pods, terms)
    sb = JSnapshotBuilder()
    pinfos = [JPodInfo(p) for p in pending]
    sb.intern_pending(pinfos)
    host = sb.build(_infos(JNodeInfo, nodes, existing))
    batch = jax.tree.map(np.asarray, JBatchBuilder(sb.table).build(pinfos))
    cfg = jprog.ProgramConfig(
        filters=FULL_FILTERS, scores=jprog.DEFAULT_SCORE_PLUGINS,
        hostname_topokey=max(sb.table.topokey.get(japi.LABEL_HOSTNAME), 0))
    return host.to_device(), batch, cfg, host


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

