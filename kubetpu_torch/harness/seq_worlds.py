"""Seeded worlds with every default family live, for both modes.

One builder for the sequential replay's and the gang auction's
(intra-batch topology) checks: the port's CPU tests (the same world built
in the JAX package's API types and in the port's, each tensorized by its
own package) and chip_smoke.py's card-against-CPU checks.  The API module
is a parameter, so this module imports nothing but the port.

A world is heterogeneous nodes (capacities, zones with some nodes
zone-less, NoSchedule and PreferNoSchedule taints, a few unschedulable
nodes), existing pods carrying preferred (anti-)affinity, required
anti-affinity and required affinity terms, and pending pods with
tolerations, hostPorts, preferred node affinity, required (anti-)affinity,
preferred (anti-)affinity, hard and soft zone spread, soft hostname spread
and Service selectors (DefaultPodTopologySpread).
"""

from __future__ import annotations

import random
from typing import List

import numpy as np

from ..api import types as port_api

APPS = ("a", "b", "c", "d")
SERVICE_APPS = ("a", "b")     # apps a Service selects


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


def _term(A, app, key):
    return A.PodAffinityTerm(
        label_selector=A.LabelSelector(match_labels={"app": app}),
        topology_key=key)


def _weighted(A, weight, app, key):
    return A.WeightedPodAffinityTerm(weight=weight,
                                     pod_affinity_term=_term(A, app, key))


def _spread(A, app, key, skew, when):
    return A.TopologySpreadConstraint(
        max_skew=skew, topology_key=key, when_unsatisfiable=when,
        label_selector=A.LabelSelector(match_labels={"app": app}))


def services(A) -> List:
    """The Services whose selectors give DefaultPodTopologySpread its
    selectors."""
    return [A.Service(metadata=A.ObjectMeta(name=f"svc-{app}",
                                            namespace="default"),
                      selector={"app": app})
            for app in SERVICE_APPS]


def spread_selector(A, pod):
    """The store's combined Service selector for ``pod`` (None when no
    Service selects it)."""
    app = pod.metadata.labels.get("app")
    if app not in SERVICE_APPS:
        return None
    return A.LabelSelector(match_expressions=[
        A.LabelSelectorRequirement("app", "In", [app])])


def term_world(A, seed: int, n_nodes: int, n_pods: int):
    """(nodes, existing {node name: [pods]}, pending) in API module A."""
    r = random.Random(seed)
    host, zone = A.LABEL_HOSTNAME, A.LABEL_ZONE
    nodes = []
    for i in range(n_nodes):
        labels = {"disk": r.choice(["ssd", "hdd"]), host: f"n{i}"}
        if r.random() < 0.85:
            labels[zone] = "z%d" % r.randrange(4)
        taints = []
        if r.random() < 0.2:
            taints.append(A.Taint(
                key="dedicated", value="gpu",
                effect=r.choice(["NoSchedule", "PreferNoSchedule"])))
        nodes.append(_node(A, f"n{i}", labels, r.choice(["2", "4", "8"]),
                           r.choice(["4Gi", "16Gi"]),
                           str(r.choice([8, 16, 110])), taints,
                           r.random() < 0.03))
    existing = {}
    for i in range(n_nodes):
        eps = []
        for j in range(r.randrange(0, 4)):
            p = _pod(A, f"e{i}_{j}", {"app": r.choice(APPS)},
                     r.choice(["100m", "500m"]), "128Mi")
            roll = r.random()
            if roll < 0.2:
                p.spec.affinity = A.Affinity(pod_affinity=A.PodAffinity(
                    preferred_during_scheduling_ignored_during_execution=[
                        _weighted(A, r.choice([10, 50]), r.choice(APPS),
                                  zone)]))
            elif roll < 0.3:
                p.spec.affinity = A.Affinity(
                    pod_anti_affinity=A.PodAntiAffinity(
                        required_during_scheduling_ignored_during_execution=[
                            _term(A, "c", host)]))
            elif roll < 0.35:
                p.spec.affinity = A.Affinity(pod_affinity=A.PodAffinity(
                    required_during_scheduling_ignored_during_execution=[
                        _term(A, "a", zone)]))
            elif roll < 0.4:
                p.spec.affinity = A.Affinity(
                    pod_anti_affinity=A.PodAntiAffinity(
                        preferred_during_scheduling_ignored_during_execution=[
                            _weighted(A, 30, r.choice(APPS), zone)]))
            p.spec.node_name = f"n{i}"
            eps.append(p)
        existing[f"n{i}"] = eps
    pending = []
    for i in range(n_pods):
        kw = {}
        if r.random() < 0.25:
            kw["tolerations"] = [A.Toleration(key="dedicated",
                                              operator="Exists")]
        app = r.choice(APPS)
        p = _pod(A, f"p{i}", {"app": app},
                 r.choice(["100m", "500m", "1"]), r.choice(["64Mi", "512Mi"]),
                 **kw)
        if r.random() < 0.15:
            p.spec.containers[0].ports = [A.ContainerPort(
                container_port=8080, host_port=r.choice([8080, 9090]))]
        aff = A.Affinity()
        if r.random() < 0.15:
            aff.node_affinity = A.NodeAffinity(
                preferred_during_scheduling_ignored_during_execution=[
                    A.PreferredSchedulingTerm(
                        weight=r.choice([10, 100]),
                        preference=A.NodeSelectorTerm(match_expressions=[
                            A.NodeSelectorRequirement(
                                key="disk", operator="In",
                                values=["ssd"])]))])
        other = r.choice(APPS)
        roll = r.random()
        cons = p.spec.topology_spread_constraints
        if roll < 0.1:
            cons.append(_spread(A, app, zone, 1, "DoNotSchedule"))
        elif roll < 0.18:
            cons.append(_spread(A, app, zone, 1, "ScheduleAnyway"))
        elif roll < 0.24:
            cons.append(_spread(A, app, host, 1, "ScheduleAnyway"))
        elif roll < 0.28:
            # two constraints of each kind on one pod
            cons.append(_spread(A, app, zone, 2, "DoNotSchedule"))
            cons.append(_spread(A, other, host, 3, "DoNotSchedule"))
            cons.append(_spread(A, app, zone, 1, "ScheduleAnyway"))
            cons.append(_spread(A, other, host, 2, "ScheduleAnyway"))
        elif roll < 0.33:
            aff.pod_anti_affinity = A.PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=[
                    _term(A, app, host)])
        elif roll < 0.38:
            # two terms on one topology key: repeated pair ids in one step
            aff.pod_anti_affinity = A.PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=[
                    _term(A, app, host), _term(A, other, host)])
        elif roll < 0.44:
            aff.pod_anti_affinity = A.PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=[
                    _term(A, other, zone)])
        elif roll < 0.52:
            aff.pod_affinity = A.PodAffinity(
                required_during_scheduling_ignored_during_execution=[
                    _term(A, "a", zone)],
                preferred_during_scheduling_ignored_during_execution=[
                    _weighted(A, 20, app, host)])
        elif roll < 0.6:
            aff.pod_anti_affinity = A.PodAntiAffinity(
                preferred_during_scheduling_ignored_during_execution=[
                    _weighted(A, 40, other, zone),
                    _weighted(A, 10, app, zone)])
        if (aff.node_affinity or aff.pod_affinity
                or aff.pod_anti_affinity):
            p.spec.affinity = aff
        pending.append(p)
    return nodes, existing, pending


def port_inputs(seed: int, n_nodes: int, n_pods: int) -> tuple:
    """term_world in the port's API types, tensorized by the port's
    builders, Service selectors included: (HostClusterArrays, host
    PodBatch, the hostname topology key's vocab id)."""
    from ..framework.types import NodeInfo, PodInfo
    from ..models.batch import PodBatchBuilder
    from ..state.tensors import SnapshotBuilder
    A = port_api
    nodes, existing, pending = term_world(A, seed, n_nodes, n_pods)
    infos = []
    for n in nodes:
        ni = NodeInfo(n)
        for p in existing.get(n.name, []):
            ni.add_pod(p)
        infos.append(ni)
    pinfos = [PodInfo(p) for p in pending]
    builder = SnapshotBuilder()
    builder.intern_pending(pinfos)
    host = builder.build(infos)
    batch = PodBatchBuilder(builder.table).build(
        pinfos, spread_selectors=[spread_selector(A, p) for p in pending])
    return host, batch, max(builder.table.topokey.get(A.LABEL_HOSTNAME), 0)


def term_keys(batch) -> tuple:
    """The topology-key ids of a host batch's valid term sets (the
    ProgramConfig.active_topo_keys the scheduler sets for it)."""
    keys = set()
    for t in (batch.ra, batch.raa, batch.pref, batch.spread,
              batch.spread_soft):
        live = np.asarray(t.valid) & np.asarray(t.topo_known)
        keys.update(np.asarray(t.topo_key)[live].tolist())
    return tuple(sorted(keys))
