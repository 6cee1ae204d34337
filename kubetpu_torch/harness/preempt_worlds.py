"""Seeded preemption worlds for the scheduler's failure path.

One builder for the port's CPU tests (the same world built in the JAX
package's API types and in the port's, each drained by its own
scheduler) and chip_smoke.py's card-against-CPU check.  The API module is
a parameter, so this module imports nothing but the port.

A world is nodes packed with bound victims of mixed priorities (so most
preemptors fit nowhere until something is evicted); PodDisruptionBudgets
whose budgets bind (0 or 1 disruptions allowed over a labelled share of
the victims); pods already nominated to nodes (parked in the nominator,
as a preemptor is while its victims terminate); and pending preemptors
of several priorities, some asking for memory that is not a whole MiB.
With ``terms=True`` some bound pods carry required hostname anti-affinity
(so every preemptor's what-if takes the per-pod reprieve) and some
preemptors carry zone spread constraints or pod (anti-)affinity.  Every
object's creation timestamp is fixed (pickOneNodeForPreemption's fifth
criterion reads it), so the two packages' worlds are identical.
"""

from __future__ import annotations

import random
from typing import List, NamedTuple, Tuple

VICTIM_PRIOS = (-10, 0, 5, 10, 50)
PREEMPTOR_PRIOS = (20, 60, 100)
GUARDED = ("g0", "g1")     # PDB-guarded victim groups


class World(NamedTuple):
    nodes: list
    bound: list            # victims, spec.node_name set
    pdbs: list
    parked: List[Tuple[object, str]]   # (pod, nominated node name)
    pending: list          # the preemptors


def _pod(A, name, labels, cpu, mem, prio, ts):
    c = A.Container(name="c", image="img:1", resources=A.ResourceRequirements(
        requests={"cpu": cpu, "memory": mem}))
    return A.Pod(metadata=A.ObjectMeta(name=name, namespace="default",
                                       labels=labels,
                                       creation_timestamp=float(ts)),
                 spec=A.PodSpec(containers=[c], priority=prio))


def world(A, seed: int, n_nodes: int, n_pending: int, terms: bool = False,
          n_parked: int = 2) -> World:
    """A seeded preemption world in API module A."""
    r = random.Random(seed)
    host, zone = A.LABEL_HOSTNAME, A.LABEL_ZONE
    nodes = []
    for i in range(n_nodes):
        labels = {host: f"n{i}", zone: "z%d" % (i % 3)}
        nodes.append(A.Node(
            metadata=A.ObjectMeta(name=f"n{i}", labels=labels),
            status=A.NodeStatus(allocatable={
                "cpu": r.choice(["2", "4"]), "memory": "8Gi",
                "pods": str(r.choice([4, 6, 110]))})))
    ts = 0
    bound = []
    for i, n in enumerate(nodes):
        cap = int(n.status.allocatable["cpu"]) * 1000
        used = 0
        j = 0
        while True:
            cpu = r.choice([300, 500, 700, 900, 1100])
            if used + cpu > cap or j >= 5:
                break
            used += cpu
            labels = {"app": r.choice(("a", "b", "c"))}
            if r.random() < 0.3:
                labels["guard"] = r.choice(GUARDED)
            ts += 1
            p = _pod(A, f"v{i}_{j}", labels, f"{cpu}m",
                     r.choice(["128Mi", "256Mi", "300M", "123456789"]),
                     r.choice(VICTIM_PRIOS), ts)
            if terms and r.random() < 0.2:
                p.spec.affinity = A.Affinity(
                    pod_anti_affinity=A.PodAntiAffinity(
                        required_during_scheduling_ignored_during_execution=[
                            A.PodAffinityTerm(
                                label_selector=A.LabelSelector(
                                    match_labels={"app": "x"}),
                                topology_key=host)]))
            p.spec.node_name = n.name
            bound.append(p)
            j += 1
    pdbs = [A.PodDisruptionBudget(
        metadata=A.ObjectMeta(name=f"pdb-{g}", namespace="default"),
        selector=A.LabelSelector(match_labels={"guard": g}),
        disruptions_allowed=k)
        for k, g in enumerate(GUARDED)]
    parked = []
    for i in range(n_parked):
        ts += 1
        p = _pod(A, f"nom{i}", {"app": "n"}, r.choice(["500m", "900m"]),
                 "128Mi", r.choice((60, 100, 200)), ts)
        nn = nodes[r.randrange(n_nodes)].name
        p.status.nominated_node_name = nn
        parked.append((p, nn))
    pending = []
    for i in range(n_pending):
        ts += 1
        app = r.choice(("a", "b", "x"))
        p = _pod(A, f"p{i}", {"app": app},
                 r.choice(["600m", "1000m", "1500m", "2500m"]),
                 r.choice(["250Mi", "100M", "1Gi"]),
                 r.choice(PREEMPTOR_PRIOS), ts)
        if terms:
            roll = r.random()
            if roll < 0.25:
                p.spec.topology_spread_constraints = [
                    A.TopologySpreadConstraint(
                        max_skew=1, topology_key=zone,
                        when_unsatisfiable="DoNotSchedule",
                        label_selector=A.LabelSelector(
                            match_labels={"app": app}))]
            elif roll < 0.45:
                p.spec.affinity = A.Affinity(
                    pod_anti_affinity=A.PodAntiAffinity(
                        required_during_scheduling_ignored_during_execution=[
                            A.PodAffinityTerm(
                                label_selector=A.LabelSelector(
                                    match_labels={"app": app}),
                                topology_key=host)]))
        pending.append(p)
    return World(nodes, bound, pdbs, parked, pending)


def populate(store, w: World) -> None:
    """Add the world's nodes, bound victims and PDBs to ``store`` (the
    pending preemptors and the parked nominations are the caller's)."""
    for n in w.nodes:
        store.add(n)
    for p in w.bound:
        store.add(p)
    for pdb in w.pdbs:
        store.add(pdb)
