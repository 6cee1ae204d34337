"""Seeded worlds that carry a custom profile: the configurable scorers,
host plugins at every extension point, and a Permit pair.

The port's CPU tests build a world here in the JAX package's API types and
in the port's, and drive both schedulers through it; chip_smoke.py drives
the port on the card and on the CPU.  Every module the world needs (API
types, configuration, the framework's plugin bases) is a parameter, so
this module imports nothing but the port.

A world holds nodes with the labels NodeLabel reads (``tier`` present on
most, ``drain`` on a few, ``disk``) and the ``rack`` ServiceAffinity
scores by, an extended resource (EXT) on half the nodes, existing pods,
and pending pods with limits (NodeResourceLimits), EXT requests and two
Permit pairs; ``terms=True`` adds pod (anti-)affinity and spread terms and
Services (ServiceAffinity, DefaultPodTopologySpread).  The profile adds to
the default set: NodeResourcesMostAllocated in place of LeastAllocated,
the NodeLabel filter, ServiceAffinity, the recording plugin POINTS at
every point (a host filter rejecting a seeded node subset, a host score,
the Permit pairs and per-pod injected failures), and, with
``scorers=True``, RequestedToCapacityRatio over cpu, memory and EXT,
NodeResourceLimits and the NodeLabel score.
"""

from __future__ import annotations

import random
import zlib
from typing import Dict, List, Optional

EXT = "example.com/foo"
POINTS = "WorldPoints"
PERMIT_TIMEOUT = 30.0
PAIRS = 2                 # pending pods 0-1 and 2-3 are Permit pairs


def _h(*parts) -> int:
    """A stable hash (the same in every process)."""
    return zlib.crc32("/".join(str(p) for p in parts).encode())


def world(A, seed: int, n_nodes: int = 48, n_pods: int = 200,
          terms: bool = False):
    """(nodes, existing {node: [pods]}, pending, services) in API module
    ``A``."""
    r = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {A.LABEL_HOSTNAME: f"n{i}", A.LABEL_ZONE: f"z{i % 4}",
                  "rack": f"r{r.randrange(6)}",
                  "disk": r.choice(["ssd", "hdd"])}
        if r.random() < 0.85:
            labels["tier"] = "gold"
        if r.random() < 0.1:
            labels["drain"] = "true"
        alloc = {"cpu": r.choice(["4", "8", "16"]),
                 "memory": r.choice(["16Gi", "32Gi"]), "pods": "110"}
        if i % 2 == 0:
            alloc[EXT] = "4"
        nodes.append(A.Node(metadata=A.ObjectMeta(name=f"n{i}",
                                                  labels=labels),
                            spec=A.NodeSpec(),
                            status=A.NodeStatus(allocatable=alloc)))

    def pod(name, app, cpu, mem, ext=0, limits=None):
        req = {"cpu": cpu, "memory": mem}
        if ext:
            req[EXT] = str(ext)
        c = A.Container(name="c", image="img:1",
                        resources=A.ResourceRequirements(
                            requests=req, limits=dict(limits or {})))
        return A.Pod(metadata=A.ObjectMeta(name=name, namespace="default",
                                           labels={"app": app}),
                     spec=A.PodSpec(containers=[c]))

    existing: Dict[str, List] = {}
    for i, n in enumerate(nodes):
        eps = []
        for j in range(r.randrange(0, 4)):
            p = pod(f"e{i}_{j}", r.choice("abc"), r.choice(["500m", "1"]),
                    r.choice(["1Gi", "2Gi"]),
                    ext=1 if i % 2 == 0 and r.random() < 0.3 else 0)
            p.spec.node_name = n.name
            eps.append(p)
        existing[n.name] = eps
    pending = []
    for i in range(n_pods):
        limits = ({"cpu": r.choice(["2", "12"]),
                   "memory": r.choice(["4Gi", "24Gi"])}
                  if r.random() < 0.5 else None)
        p = pod(f"p{i}", r.choice("abc"),
                "100m" if i < 2 * PAIRS else r.choice(["100m", "500m", "1"]),
                r.choice(["256Mi", "1Gi"]),
                ext=1 if i >= 2 * PAIRS and r.random() < 0.2 else 0,
                limits=limits)
        if i < 2 * PAIRS:
            p.metadata.labels["pair"] = str(i // 2)
        elif terms:
            roll = r.random()
            sel = A.LabelSelector(match_labels={"app": r.choice("ab")})
            if roll < 0.2:
                p.spec.affinity = A.Affinity(
                    pod_anti_affinity=A.PodAntiAffinity(
                        required_during_scheduling_ignored_during_execution=[
                            A.PodAffinityTerm(label_selector=sel,
                                              topology_key=A.LABEL_HOSTNAME)]))
            elif roll < 0.35:
                p.spec.topology_spread_constraints = [
                    A.TopologySpreadConstraint(
                        max_skew=2, topology_key=A.LABEL_ZONE,
                        when_unsatisfiable=r.choice(
                            ["DoNotSchedule", "ScheduleAnyway"]),
                        label_selector=sel)]
        pending.append(p)
    services = ([A.Service(metadata=A.ObjectMeta(name="svc-a",
                                                 namespace="default"),
                           selector={"app": "a"})] if terms else [])
    return nodes, existing, pending, services


def populate(store, nodes, existing, services) -> None:
    """Add a world's nodes, bound pods and Services to a store."""
    for n in nodes:
        store.add(n)
    for eps in existing.values():
        for p in eps:
            store.add(p)
    for s in services:
        store.add(s)


def profile(C, scorers: bool = True):
    """The world's KubeSchedulerProfile in configuration module ``C``."""
    P, S = C.Plugin, C.PluginSet
    score = [P("NodeResourcesMostAllocated", 1)]
    if scorers:
        score += [P("RequestedToCapacityRatio", 1),
                  P("NodeResourceLimits", 1), P("NodeLabel", 1)]
    score += [P("ServiceAffinity", 1), P(POINTS, 1)]
    plugins = C.Plugins(
        pre_filter=S(enabled=[P("ServiceAffinity"), P(POINTS)]),
        filter=S(enabled=[P("NodeLabel"), P("ServiceAffinity"),
                          P(POINTS)]),
        post_filter=S(enabled=[P(POINTS)]),
        pre_score=S(enabled=[P(POINTS)]),
        score=S(enabled=score,
                disabled=[P("NodeResourcesLeastAllocated")]),
        reserve=S(enabled=[P(POINTS)]),
        unreserve=S(enabled=[P(POINTS)]),
        permit=S(enabled=[P(POINTS)]),
        pre_bind=S(enabled=[P(POINTS)]),
        # the recorder first, returning Skip: DefaultBinder binds
        bind=S(enabled=[P(POINTS), P("DefaultBinder")],
               disabled=[P("*")]),
        post_bind=S(enabled=[P(POINTS)]))
    return C.KubeSchedulerProfile(plugins=plugins, plugin_config={
        "NodeLabel": {"presentLabels": ["tier"], "absentLabels": ["drain"],
                      "presentLabelsPreference": ["disk"],
                      "absentLabelsPreference": ["rack"]},
        "RequestedToCapacityRatio": {
            "shape": [{"utilization": 0, "score": 0},
                      {"utilization": 40, "score": 7},
                      {"utilization": 100, "score": 3}],
            "resources": [{"name": "cpu", "weight": 1},
                          {"name": "memory", "weight": 1},
                          {"name": EXT, "weight": 2}]},
        "ServiceAffinity": {"affinityLabels": ["disk"],
                            "antiAffinityLabelsPreference": ["rack"]}})


def points_plugin(fw, seed: int, calls: List, fail_at: Optional[Dict] = None):
    """The registry factory of POINTS for framework interface module
    ``fw``.  calls receives (point, pod name, node name or None) from
    every point, in call order; fail_at maps a pod name to the point
    ("Reserve", "Permit" or "PreBind") at which that pod fails."""
    fail_at = dict(fail_at or {})

    class WorldPoints(fw.PreFilterPlugin, fw.FilterPlugin,
                      fw.PostFilterPlugin, fw.PreScorePlugin,
                      fw.ScorePlugin, fw.ReservePlugin, fw.UnreservePlugin,
                      fw.PermitPlugin, fw.PreBindPlugin, fw.BindPlugin,
                      fw.PostBindPlugin):
        NAME = POINTS

        def __init__(self, handle):
            self.handle = handle

        def name(self):
            return POINTS

        def _rec(self, point, pod, node=None):
            calls.append((point, pod.metadata.name, node))

        def _fails(self, point, pod) -> bool:
            return fail_at.get(pod.metadata.name) == point

        def pre_filter(self, state, pod):
            self._rec("PreFilter", pod)
            return fw.Status.success()

        def filter(self, state, pod, node_info):
            self._rec("Filter", pod, node_info.node_name)
            if _h(seed, pod.metadata.name, node_info.node_name) % 7 == 0:
                return fw.Status.unschedulable("rejected by host filter")
            return fw.Status.success()

        def post_filter(self, state, pod, filtered_node_status=None):
            self._rec("PostFilter", pod)
            return None, fw.Status.unschedulable("no help")

        def pre_score(self, state, pod, nodes):
            self._rec("PreScore", pod)
            return fw.Status.success()

        def score(self, state, pod, node_name):
            self._rec("Score", pod, node_name)
            return _h(pod.metadata.name, node_name) % 11, fw.Status.success()

        def score_extensions(self):
            return self

        def normalize_score(self, state, pod, scores):
            self._rec("NormalizeScore", pod)
            top = max(s for _, s in scores) or 1
            return ([(n, s * fw.MAX_NODE_SCORE // top) for n, s in scores],
                    fw.Status.success())

        def reserve(self, state, pod, node_name):
            self._rec("Reserve", pod, node_name)
            if self._fails("Reserve", pod):
                return fw.Status.error("injected reserve failure")
            return fw.Status.success()

        def unreserve(self, state, pod, node_name):
            self._rec("Unreserve", pod, node_name)

        def permit(self, state, pod, node_name):
            """The first pod of a pair waits; the second allows it."""
            self._rec("Permit", pod, node_name)
            if self._fails("Permit", pod):
                return fw.Status.unschedulable("injected permit rejection"), 0.0
            pair = pod.metadata.labels.get("pair")
            if pair is None:
                return fw.Status.success(), 0.0
            waiting = []
            self.handle.iterate_over_waiting_pods(
                lambda wp: waiting.append(wp)
                if wp.pod.metadata.labels.get("pair") == pair else None)
            if not waiting:
                return fw.Status(fw.Code.WAIT), PERMIT_TIMEOUT
            for wp in waiting:
                wp.allow(POINTS)
            return fw.Status.success(), 0.0

        def pre_bind(self, state, pod, node_name):
            self._rec("PreBind", pod, node_name)
            if self._fails("PreBind", pod):
                return fw.Status.error("injected prebind failure")
            return fw.Status.success()

        def bind(self, state, pod, node_name):
            self._rec("Bind", pod, node_name)
            return fw.Status(fw.Code.SKIP)

        def post_bind(self, state, pod, node_name):
            self._rec("PostBind", pod, node_name)

    return lambda args=None, handle=None: WorldPoints(handle)


def per_pod(calls) -> Dict[str, List]:
    """calls grouped by pod, each pod's in call order."""
    out: Dict[str, List] = {}
    for point, pod, node in calls:
        out.setdefault(pod, []).append((point, node))
    return out
