"""Composed filter and score passes for one scheduler profile.

The counterpart of kubetpu/models/programs.py for the gang auction: the
device-side replacement for the reference's per-pod Filter -> Score ->
NormalizeScore -> weight pipeline (reference: core/generic_scheduler.go:146
Schedule, prioritizeNodes :622; weights framework/v1alpha1/framework.go:
579-656), over a whole batch of B pods against N nodes at once.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..ops import kernels as K

# Default plugin weights (reference: algorithmprovider/registry.go:119-134).
DEFAULT_SCORE_PLUGINS: Tuple[Tuple[str, int], ...] = (
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("InterPodAffinity", 1),
    ("NodeResourcesLeastAllocated", 1),
    ("NodeAffinity", 1),
    ("NodePreferAvoidPods", 10000),
    ("PodTopologySpread", 2),
    ("DefaultPodTopologySpread", 1),
    ("TaintToleration", 1),
)

DEFAULT_FILTER_PLUGINS: Tuple[str, ...] = (
    "NodeUnschedulable",
    "NodeResourcesFit",
    "NodeName",
    "NodePorts",
    "NodeAffinity",
    "TaintToleration",
    "PodTopologySpread",
    "InterPodAffinity",
)

# Filters whose failure is UnschedulableAndUnresolvable — preemption cannot
# help on such nodes (consumed by nodesWherePreemptionMightHelp,
# core/generic_scheduler.go:1041).
UNRESOLVABLE_FILTERS = frozenset({
    "NodeUnschedulable", "NodeName", "NodeAffinity", "TaintToleration",
})


class ProgramConfig(NamedTuple):
    """Static (hashable) program configuration — one per profile."""
    filters: Tuple[str, ...] = DEFAULT_FILTER_PLUGINS
    scores: Tuple[Tuple[str, int], ...] = DEFAULT_SCORE_PLUGINS
    hostname_topokey: int = 0  # topokey vocab id of kubernetes.io/hostname
    # per-plugin static kernel args ((plugin, args-tuple), ...); none of the
    # default family reads any
    plugin_args: Tuple[Tuple[str, Tuple], ...] = ()
    # kept for field parity with the JAX package; the auction always
    # searches every node
    percentage_of_nodes_to_score: int = 100
    # topology-key ids that can appear in the batch's term sets; () = all
    # keys (always safe); a non-empty tuple MUST be a superset
    active_topo_keys: Tuple[int, ...] = ()

    @property
    def active_keys(self):
        return self.active_topo_keys or None

    def arg(self, name: str, default=()):
        for n, a in self.plugin_args:
            if n == name:
                return a
        return default


def _filter_mask(name: str, cluster, batch, cfg: ProgramConfig, affinity_ok):
    """One filter plugin's pass mask [B, N] -> (ok, extra_unresolvable or
    None)."""
    if name == "NodeUnschedulable":
        return K.node_unschedulable_filter(cluster, batch), None
    if name == "NodeResourcesFit":
        return K.fit_filter(cluster, batch), None
    if name == "NodeName":
        return K.node_name_filter(cluster, batch), None
    if name == "NodePorts":
        return K.node_ports_filter(cluster, batch), None
    if name == "NodeAffinity":
        return affinity_ok, None
    if name == "TaintToleration":
        return K.taint_filter(cluster, batch), None
    if name == "PodTopologySpread":
        return K.spread_filter(cluster, batch, affinity_ok,
                               active_keys=cfg.active_keys), None
    if name == "InterPodAffinity":
        return K.interpod_filter(cluster, batch, active_keys=cfg.active_keys)
    raise NotImplementedError(
        "filter kernel %s is not ported (ROADMAP: framework extension "
        "points)" % name)


def run_filters(cluster, batch, cfg: ProgramConfig, host_ok=None,
                skip: Tuple[str, ...] = ()):
    """Returns (feasible, unresolvable, node_affinity_ok).  host_ok [B, N]
    carries host-side filter verdicts; skip names filters the caller
    evaluates itself (gang mode re-evaluates NodeResourcesFit/NodePorts
    against in-flight placements)."""
    base = cluster.node_valid[None, :] & batch.valid[:, None]
    if host_ok is not None:
        base = base & host_ok
    feasible = base
    unresolvable = torch.zeros_like(base)
    affinity_ok = K.node_affinity_filter(cluster, batch)
    for name in cfg.filters:
        if name in skip:
            continue
        ok, extra_unres = _filter_mask(name, cluster, batch, cfg, affinity_ok)
        if extra_unres is not None:
            unresolvable = unresolvable | (extra_unres & base)
        if name in UNRESOLVABLE_FILTERS:
            unresolvable = unresolvable | (~ok & base)
        feasible = feasible & ok
    return feasible, unresolvable, affinity_ok


STATIC_RAW_SCORES = {
    # score plugins whose RAW scores do not depend on the auction carry:
    # gang mode computes them once and re-normalizes per round
    "ImageLocality": K.image_locality_score,
    "NodeAffinity": K.node_affinity_score,
    "NodePreferAvoidPods": K.prefer_avoid_pods_score,
    "TaintToleration": K.taint_toleration_score,
}


def static_raw_scores(cluster, batch, cfg: ProgramConfig):
    """The assignment-independent raw scores, keyed "raw:<plugin>"."""
    return {f"raw:{name}": fn(cluster, batch)
            for name, fn in STATIC_RAW_SCORES.items()
            if any(n == name for n, _ in cfg.scores)}


def run_scores(cluster, batch, cfg: ProgramConfig, feasible, affinity_ok,
               pre=None):
    """Per-plugin normalized scores x weight, summed (reference:
    framework.go:579-656 RunScorePlugins).  pre: precomputed
    assignment-independent tensors ("interpod_score", "default_spread",
    "raw:<plugin>").  PodTopologySpread scores the term-free constant path
    only: a batch with soft spread constraints is refused before the
    auction (ROADMAP: intra-batch topology)."""
    pre = pre or {}
    total = torch.zeros(feasible.shape, dtype=torch.float32,
                        device=feasible.device)
    per_plugin: Dict[str, torch.Tensor] = {}
    for name, weight in cfg.scores:
        if name == "NodeResourcesBalancedAllocation":
            s = K.balanced_allocation_score(cluster, batch)
        elif name == "ImageLocality":
            s = pre.get("raw:ImageLocality")
            if s is None:
                s = K.image_locality_score(cluster, batch)
        elif name == "InterPodAffinity":
            s = K.interpod_score(cluster, batch, feasible,
                                 pre=pre.get("interpod_score"),
                                 active_keys=cfg.active_keys)
        elif name == "NodeResourcesLeastAllocated":
            s = K.least_allocated_score(cluster, batch)
        elif name == "NodeResourcesMostAllocated":
            s = K.most_allocated_score(cluster, batch)
        elif name == "NodeAffinity":
            raw = pre.get("raw:NodeAffinity")
            if raw is None:
                raw = K.node_affinity_score(cluster, batch)
            s = K.default_normalize(raw, feasible, reverse=False)
        elif name == "NodePreferAvoidPods":
            s = pre.get("raw:NodePreferAvoidPods")
            if s is None:
                s = K.prefer_avoid_pods_score(cluster, batch)
        elif name == "PodTopologySpread":
            s = K.spread_soft_score_termfree(feasible)
        elif name == "DefaultPodTopologySpread":
            raw = K.default_spread_score(cluster, batch,
                                         match_ns=pre.get("default_spread"))
            s = K.default_spread_normalize(cluster, batch, raw, feasible)
        elif name == "TaintToleration":
            raw = pre.get("raw:TaintToleration")
            if raw is None:
                raw = K.taint_toleration_score(cluster, batch)
            s = K.default_normalize(raw, feasible, reverse=True)
        else:
            raise NotImplementedError(
                "score kernel %s is not ported (ROADMAP: framework "
                "extension points)" % name)
        s = torch.where(feasible, s, torch.zeros_like(s)) * float(weight)
        per_plugin[name] = s
        total = total + s
    return total, per_plugin
