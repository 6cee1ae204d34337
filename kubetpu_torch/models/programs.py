"""Composed filter and score passes for one scheduler profile.

The counterpart of kubetpu/models/programs.py: the device-side
replacement for the reference's per-pod Filter -> Score -> NormalizeScore
-> weight -> selectHost pipeline (reference: core/generic_scheduler.go:146
Schedule, prioritizeNodes :622, selectHost :217; weights
framework/v1alpha1/framework.go:579-656), over a whole batch of B pods
against N nodes at once.  ``schedule_batch`` is the one-shot program (every
pod against the same snapshot) that kube-scheduler's literal unit-test
tables run through; the gang auction and the replay build on the passes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..ops import kernels as K
from ..utils import prng

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
    "NodeLabel",  # nodelabel/node_label.go:106 ErrReasonPresenceViolated
})

# RequestedToCapacityRatio's arguments when a profile names none: the
# plugin's default shape on the MaxNodeScore scale, cpu and memory
DEFAULT_RTCR_ARGS = (((0, 0), (100, 100)), ((0, 0, 1), (1, 0, 1)))
NO_NODE_LABEL_ARGS = ((), (), ())


class ProgramConfig(NamedTuple):
    """Static (hashable) program configuration — one per profile."""
    filters: Tuple[str, ...] = DEFAULT_FILTER_PLUGINS
    scores: Tuple[Tuple[str, int], ...] = DEFAULT_SCORE_PLUGINS
    hostname_topokey: int = 0  # topokey vocab id of kubernetes.io/hostname
    # per-plugin static kernel args ((plugin, args-tuple), ...):
    # RequestedToCapacityRatio's shape and resources, NodeLabel's key ids
    plugin_args: Tuple[Tuple[str, Tuple], ...] = ()
    # adaptive node sampling of the sequential replay (reference:
    # percentageOfNodesToScore, generic_scheduler.go:54-59; 0 = adaptive,
    # >= 100 = search every node); the auction always searches every node
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


class FilterScoreResult(NamedTuple):
    feasible: torch.Tensor        # [B, N] bool
    unresolvable: torch.Tensor    # [B, N] bool (failed beyond preemption)
    scores: torch.Tensor          # [B, N] f32 weighted total (0 infeasible)
    plugin_scores: Dict[str, torch.Tensor]  # per-plugin weighted [B, N]


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
    if name == "NodeLabel":
        present, absent, _ = cfg.arg("NodeLabel", NO_NODE_LABEL_ARGS)
        return K.node_label_filter(cluster, batch, present, absent), None
    raise ValueError("unknown filter kernel %s" % name)


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


def explain_filters(cluster, batch, cfg: ProgramConfig, host_ok=None):
    """Per-filter unschedulability attribution (the tensor analog of the
    reference's per-node FailedPredicates map, core/generic_scheduler.go:
    565).  For every pod with no feasible node, a filter is *blocking*
    when every node that passes all OTHER filters fails it.  Returns
    (no_feasible [B] bool, blocking [F, B] bool), F = len(cfg.filters)."""
    no_feasible, masks, base, _, _, _ = _explain_masks(cluster, batch, cfg,
                                                       host_ok)
    return no_feasible, torch.stack(_blocking(masks, base, no_feasible))


def _explain_masks(cluster, batch, cfg: ProgramConfig, host_ok):
    """The audit's shared front half: (no_feasible, the per-filter masks
    ANDed with the base, base, all_ok, affinity_ok, the densified
    batch)."""
    from .batch import densify_for
    batch = densify_for(cluster, batch)
    base = cluster.node_valid[None, :] & batch.valid[:, None]
    if host_ok is not None:
        base = base & host_ok
    affinity_ok = K.node_affinity_filter(cluster, batch)
    masks = [_filter_mask(name, cluster, batch, cfg, affinity_ok)[0] & base
             for name in cfg.filters]
    all_ok = base
    for m in masks:
        all_ok = all_ok & m
    no_feasible = ~all_ok.any(dim=1) & batch.valid
    return no_feasible, masks, base, all_ok, affinity_ok, batch


def _blocking(masks, base, no_feasible):
    """Per filter: every node passing all the other filters fails it."""
    out = []
    for i in range(len(masks)):
        others = base
        for j, m in enumerate(masks):
            if j != i:
                others = others & m
        blocked = others.any(dim=1) & ~(others & masks[i]).any(dim=1)
        out.append(blocked & no_feasible)
    return out


# best_score ships in integer milli-units so the whole audit packs into
# one i32 array; default-profile totals reach ~1e6 per node
# (NodePreferAvoidPods 10000 x 100), so micro-units would overflow i32,
# and the clip before the cast is a second fence
SCORE_SCALE = 1_000
_SCORE_I32_MAX = float(2 ** 31 - 128)


def explain_verdicts(cluster, batch, cfg: ProgramConfig, host_ok=None):
    """The per-pod decision audit program (the DecisionLog feed): why each
    pod was (un)schedulable this cycle, in ONE packed [2F + 3, B] i32
    tensor (F = len(cfg.filters)):

      rows 0..F-1      per-filter failed-node counts over valid nodes
                       passing host_ok
      rows F..2F-1     0/1 blocking flags (explain_filters)
      row 2F           0/1 no-feasible-node flag
      row 2F + 1       best feasible node row (-1 when none): the first
                       argmax of the weighted score over the feasible mask
      row 2F + 2       best feasible score in milli-units (SCORE_SCALE,
                       rounded half to even, clipped to the i32 range)

    Evaluated against the cycle-start cluster, so a gang pod that lost
    only to intra-batch contention reports its round-0 feasible count
    and best score."""
    no_feasible, masks, base, all_ok, affinity_ok, batch = _explain_masks(
        cluster, batch, cfg, host_ok)
    i32 = torch.int32
    fail_counts = [(base & ~m).sum(dim=1, dtype=i32) for m in masks]
    blocking = [b.to(i32) for b in _blocking(masks, base, no_feasible)]
    scores, _ = run_scores(cluster, batch, cfg, all_ok, affinity_ok)
    masked = torch.where(all_ok, scores, torch.full_like(scores, -2.0 ** 30))
    any_ok = all_ok.any(dim=1)
    best_node = torch.where(any_ok, torch.argmax(masked, dim=1),
                            torch.full_like(any_ok, -1, dtype=torch.int64))
    best_score = torch.where(any_ok, masked.max(dim=1).values,
                             torch.zeros_like(masked[:, 0]))
    milli = torch.round(best_score * SCORE_SCALE).clamp(-_SCORE_I32_MAX,
                                                        _SCORE_I32_MAX)
    return torch.stack(fail_counts + blocking + [
        no_feasible.to(i32), best_node.to(i32), milli.to(i32)])


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
    "spread_soft", "spread_log" — the soft-spread weight table of
    ops/kernels.spread_log_table — and "raw:<plugin>")."""
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
            s = K.spread_soft_score(cluster, batch, feasible, affinity_ok,
                                    cfg.hostname_topokey,
                                    match_ns=pre.get("spread_soft"),
                                    log_table=pre.get("spread_log"),
                                    active_keys=cfg.active_keys)
        elif name == "DefaultPodTopologySpread":
            raw = K.default_spread_score(cluster, batch,
                                         match_ns=pre.get("default_spread"))
            s = K.default_spread_normalize(cluster, batch, raw, feasible)
        elif name == "TaintToleration":
            raw = pre.get("raw:TaintToleration")
            if raw is None:
                raw = K.taint_toleration_score(cluster, batch)
            s = K.default_normalize(raw, feasible, reverse=True)
        elif name == "RequestedToCapacityRatio":
            shape, resources = cfg.arg("RequestedToCapacityRatio",
                                       DEFAULT_RTCR_ARGS)
            s = K.requested_to_capacity_ratio_score(cluster, batch, shape,
                                                    resources)
        elif name == "NodeResourceLimits":
            s = K.resource_limits_score(cluster, batch)
        elif name == "NodeLabel":
            _, _, prefs = cfg.arg("NodeLabel", NO_NODE_LABEL_ARGS)
            s = K.node_label_score(cluster, batch, prefs)
        else:
            raise ValueError("unknown score kernel %s" % name)
        s = torch.where(feasible, s, torch.zeros_like(s)) * float(weight)
        per_plugin[name] = s
        total = total + s
    return total, per_plugin


def filter_and_score(cluster, batch, cfg: ProgramConfig,
                     host_ok=None) -> FilterScoreResult:
    """Every filter and score of the profile for the whole batch against
    one snapshot."""
    from .batch import densify_for
    batch = densify_for(cluster, batch)
    feasible, unresolvable, affinity_ok = run_filters(cluster, batch, cfg,
                                                      host_ok)
    scores, per_plugin = run_scores(cluster, batch, cfg, feasible,
                                    affinity_ok)
    return FilterScoreResult(feasible=feasible, unresolvable=unresolvable,
                             scores=scores, plugin_scores=per_plugin)


def select_host(scores, feasible, rng):
    """Masked argmax with a uniform tie-break among the best nodes
    (reference: generic_scheduler.go:217 selectHost).  Pod i draws
    jax.random.categorical(split(rng, B)[i], logits) with logits 0 on the
    ties and -2**62 elsewhere, which is argmax(gumbel + logits) with the
    first index on equal values.  Returns [B] int32, -1 where no node is
    feasible."""
    B, N = scores.shape
    neg = torch.full_like(scores, -2.0 ** 62)
    masked = torch.where(feasible, scores, neg)
    best = masked.max(dim=1, keepdim=True).values
    ties = (masked == best) & feasible
    logits = torch.where(ties, torch.zeros_like(scores), neg)
    gumbel = prng.gumbel(prng.split(rng.to(scores.device), B), (N,))
    choice = torch.argmax(gumbel + logits, dim=1).to(torch.int32)
    return torch.where(feasible.any(dim=1), choice,
                       torch.full_like(choice, -1))


def schedule_batch(cluster, batch, cfg: ProgramConfig, rng, host_ok=None):
    """One-shot independent scheduling of a batch: every pod filtered,
    scored and placed against the same snapshot (no intra-batch
    interaction).  rng: an int64 [2] key (utils/prng.PRNGKey).  Returns
    (FilterScoreResult, chosen [B] int32)."""
    res = filter_and_score(cluster, batch, cfg, host_ok)
    return res, select_host(res.scores, res.feasible, rng)


# ---------------------------------------------------------------------------
# preemption's programs and the nominated-pods overlay
# (kubetpu/models/programs.py:358-443, 528-612)


def filter_verdicts(cluster, batch, cfg: ProgramConfig, host_ok=None):
    """Filters only — (feasible, unresolvable) [B, N].  Preemption's shared
    verdict refresh uses this; scores there would be pure waste."""
    from .batch import densify_for
    batch = densify_for(cluster, batch)
    feasible, unresolvable, _ = run_filters(cluster, batch, cfg, host_ok)
    return feasible, unresolvable


def whatif_static_ok(cluster, batch, cfg: ProgramConfig):
    """Per-(pod, node) verdict of every filter EXCEPT NodeResourcesFit —
    the victim-removal-invariant half of the preemption what-if (removing
    victims perturbs only the resource channels for the term-free pods the
    wave serves).  cfg must already have the droppable topology filters
    removed."""
    from .batch import densify_for
    batch = densify_for(cluster, batch)
    feasible, _, _ = run_filters(cluster, batch, cfg,
                                 skip=("NodeResourcesFit",))
    return feasible


def whatif_wave(cluster, static_ok, wave_req, cand_rows, cand_valid,
                nom_add, tab_req, tab_valid, cand_idx):
    """Wave-batched selectVictimsOnNode (generic_scheduler.go:949) for a
    whole cycle's failed pods at once, the [B, C, K] axis of the
    preemption wave (preemption.py preempt_wave).  Victims arrive as a
    compact per-(priority, node) table plus per-(pod, candidate) indices
    into it; the [B, C, K, R] expansion happens on the device.

    static_ok [B, N]      all non-fit filter verdicts (whatif_static_ok)
    wave_req  [B, R]      preemptor resource request channels
    cand_rows [B, C]      candidate node rows per pod (-1 pad)
    cand_valid [B, C]     real (pod, candidate) pairs
    nom_add   [B, C, R]   nominated-pod requests reserved on each candidate
    tab_req   [S, K, R]   victim resources per table row, reprieve order
    tab_valid [S, K]      real victim slots per table row
    cand_idx  [B, C]      table row per (pod, candidate) (0 pad)

    Returns packed [B, C, K+1] bool: [..., 0] = pod fits with every victim
    removed (fits0); [..., 1 + k] = victim k was reprieved (stays).  The
    reprieve scan over K is a Python loop of device ops, no host read; the
    victims' sum adds k = 0, 1, ... in order, as XLA reduces that axis."""
    rows = cand_rows.long().clamp(min=0)
    sok = torch.gather(static_ok, 1, rows) & cand_valid          # [B, C]
    idx = cand_idx.long()
    vic_req = tab_req[idx]                                       # [B, C, K, R]
    vic_valid = tab_valid[idx] & cand_valid[:, :, None]          # [B, C, K]
    n_vic = vic_req.shape[2]
    masked = vic_req * vic_valid[..., None].to(vic_req.dtype)
    rm_req = torch.zeros_like(masked[:, :, 0])
    for k in range(n_vic):
        rm_req = rm_req + masked[:, :, k]                        # [B, C, R]
    free_base = (cluster.allocatable - cluster.requested)[rows]  # [B, C, R]
    breq = wave_req[:, None, :].expand(free_base.shape)
    free = free_base - nom_add + rm_req
    fits0 = K.fit_rows(breq, free) & sok
    out = [fits0]
    for k in range(n_vic):
        exists = vic_valid[:, :, k] & fits0
        try_free = free - vic_req[:, :, k] * exists[..., None].to(free.dtype)
        fit = K.fit_rows(breq, try_free) & sok & exists
        free = torch.where(fit[..., None], try_free, free)
        out.append(fit)
    return torch.stack(out, dim=2)


def nominated_fit_mask(cluster, batch, nom):
    """The nominated-pods overlay pass (reference: addNominatedPods +
    two-pass filtering, core/generic_scheduler.go:530,594-612): for each
    pod, nominated pods of EQUAL-OR-GREATER priority — excluding the pod
    ITSELF when it is the nominator — count as running on their nominated
    nodes, and the pod must fit with that usage added.  The overlay-free
    pass is the main filter program, so ANDing this mask in reproduces the
    two-pass rule for the resource dimension.  The work is [B, M, R]
    (M = nominated pods), never [B, N, R].  Returns [B, N] bool."""
    B = batch.priority.shape[0]
    N = cluster.allocatable.shape[0]
    M = nom.node.shape[0]
    dev = batch.req.device
    ok_entry = nom.valid & (nom.node >= 0)
    # w[b, j]: entry j reserves capacity against pod b
    w = ((nom.prio[None, :] >= batch.priority[:, None]) & ok_entry[None, :]
         & (nom.self_row[None, :]
            != torch.arange(B, dtype=nom.self_row.dtype, device=dev)[:, None]))
    # slot m's overlay sums entry j's request over the valid entries on
    # m's node (same_node[m, j]) that reserve against pod b (w[b, j]), in
    # ascending j as XLA's contraction adds them.  The entries of one node
    # are few: take the r-th member of every slot's node group for
    # r = 0, 1, ..., so no [B, M, M] coefficient tensor is built (one
    # read of the entries' node rows, to group them)
    node = nom.node.cpu().numpy()
    members: dict = {}
    for j in np.flatnonzero(ok_entry.cpu().numpy()):
        members.setdefault(int(node[j]), []).append(int(j))
    depth = max((len(v) for v in members.values()), default=0)
    member = np.full((depth, M), -1, np.int64)
    for m in range(M):
        group = members.get(int(node[m]), ())
        member[:len(group), m] = group
    member = torch.from_numpy(member).to(dev)
    overlay = torch.zeros((B, M, nom.req.shape[1]), dtype=torch.float32,
                          device=dev)
    for r in range(depth):
        j = member[r]
        js = j.clamp(min=0)
        take = w[:, js] & (j >= 0)[None, :]                         # [B, M]
        overlay = overlay + take.to(torch.float32)[..., None] * nom.req[js]
    rows = nom.node.long().clamp(0, N - 1)
    free = cluster.allocatable[rows] - cluster.requested[rows]       # [M, R]
    ok = K.fit_rows(batch.req[:, None, :].expand(overlay.shape),
                    free[None, :, :] - overlay)                      # [B, M]
    vals = torch.where(ok_entry[None, :], ok, torch.ones_like(ok))
    # .at[:, rows].min: several entries may share a node row
    mask = torch.ones((B, N), dtype=torch.uint8, device=dev)
    mask.scatter_reduce_(1, rows[None, :].expand(B, M), vals.to(torch.uint8),
                         "amin", include_self=True)
    return mask.bool()


def nominated_topology_mask(cluster, nom_batch, nom_rows, nom_prio, batch,
                            cfg: ProgramConfig):
    """Topology dimension of addNominatedPods (generic_scheduler.go:530):
    nominated pods become EXISTING pods placed on their nominated nodes —
    labels, namespaces and required anti-affinity terms included — and the
    batch re-runs its InterPodAffinity + PodTopologySpread filters against
    that extended cluster.  Rows where no nominated pod of >= priority
    qualifies pass untouched; rows where only a subset qualifies see the
    full overlay (the reference's documented over-blocking deviation).
    Returns [B, N] bool."""
    from .batch import densify_for
    from .gang import _extend_cluster   # lazy: gang imports this module
    batch = densify_for(cluster, batch)
    nom_batch = densify_for(cluster, nom_batch)
    ext = _extend_cluster(cluster, nom_batch)
    placed = nom_batch.valid & (nom_rows >= 0)
    ext = ext._replace(
        pod_node=torch.cat([cluster.pod_node, nom_rows.to(torch.int32)]),
        pod_valid=torch.cat([cluster.pod_valid, placed]))
    affinity_ok = K.node_affinity_filter(ext, batch)
    ok = torch.ones((batch.valid.shape[0], cluster.allocatable.shape[0]),
                    dtype=torch.bool, device=batch.req.device)
    if "PodTopologySpread" in cfg.filters:
        ok = ok & K.spread_filter(ext, batch, affinity_ok,
                                  active_keys=cfg.active_keys)
    if "InterPodAffinity" in cfg.filters:
        ipa_ok, _ = K.interpod_filter(ext, batch,
                                      active_keys=cfg.active_keys)
        ok = ok & ipa_ok
    affected = (placed[None, :]
                & (nom_prio[None, :] >= batch.priority[:, None])).any(dim=1)
    return torch.where(affected[:, None], ok, torch.ones_like(ok))


# ---------------------------------------------------------------------------
# the delta path's scatter (kubetpu/models/programs.py:446-514)

# ClusterDelta's node-row and pod-row tables, by the ClusterTensors field
# each one updates (the label id lists densify first)
_NODE_DELTA = (("allocatable", "allocatable"), ("requested", "requested"),
               ("nonzero_requested", "nonzero_requested"),
               ("node_valid", "node_valid"),
               ("unschedulable", "unschedulable"), ("kv", "kv_ids"),
               ("keymask", "keymask"), ("num", "num"),
               ("topo_pair", "topo_pair"), ("taints", "taints"),
               ("ports", "ports"), ("images", "images"),
               ("avoid_hot", "avoid_hot"), ("zone_hot", "zone_hot"))
_POD_DELTA = (("pod_kv", "pod_kv_ids"), ("pod_key", "pod_key"),
              ("pod_ns_hot", "pod_ns_hot"), ("pod_node", "pod_node"),
              ("pod_valid", "pod_valid"),
              ("pod_terminating", "pod_terminating"))
_WHOLE_DELTA = ("image_size", "image_spread", "taint_is_hard",
                "taint_is_prefer")


def apply_cluster_delta(cluster, delta, donate: bool = True):
    """Scatter one cycle's ClusterDelta (state/tensors.py gather_delta)
    into the resident ClusterTensors.  donate=True updates the resident
    tensors in place (``index_copy_`` per field; the caller's previous
    ClusterTensors then shares their storage); donate=False clones each
    updated tensor first, leaving the input untouched.  The tables' pad
    rows (index N or P, which XLA's mode="drop" discards) are cut off on
    the host, so no out-of-range index reaches the device; every table
    travels in one packed host->device copy.  The label id lists densify
    as HostClusterArrays.to_device densifies them, so a delta-applied
    cluster equals a rebuild byte for byte.  The four [I]/[T] vocab
    vectors are replaced wholesale."""
    from ..state.tensors import _densify_ids
    from ..utils.device import upload_packed
    N = cluster.allocatable.shape[0]
    P = cluster.pod_valid.shape[0]
    nd = int(np.count_nonzero(delta.node_rows < N))
    pd = int(np.count_nonzero(delta.pod_rows < P))
    host = ([delta.node_rows[:nd].astype(np.int64)]
            + [getattr(delta, f)[:nd] for _, f in _NODE_DELTA]
            + [delta.pod_rows[:pd].astype(np.int64)]
            + [getattr(delta, f)[:pd] for _, f in _POD_DELTA]
            + [getattr(delta, f) for f in _WHOLE_DELTA])
    dev = upload_packed(host, cluster.allocatable.device)
    n_node = len(_NODE_DELTA)
    nr, node_vals = dev[0], dev[1:1 + n_node]
    pr = dev[1 + n_node]
    pod_vals = dev[2 + n_node:2 + n_node + len(_POD_DELTA)]
    whole = dev[2 + n_node + len(_POD_DELTA):]
    L = cluster.kv.shape[1]

    def scat(x, rows, vals):
        x = x if donate else x.clone()
        return x.index_copy_(0, rows, vals)

    upd = {}
    for (field, _), vals in zip(_NODE_DELTA, node_vals):
        if field == "kv":
            vals = _densify_ids(vals, L)
        upd[field] = scat(getattr(cluster, field), nr, vals)
    for (field, _), vals in zip(_POD_DELTA, pod_vals):
        if field == "pod_kv":
            vals = _densify_ids(vals, L)
        upd[field] = scat(getattr(cluster, field), pr, vals)
    upd.update(zip(_WHOLE_DELTA, whole))
    return cluster._replace(**upd)
