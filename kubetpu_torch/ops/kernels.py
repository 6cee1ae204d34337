"""Batched Filter/Score kernels for the gang auction, in PyTorch.

The counterpart of kubetpu/ops/kernels.py for the functions the
sequential replay and the term-free gang cycle reach (reference:
pkg/scheduler/framework/plugins/*).  Shape
conventions: B pending pods x N nodes x P existing pods.  Every function
takes (ClusterTensors, PodBatch) NamedTuples of tensors and runs on
whichever device those tensors live on.

Bit-identity with the JAX package rests on three rules:

* each elementwise formula keeps the reference's op order; a product is
  rounded before the add that follows it (no fused multiply-add), and
  every division is correctly rounded;
* f32 constants that the reference computes in double and rounds once
  (``1 - ZONE_WEIGHTING``) are baked in with that same rounding;
* every reduction across nodes or pods is a max/min (exact in any order)
  or a sum of integer-valued f32 below 2**24 (exact in any order), so the
  matrix products below — float32, TF32 off — give the same bits on the
  CPU and the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..state.tensors import CH_CPU, CH_MEM, CH_PODS, N_FIXED_CHANNELS
from ..utils.xla_math import xla_log_f32
from .selectors import match_selectors

MAX_NODE_SCORE = 100.0  # reference: framework/v1alpha1/interface.go:85


def _f32(x: float) -> float:
    """A Python float holding x rounded once to float32."""
    return float(np.float32(x))


def _f(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _idiv(a, b):
    """Go int64 division (truncation toward zero) for non-negative operands;
    b == 0 guarded by callers.  One remainder correction recovers the exact
    quotient wherever a / b rounds across an integer."""
    q = torch.floor(a / b)
    r = a - q * b
    return q + (r >= b).float() - (r < 0).float()


def gumbel_tiebreak_argmax(total, f, gumbel, col_offset, neg):
    """Propose half of the selectHost decomposition over a [W, n] block:
    mask infeasible columns to ``neg``, take the row max, then break exact
    score ties by the largest gumbel (argmax over where(tie, gumbel, neg)
    is jax.random.categorical restricted to the tie set).  torch.argmax
    keeps the first index on exact ties, like jnp.argmax.  Returns
    (best, h, arg) with arg offset by ``col_offset``."""
    masked = torch.where(f, total, torch.full_like(total, neg))
    best = masked.max(dim=1).values
    h = torch.where((masked == best[:, None]) & f, gumbel,
                    torch.full_like(gumbel, neg))
    hbest = h.max(dim=1).values
    arg = torch.argmax(h, dim=1).to(torch.int32) + col_offset
    return best, hbest, arg


# ---------------------------------------------------------------------------
# exact reductions over mesh shards (kubetpu/ops/kernels.py:66-113)
#
# A reduction takes one piece per shard of a mesh axis (a list, in shard
# order, each piece on its shard's device), gathers the pieces onto the
# first one's device, folds them in shard order and returns the result
# copied back to every shard's device.  The fold is exact in any order:
# float max/min always, sums only over ints or integer-valued f32 below
# 2**24 (the caller's contract, as in the JAX package).

CANDIDATE_SENTINEL = 2 ** 30


def _fold_shards(parts, op):
    from ..utils.device import shard_copy
    home = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, shard_copy(p, home))
    return [acc] + [shard_copy(acc, p.device) for p in parts[1:]]


def exact_psum(parts):
    """Cross-shard sum (ints, or integer-valued f32 below 2**24)."""
    return _fold_shards(parts, torch.add)


def exact_pmax(parts):
    """Cross-shard max: exactly associative."""
    return _fold_shards(parts, torch.maximum)


def exact_pmin(parts):
    """Cross-shard min: exactly associative."""
    return _fold_shards(parts, torch.minimum)


def crossaxis_first_index_argmax(tile_best, tile_h, tile_arg, neg):
    """Cross-shard resolve of per-tile gumbel_tiebreak_argmax results
    (lists over the shards of one row of tiles): the max score, then the
    max gumbel among the tiles holding it, then the MIN global index among
    tiles tying on both — the index torch.argmax over the whole row picks.
    Returns per-shard lists (best, index)."""
    best = exact_pmax(tile_best)
    gh = exact_pmax([torch.where(tb == b, th, torch.full_like(th, neg))
                     for tb, th, b in zip(tile_best, tile_h, best)])
    cand = [torch.where((tb == b) & (th == g), ta,
                        torch.full_like(ta, CANDIDATE_SENTINEL))
            for tb, th, ta, b, g in zip(tile_best, tile_h, tile_arg, best,
                                        gh)]
    return best, exact_pmin(cand)


# ---------------------------------------------------------------------------
# shared aggregation helpers


def per_node_counts(match_sp: torch.Tensor, pod_node: torch.Tensor,
                    n_nodes: int) -> torch.Tensor:
    """[S, P] per-existing-pod values -> [S, N] per-node sums (float32;
    exact for the integer-valued inputs every caller passes)."""
    oh = pod_node.long()[:, None] == torch.arange(
        n_nodes, device=pod_node.device)[None, :]
    return _f(match_sp) @ _f(oh)


def _active_keys(TK: int, active_keys):
    return (range(TK) if active_keys is None
            else [k for k in active_keys if 0 <= k < TK])


def _samepair_pods_to_nodes(cluster, values_sp, keys_s, pod_node, pod_valid,
                            active_keys=None) -> torch.Tensor:
    """out[s, n] = sum of values[s, p] over existing pods p placed on a node
    sharing node n's (keys_s[s], value) topology pair.  Rows whose key id
    is outside [0, TK) read zeros; active_keys restricts the key loop and
    must be a superset of the keys in keys_s."""
    tp = cluster.topo_pair                              # [N, TK]
    TK = tp.shape[1]
    pod_tp = tp[pod_node.long().clamp(min=0)]           # [P, TK]
    placed = (pod_node >= 0) & pod_valid
    vals = _f(values_sp)
    out = torch.zeros((values_sp.shape[0], tp.shape[0]), dtype=torch.float32,
                      device=tp.device)
    for k in _active_keys(TK, active_keys):
        pk = torch.where(placed, pod_tp[:, k], torch.full_like(pod_tp[:, k], -1))
        sp = (pk[:, None] == tp[None, :, k]) & (pk >= 0)[:, None]
        red = vals @ _f(sp)
        out = torch.where((keys_s == k)[:, None], red, out)
    return out


def _samepair_nodes(cluster, values_sn, keys_s, active_keys=None):
    """out[s, n] = sum of values[s, n'] over nodes n' sharing node n's
    (keys_s[s], value) pair (same active_keys contract)."""
    tp = cluster.topo_pair
    TK = tp.shape[1]
    vals = _f(values_sn)
    out = torch.zeros(values_sn.shape, dtype=torch.float32, device=tp.device)
    for k in _active_keys(TK, active_keys):
        col = tp[:, k]
        sp = (col[:, None] == col[None, :]) & (col >= 0)[:, None]
        red = vals @ _f(sp)
        out = torch.where((keys_s == k)[:, None], red, out)
    return out


def pair_scatter(values_sn: torch.Tensor, pair_sn: torch.Tensor,
                 L: int) -> torch.Tensor:
    """Sum per-(s, item) values by topology-pair id -> [S, L]; pair id -1
    entries are dropped.  A scatter-add: exact in any order (the card's
    atomics) for the integer-valued values every caller passes."""
    ids = torch.where(pair_sn >= 0, pair_sn.long(),
                      torch.full_like(pair_sn, L, dtype=torch.long))
    out = torch.zeros((values_sn.shape[0], L + 1), dtype=torch.float32,
                      device=values_sn.device)
    return out.scatter_add_(1, ids, _f(values_sn))[:, :L]


def pair_gather(pair_counts_sl: torch.Tensor,
                pair_sn: torch.Tensor) -> torch.Tensor:
    """[S, L] pair values gathered back to items via [S, N] pair ids;
    -1 -> 0."""
    got = pair_counts_sl.gather(1, pair_sn.long().clamp(min=0))
    return torch.where(pair_sn >= 0, got, torch.zeros_like(got))


def node_topo_pairs(cluster, topo_key_s: torch.Tensor) -> torch.Tensor:
    """Each node's pair id [S, N] for topology-key ids [S] (-1 when the
    node lacks the key)."""
    return cluster.topo_pair.T[topo_key_s.long()]


def pod_topo_pairs(cluster, topo_key_s: torch.Tensor) -> torch.Tensor:
    """Pair ids of each existing pod's node for keys [S] -> [S, P] (-1 for
    unplaced or invalid pods)."""
    pod_topo = cluster.topo_pair[cluster.pod_node.long().clamp(min=0)]
    pairs = pod_topo.T[topo_key_s.long()]
    placed = (cluster.pod_node >= 0) & cluster.pod_valid
    return torch.where(placed[None, :], pairs, torch.full_like(pairs, -1))


# ---------------------------------------------------------------------------
# filters — each returns ok [B, N] bool


def _channels(R: int, ndim: int, device):
    ch = torch.arange(R, device=device).reshape((1,) * (ndim - 1) + (R,))
    is_fixed = (ch < N_FIXED_CHANNELS) & (ch != CH_PODS)
    is_pods = ch == CH_PODS
    return is_fixed, is_pods


def fit_rows(req: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """Row-wise NodeResourcesFit verdict: request rows [X, R] against
    available rows [X, R] (fit.go:194-267: pod count always checked;
    cpu/mem/ephemeral when the pod requests anything; scalars only when
    requested)."""
    free_ok = avail >= req
    is_fixed, is_pods = _channels(req.shape[-1], req.ndim, req.device)
    check = is_fixed | (req > 0)
    res_ok = (free_ok | ~check | is_pods).all(dim=-1)
    pods_ok = free_ok[..., CH_PODS]
    zero_req = (torch.where(is_pods, torch.zeros_like(req), req) == 0).all(-1)
    return pods_ok & (zero_req | res_ok)


def fit_filter(cluster, batch) -> torch.Tensor:
    """NodeResourcesFit (reference: noderesources/fit.go:194-267)."""
    return fit_matrix(cluster.allocatable, cluster.requested, batch.req)


def fit_matrix(alloc, used, req) -> torch.Tensor:
    """[B, N] NodeResourcesFit verdict of requests [B, R] against nodes'
    allocatable and used [N, R]."""
    free_ok = alloc[None, :, :] >= req[:, None, :] + used[None, :, :]
    is_fixed, is_pods = _channels(alloc.shape[1], 3, alloc.device)
    check = is_fixed | (req[:, None, :] > 0)
    res_ok = (free_ok | ~check | is_pods).all(dim=-1)
    pods_ok = free_ok[:, :, CH_PODS]
    nonpods = torch.where(is_pods[0], torch.zeros_like(req), req)
    zero_req = (nonpods == 0).all(dim=-1)
    return pods_ok & (zero_req[:, None] | res_ok)


def node_name_filter(cluster, batch) -> torch.Tensor:
    """NodeName (reference: nodename/node_name.go:51)."""
    has = cluster.kv.T[batch.node_name_kvid.long().clamp(min=0)]
    named_ok = has & (batch.node_name_kvid >= 0)[:, None]
    return torch.where(batch.has_node_name[:, None], named_ok,
                       torch.ones_like(named_ok))


def node_unschedulable_filter(cluster, batch) -> torch.Tensor:
    """NodeUnschedulable (reference: node_unschedulable.go:51)."""
    return ~(cluster.unschedulable[None, :]
             & ~batch.tolerates_unschedulable[:, None])


def node_ports_filter(cluster, batch) -> torch.Tensor:
    """NodePorts (reference: nodeports/node_ports.go:108; wildcard
    semantics are encoded at intern time)."""
    return (batch.ports_hot @ _f(cluster.ports).T) < 0.5


def taint_filter(cluster, batch) -> torch.Tensor:
    """TaintToleration: an untolerated NoSchedule/NoExecute taint fails
    (reference: taint_toleration.go:54-72)."""
    untol_hard = _f(~batch.tolerated) * _f(cluster.taint_is_hard)[None, :]
    return (untol_hard @ _f(cluster.taints).T) < 0.5


def node_affinity_filter(cluster, batch) -> torch.Tensor:
    """NodeAffinity + spec.nodeSelector (reference: node_affinity.go:54)."""
    B = batch.req.shape[0]
    sel_ok = match_selectors(batch.node_selector, cluster.kv,
                             cluster.keymask, cluster.num)
    term_m = match_selectors(batch.rna_sel, cluster.kv, cluster.keymask,
                             cluster.num)
    Tn = batch.rna_valid.shape[1]
    term_m = term_m.reshape(B, Tn, -1)
    any_term = (term_m & batch.rna_valid[:, :, None]).any(dim=1)
    rna_ok = torch.where(batch.has_rna[:, None], any_term,
                         torch.ones_like(any_term))
    return sel_ok & rna_ok


# ---------------------------------------------------------------------------
# PodTopologySpread


def spread_match_ns(cluster, batch, constraints) -> torch.Tensor:
    """[B, C, P] constraint-selector x namespace match against the pods."""
    B, C = constraints.topo_key.shape
    m = match_selectors(constraints.sel, cluster.pod_kv, cluster.pod_key)
    ns_ok = (batch.ns_hot @ cluster.pod_ns_hot.T) > 0.5
    return m.reshape(B, C, -1) & ns_ok[:, None, :]


class SpreadState(NamedTuple):
    node_counts: torch.Tensor   # [B, C, N] matching-pod counts per node
    pair_counts: torch.Tensor   # [B*C, L] counts per registered pair
    registered: torch.Tensor    # [B*C, L] bool: an eligible node has the pair
    node_pair: torch.Tensor     # [B*C, N] node's pair id per constraint
    has_key: torch.Tensor       # [B, C, N] node has the topology key
    eligible: torch.Tensor      # [B, N] affinity-ok nodes with every key
    any_eligible: torch.Tensor  # [B]


def _spread_state(cluster, batch, constraints, affinity_ok, count_mask_nodes,
                  match_ns=None) -> SpreadState:
    """Pair-space state shared by the hard filter and the soft score of
    the sequential replay.  count_mask_nodes [B, N]: nodes whose pods are
    counted into pair sums (PreFilter counts every node's pods into
    registered pairs; PreScore only affinity-matching nodes with all
    keys)."""
    B, C = constraints.topo_key.shape
    N = cluster.allocatable.shape[0]
    L = cluster.kv.shape[1]
    if match_ns is None:
        match_ns = spread_match_ns(cluster, batch, constraints)
    countable = cluster.pod_valid & ~cluster.pod_terminating
    m = match_ns & countable[None, None, :]
    node_counts = per_node_counts(m.reshape(B * C, -1), cluster.pod_node,
                                  N).reshape(B, C, N)
    node_pair = node_topo_pairs(cluster, constraints.topo_key.reshape(-1))
    has_key = ((node_pair >= 0).reshape(B, C, N)
               & constraints.topo_known.reshape(B, C)[:, :, None])
    node_pair = torch.where(has_key.reshape(B * C, N), node_pair,
                            torch.full_like(node_pair, -1))
    all_keys = (has_key | ~constraints.valid[:, :, None]).all(dim=1)
    eligible = affinity_ok & cluster.node_valid[None, :] & all_keys
    any_eligible = eligible.any(dim=1)
    elig_bc = eligible[:, None, :].expand(B, C, N).reshape(B * C, N)
    registered = pair_scatter(elig_bc, node_pair, L) > 0.5
    counted = count_mask_nodes[:, None, :].expand(B, C, N).reshape(B * C, N)
    pair_counts = pair_scatter(node_counts.reshape(B * C, N) * _f(counted),
                               node_pair, L)
    pair_counts = torch.where(registered, pair_counts,
                              torch.zeros_like(pair_counts))
    return SpreadState(node_counts=node_counts, pair_counts=pair_counts,
                       registered=registered, node_pair=node_pair,
                       has_key=has_key, eligible=eligible,
                       any_eligible=any_eligible)


def spread_filter(cluster, batch, affinity_ok, match_ns=None,
                  active_keys=None) -> torch.Tensor:
    """PodTopologySpread hard constraints (reference:
    podtopologyspread/filtering.go:200-283), node-space formulation."""
    cons = batch.spread
    B, C = cons.topo_key.shape
    N = cluster.allocatable.shape[0]
    if match_ns is None:
        match_ns = spread_match_ns(cluster, batch, cons)
    countable = cluster.pod_valid & ~cluster.pod_terminating
    m = (match_ns & countable[None, None, :]).reshape(B * C, -1)
    keys = torch.where(cons.topo_known, cons.topo_key,
                       torch.full_like(cons.topo_key, -1)).reshape(-1)
    cnt = _samepair_pods_to_nodes(cluster, m, keys, cluster.pod_node,
                                  cluster.pod_valid, active_keys=active_keys)
    node_pair = node_topo_pairs(cluster, cons.topo_key.reshape(-1))
    has_key = ((node_pair >= 0).reshape(B, C, N)
               & cons.topo_known.reshape(B, C)[:, :, None])
    all_keys = (has_key | ~cons.valid[:, :, None]).all(dim=1)
    eligible = affinity_ok & cluster.node_valid[None, :] & all_keys
    any_eligible = eligible.any(dim=1)
    elig_bc = eligible[:, None, :].expand(B, C, N).reshape(B * C, N)
    registered = _samepair_nodes(cluster, elig_bc, keys,
                                 active_keys=active_keys) > 0.5
    big = torch.full_like(cnt, float(2 ** 31))
    min_match = torch.where(registered, cnt, big).min(dim=1).values
    min_match = min_match.reshape(B, C)
    match_num = torch.where(registered, cnt,
                            torch.zeros_like(cnt)).reshape(B, C, N)
    self_m = _f(cons.self_match)[:, :, None]
    skew = match_num + self_m - min_match[:, :, None]
    c_ok = has_key & (skew <= cons.max_skew[:, :, None])
    ok = (c_ok | ~cons.valid[:, :, None]).all(dim=1)
    has_any = cons.valid.any(dim=1)
    gate = has_any[:, None] & any_eligible[:, None]
    return torch.where(gate, ok, torch.ones_like(ok))


def spread_log_table(n: int, device) -> torch.Tensor:
    """spread_log_weight of every size 0..n: a size counts nodes or the
    distinct pairs of nodes, so n = the cluster's node rows bounds it."""
    return xla_log_f32(torch.arange(n + 1, dtype=torch.float32,
                                    device=device) + 2.0)


def spread_log_weight(size: torch.Tensor, table=None) -> torch.Tensor:
    """log(size + 2) of the soft-spread score (scoring.go:286): the f32
    sum size + 2 and XLA:CPU's f32 log of it (utils/xla_math), the
    reference's bits on the CPU and the card.  ``size`` is integer-valued;
    with ``table`` (spread_log_table) the weight is a gather of the same
    bits, not the log's ~250 kernels on every call."""
    if table is None:
        return xla_log_f32(size + 2.0)
    return table[size.long().clamp(0, table.shape[0] - 1)]


def spread_soft_score(cluster, batch, feasible, affinity_ok,
                      hostname_topokey: int, match_ns=None, log_table=None,
                      active_keys=None) -> torch.Tensor:
    """PodTopologySpread soft constraints, normalized (reference:
    podtopologyspread/scoring.go PreScore/Score/NormalizeScore).  The
    distinct-pair count sums 1/members over each pair's eligible members
    (a non-integer sum, rounded); the constraints' weighted counts are
    added left to right before the floor, as the reference's reduction."""
    cons = batch.spread_soft
    B, C = cons.topo_key.shape
    N = cluster.allocatable.shape[0]
    count_nodes = affinity_ok & cluster.node_valid[None, :]
    if match_ns is None:
        match_ns = spread_match_ns(cluster, batch, cons)
    countable = cluster.pod_valid & ~cluster.pod_terminating
    m = match_ns & countable[None, None, :]                       # [B, C, P]
    keys = torch.where(cons.topo_known, cons.topo_key,
                       torch.full_like(cons.topo_key, -1)).reshape(-1)
    node_pair = node_topo_pairs(cluster, cons.topo_key.reshape(-1))
    has_key = ((node_pair >= 0).reshape(B, C, N)
               & cons.topo_known.reshape(B, C)[:, :, None])
    is_host = (cons.topo_key == hostname_topokey) & cons.topo_known
    valid = cons.valid

    # per-node match counts (hostname constraints read these directly)
    node_counts = per_node_counts(m.reshape(B * C, -1), cluster.pod_node,
                                  N).reshape(B, C, N)
    # pair sums count only pods on PreScore-eligible nodes (scoring.go:139)
    pod_node = cluster.pod_node.long()
    cm_pods = count_nodes[:, pod_node.clamp(min=0)] & (pod_node >= 0)[None, :]
    m_counted = (m & cm_pods[:, None, :]).reshape(B * C, -1)
    cnt_pair = _samepair_pods_to_nodes(cluster, m_counted, keys,
                                       cluster.pod_node, cluster.pod_valid,
                                       active_keys=active_keys)

    # eligibility and registration from the filtered nodes only
    all_keys = (has_key | ~valid[:, :, None]).all(dim=1)         # [B, N]
    ignored = feasible & ~all_keys
    scored = feasible & all_keys
    eligible = feasible & cluster.node_valid[None, :] & all_keys
    elig_bc = eligible[:, None, :].expand(B, C, N).reshape(B * C, N)
    members = _samepair_nodes(cluster, elig_bc, keys,
                              active_keys=active_keys)           # [B*C, N]
    registered = members > 0.5
    # each registered pair's eligible members contribute 1/members: the
    # row sum is the distinct-pair count up to rounding
    inv = torch.where(registered & elig_bc,
                      1.0 / torch.clamp(members, min=1.0),
                      torch.zeros_like(members))
    topo_size = torch.round(inv.sum(dim=1)).reshape(B, C)
    n_scored = _f(scored).sum(dim=1)
    size = torch.where(is_host, n_scored[:, None], topo_size)
    weight = spread_log_weight(size, log_table)

    pair_cnt = torch.where(registered, cnt_pair,
                           torch.zeros_like(cnt_pair)).reshape(B, C, N)
    cnt = torch.where(is_host[:, :, None], node_counts, pair_cnt)
    ms = cons.max_skew[:, :, None]                # adjustForMaxSkew (:294)
    cnt = torch.where(cnt < ms, ms - 1.0, cnt)
    scope = (valid & cons.topo_known)[:, :, None] & has_key
    contrib = torch.where(scope, cnt * weight[:, :, None],
                          torch.zeros_like(cnt))
    raw = contrib[:, 0]                    # C >= 1: the builder pads to 1
    for j in range(1, C):
        raw = raw + contrib[:, j]
    raw = torch.floor(raw)                                     # int64(score)
    raw = torch.where(ignored, torch.zeros_like(raw), raw)

    # NormalizeScore (scoring.go:210-257): min/max over scored nodes
    big = float(2 ** 62)
    min_s = torch.where(scored, raw, torch.full_like(raw, big)).min(
        dim=1, keepdim=True).values
    max_s = torch.where(scored, raw, torch.full_like(raw, -big)).max(
        dim=1, keepdim=True).values
    max_s = torch.clamp(max_s, min=0.0)
    norm = torch.where(
        max_s > 0,
        _idiv(MAX_NODE_SCORE * (max_s + torch.clamp(min_s, max=big) - raw),
              torch.clamp(max_s, min=1.0)),
        torch.full_like(raw, MAX_NODE_SCORE))
    out = torch.where(ignored, torch.zeros_like(norm), norm)
    # no soft constraints: every filtered node scores MaxNodeScore (the
    # reference's maxScore == 0 branch)
    has_any = valid.any(dim=1, keepdim=True)
    out = torch.where(has_any, out, torch.full_like(out, MAX_NODE_SCORE))
    return torch.where(feasible, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# InterPodAffinity


def _pod_term_matches_static(cluster, terms, B: int) -> torch.Tensor:
    """Selector x namespace match of pod-side terms against the pod axis
    -> [B, T, P]."""
    m = match_selectors(terms.sel, cluster.pod_kv, cluster.pod_key)
    T = terms.valid.shape[1]
    m = m.reshape(B, T, -1)
    NS = terms.ns_hot.shape[-1]
    ns_ok = (terms.ns_hot.reshape(B * T, NS)
             @ cluster.pod_ns_hot.T).reshape(B, T, -1) > 0.5
    return m & ns_ok


def _pod_term_matches(cluster, terms, B: int, pre=None) -> torch.Tensor:
    if pre is None:
        pre = _pod_term_matches_static(cluster, terms, B)
    return pre & cluster.pod_valid[None, None, :]


def existing_terms_match(terms, batch) -> torch.Tensor:
    """[Et, B] existing-pod term-selector x namespace x validity match."""
    em = match_selectors(terms.sel, batch.kv_hot, batch.key_hot)
    ens = (terms.ns_hot @ batch.ns_hot.T) > 0.5
    return em & ens & terms.valid[:, None]


class InterpodPre(NamedTuple):
    m_ra: torch.Tensor   # [B, Tr, P]
    m_raa: torch.Tensor  # [B, Ta, P]
    em: torch.Tensor     # [Et, B]


def interpod_filter_pre(cluster, batch) -> InterpodPre:
    B = batch.req.shape[0]
    return InterpodPre(
        m_ra=_pod_term_matches_static(cluster, batch.ra, B),
        m_raa=_pod_term_matches_static(cluster, batch.raa, B),
        em=existing_terms_match(cluster.filter_terms, batch))


def _owner_pairs(cluster, terms):
    """Each existing term's owner pair id (-1 when invalid/unplaced) and
    the [Et, N] same-pair node mask."""
    pod_tp = cluster.topo_pair[cluster.pod_node.long().clamp(min=0)]
    owner = terms.pod_idx.long().clamp(min=0)
    owner_ok = cluster.pod_valid[owner] & (cluster.pod_node[owner] >= 0)
    e_pair = pod_tp[owner].gather(1, terms.topo_key.long()[:, None])[:, 0]
    e_pair = torch.where(terms.valid & owner_ok, e_pair,
                         torch.full_like(e_pair, -1))
    node_pairs_e = cluster.topo_pair.T[terms.topo_key.long()]   # [Et, N]
    sp_rows = (node_pairs_e == e_pair[:, None]) & (e_pair >= 0)[:, None]
    return owner_ok, sp_rows


def interpod_filter(cluster, batch, pre: InterpodPre | None = None,
                    return_no_matches: bool = False, active_keys=None):
    """InterPodAffinity filter -> (ok, affinity_unresolvable) (reference:
    interpodaffinity/filtering.go:314-396).  With return_no_matches, also
    the [B] bool marking pods whose required-affinity terms match nothing
    yet: the self-match bootstrap (filtering.go:356) is what admits them."""
    B = batch.req.shape[0]
    N = cluster.allocatable.shape[0]
    if pre is None:
        pre = interpod_filter_pre(cluster, batch)

    # incoming required affinity (filtering.go:342 satisfyPodAffinity)
    ra = batch.ra
    Tr = ra.valid.shape[1]
    m = _pod_term_matches(cluster, ra, B, pre=pre.m_ra)       # [B, T, P]
    match_all = (m | ~ra.valid[:, :, None]).all(dim=1)        # [B, P]
    has_ra = ra.valid.any(dim=1)
    keys_r = torch.where(ra.topo_known, ra.topo_key,
                         torch.full_like(ra.topo_key, -1)).reshape(-1)
    contrib = match_all[:, None, :].expand(m.shape).reshape(B * Tr, -1)
    cnt = _samepair_pods_to_nodes(cluster, contrib, keys_r,
                                  cluster.pod_node, cluster.pod_valid,
                                  active_keys=active_keys)
    node_pair = node_topo_pairs(cluster, ra.topo_key.reshape(-1))
    node_has_key = ((node_pair >= 0).reshape(B, Tr, N)
                    & ra.topo_known[:, :, None])
    cnt = cnt.reshape(B, Tr, N)
    term_ok = node_has_key & (cnt > 0.5)
    aff_ok = (term_ok | ~ra.valid[:, :, None]).all(dim=1)
    pod_tp = cluster.topo_pair[cluster.pod_node.long().clamp(min=0)]
    pod_keyed = ((pod_tp.T[keys_r.long().clamp(min=0)] >= 0)
                 & (keys_r >= 0)[:, None]
                 & (cluster.pod_node >= 0)[None, :]
                 & cluster.pod_valid[None, :])
    tot = _f(pod_keyed & contrib & ra.valid.reshape(-1)[:, None]).sum(dim=1)
    no_matches = tot.reshape(B, Tr).sum(dim=1) < 0.5
    self_all = (ra.self_match | ~ra.valid).all(dim=1) & has_ra
    all_keys = (node_has_key | ~ra.valid[:, :, None]).all(dim=1)
    aff_ok = aff_ok | ((no_matches & self_all)[:, None] & all_keys)
    aff_ok = torch.where(has_ra[:, None], aff_ok, torch.ones_like(aff_ok))

    # incoming required anti-affinity (filtering.go:329)
    raa = batch.raa
    Ta = raa.valid.shape[1]
    ma = _pod_term_matches(cluster, raa, B, pre=pre.m_raa).reshape(B * Ta, -1)
    keys_a = torch.where(raa.topo_known, raa.topo_key,
                         torch.full_like(raa.topo_key, -1)).reshape(-1)
    cnt_a = _samepair_pods_to_nodes(cluster, ma, keys_a, cluster.pod_node,
                                    cluster.pod_valid,
                                    active_keys=active_keys)
    np_a = node_topo_pairs(cluster, raa.topo_key.reshape(-1))
    has_key_a = (np_a >= 0).reshape(B, Ta, N) & raa.topo_known[:, :, None]
    cnt_a = cnt_a.reshape(B, Ta, N)
    anti_fail = (has_key_a & (cnt_a > 0.5)
                 & raa.valid[:, :, None]).any(dim=1)

    # existing pods' required anti-affinity (filtering.go:314)
    _, sp_rows = _owner_pairs(cluster, cluster.filter_terms)
    exist_fail = (_f(pre.em).T @ _f(sp_rows)) > 0.5

    ok = aff_ok & ~anti_fail & ~exist_fail
    if return_no_matches:
        return ok, ~aff_ok, no_matches
    return ok, ~aff_ok


class InterpodScorePre(NamedTuple):
    m_pref: torch.Tensor  # [B, Tp, P]
    em: torch.Tensor      # [Es, B]


def interpod_score_pre(cluster, batch) -> InterpodScorePre:
    B = batch.req.shape[0]
    return InterpodScorePre(
        m_pref=_pod_term_matches_static(cluster, batch.pref, B),
        em=existing_terms_match(cluster.score_terms, batch))


def interpod_score_raw(cluster, batch, pre: InterpodScorePre | None = None,
                       active_keys=None):
    """The RAW half of InterPodAffinity scoring -> (raw [B, N], any_counts
    [B, 1]); round-invariant under intra_batch_topology=False, so the
    auction computes it once."""
    B = batch.req.shape[0]
    N = cluster.allocatable.shape[0]
    if pre is None:
        pre = interpod_score_pre(cluster, batch)
    pt = batch.pref
    T = pt.valid.shape[1]
    m = _pod_term_matches(cluster, pt, B, pre=pre.m_pref)
    data = _f(m) * pt.weight[:, :, None] * _f(pt.valid)[:, :, None]
    keys_p = torch.where(pt.topo_known, pt.topo_key,
                         torch.full_like(pt.topo_key, -1)).reshape(-1)
    raw1 = _samepair_pods_to_nodes(cluster, data.reshape(B * T, -1), keys_p,
                                   cluster.pod_node, cluster.pod_valid,
                                   active_keys=active_keys)
    raw1 = raw1.reshape(B, T, N).sum(dim=1)

    st = cluster.score_terms
    owner_ok, sp_rows = _owner_pairs(cluster, st)
    em = _f(pre.em & owner_ok[:, None]) * st.weight[:, None]   # [Es, B]
    raw2 = em.T @ _f(sp_rows)
    raw = raw1 + raw2
    any_counts = (raw != 0).any(dim=1, keepdim=True)
    return raw, any_counts


def interpod_score(cluster, batch, feasible, pre=None,
                   active_keys=None) -> torch.Tensor:
    """InterPodAffinity scoring, normalized (reference: scoring.go:237-271;
    min/max start at 0)."""
    raw, any_counts = interpod_score_raw(cluster, batch, pre=pre,
                                         active_keys=active_keys)
    big = float(2 ** 62)
    max_c = torch.clamp(torch.where(feasible, raw, torch.full_like(raw, -big))
                        .max(dim=1, keepdim=True).values, min=0.0)
    min_c = torch.clamp(torch.where(feasible, raw, torch.full_like(raw, big))
                        .min(dim=1, keepdim=True).values, max=0.0)
    diff = max_c - min_c
    norm = torch.where(diff > 0,
                       _idiv(MAX_NODE_SCORE * (raw - min_c),
                             torch.clamp(diff, min=1.0)),
                       torch.zeros_like(raw))
    out = torch.where(any_counts, norm, raw)
    return torch.where(feasible, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# resource scorers


def _safe_den(cap):
    """Divide-by-zero guard that keeps sub-unit capacities (only true zero
    is redirected; callers mask that case)."""
    return torch.where(cap > 0, cap, torch.ones_like(cap))


def _alloc_req(cluster, batch):
    """(requested-with-pod, allocatable) for cpu/mem using NonZeroRequested
    (reference: noderesources/resource_allocation.go:108-117)."""
    req_cpu = (cluster.nonzero_requested[None, :, 0]
               + batch.nonzero_req[:, 0][:, None])
    req_mem = (cluster.nonzero_requested[None, :, 1]
               + batch.nonzero_req[:, 1][:, None])
    alloc_cpu = cluster.allocatable[None, :, CH_CPU]
    alloc_mem = cluster.allocatable[None, :, CH_MEM]
    return req_cpu, req_mem, alloc_cpu, alloc_mem


_BALANCED_EPS = _f32(1e-5)


def balanced_formula(req_cpu, req_mem, alloc_cpu, alloc_mem):
    """(1 - |cpuFraction - memFraction|) * MaxNodeScore, truncated
    (reference: balanced_allocation.go:83-113).  The 1e-5 compensates an
    f32 quotient landing an ulp under a true integer product; the product
    is rounded before the epsilon is added."""
    one = torch.ones((), device=req_cpu.device)
    cpu_frac = torch.where(alloc_cpu > 0, req_cpu / _safe_den(alloc_cpu), one)
    mem_frac = torch.where(alloc_mem > 0, req_mem / _safe_den(alloc_mem), one)
    diff = torch.abs(cpu_frac - mem_frac)
    score = torch.floor((1.0 - diff) * MAX_NODE_SCORE + _BALANCED_EPS)
    return torch.where((cpu_frac >= 1.0) | (mem_frac >= 1.0),
                       torch.zeros_like(score), score)


def least_formula(req, cap):
    """(capacity - requested) * MaxNodeScore / capacity
    (reference: least_allocated.go:95-117)."""
    s = _idiv((cap - req) * MAX_NODE_SCORE, _safe_den(cap))
    return torch.where((cap <= 0) | (req > cap), torch.zeros_like(s), s)


def most_formula(req, cap):
    """requested * MaxNodeScore / capacity (reference: most_allocated.go:101)."""
    s = _idiv(req * MAX_NODE_SCORE, _safe_den(cap))
    return torch.where((cap <= 0) | (req > cap), torch.zeros_like(s), s)


def balanced_allocation_score(cluster, batch):
    return balanced_formula(*_alloc_req(cluster, batch))


def _weighted_resource_score(cluster, batch, per_resource):
    req_cpu, req_mem, alloc_cpu, alloc_mem = _alloc_req(cluster, batch)
    total = (per_resource(req_cpu, alloc_cpu) * 1.0
             + per_resource(req_mem, alloc_mem) * 1.0)
    return _idiv(total, 2.0)


def least_allocated_score(cluster, batch):
    return _weighted_resource_score(cluster, batch, least_formula)


def most_allocated_score(cluster, batch):
    return _weighted_resource_score(cluster, batch, most_formula)


# ---------------------------------------------------------------------------
# remaining scorers


def node_affinity_score(cluster, batch):
    """Sum of matched preferred node-affinity term weights (raw)
    (reference: nodeaffinity/node_affinity.go:65-103)."""
    B = batch.req.shape[0]
    Tp = batch.pna_valid.shape[1]
    m = match_selectors(batch.pna_sel, cluster.kv, cluster.keymask,
                        cluster.num).reshape(B, Tp, -1)
    w = batch.pna_weight * _f(batch.pna_valid)
    return torch.bmm(w[:, None, :], _f(m))[:, 0, :]


def taint_toleration_score(cluster, batch):
    """Count of untolerated PreferNoSchedule taints (raw)
    (reference: taint_toleration.go:123-141)."""
    untol_prefer = _f(~batch.tolerated) * _f(cluster.taint_is_prefer)[None, :]
    return untol_prefer @ _f(cluster.taints).T


_MB = 1024.0 * 1024.0
IMAGE_MIN_THRESHOLD = 23.0 * _MB       # reference: image_locality.go:44
IMAGE_MAX_CONTAINER_THRESHOLD = 1000.0 * _MB


def image_locality_score(cluster, batch):
    """Scaled sum of present image sizes (reference: image_locality.go:82-110)."""
    scaled = _f(cluster.images) * torch.floor(
        cluster.image_size * cluster.image_spread)[None, :]
    s = batch.images_hot @ scaled.T
    max_thr = IMAGE_MAX_CONTAINER_THRESHOLD * torch.clamp(batch.n_containers,
                                                          min=1.0)
    s = torch.minimum(torch.clamp(s, min=IMAGE_MIN_THRESHOLD),
                      max_thr[:, None])
    return _idiv(MAX_NODE_SCORE * (s - IMAGE_MIN_THRESHOLD),
                 max_thr[:, None] - IMAGE_MIN_THRESHOLD)


def prefer_avoid_pods_score(cluster, batch):
    """MaxNodeScore unless the node's preferAvoidPods annotation names the
    pod's RC/RS controller (reference: node_prefer_avoid_pods.go:46-81)."""
    hit = cluster.avoid_hot.T[batch.avoid_id.long().clamp(min=0)]
    avoided = hit & (batch.avoid_id >= 0)[:, None]
    return torch.where(avoided, torch.zeros(avoided.shape, device=hit.device),
                       torch.full(avoided.shape, MAX_NODE_SCORE,
                                  device=hit.device))


def default_spread_match_ns(cluster, batch):
    """[B, P] DefaultPodTopologySpread selector x namespace match."""
    m = match_selectors(batch.spread_selector, cluster.pod_kv,
                        cluster.pod_key)
    ns_ok = (batch.ns_hot @ cluster.pod_ns_hot.T) > 0.5
    return m & ns_ok


def default_spread_score(cluster, batch, match_ns=None):
    """DefaultPodTopologySpread raw score: matching same-namespace,
    non-terminating pods on the node (reference:
    default_pod_topology_spread.go:74-97, 200-215)."""
    N = cluster.allocatable.shape[0]
    if match_ns is None:
        match_ns = default_spread_match_ns(cluster, batch)
    countable = cluster.pod_valid & ~cluster.pod_terminating
    counts = per_node_counts(match_ns & countable[None, :], cluster.pod_node,
                             N)
    return torch.where(batch.spread_skip[:, None], torch.zeros_like(counts),
                       counts)


ZONE_WEIGHTING = 2.0 / 3.0  # reference: default_pod_topology_spread.go:44
# both weights are computed in double and rounded once to f32, as the
# reference's weak-typed Python constants are: 1 - 2/3 -> 0.33333334
# (f32(1) - f32(2/3) would give 0.3333333)
ONE_MINUS_ZONE_W = _f32(1.0 - ZONE_WEIGHTING)
ZONE_W = _f32(ZONE_WEIGHTING)


def default_spread_normalize(cluster, batch, raw, feasible):
    """Zone-aware normalization (reference:
    default_pod_topology_spread.go:104-166)."""
    big = float(2 ** 62)
    raw_f = torch.where(feasible, raw, torch.zeros_like(raw))
    max_node = torch.clamp(torch.where(feasible, raw, torch.full_like(raw, -big))
                           .max(dim=1, keepdim=True).values, min=0.0)
    zh = cluster.zone_hot
    has_zone = (zh > 0).any(dim=1)
    counts_by_zone = raw_f @ zh                                  # [B, Z]
    have_zones = (feasible & has_zone[None, :]).any(dim=1, keepdim=True)
    if zh.shape[1]:
        max_zone = counts_by_zone.max(dim=1, keepdim=True).values
    else:
        max_zone = torch.full_like(max_node, -float("inf"))
    max_zone = torch.clamp(max_zone, min=0.0)
    f_score = torch.where(max_node > 0,
                          MAX_NODE_SCORE * (max_node - raw)
                          / torch.clamp(max_node, min=1.0),
                          torch.full_like(raw, MAX_NODE_SCORE))
    node_zone_count = counts_by_zone @ zh.T
    zone_score = torch.where(max_zone > 0,
                             MAX_NODE_SCORE * (max_zone - node_zone_count)
                             / torch.clamp(max_zone, min=1.0),
                             torch.full_like(raw, MAX_NODE_SCORE))
    with_zone = f_score * ONE_MINUS_ZONE_W + ZONE_W * zone_score
    out = torch.where(have_zones & has_zone[None, :], with_zone, f_score)
    out = torch.floor(out)
    out = torch.where(batch.spread_skip[:, None], torch.zeros_like(out), out)
    return torch.where(feasible, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# normalization helpers


def default_normalize(raw, feasible, reverse: bool):
    """reference: plugins/helper/normalize_score.go:26."""
    big = float(2 ** 62)
    max_c = torch.clamp(torch.where(feasible, raw, torch.full_like(raw, -big))
                        .max(dim=1, keepdim=True).values, min=0.0)
    scaled = _idiv(MAX_NODE_SCORE * raw, torch.clamp(max_c, min=1.0))
    if reverse:
        scaled = MAX_NODE_SCORE - scaled
    zero_case = MAX_NODE_SCORE if reverse else 0.0
    out = torch.where(max_c > 0, scaled, torch.full_like(scaled, zero_case))
    return torch.where(feasible, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# configurable scorers (driven by plugin args; kubetpu/ops/kernels.py:
# 938-1055)


def _itrunc(a, b):
    """Go int64 division truncates toward zero (not floor); b > 0."""
    q = _idiv(torch.abs(a), b)
    return torch.where(a < 0, -q, q)


def broken_linear(p, shape):
    """Piecewise-linear shape function with Go's integer division
    (reference: noderesources/requested_to_capacity_ratio.go:158
    buildBrokenLinearFunction).  shape: a static tuple of (utilization,
    score).  A falling segment has a negative delta, which truncates
    toward zero; the delta's product is rounded before the division and
    the add that follow it."""
    out = torch.full_like(p, float(shape[-1][1]))
    for i in range(len(shape) - 1, -1, -1):
        u_i, s_i = float(shape[i][0]), float(shape[i][1])
        if i == 0:
            seg = torch.full_like(p, s_i)
        else:
            u_p, s_p = float(shape[i - 1][0]), float(shape[i - 1][1])
            seg = s_p + _itrunc((s_i - s_p) * (p - u_p), u_i - u_p)
        out = torch.where(p <= u_i, seg, out)
    return out


def broken_linear_scalar(p, shape):
    """broken_linear at one utilization, in exact Python arithmetic (Go's
    truncating division): the score of a zero or exceeded capacity,
    rawScoringFunction(maxUtilization), a constant of the shape."""
    for i, (u_i, s_i) in enumerate(shape):
        if p <= u_i:
            if i == 0:
                return float(s_i)
            u_p, s_p = shape[i - 1]
            num = (s_i - s_p) * (p - u_p)
            q = abs(num) // (u_i - u_p)
            return float(s_p + (-q if num < 0 else q))
    return float(shape[-1][1])


def rtcr_combine(parts, shape):
    """The weighted RequestedToCapacityRatio combine of the batch kernel
    and the sequential replay (reference: requested_to_capacity_ratio.go:
    124-147).  parts: (req, cap, weight) triples.  Zero or exceeded
    capacity scores rawScoringFunction(maxUtilization); the final divide
    is math.Round (half away from zero) in exact integer form."""
    fallback = broken_linear_scalar(100, shape)
    total = weight_sum = None
    for req, cap, weight in parts:
        # _safe_den: sub-unit capacities (memory in MiB) divide by their
        # true value; cap <= 0 takes the fallback
        util = 100.0 - _idiv((cap - req) * 100.0, _safe_den(cap))
        s = torch.where((cap <= 0) | (req > cap), fallback,
                        broken_linear(util, shape))
        contrib = torch.where(s > 0, s * float(weight), 0.0)
        w = torch.where(s > 0, float(weight), 0.0)
        total = contrib if total is None else total + contrib
        weight_sum = w if weight_sum is None else weight_sum + w
    return torch.where(weight_sum > 0,
                       _idiv(2.0 * total + weight_sum,
                             torch.clamp(2.0 * weight_sum, min=1.0)),
                       0.0)


def rtcr_parts(resources, cpu, mem, scalar):
    """RequestedToCapacityRatio's (req, cap, weight) triples, for the
    batch kernel and the replay alike.  resources: ((kind, ch, weight),
    ...), kind 0 = cpu and 1 = memory (the (req, cap) pairs ``cpu`` and
    ``mem``, non-zero requests), 2 = the scalar channel ch, whose pair
    ``scalar(ch)`` gives; ch < 0 names a resource the cluster does not
    know, whose capacity is 0."""
    parts = []
    for kind, ch, weight in resources:
        if kind == 0:
            req, cap = cpu
        elif kind == 1:
            req, cap = mem
        elif ch < 0:
            req, cap = torch.zeros_like(cpu[0]), torch.zeros_like(cpu[1])
        else:
            req, cap = scalar(ch)
        parts.append((req, cap, weight))
    return parts


def requested_to_capacity_ratio_score(cluster, batch, shape, resources):
    """RequestedToCapacityRatio (reference: requested_to_capacity_ratio.go:
    124-147), over the batch [B, N]."""
    req_cpu, req_mem, alloc_cpu, alloc_mem = _alloc_req(cluster, batch)
    return rtcr_combine(rtcr_parts(
        resources, (req_cpu, alloc_cpu), (req_mem, alloc_mem),
        lambda ch: (cluster.requested[None, :, ch]
                    + batch.req[:, ch][:, None],
                    cluster.allocatable[None, :, ch])), shape)


def resource_limits_score(cluster, batch):
    """NodeResourceLimits: 1 where the node satisfies the pod's cpu or
    memory limit (reference: noderesources/resource_limits.go:104-123,
    155)."""
    lim_cpu = batch.limits[:, None, CH_CPU]
    lim_mem = batch.limits[:, None, CH_MEM]
    alloc_cpu = cluster.allocatable[None, :, CH_CPU]
    alloc_mem = cluster.allocatable[None, :, CH_MEM]
    cpu_ok = (lim_cpu > 0) & (alloc_cpu > 0) & (lim_cpu <= alloc_cpu)
    mem_ok = (lim_mem > 0) & (alloc_mem > 0) & (lim_mem <= alloc_mem)
    return (cpu_ok | mem_ok).float()


def node_label_filter(cluster, batch, present_ids, absent_ids):
    """NodeLabel filter: every configured present label present, every
    absent one absent (reference: nodelabel/node_label.go:48-68).  ids
    are key-vocab ids; -1 is a label no node carries."""
    B = batch.req.shape[0]
    N = cluster.keymask.shape[0]
    ok = torch.ones((N,), dtype=torch.bool, device=cluster.keymask.device)
    for kid in present_ids:
        ok = ok & (cluster.keymask[:, kid] if kid >= 0
                   else torch.zeros_like(ok))
    for kid in absent_ids:
        if kid >= 0:
            ok = ok & ~cluster.keymask[:, kid]
    return ok[None, :].expand(B, N)


def node_label_score(cluster, batch, prefs):
    """NodeLabel score: MaxNodeScore per satisfied preference, averaged
    (reference: nodelabel/node_label.go:70-93).  prefs: ((key_id,
    want_present), ...)."""
    B = batch.req.shape[0]
    N = cluster.keymask.shape[0]
    dev = cluster.keymask.device
    if not prefs:
        return torch.zeros((B, N), dtype=torch.float32, device=dev)
    score = torch.zeros((N,), dtype=torch.float32, device=dev)
    for kid, want_present in prefs:
        has = (cluster.keymask[:, kid] if kid >= 0
               else torch.zeros((N,), dtype=torch.bool, device=dev))
        hit = has if want_present else ~has
        score = score + hit.float() * MAX_NODE_SCORE
    score = _idiv(score, float(len(prefs)))
    return score[None, :].expand(B, N)
