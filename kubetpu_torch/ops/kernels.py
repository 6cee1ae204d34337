"""Batched Filter/Score kernels for the gang auction, in PyTorch.

The counterpart of kubetpu/ops/kernels.py for the functions a term-free
gang cycle reaches (reference: pkg/scheduler/framework/plugins/*).  Shape
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


def node_topo_pairs(cluster, topo_key_s: torch.Tensor) -> torch.Tensor:
    """Each node's pair id [S, N] for topology-key ids [S] (-1 when the
    node lacks the key)."""
    return cluster.topo_pair.T[topo_key_s.long()]


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


def spread_soft_score_termfree(feasible) -> torch.Tensor:
    """PodTopologySpread scoring for a batch with no soft constraints: the
    reference's maxScore==0 branch gives MaxNodeScore on every feasible
    node (scoring.go).  Batches with soft constraints need the full
    scorer, which is not ported (ROADMAP: intra-batch topology)."""
    return torch.where(feasible, torch.full(feasible.shape, MAX_NODE_SCORE,
                                            device=feasible.device),
                       torch.zeros(feasible.shape, device=feasible.device))


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
                    active_keys=None):
    """InterPodAffinity filter -> (ok, affinity_unresolvable) (reference:
    interpodaffinity/filtering.go:314-396)."""
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
