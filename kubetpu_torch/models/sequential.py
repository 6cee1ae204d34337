"""Sequential-replay scheduling: scheduleOne over a batch, in pod order.

The counterpart of kubetpu/models/sequential.py.  The reference schedules
pods strictly serially because pod i's binding changes pod i+1's filter
and score inputs (reference: pkg/scheduler/scheduler.go:509 scheduleOne;
cache.AssumePod :435).  As in the JAX package, the O(B x P x N) matching
work is precomputed in batched products, and a loop over the pod rows
carries the small mutable state a placement creates:

  - node resource vectors (requested / non-zero requested);
  - topology-pair match counts for PodTopologySpread (hard and soft);
  - pair counts for InterPodAffinity (incoming required terms, existing
    anti-affinity, scoring contributions);
  - per-node matching-pod counts (hostname spread,
    DefaultPodTopologySpread);
  - hostPorts registered by the batch's own placements;
  - the adaptive-sampling start index.

The JAX package runs the loop as a ``lax.scan``; here it is a Python loop
over the rows whose every step is device work only — no ``.item()``, no
boolean-mask indexing, no branch on a tensor — so the cycle keeps the
reference's single readback of ``packed``.  Step i sees exactly the
cluster state the serial loop sees after placements 0..i-1.

Exactness, beyond ops/kernels.py's rules:

* every carry holds integer-valued f32 (counts, integer weights, request
  channels), so ``index_add_``'s atomics on the card give the same sums as
  the reference's ordered scatter, duplicate ids included;
* the soft-spread weight log(size + 2) is ops/kernels.spread_log_weight,
  XLA:CPU's f32 log (utils/xla_math, the same bits on the CPU and the
  card), tabulated once per scan for the sizes 0..N a step can meet, and
  its products are summed over the constraints left to right, as the
  reference's reduction does;
* selectHost draws from a [B, N] plane made before the loop
  (utils/prng.select_plane): argmax(where(ties, gumbel_row, -2**62)) is
  the reference's ``categorical(fold_in(rng, i), logits)``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from ..ops import kernels as K
from ..ops.selectors import match_selectors
from ..state.tensors import CH_CPU, CH_MEM, CH_PODS, N_FIXED_CHANNELS
from ..utils import prng
from .batch import densify_for
from .programs import (DEFAULT_RTCR_ARGS, NO_NODE_LABEL_ARGS,
                       ProgramConfig, UNRESOLVABLE_FILTERS)

_f = K._f
NEG = float(-2 ** 62)
BIG = float(2 ** 62)


class SeqResult(NamedTuple):
    chosen: torch.Tensor       # [B] i32 node row, -1 unschedulable
    score: torch.Tensor        # [B] f32 winning score
    n_feasible: torch.Tensor   # [B] i32 feasible-node count at the pod's
                               # turn (of the sampled search when sampling
                               # binds)
    all_unresolvable: torch.Tensor  # [B] bool every failed node failed
                               # UnschedulableAndUnresolvable
    requested: torch.Tensor    # [N, R] final requested
    next_start: torch.Tensor   # i32 rotated start index after the batch
                               # (nextStartNodeIndex,
                               # generic_scheduler.go:451,487)
    packed: torch.Tensor       # [3*B+1] i32 = (chosen, n_feasible,
                               # all_unresolvable, [next_start]): the
                               # host's per-cycle view in one readback


def _num_feasible_nodes_to_find(n_valid: torch.Tensor, pct: int):
    """reference: generic_scheduler.go:54-59,379-399
    numFeasibleNodesToFind.  n_valid: an integer tensor; pct: static."""
    if pct >= 100:
        return n_valid
    adaptive = pct if pct > 0 else torch.clamp(50 - n_valid // 125, min=5)
    num = torch.clamp(n_valid * adaptive // 100, min=100)
    return torch.where(n_valid < 100, n_valid, num)


def _term_state(cluster, terms, B: int):
    """Base pair counts and node-pair maps for a PodTerms set."""
    T = terms.valid.shape[1]
    N = cluster.allocatable.shape[0]
    m = K._pod_term_matches(cluster, terms, B)               # [B, T, P]
    ep_pair = K.pod_topo_pairs(cluster, terms.topo_key.reshape(-1))
    node_pair = K.node_topo_pairs(cluster, terms.topo_key.reshape(-1))
    has_key = ((node_pair >= 0).reshape(B, T, N)
               & terms.topo_known[:, :, None])
    return m, ep_pair, node_pair, has_key


def _batch_term_matches(terms, batch, B: int) -> torch.Tensor:
    """Match pod-side terms against the batch's own pods -> [B*T, B]."""
    m = match_selectors(terms.sel, batch.kv_hot, batch.key_hot)
    T = terms.valid.shape[1]
    NS = terms.ns_hot.shape[-1]
    ns_ok = (terms.ns_hot.reshape(B * T, NS)
             @ batch.ns_hot.T).reshape(B, T, B) > 0.5
    m = (m.reshape(B, T, B) & ns_ok & terms.valid[:, :, None]
         & batch.valid[None, None, :])
    return m.reshape(B * T, B)


def _existing_pairs(cluster, terms):
    """Each existing term's owner pair id [E] (-1 when invalid) and
    whether its owner pod is valid."""
    pod_topo = cluster.topo_pair[cluster.pod_node.long().clamp(min=0)]
    owner = terms.pod_idx.long().clamp(min=0)
    e_pair = pod_topo[owner].gather(1, terms.topo_key.long()[:, None])[:, 0]
    owner_ok = cluster.pod_valid[owner]
    return torch.where(terms.valid & owner_ok, e_pair,
                       torch.full_like(e_pair, -1)), owner_ok


def _existing_counts(values_eb: torch.Tensor, e_pair: torch.Tensor,
                     L: int) -> torch.Tensor:
    """[E, B] per-term values summed by owner pair -> [B, L]."""
    ids = torch.where(e_pair >= 0, e_pair.long(),
                      torch.full_like(e_pair, L, dtype=torch.long))
    out = torch.zeros((L + 1, values_eb.shape[1]), dtype=torch.float32,
                      device=values_eb.device)
    return out.index_add_(0, ids, values_eb)[:L].T.contiguous()


def _scan(step: Callable, B: int) -> List[torch.Tensor]:
    """Run ``step`` over the pod rows 0..B-1 and stack its per-row
    outputs.  Every step only enqueues device work."""
    outs = [step(i) for i in range(B)]
    return [torch.stack(col) for col in zip(*outs)]


def schedule_sequential(cluster, batch, cfg: ProgramConfig, rng,
                        hard_pod_affinity_weight: float = 1.0,
                        host_ok=None, start_index: int = 0,
                        score_bias=None, gumbel=None) -> SeqResult:
    """One batch replayed in pod order (the JAX package's
    schedule_sequential).  rng: an int64 [2] key (utils/prng.PRNGKey).
    host_ok: optional [B, N] bool host filter verdicts; score_bias:
    optional [B, N] f32 host scores added before selectHost; gumbel:
    optional [B, N] selectHost plane (default: drawn from rng; the tests
    hand in the JAX package's plane)."""
    filters = set(cfg.filters)
    score_w = dict(cfg.scores)
    batch = densify_for(cluster, batch)
    dev = batch.req.device
    B = batch.req.shape[0]
    N = cluster.allocatable.shape[0]
    L = cluster.kv.shape[1]
    # adaptive sampling: each pod searches only the first `limit` feasible
    # nodes in rotated processing order, then advances the start index by
    # the number of nodes examined (generic_scheduler.go:379-399,451,487)
    pct = cfg.percentage_of_nodes_to_score
    sample = pct < 100
    n_valid = cluster.node_valid.sum(dtype=torch.int32)
    sample_limit = _num_feasible_nodes_to_find(n_valid, pct)

    # ---------------- static precompute ----------------
    base = cluster.node_valid[None, :] & batch.valid[:, None]
    if host_ok is not None:
        base = base & host_ok
    affinity_ok = K.node_affinity_filter(cluster, batch)
    static_ok = base
    static_unres = torch.zeros_like(base)
    static_filters = (("NodeUnschedulable", K.node_unschedulable_filter),
                      ("NodeName", K.node_name_filter),
                      ("NodeAffinity", lambda c, b: affinity_ok),
                      ("TaintToleration", K.taint_filter),
                      ("NodeLabel", lambda c, b: K.node_label_filter(
                          c, b, *cfg.arg("NodeLabel",
                                         NO_NODE_LABEL_ARGS)[:2])))
    for name, fn in static_filters:
        if name in filters:
            ok = fn(cluster, batch)
            if name in UNRESOLVABLE_FILTERS:
                static_unres = static_unres | (~ok & base)
            static_ok = static_ok & ok
    ports_ok0 = (K.node_ports_filter(cluster, batch)
                 if "NodePorts" in filters else None)
    ns_eq = (batch.ns_hot @ batch.ns_hot.T) > 0.5              # [B, B]
    not_term = batch.valid  # new pods are never terminating

    use_sph = "PodTopologySpread" in filters
    if use_sph:
        cons = batch.spread
        C = cons.topo_key.shape[1]
        st = K._spread_state(cluster, batch, cons, affinity_ok,
                             cluster.node_valid[None, :].expand(B, N))
        sph_m_bb = match_selectors(cons.sel, batch.kv_hot, batch.key_hot)
        sph_m_bb = _f(sph_m_bb.reshape(B, C, B) & ns_eq[:, None, :]
                      & not_term[None, None, :]).reshape(B * C, B)
        sph_has_cons = cons.valid.any(dim=1)

    use_sps = "PodTopologySpread" in score_w
    if use_sps:
        scons = batch.spread_soft
        Cs = scons.topo_key.shape[1]
        count_mask = affinity_ok & cluster.node_valid[None, :]
        sst = K._spread_state(cluster, batch, scons,
                              torch.zeros_like(affinity_ok), count_mask)
        # registration is per step (it depends on the pod's feasible
        # set): the precomputed registered mask is unused
        sps_all_keys = (sst.has_key | ~scons.valid[:, :, None]).all(dim=1)
        sps_cm = count_mask & sps_all_keys   # nodes whose pods are counted
        sps_m_bb = match_selectors(scons.sel, batch.kv_hot, batch.key_hot)
        sps_m_bb = _f(sps_m_bb.reshape(B, Cs, B) & ns_eq[:, None, :]
                      & not_term[None, None, :]).reshape(B * Cs, B)
        sps_is_host = (scons.topo_key == cfg.hostname_topokey) \
            & scons.topo_known
        sps_scope = scons.valid & scons.topo_known                # [B, Cs]
        sps_any = scons.valid.any(dim=1)
        sps_log = K.spread_log_table(N, dev)     # the weight of each size

    use_ipf = "InterPodAffinity" in filters
    if use_ipf:
        ra, raa = batch.ra, batch.raa
        Tr, Ta = ra.valid.shape[1], raa.valid.shape[1]
        m_ra, ep_ra, np_ra, hk_ra = _term_state(cluster, ra, B)
        match_all = (m_ra | ~ra.valid[:, :, None]).all(dim=1)    # [B, P]
        ra_pair0 = K.pair_scatter(
            match_all[:, None, :].expand(m_ra.shape).reshape(B * Tr, -1),
            ep_ra, L)
        m_raa, ep_raa, np_raa, hk_raa = _term_state(cluster, raa, B)
        raa_pair0 = K.pair_scatter(m_raa.reshape(B * Ta, -1), ep_raa, L)
        ra_ind_bb = _batch_term_matches(ra, batch, B)             # [BTr, B]
        has_ra = ra.valid.any(dim=1)
        ra_all_bb = (ra_ind_bb.reshape(B, Tr, B)
                     | ~ra.valid[:, :, None]).all(dim=1)           # [B, B]
        ra_all_bb = _f(ra_all_bb & has_ra[:, None] & batch.valid[None, :])
        ra_all_rep = ra_all_bb.repeat_interleave(Tr, dim=0)       # [BTr, B]
        raa_ind_bb = _f(_batch_term_matches(raa, batch, B))       # [BTa, B]
        # existing pods' required anti-affinity -> [B, L] base counts
        ft = cluster.filter_terms
        em = match_selectors(ft.sel, batch.kv_hot, batch.key_hot)
        ens = (ft.ns_hot @ batch.ns_hot.T) > 0.5
        em = em & ens & ft.valid[:, None]
        e_pair, _ = _existing_pairs(cluster, ft)
        ea_cnt0 = _existing_counts(_f(em), e_pair, L)
        self_all = (ra.self_match | ~ra.valid).all(dim=1) & has_ra
        ra_all_keys = (hk_ra | ~ra.valid[:, :, None]).all(dim=1)   # [B, N]
        raa_live = hk_raa & raa.valid[:, :, None]                 # [B, Ta, N]

    use_ips = "InterPodAffinity" in score_w
    if use_ips:
        pt = batch.pref
        Tp = pt.valid.shape[1]
        m_p, ep_p, np_p, _ = _term_state(cluster, pt, B)
        data = _f(m_p) * pt.weight[:, :, None] * _f(pt.valid)[:, :, None]
        pref_pair0 = K.pair_scatter(data.reshape(B * Tp, -1), ep_p, L)
        sterms = cluster.score_terms
        em = match_selectors(sterms.sel, batch.kv_hot, batch.key_hot)
        ens = (sterms.ns_hot @ batch.ns_hot.T) > 0.5
        e_pair, owner_ok = _existing_pairs(cluster, sterms)
        em = (_f(em & ens & sterms.valid[:, None] & owner_ok[:, None])
              * sterms.weight[:, None])
        sc_cnt0 = _existing_counts(em, e_pair, L)
        pref_w_bb = (_f(_batch_term_matches(pt, batch, B))
                     * (pt.weight * _f(pt.valid)).reshape(B * Tp, 1))
        # required affinity terms of a placed pod score at hardWeight
        ra_s = batch.ra
        Trs = ra_s.valid.shape[1]
        hard_bb = (_f(_batch_term_matches(ra_s, batch, B))
                   * hard_pod_affinity_weight)                    # [BTrs, B]
        np_ra_s = K.node_topo_pairs(cluster, ra_s.topo_key.reshape(-1))

    use_ds = "DefaultPodTopologySpread" in score_w
    if use_ds:
        ds_raw0 = K.default_spread_score(cluster, batch)          # [B, N]
        ds_m = match_selectors(batch.spread_selector, batch.kv_hot,
                               batch.key_hot)
        ds_bb = _f(ds_m & ns_eq & not_term[None, :]
                   & ~batch.spread_skip[:, None])                 # [B, B]
        zh = cluster.zone_hot          # [N, Z], zero rows when zoneless
        has_zone = (zh > 0).any(dim=1)

    image_score = (K.image_locality_score(cluster, batch)
                   if "ImageLocality" in score_w else None)
    avoid_score = (K.prefer_avoid_pods_score(cluster, batch)
                   if "NodePreferAvoidPods" in score_w else None)
    node_aff_raw = (K.node_affinity_score(cluster, batch)
                    if "NodeAffinity" in score_w else None)
    taint_raw = (K.taint_toleration_score(cluster, batch)
                 if "TaintToleration" in score_w else None)
    limits_score = (K.resource_limits_score(cluster, batch)
                    if "NodeResourceLimits" in score_w else None)
    nodelabel_score = (K.node_label_score(
        cluster, batch, cfg.arg("NodeLabel", NO_NODE_LABEL_ARGS)[2])
        if "NodeLabel" in score_w else None)
    rtcr_args = (cfg.arg("RequestedToCapacityRatio", DEFAULT_RTCR_ARGS)
                 if "RequestedToCapacityRatio" in score_w else None)

    if gumbel is None:
        gumbel = prng.select_plane(rng.to(dev), B, N)
    gumbel = gumbel.to(device=dev, dtype=torch.float32)

    # ---------------- carries (updated in place by the steps) ----------------
    c = {"req": cluster.requested.clone(),
         "nz": cluster.nonzero_requested.clone()}
    if sample:
        c["start"] = torch.full((), start_index, dtype=torch.int64,
                                device=dev)
    if ports_ok0 is not None:
        # ports the batch's own placements have registered per node;
        # existing pods' ports are already inside ports_ok0
        c["ports_used"] = torch.zeros((N, batch.ports_hot.shape[1]),
                                      dtype=torch.float32, device=dev)
    if use_sph:
        c["sph_cnt"] = st.pair_counts.contiguous().clone()
    if use_sps:
        c["sps_cnt"] = sst.pair_counts.contiguous().clone()
        c["sps_node"] = sst.node_counts.reshape(B * Cs, N).clone()
    if use_ipf:
        c["ra_cnt"] = ra_pair0.contiguous()
        c["raa_cnt"] = raa_pair0.contiguous()
        c["ea_cnt"] = ea_cnt0
    if use_ips:
        c["pref_cnt"] = pref_pair0.contiguous()
        c["sc_own"] = sc_cnt0
    if use_ds:
        c["ds_cnt"] = ds_raw0.clone()

    kv_f = _f(cluster.kv)                                          # [N, L]
    alloc = cluster.allocatable
    alloc_cpu = alloc[:, CH_CPU]
    alloc_mem = alloc[:, CH_MEM]
    ch = torch.arange(alloc.shape[1], device=dev)
    is_fixed = (ch < N_FIXED_CHANNELS) & (ch != CH_PODS)
    is_pods = ch == CH_PODS
    k_idx = torch.arange(N, device=dev)
    nv = torch.clamp(n_valid, min=1)
    in_range = k_idx < n_valid

    # flat offset of each row of the [S, L] pair carries
    row_base = {k: torch.arange(v.shape[0], device=dev) * v.shape[1]
                for k, v in c.items()
                if k in ("sph_cnt", "sps_cnt", "ra_cnt", "raa_cnt",
                         "pref_cnt")}

    def flat_add(name, rows_ids, vals):
        """carry[r, ids[r]] += vals[r] for every row r of a pair carry
        (one id per row: no duplicates)."""
        flat = row_base[name] + rows_ids.long().clamp(min=0)
        c[name].view(-1).index_add_(0, flat, vals)

    def row_normalize(raw_row, feas_row, reverse: bool):
        max_c = torch.clamp(torch.where(feas_row, raw_row, NEG).amax(),
                            min=0.0)
        scaled = K._idiv(K.MAX_NODE_SCORE * raw_row,
                         torch.clamp(max_c, min=1.0))
        if reverse:
            scaled = K.MAX_NODE_SCORE - scaled
        zero_case = K.MAX_NODE_SCORE if reverse else 0.0
        out = torch.where(max_c > 0, scaled, zero_case)
        return torch.where(feas_row, out, 0.0)

    def step(i: int):
        feas = static_ok[i]
        unres = static_unres[i]

        # ---- dynamic filters
        if "NodeResourcesFit" in filters:
            req_i = batch.req[i]
            free_ok = alloc >= req_i[None, :] + c["req"]
            check = is_fixed | (req_i > 0)
            res_ok = (free_ok | ~check[None, :] | is_pods[None, :]).all(dim=1)
            pods_ok = free_ok[:, CH_PODS]
            zero_req = (torch.where(is_pods, 0.0, req_i) == 0).all()
            feas = feas & pods_ok & (zero_req | res_ok)

        if ports_ok0 is not None:
            conflict = torch.mv(c["ports_used"], batch.ports_hot[i]) > 0.5
            feas = feas & ports_ok0[i] & ~conflict

        if use_sph:
            rows = slice(i * C, (i + 1) * C)
            cnt = c["sph_cnt"][rows]                              # [C, L]
            reg = st.registered[rows]
            min_match = torch.where(reg, cnt, BIG).amin(dim=1)    # [C]
            mn = K.pair_gather(torch.where(reg, cnt, 0.0),
                               st.node_pair[rows])                # [C, N]
            skew = (mn + _f(cons.self_match[i])[:, None]
                    - min_match[:, None])
            c_ok = st.has_key[i] & (skew <= cons.max_skew[i][:, None])
            ok = (c_ok | ~cons.valid[i][:, None]).all(dim=0)
            feas = feas & (ok | ~(sph_has_cons[i] & st.any_eligible[i]))

        if use_ipf:
            cnt_r = c["ra_cnt"][i * Tr:(i + 1) * Tr]
            c_at = K.pair_gather(cnt_r, np_ra[i * Tr:(i + 1) * Tr])
            term_ok = hk_ra[i] & (c_at > 0.5)
            aff_ok = (term_ok | ~ra.valid[i][:, None]).all(dim=0)
            no_matches = cnt_r.sum() < 0.5
            aff_ok = aff_ok | (no_matches & self_all[i] & ra_all_keys[i])
            aff_ok = aff_ok | ~has_ra[i]
            ca = K.pair_gather(c["raa_cnt"][i * Ta:(i + 1) * Ta],
                               np_raa[i * Ta:(i + 1) * Ta])
            anti_fail = (raa_live[i] & (ca > 0.5)).any(dim=0)
            exist_fail = torch.mv(kv_f, c["ea_cnt"][i]) > 0.5
            unres = unres | (~aff_ok & static_ok[i])
            feas = feas & aff_ok & ~anti_fail & ~exist_fail

        # ---- adaptive sampling: keep only the first `sample_limit`
        # feasible nodes in rotated processing order (findNodesThatFit's
        # stop at numFeasibleNodesToFind, generic_scheduler.go:451-487)
        if sample:
            start = c["start"]
            perm = torch.where(in_range, (start + k_idx) % nv, 0)
            feas_perm = in_range & feas[perm]
            cum = torch.cumsum(feas_perm.int(), dim=0)
            allowed_perm = feas_perm & (cum <= sample_limit)
            reached = cum >= sample_limit
            kth_pos = torch.argmax(reached.int())     # first True
            n_processed = torch.where(cum[-1] >= sample_limit, kth_pos + 1,
                                      n_valid)
            # perm sends every out-of-range k to node 0 with False: an
            # amax reduction keeps node 0's True
            feas = torch.zeros((N,), dtype=torch.int32, device=dev) \
                .scatter_reduce_(0, perm, allowed_perm.int(), "amax") > 0
            new_start = (start + n_processed) % nv

        # ---- scores, in the reference's order
        total = torch.zeros((N,), dtype=torch.float32, device=dev)
        req_cpu = c["nz"][:, 0] + batch.nonzero_req[i, 0]
        req_mem = c["nz"][:, 1] + batch.nonzero_req[i, 1]

        if "NodeResourcesBalancedAllocation" in score_w:
            s = K.balanced_formula(req_cpu, req_mem, alloc_cpu, alloc_mem)
            total = total + (torch.where(feas, s, 0.0)
                             * score_w["NodeResourcesBalancedAllocation"])
        if "NodeResourcesLeastAllocated" in score_w:
            s = K._idiv(K.least_formula(req_cpu, alloc_cpu)
                        + K.least_formula(req_mem, alloc_mem), 2.0)
            total = total + (torch.where(feas, s, 0.0)
                             * score_w["NodeResourcesLeastAllocated"])
        if "NodeResourcesMostAllocated" in score_w:
            s = K._idiv(K.most_formula(req_cpu, alloc_cpu)
                        + K.most_formula(req_mem, alloc_mem), 2.0)
            total = total + (torch.where(feas, s, 0.0)
                             * score_w["NodeResourcesMostAllocated"])
        if image_score is not None:
            total = total + (torch.where(feas, image_score[i], 0.0)
                             * score_w["ImageLocality"])
        if avoid_score is not None:
            total = total + (torch.where(feas, avoid_score[i], 0.0)
                             * score_w["NodePreferAvoidPods"])
        if limits_score is not None:
            total = total + (torch.where(feas, limits_score[i], 0.0)
                             * score_w["NodeResourceLimits"])
        if nodelabel_score is not None:
            total = total + (torch.where(feas, nodelabel_score[i], 0.0)
                             * score_w["NodeLabel"])
        if rtcr_args is not None:
            # scored against the step's carried usage
            shape, resources = rtcr_args
            parts = K.rtcr_parts(
                resources, (req_cpu, alloc_cpu), (req_mem, alloc_mem),
                lambda ch: (c["req"][:, ch] + batch.req[i, ch],
                            alloc[:, ch]))
            total = total + (torch.where(feas, K.rtcr_combine(parts, shape),
                                         0.0)
                             * score_w["RequestedToCapacityRatio"])
        if node_aff_raw is not None:
            total = total + (row_normalize(node_aff_raw[i], feas, False)
                             * score_w["NodeAffinity"])
        if taint_raw is not None:
            total = total + (row_normalize(taint_raw[i], feas, True)
                             * score_w["TaintToleration"])

        if use_ips:
            counts = (c["pref_cnt"][i * Tp:(i + 1) * Tp].sum(dim=0)
                      + c["sc_own"][i])                           # [L]
            raw = torch.mv(kv_f, counts)                          # [N]
            any_counts = (counts != 0).any()
            max_c = torch.clamp(torch.where(feas, raw, NEG).amax(), min=0.0)
            min_c = torch.clamp(torch.where(feas, raw, BIG).amin(), max=0.0)
            diff = max_c - min_c
            norm = torch.where(diff > 0,
                               K._idiv(K.MAX_NODE_SCORE * (raw - min_c),
                                       torch.clamp(diff, min=1.0)), 0.0)
            s = torch.where(any_counts, norm, raw)
            total = total + (torch.where(feas, s, 0.0)
                             * score_w["InterPodAffinity"])

        if use_sps:
            rows = slice(i * Cs, (i + 1) * Cs)
            npair = sst.node_pair[rows]                           # [Cs, N]
            is_host = sps_is_host[i]
            all_keys = sps_all_keys[i]
            ignored = feas & ~all_keys
            scored = feas & all_keys
            # per-step registration from this pod's feasible set
            elig = scored[None, :] & (npair >= 0)
            reg = K.pair_scatter(elig, npair, L) > 0.5            # [Cs, L]
            reg = reg & ~is_host[:, None]
            topo_size = _f(reg).sum(dim=1)
            n_scored = _f(scored).sum()
            size = torch.where(is_host, n_scored, topo_size)
            weight = K.spread_log_weight(size, sps_log)
            pair_c = K.pair_gather(torch.where(reg, c["sps_cnt"][rows], 0.0),
                                   npair)
            cval = torch.where(is_host[:, None], c["sps_node"][rows], pair_c)
            ms = scons.max_skew[i][:, None]
            cval = torch.where(cval < ms, ms - 1.0, cval)
            contrib = torch.where(sps_scope[i][:, None] & sst.has_key[i],
                                  cval * weight[:, None], 0.0)
            raw = contrib[0]
            for j in range(1, Cs):        # left to right, as the reference
                raw = raw + contrib[j]
            raw = torch.where(ignored, 0.0, torch.floor(raw))
            min_s = torch.where(scored, raw, BIG).amin()
            max_s = torch.clamp(torch.where(scored, raw, NEG).amax(), min=0.0)
            norm = torch.where(
                max_s > 0,
                K._idiv(K.MAX_NODE_SCORE * (max_s + torch.clamp(min_s, max=BIG)
                                            - raw),
                        torch.clamp(max_s, min=1.0)),
                K.MAX_NODE_SCORE)
            s = torch.where(ignored, 0.0, norm)
            s = torch.where(sps_any[i], s, K.MAX_NODE_SCORE)
            total = total + (torch.where(feas, s, 0.0)
                             * score_w["PodTopologySpread"])

        if use_ds:
            raw = c["ds_cnt"][i]
            max_node = torch.clamp(torch.where(feas, raw, NEG).amax(),
                                   min=0.0)
            zcounts = torch.where(feas, raw, 0.0) @ zh            # [Z]
            have_zones = (feas & has_zone).any()
            if zh.shape[1]:
                max_zone = torch.clamp(zcounts.amax(), min=0.0)
            else:
                max_zone = torch.zeros((), device=dev)
            # true divisions, as the reference's (float64 there; the
            # floor lands after the zone combine)
            f_score = torch.where(
                max_node > 0,
                K.MAX_NODE_SCORE * (max_node - raw)
                / torch.clamp(max_node, min=1.0), K.MAX_NODE_SCORE)
            nzc = zh @ zcounts                                    # [N]
            z_score = torch.where(
                max_zone > 0,
                K.MAX_NODE_SCORE * (max_zone - nzc)
                / torch.clamp(max_zone, min=1.0), K.MAX_NODE_SCORE)
            wz = (f_score * K.ONE_MINUS_ZONE_W) + K.ZONE_W * z_score
            s = torch.floor(torch.where(have_zones & has_zone, wz, f_score))
            s = torch.where(batch.spread_skip[i], 0.0, s)
            total = total + (torch.where(feas, s, 0.0)
                             * score_w["DefaultPodTopologySpread"])

        # ---- select
        if score_bias is not None:
            total = total + score_bias[i]
        masked = torch.where(feas, total, NEG)
        best = masked.amax()
        ties = (masked == best) & feas
        choice = torch.argmax(torch.where(ties, gumbel[i], NEG))
        has = feas.any()
        chosen = torch.where(has, choice, -1)
        n_feas = feas.sum(dtype=torch.int32)
        # host-filter failures stay resolvable for the preemption gate
        # (host_ok is folded into base but not into this exclusion mask)
        base_nodes_i = cluster.node_valid & batch.valid[i]
        all_unres = (unres | feas | ~base_nodes_i).all()
        win_score = torch.where(has, best, 0.0)

        # ---- apply the placement to the carries (no-op when unschedulable)
        ok = has & batch.valid[i]
        node = chosen.clamp(0, N - 1).reshape(1)
        w = _f(ok)
        c["req"].index_add_(0, node, (batch.req[i] * w)[None, :])
        c["nz"].index_add_(0, node, (batch.nonzero_req[i] * w)[None, :])
        if sample:
            # padded (invalid) pods must not advance the rotation
            c["start"] = torch.where(batch.valid[i], new_start, c["start"])
        if ports_ok0 is not None:
            P = c["ports_used"].shape[1]
            c["ports_used"].scatter_reduce_(
                0, node[:, None].expand(1, P),
                (batch.ports_asnode_hot[i] * w)[None, :], "amax")
        if use_sph:
            ids = st.node_pair.index_select(1, node)[:, 0]        # [BC]
            flat_add("sph_cnt", ids, sph_m_bb[:, i] * w * _f(ids >= 0))
        if use_sps:
            ids = sst.node_pair.index_select(1, node)[:, 0]
            in_mask = _f(sps_cm.index_select(1, node)
                         .expand(B, Cs).reshape(B * Cs))
            flat_add("sps_cnt", ids,
                     sps_m_bb[:, i] * w * _f(ids >= 0) * in_mask)
            c["sps_node"].index_add_(1, node,
                                     (sps_m_bb[:, i] * w * in_mask)[:, None])
        if use_ipf:
            ids = np_ra.index_select(1, node)[:, 0]
            flat_add("ra_cnt", ids, ra_all_rep[:, i] * w * _f(ids >= 0))
            ids = np_raa.index_select(1, node)[:, 0]
            flat_add("raa_cnt", ids, raa_ind_bb[:, i] * w * _f(ids >= 0))
            # pod i's own anti terms now repel matching future pods
            own_ids = ids[i * Ta:(i + 1) * Ta]
            own_m = raa_ind_bb[i * Ta:(i + 1) * Ta]               # [Ta, B]
            c["ea_cnt"].index_add_(1, own_ids.long().clamp(min=0),
                                   own_m.T * w * _f(own_ids >= 0)[None, :])
        if use_ips:
            ids = np_p.index_select(1, node)[:, 0]
            flat_add("pref_cnt", ids, pref_w_bb[:, i] * w * _f(ids >= 0))
            own_ids = ids[i * Tp:(i + 1) * Tp]
            own_m = pref_w_bb[i * Tp:(i + 1) * Tp]
            c["sc_own"].index_add_(1, own_ids.long().clamp(min=0),
                                   own_m.T * w * _f(own_ids >= 0)[None, :])
            own_ids = np_ra_s[i * Trs:(i + 1) * Trs] \
                .index_select(1, node)[:, 0]
            own_m = hard_bb[i * Trs:(i + 1) * Trs]
            c["sc_own"].index_add_(1, own_ids.long().clamp(min=0),
                                   own_m.T * w * _f(own_ids >= 0)[None, :])
        if use_ds:
            c["ds_cnt"].index_add_(1, node, (ds_bb[:, i] * w)[:, None])
        return chosen, win_score, n_feas, all_unres

    chosen, score, n_feas, all_unres = _scan(step, B)
    chosen = chosen.to(torch.int32)
    next_start = (c["start"] if sample
                  else torch.full((), start_index, device=dev)).to(torch.int32)
    packed = torch.cat([chosen, n_feas, all_unres.to(torch.int32),
                        next_start.reshape(1)])
    return SeqResult(chosen=chosen, score=score, n_feasible=n_feas,
                     all_unresolvable=all_unres, requested=c["req"],
                     next_start=next_start, packed=packed)
