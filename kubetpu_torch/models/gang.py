"""Conflict-free batched (gang) assignment: the propose-and-admit auction.

The counterpart of kubetpu/models/gang.py for term-free batches
(``intra_batch_topology=False``).  Each round:

1. every unassigned pod *proposes* to its best feasible node, breaking
   exact score ties by the selectHost gumbel row drawn from
   ``fold_in(rng, pod_row)`` (generic_scheduler.go:217);
2. pods proposing the same node are *admitted* in pod order (the batch is
   popped in priority order) up to the node's remaining multi-resource
   capacity and hostPort set — a stable sort by proposed node plus a
   segmented prefix sum over request channels;
3. admitted placements commit, and the next round recomputes feasibility
   and scores against the updated usage.

Invariants (as in the reference): zero capacity violations; every round
admits >= 1 pod or proves the remaining pods unschedulable, so the loop
terminates.

The JAX package runs the rounds in a ``lax.while_loop`` on the device.
Here the loop is Python: each round ends with ONE device->host read of a
few progress flags (``GangResult.syncs`` counts them).  ``kernel_backend``
"lax" runs ``round_step`` every round; "pallas" runs round 0 on
``round_step`` (its [B, N] feasibility is a diagnostic output) and every
later round's propose half through ``ops.propose`` — the CUDA kernel on
the card, its plain version on the CPU.

Exactness: admission's prefix sums and the commit's segment sums are f32
sums of integer-valued requests.  They are exact in any order (a CUDA
scan, ``index_add_`` atomics) only while the batch's total request per
channel stays below 2**24; schedule_gang checks that bound and raises
rather than trust a summation order.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..ops import kernels as K
from ..ops import propose as PK
from ..utils import prng
from .batch import densify_for
from .programs import ProgramConfig, run_filters, run_scores, static_raw_scores

_f = K._f
NEG = PK.NEG
EXACT_SUM_LIMIT = float(2 ** 24)


class GangResult(NamedTuple):
    chosen: torch.Tensor     # [B] i32 node row, -1 unschedulable this pass
    score: torch.Tensor      # [B] f32 score of the winning node at admission
    rounds: torch.Tensor     # i32 number of propose/admit rounds executed
    requested: torch.Tensor  # [N, R] final requested incl. batch placements
    nz: torch.Tensor         # [N, 2] final non-zero requested
    ports_used: torch.Tensor  # [N, P] f32 ports registered by batch placements
    feasible0: torch.Tensor  # [B, N] bool first-round feasibility
    unresolvable: torch.Tensor  # [B, N] bool static unresolvable filters
    n_feasible: torch.Tensor    # [B] i32 first-round feasible-node count
    all_unresolvable: torch.Tensor  # [B] bool every failed node unresolvable
    packed: torch.Tensor     # [3*B + 1] i32 = (chosen, n_feasible,
                             # all_unresolvable, [rounds]) — the host's
                             # per-cycle view in one readback
    syncs: int = 0           # device->host reads the round loop made


def _segment_base(values: torch.Tensor, is_start: torch.Tensor):
    """For row-sorted segments, each row's value at its segment's first
    row (values non-decreasing along axis 0, so a cummax over
    start ? value : -1 propagates it)."""
    mark = is_start[:, None] if values.ndim == 2 else is_start
    marked = torch.where(mark, values, torch.full_like(values, -1.0))
    return torch.cummax(marked, dim=0).values


def _seg_prefix(e_sorted: torch.Tensor, is_start: torch.Tensor):
    """Exclusive per-segment prefix sums of [B, U] rows sorted by segment."""
    cs = torch.cumsum(e_sorted, dim=0)
    excl = cs - e_sorted
    return excl - _segment_base(excl, is_start)


def admission_mask(prop, active, req_b, ports_hot_b, ports_asnode_b,
                   allocatable, req_carry, use_ports: bool, n_nodes: int):
    """Admit each proposer iff its request fits the node's free capacity
    minus EARLIER proposers' requests and its probed hostPorts miss every
    earlier proposer's registered set (stable sort by proposed node keeps
    pod order).  prop uses n_nodes as the no-op segment."""
    order = torch.argsort(prop, stable=True)
    snode = prop[order]
    sactive = active[order]
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=prop.device),
                          snode[1:] != snode[:-1]])
    sreq = req_b[order] * _f(sactive)[:, None]
    prefix_excl = _seg_prefix(sreq, is_start)
    node_safe = snode.long().clamp(0, n_nodes - 1)
    free = allocatable[node_safe] - req_carry[node_safe]
    cap_ok = K.fit_rows(req_b[order], free - prefix_excl)
    if use_ports:
        sreg = ports_asnode_b[order] * _f(sactive)[:, None]
        earlier_ports = _seg_prefix(sreg, is_start)
        conflict = (ports_hot_b[order] * earlier_ports).sum(dim=1) > 0.5
        cap_ok = cap_ok & ~conflict
    admit_sorted = cap_ok & sactive & (snode < n_nodes)
    admit = torch.zeros(prop.shape, dtype=torch.bool, device=prop.device)
    admit[order] = admit_sorted
    return admit


def admission_sums(admit, prop, req_b, nonzero_b, ports_asnode_b,
                   use_ports: bool, n_nodes: int):
    """Commit-side segment sums of one round's admitted placements:
    (add_req [N, R], add_nz [N, 2], add_ports [N, P] | None)."""
    seg = torch.where(admit, prop, torch.full_like(prop, n_nodes)).long()
    a = _f(admit)[:, None]

    def seg_sum(x):
        out = torch.zeros((n_nodes + 1, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        return out.index_add_(0, seg, x * a)[:n_nodes]

    add_ports = None
    if use_ports:
        vals = ports_asnode_b * a
        out = torch.zeros((n_nodes + 1, vals.shape[1]), dtype=torch.float32,
                          device=vals.device)
        out.scatter_reduce_(0, seg[:, None].expand_as(vals), vals, "amax")
        add_ports = out[:n_nodes]
    return seg_sum(req_b), seg_sum(nonzero_b), add_ports


def _check_exact_sums(cluster, batch) -> None:
    """Admission and commit sums are exact only below 2**24 per channel."""
    top = torch.stack([(batch.req * _f(batch.valid)[:, None]).sum(dim=0).max(),
                       (batch.nonzero_req * _f(batch.valid)[:, None])
                       .sum(dim=0).max(),
                       cluster.allocatable.max(),
                       cluster.requested.max()])
    if float(top.max()) >= EXACT_SUM_LIMIT:
        raise ValueError(
            "gang auction: a batch request total or node capacity reaches "
            "2**24 in some channel; its f32 sums would no longer be exact "
            "in every summation order")


def run_auction(cluster, batch, cfg: ProgramConfig, rng,
                intra_batch_topology: bool = True,
                kernel_backend: Optional[str] = None,
                gumbel: Optional[torch.Tensor] = None) -> GangResult:
    """The serving-loop gang entry (kubetpu.models.gang.run_auction)."""
    return schedule_gang(cluster, batch, cfg, rng,
                         intra_batch_topology=intra_batch_topology,
                         kernel_backend=kernel_backend, gumbel=gumbel)


def schedule_gang(cluster, batch, cfg: ProgramConfig, rng,
                  intra_batch_topology: bool = True,
                  residual_window: int = 512,
                  kernel_backend: Optional[str] = None,
                  gumbel: Optional[torch.Tensor] = None) -> GangResult:
    """One gang auction over ``batch``.  rng: an int64 [2] key
    (utils/prng.PRNGKey).  gumbel: optional [B, N] selectHost plane; by
    default it is drawn from fold_in(rng, pod_row), and the tests hand in
    the JAX package's plane so both sides share one tie-break draw.
    Host filter masks and host score bias (the JAX package's host_ok and
    score_bias) are not ported: ROADMAP 'framework extension points'.
    The round budget is the batch size, as max_rounds=None there."""
    if intra_batch_topology:
        raise NotImplementedError(
            "gang auction with intra-batch topology (pods carrying "
            "(anti-)affinity or spread terms) is not ported: ROADMAP "
            "'intra-batch topology'")
    backend = kernel_backend or "lax"
    if backend not in ("lax", "pallas"):
        raise ValueError("kernel_backend must be 'lax' or 'pallas'")
    batch = densify_for(cluster, batch)
    if bool(batch.spread_soft.valid.any()):
        raise NotImplementedError(
            "soft PodTopologySpread constraints need the full spread "
            "scorer: ROADMAP 'intra-batch topology'")
    _check_exact_sums(cluster, batch)
    dev = batch.req.device
    B = batch.req.shape[0]
    N = cluster.allocatable.shape[0]
    max_rounds = B
    filters = set(cfg.filters)
    use_fit = "NodeResourcesFit" in filters
    use_ports = "NodePorts" in filters
    static_ok, static_unres, affinity_ok = run_filters(
        cluster, batch, cfg, skip=("NodeResourcesFit", "NodePorts"))
    ports_ok0 = (K.node_ports_filter(cluster, batch) if use_ports
                 else torch.ones((B, N), dtype=torch.bool, device=dev))
    score_names = set(n for n, _ in cfg.scores)
    score_pre = dict(static_raw_scores(cluster, batch, cfg))
    if "InterPodAffinity" in score_names:
        score_pre["interpod_score"] = K.interpod_score_pre(cluster, batch)
    if "DefaultPodTopologySpread" in score_names:
        score_pre["default_spread"] = K.default_spread_match_ns(cluster,
                                                                batch)
    if gumbel is None:
        tie_keys = prng.fold_in(rng.to(dev),
                                torch.arange(B, dtype=torch.int64,
                                             device=dev))
        gumbel = prng.gumbel(tie_keys, (N,))
    gumbel = gumbel.to(device=dev, dtype=torch.float32)
    use_pallas = backend == "pallas"
    bundle = (PK.build_bundle(cluster, batch, cfg, static_ok, ports_ok0,
                              score_pre, None, gumbel)
              if use_pallas else None)

    P = batch.ports_hot.shape[1]
    c: Dict[str, torch.Tensor] = dict(
        req=cluster.requested.clone(),
        nz=cluster.nonzero_requested.clone(),
        ports_used=torch.zeros((N, P), dtype=torch.float32, device=dev),
        assigned=torch.full((B,), -1, dtype=torch.int32, device=dev),
        win_score=torch.zeros((B,), dtype=torch.float32, device=dev),
        feas0=torch.zeros((B, N), dtype=torch.bool, device=dev),
        retired=torch.zeros((B,), dtype=torch.bool, device=dev),
    )
    state = dict(rounds=0, admits=0, syncs=0)

    def full_sub():
        return dict(rows=torch.arange(B, dtype=torch.int64, device=dev),
                    valid=batch.valid, batch=batch, static_ok=static_ok,
                    ports_ok0=ports_ok0, affinity_ok=affinity_ok,
                    gumbel=gumbel, score_pre=score_pre, bundle=bundle)

    def gather_sub(rows):
        """The window's sub-round inputs.  Both backends gather the small
        [W, .] batch fields round_tail reads; only the lax round gathers
        what round_step reads besides (the [W, N] static masks, gumbel
        rows, score precompute, term rows).  The kernel reads its rows of
        the whole-batch bundle by index."""
        rsafe = rows.clamp(0, B - 1)
        wvalid = rows < B

        def g(x):
            return x[rsafe]

        tail_fields = dict(req=g(batch.req),
                           nonzero_req=g(batch.nonzero_req),
                           ports_hot=g(batch.ports_hot),
                           ports_asnode_hot=g(batch.ports_asnode_hot),
                           valid=g(batch.valid) & wvalid)
        if use_pallas:
            return dict(rows=rows, valid=tail_fields["valid"],
                        batch=batch._replace(**tail_fields), bundle=bundle)

        def g_pre(v):
            if isinstance(v, K.InterpodScorePre):
                return K.InterpodScorePre(m_pref=g(v.m_pref),
                                          em=v.em[:, rsafe])
            return g(v)

        pref = batch.pref
        sub_batch = batch._replace(
            spread_skip=g(batch.spread_skip),
            pref=pref._replace(ns_hot=g(pref.ns_hot),
                               topo_key=g(pref.topo_key),
                               topo_known=g(pref.topo_known),
                               weight=g(pref.weight), valid=g(pref.valid),
                               self_match=g(pref.self_match)),
            **tail_fields)
        return dict(rows=rows, valid=sub_batch.valid, batch=sub_batch,
                    static_ok=g(static_ok), ports_ok0=g(ports_ok0),
                    affinity_ok=g(affinity_ok), gumbel=g(gumbel),
                    score_pre={k: g_pre(v) for k, v in score_pre.items()})

    def unassigned_of(sb):
        rsafe = sb["rows"].clamp(0, B - 1)
        return (c["assigned"][rsafe] < 0) & sb["valid"]

    def round_step(sb, windowed: bool):
        sbatch = sb["batch"]
        unassigned = unassigned_of(sb)
        cl = cluster._replace(requested=c["req"], nonzero_requested=c["nz"])
        feas = sb["static_ok"]
        if use_fit:
            feas = feas & K.fit_filter(cl, sbatch)
        if use_ports:
            batch_conf = (sbatch.ports_hot @ c["ports_used"].T) > 0.5
            feas = feas & sb["ports_ok0"] & ~batch_conf
        feas = feas & unassigned[:, None]
        scores, _ = run_scores(cl, sbatch, cfg, feas, sb["affinity_ok"],
                               pre=sb["score_pre"])
        best, _, choice = K.gumbel_tiebreak_argmax(scores, feas,
                                                   sb["gumbel"], 0, NEG)
        active = feas.any(dim=1)
        prop = torch.where(active, choice, torch.full_like(choice, N))
        if state["rounds"] == 0:
            c["feas0"] = feas
        return round_tail(sb, prop, active, best, unassigned, windowed)

    def pallas_round(sb, windowed: bool):
        unassigned = unassigned_of(sb)
        prop, active, best = PK.propose(sb["bundle"], sb["rows"],
                                        unassigned, c["req"], c["nz"],
                                        c["ports_used"])
        return round_tail(sb, prop, active, best, unassigned, windowed)

    def round_tail(sb, prop, active, best, unassigned, windowed: bool):
        """Admission + commit; returns the device flags the loop reads:
        (admitted any, progress, any pod left in the window pool)."""
        rows = sb["rows"]
        rsafe = rows.clamp(0, B - 1)
        sbatch = sb["batch"]
        admit = admission_mask(prop, active, sbatch.req, sbatch.ports_hot,
                               sbatch.ports_asnode_hot, cluster.allocatable,
                               c["req"], use_ports, N)
        add_req, add_nz, add_ports = admission_sums(
            admit, prop, sbatch.req, sbatch.nonzero_req,
            sbatch.ports_asnode_hot, use_ports, N)
        c["req"] = c["req"] + add_req
        c["nz"] = c["nz"] + add_nz
        if use_ports:
            c["ports_used"] = torch.maximum(c["ports_used"], add_ports)
        real = rows < B
        rr = rows[real]
        c["assigned"] = c["assigned"].clone()
        c["assigned"][rr] = torch.where(admit, prop,
                                        c["assigned"][rsafe])[real]
        c["win_score"] = c["win_score"].clone()
        c["win_score"][rr] = torch.where(admit, best,
                                         c["win_score"][rsafe])[real]
        admitted_any = admit.any()
        state["rounds"] += 1
        if windowed:
            # a pod with no feasible node in a no-admission round leaves
            # the window pool; any admission re-opens everyone
            new_retire = (~active) & unassigned & ~c["retired"][rsafe]
            retired = c["retired"].clone()
            retired[rr] = retired[rr] | new_retire[real]
            c["retired"] = torch.where(admitted_any,
                                       torch.zeros_like(retired), retired)
            progress = admitted_any | new_retire.any()
        else:
            progress = admitted_any
        pool = (c["assigned"] < 0) & batch.valid & ~c["retired"]
        return torch.stack([admitted_any, progress, pool.any()])

    def read_flags(flags):
        admitted_any, progress, pool_any = flags.tolist()
        state["syncs"] += 1
        state["admits"] += int(admitted_any)
        return progress, pool_any

    fsb = full_sub()
    use_window = bool(residual_window) and residual_window < B
    progress, pool_any = read_flags(round_step(fsb, windowed=use_window))
    if not use_window:
        while progress and state["rounds"] < max_rounds:
            flags = (pallas_round(fsb, False) if use_pallas
                     else round_step(fsb, False))
            progress, pool_any = read_flags(flags)
    else:
        idx = torch.arange(B, dtype=torch.int64, device=dev)
        while (progress and pool_any
               and state["admits"] < max_rounds):
            # the first residual_window pool rows in ascending order,
            # padded with the sentinel B (jnp.nonzero(size=, fill=))
            pool = (c["assigned"] < 0) & batch.valid & ~c["retired"]
            order = torch.argsort((~pool).to(torch.int8), stable=True)
            first = order[:residual_window]
            rows = torch.where(pool[first], idx[first],
                               torch.full_like(first, B))
            sb = gather_sub(rows)
            flags = (pallas_round(sb, True) if use_pallas
                     else round_step(sb, True))
            progress, pool_any = read_flags(flags)

    unresolvable = static_unres
    base_nodes = cluster.node_valid[None, :] & batch.valid[:, None]
    all_unres = (unresolvable | c["feas0"] | ~base_nodes).all(dim=1)
    n_feas = c["feas0"].sum(dim=1, dtype=torch.int32)
    rounds = torch.tensor(state["rounds"], dtype=torch.int32, device=dev)
    packed = torch.cat([c["assigned"], n_feas, all_unres.to(torch.int32),
                        rounds.reshape(1)])
    return GangResult(chosen=c["assigned"], score=c["win_score"],
                      rounds=rounds, requested=c["req"], nz=c["nz"],
                      ports_used=c["ports_used"], feasible0=c["feas0"],
                      unresolvable=unresolvable, n_feasible=n_feas,
                      all_unresolvable=all_unres, packed=packed,
                      syncs=state["syncs"])
