"""Conflict-free batched (gang) assignment: the propose-and-admit auction.

The counterpart of kubetpu/models/gang.py.  Each round:

1. every unassigned pod *proposes* to its best feasible node, breaking
   exact score ties by the selectHost gumbel row drawn from
   ``fold_in(rng, pod_row)`` (generic_scheduler.go:217);
2. pods proposing the same node are *admitted* in pod order (the batch is
   popped in priority order) up to the node's remaining multi-resource
   capacity and hostPort set — a stable sort by proposed node plus a
   segmented prefix sum over request channels;
3. admitted placements commit, and the next round recomputes feasibility
   and scores against the updated usage.

Intra-batch topology (``intra_batch_topology=True``, for batches whose
pods carry (anti-)affinity, spread constraints or a controller spread
selector): the batch's pods are appended to the existing-pod axis once,
and each round places the admitted ones there, so PodTopologySpread and
InterPodAffinity filters and scores see earlier rounds' placements as the
reference's serial loop sees bound pods; admitted pods' required
anti-affinity terms repel later pods like existing pods' terms.  Within a
round a selector-precise same-pair deferral keeps admission order safe:
a pod defers to the next round when an earlier pod admitted this round
into the pair of one of its term keys interacts with it (rule A: matches
one of its terms; rule B: it matches an earlier pod's anti term), and a
pod admitted only by the self-match bootstrap defers behind any earlier
admission.  Deferral never blocks the first admitted pod.

Invariants (as in the reference): zero capacity violations; every round
admits >= 1 pod or proves the remaining pods unschedulable, so the loop
terminates.

The JAX package runs the rounds in a ``lax.while_loop`` on the device.
Here the loop is Python: each round ends with ONE device->host read of a
few progress flags (``GangResult.syncs`` counts them), and nothing else
in a round reads the device — no ``.item()``, boolean-mask indexing or
branch on a tensor; the carry updates are index scatters whose sentinel
rows write a spare row that is dropped.  ``kernel_backend`` "lax" runs
``round_step`` every round; "pallas" runs round 0 on ``round_step`` (its
[B, N] feasibility is a diagnostic output) and every later round's
propose half through ``ops.propose`` — the CUDA kernel on the card, its
plain version on the CPU — for the batches utils/pallas_backend routes
there (term-free ones); others run "lax".  A ``propose_step`` (the mesh's
tiled round, parallel/shardmap.py) takes the place of ``ops.propose`` in
every round, round 0 included, with the same admission, windows and
epilogue.

Exactness: admission's prefix sums, the deferral's prefix sums and the
commit's segment sums are f32 sums of integer values.  They are exact in
any order (a CUDA scan, ``index_add_`` atomics) only while the batch's
total request per channel stays below 2**24; schedule_gang checks that
bound and raises rather than trust a summation order.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..ops import kernels as K
from ..ops import propose as PK
from ..ops.selectors import (concat_selector_sets, match_selectors_unique,
                             pad_selector_slots)
from ..state.tensors import ExistingTerms
from ..utils import pallas_backend as PB
from ..utils import prng
from .batch import densify_for
from .programs import ProgramConfig, run_filters, run_scores, static_raw_scores

_f = K._f
NEG = PK.NEG
EXACT_SUM_LIMIT = float(2 ** 24)
# the per-pod companion arrays of a term or constraint set that a window
# gathers; the selector sets stay whole (the rounds read precomputed
# match matrices)
TERM_ROW_FIELDS = ("ns_hot", "topo_key", "topo_known", "weight", "valid",
                   "self_match", "max_skew")


class GangResult(NamedTuple):
    chosen: torch.Tensor     # [B] i32 node row, -1 unschedulable this pass
    score: torch.Tensor      # [B] f32 score of the winning node at admission
    rounds: torch.Tensor     # i32 number of propose/admit rounds executed
    requested: torch.Tensor  # [N, R] final requested incl. batch placements
    nz: torch.Tensor         # [N, 2] final non-zero requested
    ports_used: torch.Tensor  # [N, P] f32 ports registered by batch placements
    feasible0: torch.Tensor  # [B, N] bool first-round feasibility
    unresolvable: torch.Tensor  # [B, N] bool static unresolvable filters,
                             # plus InterPodAffinity's required-affinity
                             # bits captured at round 0 under intra-batch
                             # topology
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


def _unsort(x_sorted: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows of x_sorted back to their places: out[order] = x_sorted
    (order is a permutation, so every row is written once)."""
    return torch.empty_like(x_sorted).index_copy_(0, order, x_sorted)


def _set_rows(x: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor):
    """x with rows ``slot`` set to vals, where slot == len(x) marks a
    sentinel (the reference's mode="drop"): sentinels write a spare row
    that is dropped, so no row mask is read back to the host."""
    buf = torch.cat([x, x[:1]])
    return buf.index_copy_(0, slot, vals)[:x.shape[0]]


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
    return _unsort(admit_sorted, order)


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


def _read_flags(flags: torch.Tensor) -> list:
    """A round's one device->host read: its [3] progress flags."""
    return flags.tolist()


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


def _extend_cluster(cluster, batch):
    """Append the batch's pods to the existing-pod axis (pod_node and
    pod_valid are patched per round from the carry) and splice their
    required anti-affinity terms into filter_terms with owner rows P + j,
    so admitted batch pods repel later pods exactly like bound existing
    pods (interpodaffinity/filtering.go:166)."""
    B = batch.req.shape[0]
    P = cluster.pod_valid.shape[0]
    raa = batch.raa
    Ta = raa.valid.shape[1]
    TK = cluster.topo_pair.shape[1]
    ft = cluster.filter_terms
    dev = batch.req.device
    topo_key = raa.topo_key.reshape(-1)
    # a term whose topology key exists nowhere in the cluster never
    # produces a pair, so it never fails anything: drop it
    valid = (raa.valid & raa.topo_known & (raa.topo_key < TK)).reshape(-1)
    owners = P + torch.arange(B, dtype=torch.int32,
                              device=dev).repeat_interleave(Ta)
    ext_terms = ExistingTerms(
        sel=concat_selector_sets(ft.sel, raa.sel),
        ns_hot=torch.cat([ft.ns_hot, raa.ns_hot.reshape(B * Ta, -1)]),
        topo_key=torch.cat([ft.topo_key, topo_key]),
        pod_idx=torch.cat([ft.pod_idx, owners]),
        weight=torch.cat([ft.weight, torch.ones((B * Ta,),
                                                dtype=torch.float32,
                                                device=dev)]),
        valid=torch.cat([ft.valid, valid]))
    return cluster._replace(
        pod_kv=torch.cat([cluster.pod_kv, batch.kv_hot]),
        pod_key=torch.cat([cluster.pod_key, batch.key_hot]),
        pod_ns_hot=torch.cat([cluster.pod_ns_hot, batch.ns_hot]),
        pod_node=torch.cat([cluster.pod_node,
                            torch.full((B,), -1, dtype=cluster.pod_node.dtype,
                                       device=dev)]),
        pod_valid=torch.cat([cluster.pod_valid,
                             torch.zeros((B,), dtype=torch.bool, device=dev)]),
        pod_terminating=torch.cat([cluster.pod_terminating,
                                   torch.zeros((B,), dtype=torch.bool,
                                               device=dev)]),
        filter_terms=ext_terms)


def _key_terms_mask(terms, k: int) -> torch.Tensor:
    """[B, T] bool — valid required terms on topology key k."""
    return (terms.topo_key == k) & terms.valid & terms.topo_known


def _gather_terms(t, rsafe):
    """The rows ``rsafe`` of a term or constraint set's [B, ...] arrays
    (TERM_ROW_FIELDS); its selector set stays whole."""
    return t._replace(**{f: getattr(t, f)[rsafe]
                         for f in TERM_ROW_FIELDS if f in t._fields})


def _rules_for(terms, mu, uidx, k, pair_ok, order, is_start, admit_cap,
               anti: bool):
    """Selector-precise same-pair deferral for one term set x one key.
    rule A: pod j defers iff an earlier-admitted pod in its landing pair
    matches one of j's key-k term selectors.  rule B (anti only): pod j
    defers iff it matches a key-k anti term of an earlier-admitted pod in
    the same pair.  mu: [U, W] unique-selector match of the window's
    pods; uidx: [W, T] each term's unique selector."""
    key_terms = _key_terms_mask(terms, k)                        # [W, T]
    adm = _f(admit_cap & pair_ok)[:, None]
    mu_t = mu.T                                                  # [W, U]
    e_a = _f(mu_t) * adm           # admitted pods as selector members
    pref_a = _unsort(_seg_prefix(e_a[order], is_start), order)
    hits = pref_a.gather(1, uidx.long()) > 0                     # [W, T]
    defer = (hits & key_terms).any(dim=1) & pair_ok
    if anti:
        # admitted pods registering their key-k selectors; uidx repeats
        # within a row when two terms share a selector, so a scatter-max
        reg = torch.zeros_like(e_a).scatter_reduce_(
            1, uidx.long(), _f(key_terms), "amax", include_self=True)
        e_b = reg * adm
        pref_b = _unsort(_seg_prefix(e_b[order], is_start), order)
        defer = defer | (((pref_b > 0) & mu_t).any(dim=1) & pair_ok)
    return defer


def materialize_assigned(cluster, batch, chosen, requested, nz, ports_used,
                         pad_pods_to: int = 0, pad_terms_to: int = 0,
                         extend_score_terms: bool = False,
                         hard_pod_affinity_weight: float = 1.0):
    """Fold an auction's placements into the cluster (kubetpu.models.gang.
    materialize_assigned): the assigned batch pods join the existing-pod
    axis at their nodes, with their required anti-affinity terms in
    filter_terms; their committed usage replaces requested/nonzero; their
    registered hostPorts join cluster.ports.  Cycle chaining serves the
    result as the next cycle's cluster.  extend_score_terms adds their
    preferred terms (signed weights) and required-affinity terms
    (hard_pod_affinity_weight) to score_terms, as a fresh build would;
    pad_pods_to / pad_terms_to pad the grown pod axis and filter-term
    axis to the given (pow2) sizes with build-default rows."""
    batch = densify_for(cluster, batch)
    ext = _extend_cluster(cluster, batch)
    assigned = (chosen >= 0) & batch.valid
    ext = ext._replace(
        pod_node=torch.cat([cluster.pod_node, chosen.to(torch.int32)]),
        pod_valid=torch.cat([cluster.pod_valid, assigned]),
        requested=requested,
        nonzero_requested=nz,
        ports=cluster.ports | (ports_used > 0.5))
    dev = cluster.pod_valid.device
    if extend_score_terms:
        P0 = cluster.pod_valid.shape[0]
        TK = cluster.topo_pair.shape[1]
        st = cluster.score_terms

        def term_rows(t, w):
            bb, tt = t.valid.shape
            return (t.sel, t.ns_hot.reshape(bb * tt, -1),
                    t.topo_key.reshape(-1),
                    P0 + torch.arange(bb, dtype=torch.int32,
                                      device=dev).repeat_interleave(tt),
                    w.reshape(-1),
                    (t.valid & t.topo_known & (t.topo_key < TK)).reshape(-1))

        pr = term_rows(batch.pref, batch.pref.weight * _f(batch.pref.valid))
        ra = term_rows(batch.ra,
                       torch.full_like(batch.ra.weight,
                                       hard_pod_affinity_weight)
                       * _f(batch.ra.valid))
        ext = ext._replace(score_terms=ExistingTerms(
            sel=concat_selector_sets(concat_selector_sets(st.sel, pr[0]),
                                     ra[0]),
            ns_hot=torch.cat([st.ns_hot, pr[1], ra[1]]),
            topo_key=torch.cat([st.topo_key, pr[2], ra[2]]),
            pod_idx=torch.cat([st.pod_idx, pr[3], ra[3]]),
            weight=torch.cat([st.weight, pr[4], ra[4]]),
            valid=torch.cat([st.valid, pr[5], ra[5]])))

    def pad(x, n, fill=0):
        return torch.cat([x, torch.full((n,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    P = ext.pod_valid.shape[0]
    if pad_pods_to > P:
        n = pad_pods_to - P
        ext = ext._replace(
            pod_kv=pad(ext.pod_kv, n), pod_key=pad(ext.pod_key, n),
            pod_ns_hot=pad(ext.pod_ns_hot, n),
            pod_node=pad(ext.pod_node, n, -1),
            pod_valid=pad(ext.pod_valid, n),
            pod_terminating=pad(ext.pod_terminating, n))
    ft = ext.filter_terms
    E = ft.valid.shape[0]
    if pad_terms_to > E:
        n = pad_terms_to - E
        ext = ext._replace(filter_terms=ft._replace(
            sel=pad_selector_slots(ft.sel, pad_terms_to),
            ns_hot=pad(ft.ns_hot, n), topo_key=pad(ft.topo_key, n),
            pod_idx=pad(ft.pod_idx, n), weight=pad(ft.weight, n),
            valid=pad(ft.valid, n)))
    return ext


def run_auction(cluster, batch, cfg: ProgramConfig, rng,
                host_ok: Optional[torch.Tensor] = None,
                intra_batch_topology: bool = True,
                score_bias: Optional[torch.Tensor] = None,
                kernel_backend: Optional[str] = None,
                gumbel: Optional[torch.Tensor] = None) -> GangResult:
    """The serving-loop gang entry (kubetpu.models.gang.run_auction)."""
    return schedule_gang(cluster, batch, cfg, rng, host_ok=host_ok,
                         intra_batch_topology=intra_batch_topology,
                         score_bias=score_bias,
                         kernel_backend=kernel_backend, gumbel=gumbel)


def schedule_gang(cluster, batch, cfg: ProgramConfig, rng,
                  host_ok: Optional[torch.Tensor] = None,
                  intra_batch_topology: bool = True,
                  residual_window: int = 512,
                  score_bias: Optional[torch.Tensor] = None,
                  kernel_backend: Optional[str] = None,
                  gumbel: Optional[torch.Tensor] = None) -> GangResult:
    """One gang auction over ``batch``.  rng: an int64 [2] key
    (utils/prng.PRNGKey).  host_ok [B, N] bool: host filter verdicts
    (folded into every round's feasibility, and into the round-0
    unresolvable capture, but not into all_unresolvable's node set).
    score_bias [B, N] f32: weighted host score totals added to every
    round's scores.  gumbel: optional [B, N] selectHost plane; by default
    it is drawn from fold_in(rng, pod_row), and the tests hand in the JAX
    package's plane so both sides share one tie-break draw.  The round
    budget is the batch size, as max_rounds=None there.

    kernel_backend "pallas" is routed by content first
    (utils/pallas_backend.unsupported_reason): a batch that needs
    intra-batch topology, a score the kernel lacks or a soft spread
    constraint runs the lax round."""
    backend = kernel_backend or "lax"
    if backend not in ("lax", "pallas"):
        raise ValueError("kernel_backend must be 'lax' or 'pallas'")
    if backend == "pallas":
        backend = PB.effective_backend(cfg, intra_batch_topology, backend,
                                       batch)
    return _gang_program(cluster, batch, cfg, rng, host_ok=host_ok,
                         intra_batch_topology=intra_batch_topology,
                         residual_window=residual_window,
                         score_bias=score_bias, kernel_backend=backend,
                         gumbel=gumbel)


def _gang_program(cluster, batch, cfg: ProgramConfig, rng,
                  host_ok: Optional[torch.Tensor] = None,
                  intra_batch_topology: bool = True,
                  residual_window: int = 512,
                  score_bias: Optional[torch.Tensor] = None,
                  kernel_backend: str = "lax",
                  gumbel: Optional[torch.Tensor] = None,
                  propose_step: Optional[Callable] = None) -> GangResult:
    """The auction body, after routing.  It reads the device once before
    the rounds (_check_exact_sums) and once per round (_read_flags);
    nothing else in it waits for the card.  (schedule_gang's routing of a
    pallas request with intra-batch topology off reads the batch's soft
    constraint flags once more when the batch is on the card.)

    propose_step: a factory that takes the round-invariant bundle
    (ops/propose.build_bundle) and returns a step ``(rows, live, req, nz,
    ports_used, first) -> (prop, act, best, feas)`` with ops.propose's
    meaning, feas being the rows' [W, N] feasibility when ``first`` and
    None otherwise.  Every round, round 0 included, then proposes through
    it; it needs intra_batch_topology=False."""
    batch = densify_for(cluster, batch)
    dev = batch.req.device
    B = batch.req.shape[0]
    N = cluster.allocatable.shape[0]
    max_rounds = B
    filters = set(cfg.filters)
    use_fit = "NodeResourcesFit" in filters
    use_ports = "NodePorts" in filters
    # the topology filters move into the rounds (evaluated against the
    # committed placements) under intra-batch topology
    use_sph = "PodTopologySpread" in filters and intra_batch_topology
    use_ipa = "InterPodAffinity" in filters and intra_batch_topology
    intra = use_sph or use_ipa
    use_pallas = kernel_backend == "pallas"
    # every later round (pallas) or every round (a propose_step) proposes
    # from the bundle
    use_bundle = use_pallas or propose_step is not None
    if use_bundle and intra:
        raise ValueError(
            "kernel_backend='pallas' and a propose_step require "
            "intra_batch_topology=False (schedule_gang routes this; see "
            "utils/pallas_backend.unsupported_reason)")
    _check_exact_sums(cluster, batch)

    skip = ["NodeResourcesFit", "NodePorts"]
    if use_sph:
        skip.append("PodTopologySpread")
    if use_ipa:
        skip.append("InterPodAffinity")
    # static filters once; InterPodAffinity's unresolvable part joins the
    # unresolvable mask at round 0 when the rounds evaluate it
    static_ok, static_unres, affinity_ok = run_filters(
        cluster, batch, cfg, host_ok, skip=tuple(skip))
    base = cluster.node_valid[None, :] & batch.valid[:, None]
    if host_ok is not None:
        base = base & host_ok
    ports_ok0 = (K.node_ports_filter(cluster, batch) if use_ports
                 else torch.ones((B, N), dtype=torch.bool, device=dev))

    ext = _extend_cluster(cluster, batch) if intra else cluster
    score_names = set(n for n, _ in cfg.scores)
    # assignment-independent raws and match matrices, once per auction
    score_pre = dict(static_raw_scores(ext, batch, cfg))
    if "InterPodAffinity" in score_names:
        score_pre["interpod_score"] = K.interpod_score_pre(ext, batch)
    if "PodTopologySpread" in score_names:
        score_pre["spread_soft"] = K.spread_match_ns(ext, batch,
                                                     batch.spread_soft)
        score_pre["spread_log"] = K.spread_log_table(N, dev)
    if "DefaultPodTopologySpread" in score_names:
        score_pre["default_spread"] = K.default_spread_match_ns(ext, batch)
    term_pre: Dict[str, object] = {}
    if use_sph:
        term_pre["sph_match"] = K.spread_match_ns(ext, batch, batch.spread)
        term_pre["mu_sph"] = match_selectors_unique(
            batch.spread.sel, batch.kv_hot, batch.key_hot)       # [Us, B]
        term_pre["sph_uidx"] = batch.spread.sel.index.reshape(
            B, batch.spread.valid.shape[1])
    if use_ipa:
        term_pre["ipa_pre"] = K.interpod_filter_pre(ext, batch)
        ra = batch.ra
        has_ra = ra.valid.any(dim=1)
        term_pre["ra_boot"] = (ra.self_match | ~ra.valid).all(dim=1) & has_ra
        term_pre["mu_raa"] = match_selectors_unique(
            batch.raa.sel, batch.kv_hot, batch.key_hot)          # [Ur, B]
        term_pre["raa_uidx"] = batch.raa.sel.index.reshape(
            B, batch.raa.valid.shape[1])

    if gumbel is None:
        gumbel = prng.select_plane(rng.to(dev), B, N)
    gumbel = gumbel.to(device=dev, dtype=torch.float32)
    bundle = (PK.build_bundle(cluster, batch, cfg, static_ok, ports_ok0,
                              score_pre, score_bias, gumbel)
              if use_bundle else None)
    step = propose_step(bundle) if propose_step is not None else None

    P = batch.ports_hot.shape[1]
    c: Dict[str, torch.Tensor] = dict(
        req=cluster.requested.clone(),
        nz=cluster.nonzero_requested.clone(),
        ports_used=torch.zeros((N, P), dtype=torch.float32, device=dev),
        assigned=torch.full((B,), -1, dtype=torch.int32, device=dev),
        win_score=torch.zeros((B,), dtype=torch.float32, device=dev),
        feas0=torch.zeros((B, N), dtype=torch.bool, device=dev),
        unres=static_unres,
        retired=torch.zeros((B,), dtype=torch.bool, device=dev),
        rounds=torch.zeros((), dtype=torch.int32, device=dev),
    )
    # the host's copies of the loop's counters (the device one above
    # becomes GangResult.rounds without a host->device copy)
    state = dict(rounds=0, admits=0, syncs=0)

    def full_sub():
        return dict(rows=torch.arange(B, dtype=torch.int64, device=dev),
                    valid=batch.valid, batch=batch, static_ok=static_ok,
                    ports_ok0=ports_ok0, affinity_ok=affinity_ok,
                    gumbel=gumbel, score_pre=score_pre,
                    score_bias=score_bias, bundle=bundle, **term_pre)

    def gather_sub(rows):
        """The window's sub-round inputs.  Both backends gather the small
        [W, .] batch fields round_tail reads; only the lax round gathers
        what round_step reads besides (the [W, N] static masks, gumbel
        and bias rows, score and term precompute, term rows).  The
        unique-selector matrices stay whole-batch and are column-gathered.
        The kernel reads its rows of the whole-batch bundle by index."""
        rsafe = rows.clamp(0, B - 1)
        wvalid = rows < B

        def g(x):
            return x[rsafe]

        tail_fields = dict(req=g(batch.req),
                           nonzero_req=g(batch.nonzero_req),
                           ports_hot=g(batch.ports_hot),
                           ports_asnode_hot=g(batch.ports_asnode_hot),
                           valid=g(batch.valid) & wvalid)
        if use_bundle:
            return dict(rows=rows, valid=tail_fields["valid"],
                        batch=batch._replace(**tail_fields), bundle=bundle)

        def g_pre(v):
            if isinstance(v, K.InterpodPre):
                return K.InterpodPre(m_ra=g(v.m_ra), m_raa=g(v.m_raa),
                                     em=v.em[:, rsafe])
            if isinstance(v, K.InterpodScorePre):
                return K.InterpodScorePre(m_pref=g(v.m_pref),
                                          em=v.em[:, rsafe])
            return g(v)

        sub_batch = batch._replace(
            spread_skip=g(batch.spread_skip),
            ra=_gather_terms(batch.ra, rsafe),
            raa=_gather_terms(batch.raa, rsafe),
            pref=_gather_terms(batch.pref, rsafe),
            spread=_gather_terms(batch.spread, rsafe),
            spread_soft=_gather_terms(batch.spread_soft, rsafe),
            **tail_fields)
        sb = dict(rows=rows, valid=sub_batch.valid, batch=sub_batch,
                  static_ok=g(static_ok), ports_ok0=g(ports_ok0),
                  affinity_ok=g(affinity_ok), gumbel=g(gumbel),
                  score_pre={k: v if k == "spread_log" else g_pre(v)
                             for k, v in score_pre.items()},
                  score_bias=None if score_bias is None else g(score_bias))
        for k, v in term_pre.items():
            sb[k] = v[:, rsafe] if k.startswith("mu_") else g_pre(v)
        return sb

    def unassigned_of(sb):
        rsafe = sb["rows"].clamp(0, B - 1)
        return (c["assigned"][rsafe] < 0) & sb["valid"]

    def cluster_at():
        """The cluster as this round sees it: committed usage, and under
        intra the batch's admitted pods (the FULL carry, whatever the
        window) on the existing-pod axis at their nodes."""
        cl = ext._replace(requested=c["req"], nonzero_requested=c["nz"])
        if intra:
            cl = cl._replace(
                pod_node=torch.cat([cluster.pod_node, c["assigned"]]),
                pod_valid=torch.cat([cluster.pod_valid,
                                     (c["assigned"] >= 0) & batch.valid]))
        return cl

    def feasibility(cl, sb):
        feas = sb["static_ok"]
        sbatch = sb["batch"]
        aff_unres = boot_live = None
        if use_sph:
            feas = feas & K.spread_filter(cl, sbatch, sb["affinity_ok"],
                                          match_ns=sb["sph_match"],
                                          active_keys=cfg.active_keys)
        if use_ipa:
            ok, aff_unres, boot_live = K.interpod_filter(
                cl, sbatch, pre=sb["ipa_pre"], return_no_matches=True,
                active_keys=cfg.active_keys)
            feas = feas & ok
        if use_fit:
            feas = feas & K.fit_filter(cl, sbatch)
        if use_ports:
            batch_conf = (sbatch.ports_hot @ c["ports_used"].T) > 0.5
            feas = feas & sb["ports_ok0"] & ~batch_conf
        return feas, aff_unres, boot_live

    def topology_deferral(sb, admit_cap, prop, boot_live):
        """Selector-precise intra-round serialization (module docstring):
        one stable sort by landing pair per topology key of the batch's
        terms; the per-pair exclusive prefix sums run in unique-selector
        space."""
        W = prop.shape[0]
        prop_safe = prop.long().clamp(0, N - 1)
        is_prop = prop < N
        defer = torch.zeros((W,), dtype=torch.bool, device=dev)
        tp = cluster.topo_pair
        TK = tp.shape[1]
        keys = (range(TK) if not cfg.active_topo_keys else
                [k for k in cfg.active_topo_keys if 0 <= k < TK])
        for k in keys:
            landing = tp[prop_safe, k]
            pair_k = torch.where(is_prop, landing,
                                 torch.full_like(landing, -1))
            pair_ok = pair_k >= 0
            skey = torch.where(pair_ok, pair_k,
                               torch.full_like(pair_k, 2 ** 30))
            # stable: within a pair, earlier rows come first
            order = torch.argsort(skey, stable=True)
            spair = skey[order]
            is_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                             device=dev),
                                  spair[1:] != spair[:-1]])
            if use_ipa:
                defer = defer | _rules_for(sb["batch"].raa, sb["mu_raa"],
                                           sb["raa_uidx"], k, pair_ok,
                                           order, is_start, admit_cap,
                                           anti=True)
            if use_sph:
                defer = defer | _rules_for(sb["batch"].spread, sb["mu_sph"],
                                           sb["sph_uidx"], k, pair_ok,
                                           order, is_start, admit_cap,
                                           anti=False)
        if use_ipa:
            # bootstrap rule: a pod admitted only through the self-match
            # bootstrap (filtering.go:356) defers behind any earlier
            # admission this round, which could create the first match
            a = _f(admit_cap)
            earlier_any = torch.cumsum(a, dim=0) - a
            live = (sb["ra_boot"] if boot_live is None
                    else sb["ra_boot"] & boot_live)
            defer = defer | (live & (earlier_any > 0))
        return defer

    def round_step(sb, windowed: bool):
        sbatch = sb["batch"]
        unassigned = unassigned_of(sb)
        cl = cluster_at()
        feas, aff_unres, boot_live = feasibility(cl, sb)
        feas = feas & unassigned[:, None]
        # scores against committed usage and placements
        scores, _ = run_scores(cl, sbatch, cfg, feas, sb["affinity_ok"],
                               pre=sb["score_pre"])
        if sb["score_bias"] is not None:
            scores = scores + sb["score_bias"]
        best, _, choice = K.gumbel_tiebreak_argmax(scores, feas,
                                                   sb["gumbel"], 0, NEG)
        active = feas.any(dim=1)
        prop = torch.where(active, choice, torch.full_like(choice, N))
        if state["rounds"] == 0:
            c["feas0"] = feas
            if aff_unres is not None:
                c["unres"] = c["unres"] | (aff_unres & base)
        return round_tail(sb, prop, active, best, unassigned, windowed,
                          boot_live)

    def bundle_round(sb, windowed: bool, first: bool = False):
        unassigned = unassigned_of(sb)
        if step is None:
            prop, active, best = PK.propose(sb["bundle"], sb["rows"],
                                            unassigned, c["req"], c["nz"],
                                            c["ports_used"])
        else:
            prop, active, best, feas = step(sb["rows"], unassigned,
                                            c["req"], c["nz"],
                                            c["ports_used"], first)
            if first:
                c["feas0"] = feas
        return round_tail(sb, prop, active, best, unassigned, windowed)

    def round_tail(sb, prop, active, best, unassigned, windowed: bool,
                   boot_live=None):
        """Admission + commit; returns the device flags the loop reads:
        (admitted any, progress, any pod left in the window pool)."""
        rows = sb["rows"]
        rsafe = rows.clamp(0, B - 1)
        slot = rows.clamp(max=B)       # sentinel rows write the spare row
        sbatch = sb["batch"]
        admit = admission_mask(prop, active, sbatch.req, sbatch.ports_hot,
                               sbatch.ports_asnode_hot, cluster.allocatable,
                               c["req"], use_ports, N)
        if intra:
            # deferred pods re-check against exact counts next round
            admit = admit & ~topology_deferral(sb, admit, prop, boot_live)
        add_req, add_nz, add_ports = admission_sums(
            admit, prop, sbatch.req, sbatch.nonzero_req,
            sbatch.ports_asnode_hot, use_ports, N)
        c["req"] = c["req"] + add_req
        c["nz"] = c["nz"] + add_nz
        if use_ports:
            c["ports_used"] = torch.maximum(c["ports_used"], add_ports)
        c["assigned"] = _set_rows(
            c["assigned"], slot,
            torch.where(admit, prop, c["assigned"][rsafe]))
        c["win_score"] = _set_rows(
            c["win_score"], slot,
            torch.where(admit, best, c["win_score"][rsafe]))
        admitted_any = admit.any()
        state["rounds"] += 1
        c["rounds"] = c["rounds"] + 1
        if windowed:
            # a pod with no feasible node in a no-admission round leaves
            # the window pool; any admission re-opens everyone.  The
            # update is a max of old and new bits at the window's
            # (distinct) rows
            new_retire = (~active) & unassigned & ~c["retired"][rsafe]
            retired = _set_rows(c["retired"], slot,
                                c["retired"][rsafe] | new_retire)
            c["retired"] = torch.where(admitted_any,
                                       torch.zeros_like(retired), retired)
            progress = admitted_any | new_retire.any()
        else:
            progress = admitted_any
        pool = (c["assigned"] < 0) & batch.valid & ~c["retired"]
        return torch.stack([admitted_any, progress, pool.any()])

    def read_flags(flags):
        admitted_any, progress, pool_any = _read_flags(flags)
        state["syncs"] += 1
        state["admits"] += int(admitted_any)
        return progress, pool_any

    fsb = full_sub()
    use_window = bool(residual_window) and residual_window < B
    progress, pool_any = read_flags(
        bundle_round(fsb, use_window, first=True) if step is not None
        else round_step(fsb, windowed=use_window))
    if not use_window:
        while progress and state["rounds"] < max_rounds:
            flags = (bundle_round(fsb, False) if use_bundle
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
            flags = (bundle_round(sb, True) if use_bundle
                     else round_step(sb, True))
            progress, pool_any = read_flags(flags)

    unresolvable = c["unres"]
    # host-filter failures stay resolvable for the preemption gate:
    # host_ok is not part of this node-exclusion mask
    base_nodes = cluster.node_valid[None, :] & batch.valid[:, None]
    all_unres = (unresolvable | c["feas0"] | ~base_nodes).all(dim=1)
    n_feas = c["feas0"].sum(dim=1, dtype=torch.int32)
    rounds = c["rounds"]
    packed = torch.cat([c["assigned"], n_feas, all_unres.to(torch.int32),
                        rounds.reshape(1)])
    return GangResult(chosen=c["assigned"], score=c["win_score"],
                      rounds=rounds, requested=c["req"], nz=c["nz"],
                      ports_used=c["ports_used"], feasible0=c["feas0"],
                      unresolvable=unresolvable, n_feasible=n_feas,
                      all_unresolvable=all_unres, packed=packed,
                      syncs=state["syncs"])
