"""Preemption: wave-batched what-if victim selection.

The counterpart of kubetpu/preemption.py.  reference:
pkg/scheduler/core/generic_scheduler.go — Preempt :252,
podEligibleToPreemptOthers :1063, nodesWherePreemptionMightHelp :1041,
selectNodesForPreemption :858, selectVictimsOnNode :949 (clone + remove
lower-priority pods + re-run filters + reprieve by PDB then priority),
pickOneNodeForPreemption :729 (6-criteria lexicographic tie-break);
invoked from scheduler.go:391 preempt.

Both loops of the reference's what-if are batched:

  * every preemption-eligible FitError of a scheduling cycle is served by
    ONE [B, C, K] what-if program (models/programs.whatif_wave) per
    contention round, built from vectorized numpy victim tables
    (CycleContext.victim_index).  Cross-pod contention — two preemptors
    claiming one node — resolves on the host in ranked commit order: the
    higher pick_one_node_for_preemption rank wins the node, losers fall
    back to their next-ranked candidate, and pods left without a fresh
    candidate are re-waved against the updated overlay for a small fixed
    number of rounds.  Winners' victim deletions and nominations land on
    the shared CycleContext commit overlay (note_evict / the queue
    nominator), so later rounds see earlier evictions without
    re-tensorizing, and no victim is ever deleted twice;

  * pods whose what-if can move a topology verdict (own spread
    constraints or affinity terms, or any existing-pod filter term in the
    cluster) keep the exact per-pod reprieve (_whatif_reprieve, pod_valid
    masking included), batched over candidates; term-free pods take the
    resource-only wave, whose non-fit verdicts are constant across victim
    removal (models/programs.whatif_static_ok).

The cycle's snapshot tensors are reused; nothing is re-tensorized per
failed pod.  Every device->host read is counted in CycleContext.stats
(the wave reads its [B, C, K+1] result once per round).

Each Preempt call counts its eligible pods in
``preemption_attempts_total`` and each committed preemption observes its
victims in ``preemption_victims``, with one ``Preempted`` Event per
evicted pod.  With an extender that supports preemption
(processPreemptionWithExtenders, generic_scheduler.go:317), every pod
takes the eager node -> Victims map (_FastWave.entries_dict), which the
extenders trim before the pick.  The profile's host
filters (the volume family among them) join the device verdicts of the
candidate nodes (_wave_candidates) and are checked on a chosen node with
its victims removed (_host_filters_pass): against the final
victim-adjusted NodeInfo, not inside every reprieve step — the JAX
package's documented deviation (its README, "Preemption"), kept as it is.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .api import types as api
from .framework.interface import CycleState
from .framework.types import NodeInfo, PodInfo, pod_with_affinity
from .models import programs
from .models.batch import (PodBatchBuilder, batch_to_device, build_nominated,
                           densify_for)
from .ops._build import note_compile_event
from .state.tensors import MIB, CH_PODS, SnapshotBuilder, resource_to_channels
from .utils.intern import pow2_bucket
from .utils.trace import flight_span


class Victims:
    __slots__ = ("pods", "num_pdb_violations")

    def __init__(self, pods: List[api.Pod], num_pdb_violations: int):
        self.pods = pods
        self.num_pdb_violations = num_pdb_violations


def _pod_channels(pi: PodInfo, table, R: int) -> np.ndarray:
    """A pod's resource request as cluster channels (CH_PODS = 1).  Unknown
    scalar resources resolve to channel -1 and are skipped — a victim may
    carry an extended resource no node ever registered."""
    vec = resource_to_channels(pi.resource, table, R, intern_new=False)
    vec[CH_PODS] = 1.0
    return vec


class _NodeVictims(NamedTuple):
    """One node's evictable-pod index, priority-descending (stable order —
    the reprieve order of :1004-1037 before PDB partitioning)."""
    prios: np.ndarray     # [V] i32, descending
    snap_pos: np.ndarray  # [V] i32 — position in ni.pods snapshot order (the
                          # PDB budget consumes in THIS order, :1118)
    rows: np.ndarray      # [V] i32 existing-pod tensor rows (-1 unknown)
    req: np.ndarray       # [V, R] f32 request channels (CH_PODS = 1)
    nz: np.ndarray        # [V, 2] f32 (non-zero cpu milli, mem MiB)
    ts: np.ndarray        # [V] f64 creation timestamps (host-only tie-break)
    pis: tuple            # PodInfo per victim, same order
    uids: tuple           # pod uid per victim, same order


class CycleContext:
    """Per-cycle tensors the scheduler shares with preemption (reference:
    Preempt runs against the same g.nodeInfoSnapshot as Schedule).  Also
    caches per-pod feasibility rows so N failed pods cost ONE candidates
    pass, not N.  ``stats`` counts the cycle's waves, wave rounds,
    evictions and device->host reads."""

    def __init__(self, builder: SnapshotBuilder, cluster, cfg,
                 node_infos: Sequence[NodeInfo], batch=None,
                 row_of: Optional[Dict[str, int]] = None, host_batch=None):
        self.builder = builder
        self.cluster = cluster
        self.cfg = cfg
        self.node_infos = node_infos
        self.batch = batch           # the cycle's device PodBatch
        self.host_batch = host_batch  # its host (numpy) twin: commits read
                                      # their request rows here, not from
                                      # the device
        self.row_of = row_of or {}   # pod uid -> batch row
        self.feasible = None         # [B, N] np.ndarray once read
        self.unresolvable = None
        # same-cycle committed placements, overlaid before any what-if: a
        # pod failing late in the batch must see the capacity already
        # claimed by earlier commits
        self.commit_req = None       # [N, R] np — committed request channels
        self.commit_nz = None        # [N, 2] np
        self.commit_ports = None     # [N, P] np bool — committed host ports
        self.commits = 0
        self._verdict_commits = 0
        self._cluster_cache = None   # (commits, overlaid cluster)
        self._lazy = None            # (feasible_dev, unresolvable_dev)
        self.pod_rows = None         # uid -> existing-pod tensor row
        self._pod_row_cache = None
        self._has_filter_terms = None
        self._min_prio = None
        self._min_prio_known = False
        self._victim_index = None    # node row -> _NodeVictims
        self._node_names = None
        # wave results by pod uid (nominated node name or None) — the
        # PostFilter per-pod path short-circuits on these
        self.wave_nominated: Dict[str, Optional[str]] = {}
        # victims evicted THIS cycle, shared by every wave/preempt call
        # against this context, so none is selected (and subtracted) twice
        self.evicted_uids: set = set()
        self.stats = dict(waves=0, rounds=0, evictions=0, reads=0)

    @property
    def device(self) -> torch.device:
        return self.cluster.requested.device

    def read(self, x: torch.Tensor) -> np.ndarray:
        """One counted device->host read."""
        self.stats["reads"] += 1
        return x.cpu().numpy()

    def has_filter_terms(self) -> bool:
        """Does the cluster carry ANY valid existing-pod required
        anti-affinity term?  (One tiny read, cached per cycle.)  When
        False, removing victims cannot change the InterPodAffinity verdict
        of a term-less preemptor."""
        if self._has_filter_terms is None:
            self._has_filter_terms = bool(
                self.read(self.cluster.filter_terms.valid.any()))
        return self._has_filter_terms

    def set_lazy_verdicts(self, feasible_dev, unresolvable_dev) -> None:
        """Share DEVICE verdict arrays without a transfer: they reach the
        host only if a preemption attempt reads them with no commits in
        between."""
        self._lazy = (feasible_dev, unresolvable_dev)

    def _ensure_overlay(self) -> None:
        if self.commit_req is None:
            shape = tuple(self.cluster.requested.shape)
            self.commit_req = np.zeros(shape, np.float32)
            self.commit_nz = np.zeros((shape[0], 2), np.float32)
            self.commit_ports = np.zeros(
                (shape[0], self.cluster.ports.shape[1]), bool)

    def note_commit(self, row: int, node_row: int) -> None:
        """Record a committed batch placement (batch row -> node row)."""
        if self.batch is None:
            return
        self._ensure_overlay()
        hb = self.host_batch
        self.commit_req[node_row] += hb.req[row]
        self.commit_nz[node_row] += hb.nonzero_req[row]
        self.commit_ports[node_row] |= hb.ports_asnode_hot[row] > 0.5
        self.commits += 1

    def note_evict(self, node_row: int, req_vec: np.ndarray,
                   nz_vec: np.ndarray) -> None:
        """Record a deleted victim so later wave rounds (and later
        preemption attempts this cycle) see the freed capacity.  Ports are
        NOT restored, as in the serial what-if (a victim's host ports stay
        blocked until the next snapshot)."""
        self._ensure_overlay()
        self.commit_req[node_row] -= req_vec
        self.commit_nz[node_row] -= nz_vec
        self.commits += 1
        self.stats["evictions"] += 1

    def cluster_now(self):
        """The cycle's cluster tensors with committed placements overlaid
        (resource/pod-count channels and host ports; committed pods'
        topology terms are not overlaid, matching the nominated-pods
        overlay's scope in the reference, generic_scheduler.go:541-545)."""
        if self.commits == 0:
            return self.cluster
        if (self._cluster_cache is not None
                and self._cluster_cache[0] == self.commits):
            return self._cluster_cache[1]
        dev = self.device
        cl = self.cluster._replace(
            requested=self.cluster.requested
            + torch.from_numpy(self.commit_req).to(dev),
            nonzero_requested=(self.cluster.nonzero_requested
                               + torch.from_numpy(self.commit_nz).to(dev)),
            ports=self.cluster.ports
            | torch.from_numpy(self.commit_ports).to(dev))
        self._cluster_cache = (self.commits, cl)
        return cl

    def pod_verdicts(self, pod_uid: str):
        """(feasible_row, unresolvable_row) for a cycle pod, the whole-batch
        filter pass computed lazily on first use.  Verdicts taken before the
        latest commit are STALE: None routes the caller to a grouped pass
        against cluster_now()."""
        row = self.row_of.get(pod_uid)
        if row is None:
            return None
        self._materialize_lazy()
        if self.feasible is not None and self._verdict_commits != self.commits:
            return None
        if self.feasible is None:
            if self.batch is None:
                return None
            self.refresh_verdicts()
        return self.feasible[row], self.unresolvable[row]

    def _materialize_lazy(self) -> None:
        """Pull the auction's device verdicts to the host IF they are
        still current (no commits since) and nothing fresher exists."""
        if self.feasible is None and self._lazy is not None \
                and self.commits == 0:
            both = self.read(torch.stack(self._lazy))
            self.feasible, self.unresolvable = both[0], both[1]

    def refresh_verdicts(self) -> None:
        """One whole-batch filter pass against the CURRENT committed
        state, shared by every preemption attempt that follows."""
        feasible, unresolvable = programs.filter_verdicts(
            self.cluster_now(), self.batch, self.cfg)
        both = self.read(torch.stack([feasible, unresolvable]))
        self.feasible, self.unresolvable = both[0], both[1]
        self._verdict_commits = self.commits

    def node_names(self) -> List[str]:
        """Node name per snapshot row (once per cycle)."""
        if self._node_names is None:
            self._node_names = [ni.node_name for ni in self.node_infos]
        return self._node_names

    def min_pod_priority(self):
        """Lowest priority among all existing pods (once per cycle), or
        None when the cluster has no pods.  A preemptor at or below it can
        never find a victim."""
        if not self._min_prio_known:
            prios = [pi.pod.priority() for ni in self.node_infos
                     for pi in ni.pods]
            self._min_prio = min(prios) if prios else None
            self._min_prio_known = True
        return self._min_prio

    def pod_row_map(self) -> Dict[str, int]:
        """pod uid -> existing-pod tensor row: the scheduler's builder rows,
        else the build order of state/tensors.py SnapshotBuilder.build."""
        if self.pod_rows is not None:
            return self.pod_rows
        if self._pod_row_cache is None:
            rows: Dict[str, int] = {}
            row = 0
            for ni in self.node_infos:
                for pi in ni.pods:
                    rows[pi.pod.uid] = row
                    row += 1
            self._pod_row_cache = rows
        return self._pod_row_cache

    def victim_index(self) -> Dict[int, _NodeVictims]:
        """node row -> priority-ordered victim arrays, built in ONE host
        pass over the snapshot and shared by every wave round and every
        preemptor this cycle."""
        if self._victim_index is None:
            table = self.builder.table
            R = int(self.cluster.requested.shape[1])
            pod_rows = self.pod_row_map()
            out: Dict[int, _NodeVictims] = {}
            for j, ni in enumerate(self.node_infos):
                if not ni.pods:
                    continue
                prios = np.fromiter((pi.pod.priority() for pi in ni.pods),
                                    np.int64, len(ni.pods))
                order = np.argsort(-prios, kind="stable")
                pis = [ni.pods[int(k)] for k in order]
                out[j] = _NodeVictims(
                    prios=prios[order].astype(np.int32),
                    snap_pos=order.astype(np.int32),
                    rows=np.fromiter(
                        (pod_rows.get(pi.pod.uid, -1) for pi in pis),
                        np.int32, len(pis)),
                    req=np.stack([_pod_channels(pi, table, R)
                                  for pi in pis]),
                    nz=np.array([[pi.non_zero_cpu, pi.non_zero_mem / MIB]
                                 for pi in pis], np.float32),
                    ts=np.fromiter(
                        (pi.pod.metadata.creation_timestamp or 0.0
                         for pi in pis), np.float64, len(pis)),
                    pis=tuple(pis),
                    uids=tuple(pi.pod.uid for pi in pis))
            self._victim_index = out
        return self._victim_index


def _candidate_pass(cluster, batch1, cfg, pod_valid, dreq, dnz, row):
    """The reprieve's filter pass for one candidate: the pod's verdict at
    node ``row`` of the cluster with ``pod_valid`` as its existing-pod mask
    and ``dreq``/``dnz`` [1, .] removed from the row's usage.  Returns a
    function of (pod_valid, dreq, dnz, row) -> [1] bool.  On the card the
    pass is captured as a CUDA graph on the example inputs given (after
    two warm-up runs) and each call copies its inputs into the graph's
    and replays it."""
    base_req = cluster.requested
    base_nz = cluster.nonzero_requested

    def one(pod_valid, dreq, dnz, row):
        cl = cluster._replace(
            pod_valid=pod_valid,
            requested=base_req.index_add(0, row, -dreq),
            nonzero_requested=base_nz.index_add(0, row, -dnz))
        feas, _, _ = programs.run_filters(cl, batch1, cfg)
        return feas[0].gather(0, row)

    if not base_req.is_cuda:
        return one
    static = [x.clone() for x in (pod_valid, dreq, dnz, row)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            one(*static)
    torch.cuda.current_stream().wait_stream(side)
    note_compile_event()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = one(*static)

    def replay(*args):
        for dst, src in zip(static, args):
            dst.copy_(src)
        graph.replay()
        return out.clone()
    return replay


def _whatif_reprieve(cluster, batch1, cfg, cand_rows, rm_valid, rm_req,
                     rm_nz, vic_row, vic_req, vic_nz):
    """Batched selectVictimsOnNode (generic_scheduler.go:949) for ONE pod
    whose what-if needs pod_valid masking (topology terms in play).

    cand_rows [C]        candidate node rows
    rm_valid  [C, P]     pod_valid with ALL of each candidate's lower-priority
                         pods masked out
    rm_req    [C, R]     summed resources of those pods
    rm_nz     [C, 2]     their non-zero-request sums
    vic_row   [C, K]     victim pod rows in reprieve order (-1 pad)
    vic_req   [C, K, R]  per-victim resources
    vic_nz    [C, K, 2]

    Returns (fits0 [C] — the pod fits with all victims removed,
             reprieved [K, C] — victim k stayed on the node).

    The JAX package vmaps the filter pass over the C candidate clusters;
    here each candidate's cluster runs the filters in turn (a candidate's
    own column is all it keeps), C x (K + 1) passes with no host read.
    On the card the pass is launch-bound (a few hundred small kernels), so
    it is captured once as a CUDA graph (_candidate_pass) and replayed
    for every candidate and step: the same kernels on the same inputs."""
    batch1 = densify_for(cluster, batch1)
    C = cand_rows.shape[0]
    K = vic_row.shape[1]
    rows = cand_rows.long()
    one = _candidate_pass(cluster, batch1, cfg, rm_valid[0],
                          rm_req[:1], rm_nz[:1], rows[:1])

    def verdicts(pod_valid, dreq, dnz):
        return torch.cat([one(pod_valid[c], dreq[c:c + 1], dnz[c:c + 1],
                              rows[c:c + 1]) for c in range(C)])     # [C]

    fits0 = verdicts(rm_valid, rm_req, rm_nz)
    pod_valid, dreq, dnz = rm_valid, rm_req, rm_nz
    ok = fits0
    reprieved = []
    for k in range(K):
        row = vic_row[:, k]
        exists = (row >= 0) & ok
        e = exists.to(torch.float32)
        # .at[arange(C), clip(row, 0)].max(exists): a -1 pad hits column 0
        # with exists False and leaves it as it is
        try_valid = pod_valid.to(torch.uint8).scatter_reduce(
            1, row.long().clamp(min=0)[:, None],
            exists.to(torch.uint8)[:, None], "amax",
            include_self=True).bool()
        try_dreq = dreq - vic_req[:, k] * e[:, None]
        try_dnz = dnz - vic_nz[:, k] * e[:, None]
        fit = verdicts(try_valid, try_dreq, try_dnz) & exists
        keep = fit[:, None]
        pod_valid = torch.where(keep, try_valid, pod_valid)
        dreq = torch.where(keep, try_dreq, dreq)
        dnz = torch.where(keep, try_dnz, dnz)
        reprieved.append(fit)
    if not reprieved:
        return fits0, torch.zeros((0, C), dtype=torch.bool,
                                  device=fits0.device)
    return fits0, torch.stack(reprieved)


class Preemptor:
    def __init__(self, scheduler, max_candidates: int = 2048,
                 wave_rounds: int = 4):
        self.sched = scheduler
        # memory bound on the candidate axis, NOT the reference's behavior:
        # when exceeded, candidates are pre-ranked and trimmed
        self.max_candidates = max_candidates
        # contention-resolution rounds per wave: pods left without a fresh
        # candidate after losing a node re-enter the next round's what-if
        # against the updated overlay; leftovers after the cap fail cleanly
        # (requeue + retry next cycle)
        self.wave_rounds = wave_rounds
        # element budget for one [B, C, K, R] wave tensor set — beyond it
        # the wave splits along the pod axis
        self.max_wave_elements = 1 << 26

    # ------------------------------------------------------------------ entry

    def preempt(self, fwk, state: CycleState, pod: api.Pod,
                cycle: Optional[CycleContext] = None) -> Optional[str]:
        """reference: scheduler.go:391 + generic_scheduler.go:252 Preempt.
        Returns the nominated node name, or None.  A 1-pod wave; when the
        scheduler already served this pod in the cycle's wave, the
        recorded verdict is returned as it is."""
        if cycle is not None and pod.uid in cycle.wave_nominated:
            return cycle.wave_nominated[pod.uid]
        return self.preempt_wave(fwk, cycle, [pod]).get(pod.uid)

    def preempt_wave(self, fwk, cycle: Optional[CycleContext],
                     pods: Sequence[api.Pod]) -> Dict[str, Optional[str]]:
        """Serve every preemption-eligible failed pod of a cycle with ONE
        batched what-if per contention round.  Returns pod uid ->
        nominated node name (None = no preemption).  Victim deletions and
        nominations are committed in ranked order as part of the wave;
        results are also recorded on the CycleContext so the per-pod
        PostFilter path short-circuits."""
        sched = self.sched
        results: Dict[str, Optional[str]] = {}
        alias: Dict[str, str] = {}   # caller uid -> store-refreshed uid
        fresh: List[api.Pod] = []
        for pod in pods:
            p = sched.store.get_pod(pod.namespace, pod.metadata.name) or pod
            results[p.uid] = None
            if p.uid != pod.uid:
                alias[pod.uid] = p.uid
            # podEligibleToPreemptOthers runs before any candidates work
            if self._eligible(p):
                fresh.append(p)
        if fresh and sched.metrics is not None:
            # reference: metrics.PreemptionAttempts.Inc() per Preempt call
            sched.metrics.preemption_attempts.inc(amount=len(fresh))
        if fresh and cycle is None:
            cycle = self._build_cycle(fwk, fresh)
        try:
            if fresh and cycle.node_infos:
                cycle.stats["waves"] += 1
                self._run_wave(fwk, cycle, fresh, results)
        except BaseException:
            # record only COMMITTED winners: their victims are gone and a
            # re-attempt must not double-preempt, but unserved pods stay
            # eligible for the scheduler's per-pod fallback
            if cycle is not None:
                cycle.wave_nominated.update(
                    {uid: n for uid, n in results.items() if n})
            raise
        for orig, ref in alias.items():
            results[orig] = results[ref]
        if cycle is not None:
            cycle.wave_nominated.update(results)
        return results

    def _run_wave(self, fwk, cycle: CycleContext, pods: List[api.Pod],
                  results: Dict[str, Optional[str]]) -> None:
        sched = self.sched
        min_prio = cycle.min_pod_priority()
        if min_prio is None:
            return
        # nothing anywhere is evictable by a pod at/below the cluster's
        # minimum priority
        live = [p for p in pods if p.priority() > min_prio]
        if not live:
            return
        # ranked commit order: priority-descending, queue order within ties
        live.sort(key=lambda p: -p.priority())
        pdbs = sched.store.list("PodDisruptionBudget")
        node_row = {ni.node_name: j
                    for j, ni in enumerate(cycle.node_infos)}
        # cycle-scoped: a later preempt call against this same context must
        # see the victims this wave deletes
        deleted = cycle.evicted_uids
        pending = live
        has_preempt_ext = any(e.supports_preemption()
                              for e in sched.extenders)
        for _ in range(self.wave_rounds):
            cycle.stats["rounds"] += 1
            fastw, slow_entries = self._wave_round(fwk, cycle, pending,
                                                   pdbs, deleted)
            claimed: set = set()
            next_pending: List[api.Pod] = []
            for pod in pending:
                b = fastw.index.get(pod.uid) if fastw is not None else None
                if b is not None and not has_preempt_ext:
                    # lazy lexicographic resolution: only the WINNER's
                    # victim list materializes
                    best, victims, had_claimed = fastw.resolve(
                        fwk, pod, b, claimed)
                else:
                    # the eager map: the extenders inspect all of it
                    nv = (slow_entries.get(pod.uid)
                          if pod.uid in slow_entries
                          else (fastw.entries_dict(fwk, pod, b)
                                if b is not None else {}))
                    had_claimed = any(n in claimed for n in nv)
                    if had_claimed:
                        # a higher-ranked preemptor won this node in THIS
                        # round: fall back to the next-ranked candidates,
                        # or re-wave
                        nv = {n: v for n, v in nv.items()
                              if n not in claimed}
                    nv = self._process_with_extenders(pod, nv)
                    best = pick_one_node_for_preemption(nv) if nv else None
                    victims = nv.get(best) if best is not None else None
                if best is None:
                    if had_claimed:
                        next_pending.append(pod)
                    continue
                self._commit_victims(fwk, pod, best, victims, cycle,
                                     node_row[best])
                deleted.update(p.uid for p in victims.pods)
                claimed.add(best)
                results[pod.uid] = best
            pending = next_pending
            if not pending:
                break

    def _commit_victims(self, fwk, pod: api.Pod, best: str,
                        victims: Victims, cycle: CycleContext,
                        node_row: int) -> None:
        """Delete the chosen victims and nominate the preemptor (reference:
        scheduler.go:403-415), recording the evictions on the cycle
        overlay so later wave rounds see the freed capacity."""
        sched = self.sched
        table = cycle.builder.table
        R = int(cycle.cluster.requested.shape[1])
        if victims.pods and sched.metrics is not None:
            # reference: metrics.PreemptionVictims.Observe per preemptor
            sched.metrics.preemption_victims.observe(len(victims.pods))
        for victim in victims.pods:
            try:
                sched.store.delete(victim)
            except Exception:
                # already gone (a raced external delete): nothing was freed
                continue
            if sched.recorder:
                sched.recorder.event(victim, "Normal", "Preempted",
                                     f"by {pod.namespace}/{pod.metadata.name} "
                                     f"on node {best}")
            pi = PodInfo(victim)
            cycle.note_evict(node_row, _pod_channels(pi, table, R),
                             np.asarray([pi.non_zero_cpu,
                                         pi.non_zero_mem / MIB], np.float32))

        # reject lower-priority waiting (Permit) pods on the node
        def maybe_reject(wp):
            if wp.pod.priority() < pod.priority():
                wp.reject("preempted")
        fwk.iterate_over_waiting_pods(maybe_reject)
        # clear nomination of lower-priority pods nominated to this node
        for np_ in sched.queue.nominated_pods_for_node(best):
            if np_.priority() < pod.priority():
                sched.queue.delete_nominated_pod_if_exists(np_)
        sched.queue.add_nominated_pod(pod, best)

    def _eligible(self, pod: api.Pod) -> bool:
        """reference: generic_scheduler.go:1063 podEligibleToPreemptOthers
        — if the pod already nominated a node and a lower-priority pod
        there is terminating, wait instead of preempting again."""
        nominated = pod.status.nominated_node_name
        if not nominated:
            return True
        ni = self.sched.snapshot.get(nominated)
        if ni is None:
            return True
        for pi in ni.pods:
            if (pi.pod.metadata.deletion_timestamp is not None
                    and pi.pod.priority() < pod.priority()):
                return False
        return True

    # ------------------------------------------------------------ cycle state

    def _build_cycle(self, fwk, pods: Sequence[api.Pod]) -> CycleContext:
        """When no cycle tensors were handed over (a direct call)."""
        sched = self.sched
        sched.cache.update_snapshot(sched.snapshot)
        node_infos = list(sched.snapshot.node_info_list)
        builder = SnapshotBuilder(
            hard_pod_affinity_weight=fwk.hard_pod_affinity_weight)
        builder.intern_pending([PodInfo(p) for p in pods])
        host = builder.build(node_infos)
        cfg = programs.ProgramConfig(
            filters=fwk.tensor_filters, scores=fwk.tensor_scores,
            hostname_topokey=max(
                builder.table.topokey.get(api.LABEL_HOSTNAME), 0),
            plugin_args=fwk.tensor_plugin_args(builder.table))
        # pod_rows stays None: a fresh build's rows are the node-walk
        # order CycleContext.pod_row_map derives, as the JAX package's
        # fallback leaves them
        return CycleContext(builder=builder,
                            cluster=host.to_device(sched.device), cfg=cfg,
                            node_infos=node_infos)

    def _pods_batch(self, pods: Sequence[api.Pod], cycle: CycleContext):
        """The pods' PodBatch on the cycle's device."""
        pb = PodBatchBuilder(cycle.builder.table)
        sels = [self.sched.store.default_spread_selector(p) for p in pods]
        return batch_to_device(pb.build([PodInfo(p) for p in pods],
                                        spread_selectors=sels),
                               cycle.device)

    def _cluster_with_nominated(self, pod: api.Pod, cycle: CycleContext):
        """cluster_now plus equal/higher-priority nominated pods' resources
        on their nominated rows — the simulation must respect capacity
        other preemptors already reserved (reference: addNominatedPods
        inside fitsOnNode, generic_scheduler.go:594)."""
        cl = cycle.cluster_now()
        prio = pod.priority()
        node_row = {ni.node_name: j
                    for j, ni in enumerate(cycle.node_infos)}
        entries = []
        for p, nn in self.sched.queue.all_nominated():
            if p.uid == pod.uid or p.priority() < prio:
                continue
            row = node_row.get(nn)
            if row is None:
                continue
            entries.append((PodInfo(p), row))
        if not entries:
            return cl
        nom = build_nominated(entries, cycle.builder.table)
        add = np.zeros(tuple(cl.requested.shape), np.float32)
        keep = nom.valid & (nom.node >= 0)
        np.add.at(add, nom.node[keep], nom.req[keep])
        return cl._replace(requested=cl.requested
                           + torch.from_numpy(add).to(cycle.device))

    # ------------------------------------------------------- candidate nodes

    def _wave_candidates(self, fwk, cycle: CycleContext,
                         pods: Sequence[api.Pod]) -> Dict[str, List[int]]:
        """reference: generic_scheduler.go:1041 nodesWherePreemptionMightHelp
        for the whole wave — every failed node that is not
        UnschedulableAndUnresolvable.  In-batch pods share ONE [B, N]
        verdict refresh; the rest share one grouped pass."""
        node_infos = cycle.node_infos
        n = len(node_infos)
        verd: Dict[str, tuple] = {}
        need_pass: List[api.Pod] = []
        for pod in pods:
            v = cycle.pod_verdicts(pod.uid)
            if v is None:
                need_pass.append(pod)
            else:
                verd[pod.uid] = v
        if need_pass:
            batch = self._pods_batch(need_pass, cycle)
            feas, unres = programs.filter_verdicts(cycle.cluster_now(),
                                                   batch, cycle.cfg)
            both = cycle.read(torch.stack([feas, unres]))
            for i, pod in enumerate(need_pass):
                verd[pod.uid] = (both[0, i], both[1, i])
        out: Dict[str, List[int]] = {}
        for pod in pods:
            feasible, unresolvable = verd[pod.uid]
            feasible = np.array(feasible[:n])
            if fwk.has_relevant_host_filters(pod):
                # the host filters' verdicts join the device's
                # (kubetpu/preemption.py:685-691)
                state = CycleState()
                for j in np.flatnonzero(feasible).tolist():
                    if not fwk.run_filter_plugins(state, pod,
                                                  node_infos[j]).is_success():
                        feasible[j] = False
            out[pod.uid] = np.flatnonzero(
                ~feasible & ~unresolvable[:n]).tolist()
        return out

    # -------------------------------------------------------- victim search

    def _wave_round(self, fwk, cycle: CycleContext,
                    pods: Sequence[api.Pod], pdbs, deleted: set):
        """One contention round's what-if for every pending pod:
        candidates -> (fast wave | per-pod topology reprieve).  Returns
        (_FastWave or None, {slow pod uid: {node: Victims}})."""
        cand = self._wave_candidates(fwk, cycle, pods)
        has_terms = cycle.has_filter_terms()
        fast: List[api.Pod] = []
        slow: List[api.Pod] = []
        for pod in pods:
            if not cand.get(pod.uid):
                continue
            # the wave's static-verdict split is sound only when the
            # what-if cannot move a topology verdict (whatif_static_ok)
            if (pod.spec.topology_spread_constraints
                    or pod_with_affinity(pod) or has_terms):
                slow.append(pod)
            else:
                fast.append(pod)
        fastw = self._fast_wave(cycle, fast, cand, pdbs, deleted) \
            if fast else None
        slow_entries = {}
        for pod in slow:
            cands = [(j, cycle.node_infos[j]) for j in cand[pod.uid]]
            slow_entries[pod.uid] = self._select_nodes_for_preemption(
                fwk, pod, cands, pdbs, cycle, deleted)
        return fastw, slow_entries

    def _prio_victim_prep(self, cycle: CycleContext, prio: int, pdbs,
                          deleted: set) -> Dict[int, Tuple[np.ndarray, int]]:
        """node row -> (victim index positions in reprieve order,
        n_pdb_violating) for a preemptor of priority ``prio``, shared by
        every same-priority pod in the wave: the victim ORDER
        (PDB-violating first, then descending priority, :1004-1037)
        depends only on (priority, node)."""
        vi = cycle.victim_index()
        prep: Dict[int, Tuple[np.ndarray, int]] = {}
        for j, nv in vi.items():
            # prios is descending; evictable pods (< prio) are a suffix
            start = int(np.searchsorted(-nv.prios, -prio, side="right"))
            if start >= len(nv.prios):
                continue
            sel = np.arange(start, len(nv.prios))
            if deleted:
                keep = [int(k) for k in sel if nv.uids[k] not in deleted]
                if not keep:
                    continue
                sel = np.asarray(keep, np.int64)
            n_viol = 0
            if pdbs:
                # the per-PDB disruption budget consumes in SNAPSHOT order
                # (the serial path feeds ni.pods order, :1118)
                raw = sorted((int(k) for k in sel),
                             key=lambda k: int(nv.snap_pos[k]))
                violating, _ = filter_pods_with_pdb_violation(
                    [nv.pis[k].pod for k in raw], pdbs)
                vset = {p.uid for p in violating}
                lv = [int(k) for k in sel if nv.uids[k] in vset]
                lnv = [int(k) for k in sel if nv.uids[k] not in vset]
                sel = np.asarray(lv + lnv, np.int64)
                n_viol = len(lv)
            prep[j] = (sel, n_viol)
        return prep

    def _fast_wave(self, cycle: CycleContext, pods: List[api.Pod],
                   cand: Dict[str, List[int]], pdbs,
                   deleted: set) -> "_FastWave":
        """The wave path: ONE [B, C, K] what-if for every term-free pending
        pod.  Host work is vectorized numpy — a compact per-(priority,
        node) victim table plus per-pod index rows; the [B, C, K, R]
        expansion happens on the device (programs.whatif_wave)."""
        vi = cycle.victim_index()
        preps = {prio: self._prio_victim_prep(cycle, prio, pdbs, deleted)
                 for prio in {p.priority() for p in pods}}

        # per-pod candidate rows that actually carry victims, trimmed to
        # max_candidates by pickOneNode-style stats (cheapest kept).  A
        # row's victims and rank depend only on (priority, row), so each
        # priority's rows are ranked once, in one stable order (ties by
        # row); a pod's trimmed list is that order restricted to its own
        # candidates, which is what sorting its ascending list stably gives
        N = len(cycle.node_infos)
        by_prio: Dict[int, list] = {}   # prio -> [has victims [N], rank pos]
        cand_lists: List[List[int]] = []
        cand_arrays: List[np.ndarray] = []
        for pod in pods:
            prio = pod.priority()
            prep = preps[prio]
            pp = by_prio.get(prio)
            if pp is None:
                has = np.zeros((N,), bool)
                has[list(prep)] = True
                pp = by_prio[prio] = [has, None]
            c = np.asarray(cand[pod.uid], np.int64)
            rows = c[pp[0][c]]
            if len(rows) > self.max_candidates:
                if pp[1] is None:
                    def rank(j):
                        pr = vi[j].prios[prep[j][0]]
                        return (int(pr.max()), int(pr.sum()), len(pr))
                    order = sorted(prep, key=rank)
                    pp[1] = np.zeros((N,), np.int64)
                    pp[1][order] = np.arange(len(order))
                rows = rows[np.argsort(pp[1][rows], kind="stable")][
                    : self.max_candidates]
            cand_arrays.append(rows)
            cand_lists.append(rows.tolist())
        max_c = max((len(r) for r in cand_lists), default=0)
        if max_c == 0:
            return _FastWave.empty(pods)
        used_rows: Dict[int, set] = {}
        for pod, rows in zip(pods, cand_lists):
            used_rows.setdefault(pod.priority(), set()).update(rows)
        used = {(prio, j) for prio, js in used_rows.items() for j in js}
        K = pow2_bucket(max(len(preps[prio][j][0]) for prio, j in used), 1)
        C = pow2_bucket(max_c, 1)
        R = int(cycle.cluster.requested.shape[1])

        # split along the pod axis if the [B, C, K, R] expansion would
        # pass the element budget; chunks stay individually pow2-bucketed
        max_pods = max(1, self.max_wave_elements // max(C * K * R, 1))
        if len(pods) > max_pods:
            return _WaveUnion([
                self._fast_wave(cycle, pods[i:i + max_pods], cand, pdbs,
                                deleted)
                for i in range(0, len(pods), max_pods)])

        # compact victim table: one row per used (priority, node)
        order = sorted(used)
        S = pow2_bucket(len(order), 1)
        pos = {key: i for i, key in enumerate(order)}
        tab_row = {prio: np.zeros((N,), np.int32) for prio in used_rows}
        for (prio, j), i in pos.items():
            tab_row[prio][j] = i
        tab_req = np.zeros((S, K, R), np.float32)
        tab_valid = np.zeros((S, K), bool)
        tab_prio = np.full((S, K), -2**31, np.int64)
        tab_ts = np.zeros((S, K), np.float64)
        tab_viol = np.zeros((S, K), bool)
        for (prio, j), i in pos.items():
            sel, n_viol = preps[prio][j]
            tab_req[i, :len(sel)] = vi[j].req[sel]
            tab_valid[i, :len(sel)] = True
            tab_prio[i, :len(sel)] = vi[j].prios[sel]
            tab_ts[i, :len(sel)] = vi[j].ts[sel]
            tab_viol[i, :n_viol] = True

        batch = self._pods_batch(pods, cycle)
        B = int(batch.valid.shape[0])     # pow2 pod-axis bucket
        cand_rows = np.full((B, C), -1, np.int32)
        cand_valid = np.zeros((B, C), bool)
        cand_idx = np.zeros((B, C), np.int32)
        for b, (pod, rows) in enumerate(zip(pods, cand_arrays)):
            nc = len(rows)
            if not nc:
                continue
            cand_rows[b, :nc] = rows
            cand_valid[b, :nc] = True
            cand_idx[b, :nc] = tab_row[pod.priority()][rows]

        # nominated-pod reservations per (pod, candidate): equal-or-greater
        # priority, self excluded (addNominatedPods, :594) — wave winners
        # of earlier rounds are in the queue nominator already
        # (one masked add per nominated pod: each cell still sums its
        # nominated pods in nominator order, as the JAX package's per-pod
        # loop does)
        nom_add = None
        node_row = {ni.node_name: j
                    for j, ni in enumerate(cycle.node_infos)}
        table = cycle.builder.table
        prios = np.asarray([pod.priority() for pod in pods], np.int64)
        b_of = {pod.uid: b for b, pod in enumerate(pods)}
        # col_of[b, row]: the candidate column of node row for pod b (a
        # pod's candidate rows are distinct), -1 if none
        col_of = np.full((B, N), -1, np.int32)
        for b, rows in enumerate(cand_arrays):
            col_of[b, rows] = np.arange(len(rows), dtype=np.int32)
        for p, nn in self.sched.queue.all_nominated():
            row = node_row.get(nn)
            if row is None:
                continue
            elig = np.zeros((B,), bool)
            elig[:len(pods)] = p.priority() >= prios
            if p.uid in b_of:
                elig[b_of[p.uid]] = False
            if not elig.any():
                continue
            if nom_add is None:
                nom_add = np.zeros((B, C, R), np.float32)
            bs = np.flatnonzero(elig & (col_of[:, row] >= 0))
            nom_add[bs, col_of[bs, row]] += _pod_channels(PodInfo(p),
                                                           table, R)
        dev = cycle.device
        nom_dev = (torch.zeros((B, C, R), dtype=torch.float32, device=dev)
                   if nom_add is None else torch.from_numpy(nom_add).to(dev))

        # the droppable topology filters are gone for every fast pod by
        # construction (that is what made them fast)
        cfg_w = cycle.cfg._replace(filters=tuple(
            f for f in cycle.cfg.filters
            if f not in ("PodTopologySpread", "InterPodAffinity")))
        cluster = cycle.cluster_now()
        static_ok = programs.whatif_static_ok(cluster, batch, cfg_w)

        def up(x):
            return torch.from_numpy(x).to(dev)
        # a span under the scheduler's open preemption-wave span (no-op
        # while the flight recorder is disarmed)
        with flight_span("whatif-readback", pods=B) as sp:
            t_dev = time.perf_counter()
            packed = cycle.read(programs.whatif_wave(   # ONE read: the wave
                cluster, static_ok, batch.req, up(cand_rows), up(cand_valid),
                nom_dev, up(tab_req), up(tab_valid), up(cand_idx)))
            if sp is not None:
                # the wave's device-wait attribution
                sp.args["device_wait_s"] = round(
                    time.perf_counter() - t_dev, 6)

        # pickOneNode metrics, vectorized over the whole [B, C, K] block
        # (generic_scheduler.go:729 criteria 1-5; criterion 6 = first in
        # candidate order, the argmin tie-break in _FastWave._pick)
        evicted = (tab_valid[cand_idx] & cand_valid[:, :, None]
                   & ~packed[:, :, 1:])                      # [B, C, K]
        prio_g = tab_prio[cand_idx]
        fits = packed[:, :, 0] & cand_valid
        m1 = (evicted & tab_viol[cand_idx]).sum(axis=2)
        m2 = np.where(evicted, prio_g, -2**31).max(axis=2)
        m3 = np.where(evicted, prio_g, 0).sum(axis=2)
        m4 = evicted.sum(axis=2)
        # latest start time of the highest-priority victim: argmax takes
        # the FIRST max like the serial max() — matching reprieve order
        top = np.argmax(np.where(evicted, prio_g, -2**31), axis=2)
        m5 = -np.take_along_axis(tab_ts[cand_idx], top[:, :, None],
                                 axis=2)[:, :, 0]
        m5 = np.where(m4 > 0, m5, 0.0)
        return _FastWave(cycle=cycle, pods=pods, cand_lists=cand_lists,
                         preps=preps, vi=vi, evicted=evicted, fits=fits,
                         metrics=(m1, m2, m3, m4, m5))

    def _select_nodes_for_preemption(self, fwk, pod: api.Pod,
                                     candidates, pdbs,
                                     cycle: CycleContext,
                                     deleted: set = frozenset()
                                     ) -> Dict[str, Victims]:
        """reference: generic_scheduler.go:858 selectNodesForPreemption —
        the what-if for ONE topology-term-carrying pod, batched over every
        candidate (_whatif_reprieve).  The what-if's cfg drops topology
        filters the preemptor provably cannot trip: PodTopologySpread
        constrains only pods WITH constraints, and InterPodAffinity is
        droppable when the pod has no affinity terms AND no existing pod
        carries a filter term."""
        cfg_w = cycle.cfg
        drop = []
        if not pod.spec.topology_spread_constraints:
            drop.append("PodTopologySpread")
        if not pod_with_affinity(pod) and not cycle.has_filter_terms():
            drop.append("InterPodAffinity")
        if drop:
            cfg_w = cfg_w._replace(filters=tuple(
                f for f in cfg_w.filters if f not in drop))

        prio = pod.priority()
        table = cycle.builder.table
        R = int(cycle.cluster.requested.shape[1])
        P = int(cycle.cluster.pod_valid.shape[0])

        # per-candidate victim lists in reprieve order: PDB-violating first,
        # each group by descending priority (:1004-1037)
        entries = []  # (row, ordered victims [PodInfo], n_violating)
        pod_rows = cycle.pod_row_map()
        for row, ni in candidates:
            lower = [pi for pi in ni.pods
                     if pi.pod.priority() < prio
                     and pi.pod.uid not in deleted]
            if not lower:
                continue
            violating, _ = filter_pods_with_pdb_violation(
                [pi.pod for pi in lower], pdbs)
            vset = {p.uid for p in violating}
            lv = sorted((pi for pi in lower if pi.pod.uid in vset),
                        key=lambda pi: -pi.pod.priority())
            lnv = sorted((pi for pi in lower if pi.pod.uid not in vset),
                         key=lambda pi: -pi.pod.priority())
            entries.append((row, lv + lnv, len(lv)))
        if not entries:
            return {}
        if len(entries) > self.max_candidates:
            # memory cap: keep the candidates cheapest by pickOneNode-style
            # stats (lowest max victim priority, then sum, then count)
            def rank(e):
                vs = e[1]
                return (max(pi.pod.priority() for pi in vs),
                        sum(pi.pod.priority() for pi in vs), len(vs))
            entries = sorted(entries, key=rank)[: self.max_candidates]

        C = pow2_bucket(len(entries), 1)
        K = pow2_bucket(max(len(e[1]) for e in entries), 1)
        cand_rows = np.zeros((C,), np.int32)
        removed = np.zeros((C, P), bool)
        rm_req = np.zeros((C, R), np.float32)
        rm_nz = np.zeros((C, 2), np.float32)
        vic_row = np.full((C, K), -1, np.int32)
        vic_req = np.zeros((C, K, R), np.float32)
        vic_nz = np.zeros((C, K, 2), np.float32)
        for c, (row, victims, _nv) in enumerate(entries):
            cand_rows[c] = row
            for k, pi in enumerate(victims):
                prow = pod_rows.get(pi.pod.uid, -1)
                if prow >= 0:
                    removed[c, prow] = True
                vic_row[c, k] = prow
                vr = _pod_channels(pi, table, R)
                vic_req[c, k] = vr
                vic_nz[c, k, 0] = pi.non_zero_cpu
                vic_nz[c, k, 1] = pi.non_zero_mem / MIB
                rm_req[c] += vr
                rm_nz[c] += vic_nz[c, k]
        # pad rows: candidate 0's row with no removals (padded candidates
        # are dropped below)
        for c in range(len(entries), C):
            cand_rows[c] = entries[0][0]

        dev = cycle.device

        def up(x):
            return torch.from_numpy(x).to(dev)
        # pod_valid with ALL of each candidate's victims masked out
        rm_valid = cycle.cluster.pod_valid[None, :] & ~up(removed)
        fits0, reprieved = _whatif_reprieve(
            self._cluster_with_nominated(pod, cycle),
            self._pods_batch([pod], cycle), cfg_w, up(cand_rows),
            rm_valid, up(rm_req), up(rm_nz), up(vic_row), up(vic_req),
            up(vic_nz))
        both = cycle.read(torch.cat([fits0[None], reprieved]))  # [K+1, C]
        fits0, reprieved = both[0], both[1:]

        out: Dict[str, Victims] = {}
        for c, (row, victims, n_violating) in enumerate(entries):
            if not fits0[c]:
                continue
            final = [victims[k].pod for k in range(len(victims))
                     if not reprieved[k, c]]
            num_viol = sum(1 for k in range(min(n_violating, len(victims)))
                           if not reprieved[k, c])
            ni = cycle.node_infos[row]
            if not self._host_filters_pass(fwk, pod, ni,
                                           {p.uid for p in final}):
                continue
            out[ni.node_name] = Victims(pods=final,
                                        num_pdb_violations=num_viol)
        return out

    @staticmethod
    def _host_filters_pass(fwk, pod: api.Pod, ni: NodeInfo,
                           removed_uids: set) -> bool:
        """The profile's host filters on the node with the victims
        removed (kubetpu/preemption.py:1037)."""
        if not fwk.has_relevant_host_filters(pod):
            return True
        sim_ni = ni.clone()
        for pi in list(sim_ni.pods):
            if pi.pod.uid in removed_uids:
                sim_ni.remove_pod(pi.pod)
        return fwk.run_filter_plugins(CycleState(), pod, sim_ni).is_success()

    # ------------------------------------------------------------- extenders

    def _process_with_extenders(self, pod: api.Pod,
                                node_victims: Dict[str, Victims]
                                ) -> Dict[str, Victims]:
        """reference: generic_scheduler.go:317 processPreemptionWithExtenders
        + core/extender.go:317 ProcessPreemption
        (kubetpu/preemption.py:1050)."""
        if not node_victims:
            return node_victims
        for ext in self.sched.extenders:
            if not (ext.supports_preemption() and ext.is_interested(pod)):
                continue
            try:
                node_victims = ext.process_preemption(pod, node_victims)
            except Exception:
                if getattr(ext, "ignorable", False):
                    continue
                return {}
            if not node_victims:
                return {}
        return node_victims


class _FastWave:
    """One round's wave what-if results plus lazy contention resolution.

    resolve() reproduces pick_one_node_for_preemption's lexicographic
    tie-break over vectorized numpy metric arrays — criteria 1-5 as
    argmin filters, criterion 6 (first remaining) as candidate order — and
    materializes a Victims list only for the winner."""

    def __init__(self, cycle, pods, cand_lists, preps, vi, evicted, fits,
                 metrics):
        self.cycle = cycle
        self.pods = pods
        self.cand_lists = cand_lists
        self.preps = preps
        self.vi = vi
        self.evicted = evicted          # [B, C, K] bool
        self.fits = fits                # [B, C] bool
        self.metrics = metrics          # 5 x [B, C]
        self.index = {pod.uid: b for b, pod in enumerate(pods)}
        names = cycle.node_names() if cycle is not None else []
        self.names = [[names[j] for j in rows] for rows in cand_lists]

    @classmethod
    def empty(cls, pods):
        z = np.zeros((len(pods), 0), np.int64)
        return cls(cycle=None, pods=pods, cand_lists=[[] for _ in pods],
                   preps={}, vi={}, evicted=np.zeros((len(pods), 0, 0),
                                                     bool),
                   fits=z.astype(bool), metrics=(z, z, z, z, z))

    def _victims(self, pod, b: int, c: int) -> Victims:
        j = self.cand_lists[b][c]
        sel, n_viol = self.preps[pod.priority()][j]
        ev = self.evicted[b, c, :len(sel)].tolist()
        final = [self.vi[j].pis[int(k)].pod
                 for t, k in enumerate(sel) if ev[t]]
        num_viol = sum(1 for t in range(min(n_viol, len(sel))) if ev[t])
        return Victims(pods=final, num_pdb_violations=num_viol)

    def _pick(self, b: int, skip: set) -> Optional[int]:
        names = self.names[b]
        nc = len(names)
        if nc == 0:
            return None
        ok = self.fits[b, :nc].copy()
        if skip:
            ok &= np.fromiter((n not in skip for n in names), bool, nc)
        idx = np.flatnonzero(ok)
        for m in self.metrics:
            if idx.size <= 1:
                break
            vals = m[b, idx]
            idx = idx[vals == vals.min()]
        return int(idx[0]) if idx.size else None

    def resolve(self, fwk, pod, b: int, claimed: set):
        """(node, victims, had_claimed) — had_claimed: some feasible entry
        was lost to a same-round claim (the re-wave trigger).  A winner
        whose node the profile's host filters reject, victims removed,
        gives way to the next."""
        names = self.names[b]
        had_claimed = bool(claimed) and any(
            n in claimed for n, f in zip(names, self.fits[b].tolist()) if f)
        banned = set(claimed)
        while True:
            c = self._pick(b, banned)
            if c is None:
                return None, None, had_claimed
            victims = self._victims(pod, b, c)
            if Preemptor._host_filters_pass(
                    fwk, pod, self.cycle.node_infos[self.cand_lists[b][c]],
                    {p.uid for p in victims.pods}):
                return names[c], victims, had_claimed
            banned.add(names[c])

    def entries_dict(self, fwk, pod, b: int) -> Dict[str, Victims]:
        """The eager node -> Victims map of pod ``b``, in candidate order
        (extender path only: extenders inspect the full map, reference
        ProcessPreemption)."""
        out: Dict[str, Victims] = {}
        for c, name in enumerate(self.names[b]):
            if not self.fits[b, c]:
                continue
            victims = self._victims(pod, b, c)
            if not Preemptor._host_filters_pass(
                    fwk, pod, self.cycle.node_infos[self.cand_lists[b][c]],
                    {p.uid for p in victims.pods}):
                continue
            out[name] = victims
        return out


class _WaveUnion:
    """Routes per-pod wave handles across the element-budget chunks of one
    round (the opaque b handle becomes (chunk, b))."""

    def __init__(self, waves):
        self.waves = waves
        self.index = {uid: (w, b) for w in waves
                      for uid, b in w.index.items()}

    def resolve(self, fwk, pod, key, claimed):
        w, b = key
        return w.resolve(fwk, pod, b, claimed)

    def entries_dict(self, fwk, pod, key):
        w, b = key
        return w.entries_dict(fwk, pod, b)


# ---------------------------------------------------------------------------
# pure functions (host)


def filter_pods_with_pdb_violation(pods: List[api.Pod],
                                   pdbs) -> Tuple[List[api.Pod], List[api.Pod]]:
    """reference: generic_scheduler.go:1118 filterPodsWithPDBViolation."""
    violating, non_violating = [], []
    remaining = {id(pdb): pdb.disruptions_allowed for pdb in pdbs}
    for p in pods:
        hit = False
        for pdb in pdbs:
            if pdb.metadata.namespace != p.namespace:
                continue
            if pdb.selector is not None and pdb.selector.matches(
                    p.metadata.labels):
                if remaining[id(pdb)] <= 0:
                    hit = True
                else:
                    remaining[id(pdb)] -= 1
        (violating if hit else non_violating).append(p)
    return violating, non_violating


def pick_one_node_for_preemption(node_victims: Dict[str, Victims]
                                 ) -> Optional[str]:
    """reference: generic_scheduler.go:729 — lexicographic tie-break:
    1. fewest PDB violations
    2. lowest highest-victim-priority
    3. lowest sum of victim priorities
    4. fewest victims
    5. latest earliest start time of highest-priority victim
    6. first in iteration order (the reference returns the first
       remaining)."""
    if not node_victims:
        return None
    nodes = list(node_victims)

    def metric(fns):
        nonlocal nodes
        vals = {n: fns(node_victims[n]) for n in nodes}
        best = min(vals.values())
        nodes = [n for n in nodes if vals[n] == best]

    metric(lambda v: v.num_pdb_violations)
    if len(nodes) == 1:
        return nodes[0]
    metric(lambda v: max((p.priority() for p in v.pods), default=-2**31))
    if len(nodes) == 1:
        return nodes[0]
    metric(lambda v: sum(p.priority() for p in v.pods))
    if len(nodes) == 1:
        return nodes[0]
    metric(lambda v: len(v.pods))
    if len(nodes) == 1:
        return nodes[0]

    # latest start time of the highest-priority victim (max => min of -ts)
    def neg_latest_start(v: Victims):
        if not v.pods:
            return 0.0
        top = max(v.pods, key=lambda p: p.priority())
        return -top.metadata.creation_timestamp
    metric(neg_latest_start)
    return nodes[0]
