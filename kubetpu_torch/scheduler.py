"""Scheduler core: queue -> snapshot -> tensorize -> device program ->
packed readback -> assume + bind, on a CUDA device.

reference: pkg/scheduler/scheduler.go (scheduleOne :509, assume :435,
bind :457, recordSchedulingFailure :391) and eventhandlers.go
(addAllEventHandlers :362).  Like the JAX package's scheduler, each cycle
pops a BATCH of pods and places it with one device program:

  schedule_pending -> pop a batch (the queue-sort order) -> cache snapshot
  -> host PreFilter per pod -> the resident cluster (chained, or refreshed
  by the DeltaTensorizer) and the PodBatchBuilder's batch -> host Filter
  verdicts into ``host_ok`` (the volume
  family as one device mask, state/volumes.py) and host PreScore/Score
  into ``score_bias`` -> the mode's program with
  PRNGKey(cycle counter) -> ONE readback of ``packed`` -> per placement:
  host-filter re-check, Reserve, assume, Permit, then the bind cycle
  (WaitOnPermit, PreBind, Bind, PostBind); failed pods go through the
  PostFilter (DefaultPreemption: one batched preemption wave per cycle,
  preemption.py) and return to the queue after every placement of the
  cycle has committed.

Profiles are the configuration's: custom plugin sets over the default set
with per-plugin arguments (framework/runtime.py).  Tensorized plugins run
in the device program; host plugins run at their points, each only for
the pods it finds relevant.  Host scores are normalised over every valid
node before the dispatch (the JAX package's documented deviation from the
reference's filtered set, which keeps the single readback).

Modes: "sequential" (the default) replays scheduleOne over the batch in
pod order (models/sequential.py) with the adaptive-sampling start index
kept across cycles; "gang" runs the conflict-free auction
(models/gang.py).  Both restrict the same-pair key loops to the topology
keys of the batch's terms (ProgramConfig.active_topo_keys).  In both, pods
nominated by preemption reserve their nominated nodes for pods of lower or
equal priority (the nominated-pods overlay, ANDed into ``host_ok``).  A
gang batch whose pods carry pod (anti-)affinity, spread constraints or a
controller spread selector runs the auction with intra-batch topology, and
so the lax round whatever the configured backend; each cycle's route is
recorded in ``gang_backends``.

Binding runs in the cycle by default (``async_binding=False``); the JAX
package binds on a pool by default.  A Permit plugin that answers Wait
needs ``async_binding=True``: the bind cycle then runs on a pool of binder
threads (``wait_for_inflight_binds``).  Placements do not depend on this
setting.  Refused, a ROADMAP queue 1 item: extenders (item 8); deferred:
the pipelined serving loop, the bind retry ladder and ``run`` (item 9),
and the JAX runtime's journal/chaos/devstats/AOT utilities (item 11).

The resident cluster: each profile keeps one device-resident cluster
(state/delta.py DeltaTensorizer), brought up to date each cycle by a
scatter of the rows the cache's churn dirtied; a full build runs only on
the tensorizer's resync triggers.  In gang mode with ``chain_cycles``
(the default) the auction's placements, materialized on the device
(models/gang.materialize_assigned), are the next cycle's cluster, until a
store event the chain did not cause, a failed commit or a vocab or bucket
change breaks it.  Every pod's decision lands in ``decisions``
(utils/decisions.py); a cycle with failures runs one audit program
(models/programs.explain_verdicts) for them.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .api import types as api
from .apis.config import KubeSchedulerConfiguration, KubeSchedulerProfile
from .apis.load import validate as validate_config
from .client.store import ClusterStore
from .framework.interface import Code, CycleState, Status
from .framework.runtime import Framework
from .framework.types import (PodInfo, QueuedPodInfo, pod_with_affinity,
                              pod_with_required_anti_affinity)
from .models import programs
from .models.batch import (PodBatchBuilder, batch_to_device, build_nominated,
                           nominated_to_device, take_rows)
from .models.gang import materialize_assigned, run_auction
from .models.sequential import schedule_sequential
from .plugins.intree import DefaultPreemption, new_in_tree_registry
from .preemption import CycleContext, Preemptor
from .schedqueue.queue import SchedulingQueue
from .state import volumes as vstate
from .state.cache import SchedulerCache, Snapshot
from .state.delta import DeltaTensorizer
from .state.tensors import vocab_signature
from .utils import pallas_backend as PB
from .utils import prng
from .utils.decisions import DecisionLog, PodDecision
from .utils.device import DeviceLike, resolve_device
from .utils.intern import pow2_bucket


@dataclass
class ScheduleOutcome:
    pod: api.Pod
    node: str = ""                 # "" => unschedulable
    err: Optional[str] = None
    n_feasible: int = 0
    preemption_may_help: bool = True


class Scheduler:
    """reference: scheduler.go:69.  ``device`` defaults to CUDA; pass
    device="cpu" to run the plain PyTorch path.  registry: the plugin
    factories (default: plugins/intree.new_in_tree_registry(), to which a
    caller adds its own).  async_binding: run each bind cycle on a binder
    pool (see the module docstring)."""

    def __init__(self, store: ClusterStore,
                 config: Optional[KubeSchedulerConfiguration] = None,
                 registry=None, device: DeviceLike = None,
                 async_binding: bool = False):
        self.device = resolve_device(device)
        self.store = store
        self.config = config or KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()])
        if not self.config.profiles:
            self.config.profiles = [KubeSchedulerProfile()]
        registry = registry or new_in_tree_registry()
        # plugin existence is checked against the registry the profiles
        # are built from (reference: framework.go:205 NewFramework)
        validate_config(self.config, registry_names=set(registry))
        if self.config.extenders:
            raise NotImplementedError(
                "extenders are not ported (ROADMAP queue 1 item 8)")
        self.profiles: Dict[str, Framework] = {
            p.scheduler_name: Framework(registry, p, client=store)
            for p in self.config.profiles}
        self.cache = SchedulerCache(
            expire_listener=lambda pod: self._mark_chain_dirty())
        any_fw = next(iter(self.profiles.values()))
        self.queue = SchedulingQueue(
            sort_key=any_fw.queue_sort_key,
            pod_initial_backoff=self.config.pod_initial_backoff_seconds,
            pod_max_backoff=self.config.pod_max_backoff_seconds)
        self.snapshot = Snapshot()
        self._rng_counter = 0   # PRNGKey(cycle) — the JAX scheduler's seed 0
        # rotating node-search start of the sequential replay (reference:
        # nextStartNodeIndex, generic_scheduler.go:451); kept across cycles
        self._next_start_node_index = 0
        self._async_binding = async_binding
        self._bind_pool = (ThreadPoolExecutor(max_workers=16,
                                              thread_name_prefix="binder")
                           if async_binding else None)
        self._inflight_binds: List = []
        # the resident cluster: one DeltaTensorizer per profile, refreshed
        # by bounded scatters of the cycle's dirty rows
        self._delta: Dict[str, DeltaTensorizer] = {}
        # cycle chaining (gang mode): the previous auction's placements,
        # materialized on the device, as this cycle's cluster.  Event
        # handlers bump _chain_seq AFTER the cache mutation; a cycle
        # captures it BEFORE its snapshot, so a chain is used only if no
        # event landed since the state it embeds (a late bump only
        # over-invalidates).  Bind threads reset it (_forget)
        self._chain = None
        self._chain_seq = 0
        self._chain_lock = threading.Lock()
        # per-pod decision audit (utils/decisions.py): on by default,
        # KUBETPU_AUDIT=0 disables it
        self.decisions = DecisionLog()
        # (failed-uid set, audit rows) of the last audit: the retry-churn
        # dedup of _schedule_group
        self._audit_cache = None
        # uids of the popped pods that have an outcome in the running
        # schedule_pending: committed, or failed and requeued
        self._settled: set = set()
        # per-cycle diagnostics (the benchmark surface); the gang lists
        # stay empty in sequential mode
        self.cycle_count = 0
        self.gang_rounds: List[int] = []
        self.gang_syncs: List[int] = []
        # (backend, reason) per gang cycle: the round the auction ran
        # ("pallas" or "lax") and, when a pallas request was routed to
        # lax, why (utils/pallas_backend.unsupported_reason)
        self.gang_backends: List[Tuple[str, Optional[str]]] = []
        # host wall seconds per cycle stage, summed over cycles: snapshot
        # (and the host PreFilter), tensorize (numpy build, host filters
        # and scores, and the nominated overlay), upload (copy to the
        # device), auction (the mode's program through the packed
        # readback), chain (gang mode: materialize the next cycle's
        # cluster), commit (re-check, Reserve, assume, Permit, bind),
        # preempt (the preemption wave and the failed pods' PostFilter
        # and requeue)
        self.stage_s: Dict[str, float] = dict.fromkeys(
            ("snapshot", "tensorize", "upload", "auction", "chain",
             "commit", "preempt"), 0.0)
        # where each cycle's cluster came from: "chain" (the previous
        # auction's materialized cluster), the resync reason of a full
        # rebuild, "delta" (a scatter of dirty rows) or "clean" (nothing
        # changed)
        self.cluster_sources: List[str] = []
        # rows of recent scatter cycles (bounded), their count, and the
        # resyncs of every profile's DeltaTensorizer
        self.delta_rows = deque(maxlen=4096)
        self.delta_cycle_count = 0
        self.resync_count = 0
        # per cycle: the preemption waves, wave rounds, evictions and
        # device->host reads (preemption.CycleContext.stats)
        self.preempt_stats: List[Dict[str, int]] = []
        # preemption waves that raised; their pods were served one by one
        # through the PostFilter, as the JAX scheduler serves them
        self.preempt_wave_failures = 0
        self._add_all_event_handlers()
        # reference: scheduler.go:548 — preemption runs unless disabled;
        # DefaultPreemption serves it through the PostFilter point, with
        # the Preemptor late-bound because it needs the scheduler
        self.preemptor = (None if self.config.disable_preemption
                          else Preemptor(self))
        for fwk in self.profiles.values():
            for p in fwk.post_filter_plugins:
                if isinstance(p, DefaultPreemption):
                    p.preemptor = self.preemptor

    # ------------------------------------------------------------------ events

    def _add_all_event_handlers(self) -> None:
        """reference: eventhandlers.go:362 addAllEventHandlers."""
        def on_pod(event: str, old, new) -> None:
            pod = new if new is not None else old
            if event == "add":
                if pod.spec.node_name:
                    self._add_pod_to_cache(pod)
                    self._mark_chain_dirty()   # an external bound add
                elif self._responsible(pod):
                    self.queue.add(pod)
            elif event == "update":
                if new.spec.node_name and not old.spec.node_name:
                    # bind confirmed (possibly our own assume)
                    foreign = not self.cache.is_assumed_pod(new)
                    self._add_pod_to_cache(new)
                    if foreign:
                        self._mark_chain_dirty()   # a foreign writer bound it
                    self.queue.delete(old)
                    self.queue.assigned_pod_added(new)
                elif new.spec.node_name:
                    try:
                        self.cache.update_pod(old, new)
                    except ValueError:
                        self._add_pod_to_cache(new)
                    self._mark_chain_dirty()
                    self.queue.assigned_pod_updated(new)
                elif (self._responsible(new)
                      and not self._skip_pod_update(old, new)):
                    self.queue.update(old, new)
            elif event == "delete":
                if pod.spec.node_name:
                    try:
                        self.cache.remove_pod(pod)
                    except ValueError:
                        pass
                    self._mark_chain_dirty()
                    self.queue.move_all_to_active_or_backoff_queue(
                        "PodDelete")
                else:
                    self.queue.delete(pod)
                    fwk = self.profiles.get(pod.spec.scheduler_name)
                    if fwk is not None:
                        fwk.reject_waiting_pod(pod.uid)

        def on_node(event: str, old, new) -> None:
            if event == "add":
                self.cache.add_node(new)
                self._mark_chain_dirty()
                self.queue.move_all_to_active_or_backoff_queue("NodeAdd")
            elif event == "update":
                self.cache.update_node(old, new)
                self._mark_chain_dirty()
                self.queue.move_all_to_active_or_backoff_queue("NodeUpdate")
            elif event == "delete":
                try:
                    self.cache.remove_node(old)
                except ValueError:
                    pass
                self._mark_chain_dirty()

        def on_moveable(kind: str):
            def handler(event: str, old, new) -> None:
                self.queue.move_all_to_active_or_backoff_queue(
                    f"{kind}{event.title()}")
            return handler

        self.store.subscribe("Pod", on_pod)
        self.store.subscribe("Node", on_node)
        for kind in ("PersistentVolume", "PersistentVolumeClaim",
                     "StorageClass", "Service", "CSINode"):
            self.store.subscribe(kind, on_moveable(kind))

    def _mark_chain_dirty(self) -> None:
        """Bump the chain's event sequence, AFTER the cache mutation it
        describes."""
        with self._chain_lock:
            self._chain_seq += 1

    def _drop_chain(self) -> None:
        with self._chain_lock:
            self._chain = None

    def _chain_enabled(self) -> bool:
        return self.config.mode == "gang" and self.config.chain_cycles

    def _add_pod_to_cache(self, pod: api.Pod) -> None:
        try:
            self.cache.add_pod(pod)
        except ValueError:
            pass

    def _responsible(self, pod: api.Pod) -> bool:
        return pod.spec.scheduler_name in self.profiles

    @staticmethod
    def _skip_pod_update(old: api.Pod, new: api.Pod) -> bool:
        """reference: eventhandlers.go:311 skipPodUpdate — only
        resourceVersion/status-ish changes (a failed pod's condition and
        nomination) leave the queue alone."""
        return (old.spec == new.spec
                and old.metadata.labels == new.metadata.labels
                and old.metadata.annotations == new.metadata.annotations)

    # ------------------------------------------------------------------ cycle

    def _next_rng(self):
        self._rng_counter += 1
        return prng.PRNGKey(self._rng_counter, device=self.device)

    def schedule_pending(self, max_batch: Optional[int] = None,
                         timeout: float = 0.0) -> List[ScheduleOutcome]:
        """Run ONE batched scheduling cycle: pop up to batch_size pods and
        schedule them, one device program per profile.  Returns their
        outcomes ([] when the queue is empty).  If a group raises, every
        popped pod without an outcome goes back to the queue before the
        exception propagates (as the JAX scheduler's _recover_cycle,
        kubetpu/scheduler.py:1225): nothing popped is lost."""
        qpods = self.queue.pop_batch(max_batch or self.config.batch_size,
                                     timeout=timeout)
        by_profile: Dict[str, List[QueuedPodInfo]] = {}
        for qp in qpods:
            if not self._skip_pod_schedule(qp.pod):
                by_profile.setdefault(qp.pod.spec.scheduler_name,
                                      []).append(qp)
        outcomes: List[ScheduleOutcome] = []
        self._settled = set()
        try:
            for name, group in by_profile.items():
                outcomes.extend(self._schedule_group(self.profiles[name],
                                                     group))
        except BaseException:
            self._requeue_unsettled(
                [qp for group in by_profile.values() for qp in group])
            raise
        return outcomes

    def _requeue_unsettled(self, qpods: List[QueuedPodInfo]) -> None:
        """reference: kubetpu/scheduler.py:1275-1284 — each pod with no
        outcome back as unschedulable under the cycle captured at its pop,
        then every unschedulable pod to the active or backoff queue, where
        its own backoff paces the retry."""
        for qp in qpods:
            if qp.pod.uid in self._settled:
                continue
            try:
                self.queue.add_unschedulable_if_not_present(
                    qp, qp.scheduling_cycle)
            except ValueError:
                pass
        self.queue.move_all_to_active_or_backoff_queue("CycleRecovery")

    def _skip_pod_schedule(self, pod: api.Pod) -> bool:
        """reference: scheduler.go:691 skipPodSchedule."""
        current = self.store.get_pod(pod.namespace, pod.metadata.name)
        if current is None or current.metadata.deletion_timestamp is not None:
            return True
        return self.cache.is_assumed_pod(pod)

    @staticmethod
    def _host_relevance(fwk: Framework, qpods: List[QueuedPodInfo]
                        ) -> Dict[str, Tuple[bool, bool]]:
        """reference: kubetpu/scheduler.py:609-628 — one walk of the host
        filter plugins' relevance per pod: uid -> (any relevant, any
        relevant beyond the device-covered volume family)."""
        out: Dict[str, Tuple[bool, bool]] = {}
        for qp in qpods:
            rel = unc = False
            for p in fwk.host_filter_plugins:
                if fwk._relevant(p, qp.pod):
                    rel = True
                    if p.name() not in vstate.DEVICE_COVERED_PLUGINS:
                        unc = True
                        break
            out[qp.pod.uid] = (rel, unc)
        return out

    def _volume_mask(self, fwk: Framework, live: List[QueuedPodInfo],
                     node_infos, table, cluster) -> Optional[torch.Tensor]:
        """reference: kubetpu/scheduler.py:866-891 — the volume family's
        [B, N] device mask, built only when the profile enables a covered
        plugin and some pod of the batch has volumes; else None."""
        enabled = {p.name() for p in fwk.host_filter_plugins}
        if not (vstate.DEVICE_COVERED_PLUGINS & enabled
                and any(qp.pod.spec.volumes for qp in live)):
            return None
        return vstate.volume_mask(cluster, vstate.build_volume_overlay(
            self.store, node_infos, [qp.pod for qp in live], table, enabled))

    @staticmethod
    def _needs_topo(qpods: List[QueuedPodInfo], spread_sels) -> bool:
        """reference: kubetpu/scheduler.py:997-1006 — a batch needs
        intra-batch topology when a pod carries pod (anti-)affinity or
        spread constraints, or a controller selects it (Service or
        ReplicaSet replicas score through DefaultPodTopologySpread)."""
        return (any(pod_with_affinity(qp.pod)
                    or qp.pod.spec.topology_spread_constraints
                    for qp in qpods)
                or any(s is not None for s in spread_sels))

    @staticmethod
    def _batch_topo_keys(table, pinfos: List[PodInfo]) -> Tuple[int, ...]:
        """reference: kubetpu/scheduler.py:1919-1937 — the topology-key
        vocab ids of the batch's term sets, the key set of the same-pair
        loops (a superset of every key in the batch's terms)."""
        keys = set()
        get = table.topokey.get
        for pi in pinfos:
            for term in pi.required_affinity_terms:
                keys.add(get(term.topology_key))
            for term in pi.required_anti_affinity_terms:
                keys.add(get(term.topology_key))
            for w in pi.preferred_affinity_terms:
                keys.add(get(w.term.topology_key))
            for w in pi.preferred_anti_affinity_terms:
                keys.add(get(w.term.topology_key))
            for c in pi.pod.spec.topology_spread_constraints:
                keys.add(get(c.topology_key))
        keys.discard(-1)
        return tuple(sorted(keys))

    def _stage(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.stage_s[name] += t1 - t0
        return t1

    def _host_filter_mask(self, fwk, live, states, loop, node_infos,
                          B: int, N: int, reject: Optional[dict] = None
                          ) -> Optional[np.ndarray]:
        """reference: kubetpu/scheduler.py:892-905 — the host filters'
        verdicts per (pod, node) as a [B, N] mask for the pods whose
        ``loop`` entry is set; None when there are none.  reject: when
        given, receives uid -> {reason: rejected node count} for the
        decision audit."""
        host_ok = None
        for i, qp in enumerate(live):
            if not loop[qp.pod.uid]:
                continue
            if host_ok is None:
                host_ok = np.ones((B, N), bool)
            state = states[qp.pod.uid]
            for j, ni in enumerate(node_infos):
                st = fwk.run_filter_plugins(state, qp.pod, ni)
                host_ok[i, j] = st.is_success()
                if reject is not None and not st.is_success():
                    counts = reject.setdefault(qp.pod.uid, {})
                    for r in (st.reasons or ["host filter failed"]):
                        counts[r] = counts.get(r, 0) + 1
        return host_ok

    def _host_score_bias(self, fwk, live, states, node_infos, B: int,
                         N: int) -> Optional[np.ndarray]:
        """reference: kubetpu/scheduler.py:927-962 — host PreScore and
        Score (normalised and weighted) into a [B, N] f32 bias the device
        program adds before selectHost.  Normalisation runs over every
        valid node.  A pod whose PreScore or Score fails keeps its place
        in the batch without host scores (the JAX package's documented
        deviation: one failing plugin must not abort the batch).  None
        when no host score applies."""
        if not fwk.host_score_plugins:
            return None
        node_names = [ni.node_name for ni in node_infos]
        nodes_raw = [ni.node for ni in node_infos]
        bias = np.zeros((B, N), np.float32)
        any_bias = False
        log = logging.getLogger("kubetpu_torch")
        for i, qp in enumerate(live):
            if not any(fwk._relevant(p, qp.pod)
                       for p in fwk.host_score_plugins):
                continue
            state = states[qp.pod.uid]
            st = fwk.run_pre_score_plugins(state, qp.pod, nodes_raw)
            if not st.is_success():
                log.warning("prescore failed for %s: %s; host scores "
                            "dropped", qp.pod.metadata.name, st.message())
                continue
            try:
                plugin_scores = fwk.run_host_score_plugins(state, qp.pod,
                                                           node_names)
            except RuntimeError as e:
                log.warning("host score failed for %s: %s; scores dropped",
                            qp.pod.metadata.name, e)
                continue
            for vals in plugin_scores.values():
                bias[i, :len(vals)] += vals
                any_bias = True
        return bias if any_bias else None

    def _schedule_group(self, fwk: Framework, qpods: List[QueuedPodInfo]
                        ) -> List[ScheduleOutcome]:
        t = time.perf_counter()
        # the event sequence BEFORE the snapshot: a chain is reusable only
        # if no event landed since the state it embeds
        with self._chain_lock:
            chain_seq0 = self._chain_seq
        self.cache.update_snapshot(self.snapshot)
        node_infos = self.snapshot.node_info_list
        n_nodes = len(node_infos)
        # host PreFilter per pod (reference: kubetpu/scheduler.py:680-699);
        # a failure fails the pod, past preemption's help when the plugin
        # says UnschedulableAndUnresolvable
        states: Dict[str, CycleState] = {}
        live: List[QueuedPodInfo] = []
        outcomes: List[ScheduleOutcome] = []
        for qp in qpods:
            state = CycleState()
            st = fwk.run_pre_filter_plugins(state, qp.pod)
            if not st.is_success():
                outcomes.append(self._fail(
                    fwk, qp, st.message() or "prefilter failed",
                    preemption_may_help=(
                        st.code != Code.UNSCHEDULABLE_AND_UNRESOLVABLE),
                    state=state))
                self._record_decision(
                    qp.pod, "unschedulable",
                    message=st.message() or "prefilter failed",
                    blocking=["PreFilter"])
                continue
            states[qp.pod.uid] = state
            live.append(qp)
        if not live:
            self._stage("snapshot", t)
            return outcomes
        if n_nodes == 0:
            for qp in live:
                outcomes.append(self._fail(fwk, qp, "0/0 nodes are available",
                                           preemption_may_help=False,
                                           state=states[qp.pod.uid]))
                self._record_decision(qp.pod, "unschedulable",
                                      message="0/0 nodes are available")
            return outcomes
        spread_sels = [self.store.default_spread_selector(qp.pod)
                       for qp in live]
        pinfos = [PodInfo(qp.pod) for qp in live]
        # nominated pods join the tensor world too (labels and terms for
        # the topology overlay): their strings are interned before the
        # cluster is sized, as the JAX scheduler interns them
        nominated = self.queue.all_nominated()
        nom_pinfos = [PodInfo(p) for p, _ in nominated]
        t = self._stage("snapshot", t)

        # the cycle's cluster: the chained one, or the refreshed resident
        builder, cluster, pod_uids, t = self._cluster_for(
            fwk, node_infos, pinfos + nom_pinfos, chain_seq0, t)
        hbatch = PodBatchBuilder(builder.table).build(
            pinfos, spread_selectors=spread_sels)
        t = self._stage("tensorize", t)
        batch = batch_to_device(hbatch, self.device)
        t = self._stage("upload", t)
        table = builder.table
        B = batch.valid.shape[0]
        N = cluster.allocatable.shape[0]
        # one walk of the host filters' relevance per pod, shared by the
        # host-filter loop and the commit-time re-check
        relevance = self._host_relevance(fwk, live)
        relevant = {uid: rel for uid, (rel, _) in relevance.items()}
        # the volume family on the device: one [B, N] mask in place of
        # ~B x N Python filter calls; a pod whose relevant host filters
        # are all covered by it skips the per-node loop (its filters
        # still run at the commit-time re-check)
        vol_mask = self._volume_mask(fwk, live, node_infos, table, cluster)
        loop = {uid: rel and (vol_mask is None or unc)
                for uid, (rel, unc) in relevance.items()}
        audit = self.decisions.enabled
        host_reject: Dict[str, Dict[str, int]] = {}
        host_mask = self._host_filter_mask(fwk, live, states, loop,
                                           node_infos, B, N,
                                           host_reject if audit else None)
        bias = self._host_score_bias(fwk, live, states, node_infos, B, N)
        batch_topo_keys = self._batch_topo_keys(table, pinfos)
        # host_ok: the host filters' mask, then the volume mask, then the
        # nominated-pods two-pass overlay (addNominatedPods,
        # generic_scheduler.go:530,594-612; None when no nominated pod is
        # relevant), as kubetpu/scheduler.py:963-971 ANDs them
        host_ok = (None if host_mask is None
                   else torch.from_numpy(host_mask).to(self.device))
        if vol_mask is not None:
            host_ok = vol_mask if host_ok is None else host_ok & vol_mask
        nom_mask = self._nominated_overlay_mask(fwk, builder, cluster, batch,
                                                live, node_infos, nominated,
                                                batch_topo_keys)
        if nom_mask is not None:
            host_ok = nom_mask if host_ok is None else host_ok & nom_mask
        score_bias = (None if bias is None
                      else torch.from_numpy(bias).to(self.device))
        t = self._stage("tensorize", t)
        cfg = programs.ProgramConfig(
            filters=fwk.tensor_filters, scores=fwk.tensor_scores,
            hostname_topokey=max(table.topokey.get(api.LABEL_HOSTNAME), 0),
            plugin_args=fwk.tensor_plugin_args(table),
            percentage_of_nodes_to_score=(
                self.config.percentage_of_nodes_to_score),
            active_topo_keys=batch_topo_keys)
        cycle_ctx = CycleContext(
            builder=builder, cluster=cluster, cfg=cfg, node_infos=node_infos,
            batch=batch, row_of={qp.pod.uid: i for i, qp in enumerate(live)},
            host_batch=hbatch)
        # existing-pod rows by uid: the resident's stable rows, or the
        # chain's (neither is the snapshot's node-walk order)
        cycle_ctx.pod_rows = {uid: i for i, uid in enumerate(pod_uids)
                              if uid}

        if self.config.mode == "gang":
            needs_topo = self._needs_topo(live, spread_sels)
            self.gang_backends.append(self._gang_backend(cfg, needs_topo,
                                                         hbatch))
            res = run_auction(cluster, batch, cfg, self._next_rng(),
                              host_ok=host_ok, score_bias=score_bias,
                              intra_batch_topology=needs_topo,
                              kernel_backend=self.gang_backends[-1][0])
            packed = res.packed.cpu().numpy()     # the cycle's one readback
            self.gang_rounds.append(int(packed[3 * B]))
            self.gang_syncs.append(res.syncs)
            # the auction's verdict rows, shared lazily: preemption reads
            # them only if nothing committed since
            cycle_ctx.set_lazy_verdicts(res.feasible0, res.unresolvable)
            t = self._stage("auction", t)
            self._chain_next(fwk, builder, cluster, batch, res, pinfos,
                             pod_uids, chain_seq0, n_nodes)
            t = self._stage("chain", t)
        else:
            start = self._next_start_node_index % n_nodes
            res = schedule_sequential(
                cluster, batch, cfg, self._next_rng(),
                hard_pod_affinity_weight=float(fwk.hard_pod_affinity_weight),
                host_ok=host_ok, start_index=start, score_bias=score_bias)
            packed = res.packed.cpu().numpy()     # the cycle's one readback
            self._next_start_node_index = int(packed[3 * B])
            t = self._stage("auction", t)

        self.cycle_count += 1
        chosen = packed[:B][:len(live)].tolist()
        n_feas = packed[B:2 * B][:len(live)].tolist()
        unres = (packed[2 * B:3 * B][:len(live)] != 0).tolist()
        failed = []
        first = len(outcomes)
        commit_failed = False
        for i, qp in enumerate(live):
            if chosen[i] < 0:
                outcomes.append(None)
                failed.append(i)
                continue
            outcome = self._commit(fwk, qp, states[qp.pod.uid], pinfos[i],
                                   node_infos[chosen[i]].node_name,
                                   n_feas[i], relevant[qp.pod.uid])
            if outcome.node:
                # preemption for pods failing later in this batch must see
                # this placement (CycleContext.cluster_now)
                cycle_ctx.note_commit(i, chosen[i])
                self._record_decision(qp.pod, "scheduled", node=outcome.node,
                                      n_feasible=n_feas[i])
            else:
                commit_failed = True
                self._record_decision(qp.pod, "unschedulable",
                                      message=outcome.err or "commit failed",
                                      n_feasible=n_feas[i])
            outcomes.append(outcome)
        t = self._stage("commit", t)
        # the preemption WAVE: every preemption-eligible failure of the
        # cycle is served by one batched what-if, after every commit has
        # landed; the per-pod PostFilter below reads its verdicts.  Only
        # when DefaultPreemption is the first PostFilter plugin
        wave_pods = [live[i].pod for i in failed if not unres[i]]
        pf = fwk.post_filter_plugins
        if (wave_pods and self.preemptor is not None and pf
                and isinstance(pf[0], DefaultPreemption)):
            try:
                self.preemptor.preempt_wave(fwk, cycle_ctx, wave_pods)
            except Exception:
                # as the JAX scheduler: the wave's pods are then served one
                # by one through the PostFilter; counted, so a run can
                # fail on it
                self.preempt_wave_failures += 1
                logging.getLogger("kubetpu_torch").warning(
                    "preemption wave failed; per-pod fallback",
                    exc_info=True)
        audit_rows = (self._audit_rows(cycle_ctx, [live[i] for i in failed],
                                       host_ok, wave_pods)
                      if failed and audit else {})
        # failures requeue after every commit has landed, as the JAX
        # scheduler defers them: the queue's move-request cycle then
        # reflects this cycle's binds and evictions
        for i in failed:
            qp = live[i]
            msg = f"0/{n_nodes} nodes are available"
            outcomes[first + i] = self._fail(
                fwk, qp, msg, preemption_may_help=not unres[i],
                cycle=cycle_ctx, state=states[qp.pod.uid])
            self._record_decision(
                qp.pod, "unschedulable", message=msg,
                nominated_node=qp.pod.status.nominated_node_name or "",
                host_reasons=host_reject.get(qp.pod.uid),
                **audit_rows.get(qp.pod.uid, {}))
        # a failed commit invalidates the chain: its cluster carries the
        # pod's usage
        if commit_failed and self.config.mode == "gang":
            self._drop_chain()
        self.preempt_stats.append(dict(cycle_ctx.stats))
        self._stage("preempt", t)
        return outcomes

    def _cluster_for(self, fwk: Framework, node_infos, pending, chain_seq0,
                     t: float):
        """reference: kubetpu/scheduler.py:712-826 — the cycle's cluster:
        the chain when its sequence, profile, node count and vocab caps
        still hold, else the profile's DeltaTensorizer refreshed from the
        snapshot (pending: this cycle's and the nominated pods, in that
        order, interned first).  Returns (builder, cluster, pod uid per
        existing-pod row, stage clock); the refresh's host work counts as
        tensorize and its device copies as upload."""
        with self._chain_lock:
            chain = self._chain
        use_chain = (chain is not None and chain["seq"] == chain_seq0
                     and self._chain_enabled()
                     and chain["profile"] == fwk.profile_name
                     and chain["n_nodes"] == len(node_infos))
        if use_chain:
            chain["builder"].intern_pending(pending)
            use_chain = vocab_signature(chain["builder"].table) == \
                chain["caps"]
        if use_chain:
            self.cluster_sources.append("chain")
            return chain["builder"], chain["cluster"], chain["pod_uids"], t
        delta = self._delta.get(fwk.profile_name)
        if delta is None:
            delta = DeltaTensorizer(
                hard_pod_affinity_weight=fwk.hard_pod_affinity_weight,
                device=self.device)
            self._delta[fwk.profile_name] = delta
        # the synchronous cycle keeps no earlier cycle's cluster in flight
        cluster, dstats = delta.refresh(
            node_infos, pending=pending, donate=delta.safe_to_donate(()))
        now = time.perf_counter()
        self.stage_s["upload"] += delta.upload_s
        self.stage_s["tensorize"] += now - t - delta.upload_s
        if dstats.resync:
            self.resync_count += 1
            self.cluster_sources.append(dstats.reason)
        elif dstats.delta_rows > 0:
            self.delta_rows.append(dstats.delta_rows)
            self.delta_cycle_count += 1
            self.cluster_sources.append("delta")
        else:
            self.cluster_sources.append("clean")
        self._drop_chain()
        # after refresh: a compacting resync swaps the builder
        return delta.builder, cluster, delta.pod_uid_list(), now

    def _chain_next(self, fwk, builder, cluster, batch, res, pinfos,
                    pod_uids, chain_seq0: int, n_nodes: int) -> None:
        """reference: kubetpu/scheduler.py:1151-1207 — materialize this
        auction's placements as the next cycle's cluster (before any
        commit, so the cache's pod count excludes this cycle's assumes),
        unless chaining is off or the grown pod axis would land in a
        bigger pow2 bucket than a fresh build would use (pow2 slack
        compounds across cycles; a rebuild compacts it)."""
        B_cap = batch.valid.shape[0]
        p_next = int(cluster.pod_valid.shape[0]) + B_cap
        if (not self._chain_enabled()
                or pow2_bucket(p_next) > pow2_bucket(self.cache.pod_count()
                                                     + 2 * B_cap)):
            self._drop_chain()
            return
        e_next = (int(cluster.filter_terms.valid.shape[0])
                  + B_cap * batch.raa.valid.shape[1])
        next_cluster = materialize_assigned(
            cluster, batch, res.chosen, res.requested, res.nz,
            res.ports_used, pad_pods_to=pow2_bucket(p_next),
            pad_terms_to=pow2_bucket(e_next), extend_score_terms=True,
            hard_pod_affinity_weight=float(fwk.hard_pod_affinity_weight))
        uids = list(pod_uids)
        uids.extend(pi.pod.uid for pi in pinfos)
        uids.extend([None] * (B_cap - len(pinfos)))      # batch padding
        uids.extend([None] * (pow2_bucket(p_next) - len(uids)))
        with self._chain_lock:
            self._chain = dict(builder=builder, cluster=next_cluster,
                               pod_uids=uids, seq=chain_seq0,
                               caps=vocab_signature(builder.table),
                               profile=fwk.profile_name, n_nodes=n_nodes)

    def _nominated_overlay_mask(self, fwk, builder, cluster, batch, qpods,
                                node_infos, nominated, batch_topo_keys=()):
        """reference: kubetpu/scheduler.py:1940-2005 — [B, N] bool device
        mask, False where a pod would not fit once equal-or-greater-
        priority NOMINATED pods count as running on their nominated nodes
        (addNominatedPods, core/generic_scheduler.go:530; the overlay-free
        second pass is the main program).  Both dimensions of AddPod:
        resource capacity (nominated_fit_mask) and topology terms
        (nominated_topology_mask).  A nominated pod in the batch reserves
        capacity against every OTHER row, never its own; batch members are
        left out of the topology overlay (the JAX package's documented
        deviation).  None when no nominated pod is on a snapshot node."""
        uid_to_row = {qp.pod.uid: i for i, qp in enumerate(qpods)}
        node_row = {ni.node_name: j for j, ni in enumerate(node_infos)}
        entries = []
        for pod, nn in nominated:
            row = node_row.get(nn)
            if row is None:
                continue
            entries.append((PodInfo(pod), row, uid_to_row.get(pod.uid, -1)))
        if not entries:
            return None
        nom = nominated_to_device(build_nominated(entries, builder.table),
                                  self.device)
        mask = programs.nominated_fit_mask(cluster, batch, nom)

        # topology overlay: only when the profile runs topology filters and
        # some term could actually interact
        topo_filters = {"InterPodAffinity", "PodTopologySpread"}
        topo_entries = [(pi, row) for pi, row, sr in entries if sr < 0]
        if topo_entries and (topo_filters & set(fwk.tensor_filters)):
            interacts = (
                any(pod_with_affinity(qp.pod)
                    or qp.pod.spec.topology_spread_constraints
                    for qp in qpods)
                or any(pod_with_required_anti_affinity(pi.pod)
                       for pi, _ in topo_entries))
            if interacts:
                nom_pb = PodBatchBuilder(builder.table).build(
                    [pi for pi, _ in topo_entries])
                M = nom_pb.valid.shape[0]
                rows = np.full((M,), -1, np.int32)
                prio = np.zeros((M,), np.int32)
                for i, (pi, row) in enumerate(topo_entries):
                    rows[i] = row
                    prio[i] = pi.pod.priority()
                active = tuple(sorted(
                    set(batch_topo_keys)
                    | set(self._batch_topo_keys(
                        builder.table, [pi for pi, _ in topo_entries]))))
                topo_mask = programs.nominated_topology_mask(
                    cluster, batch_to_device(nom_pb, self.device),
                    torch.from_numpy(rows).to(self.device),
                    torch.from_numpy(prio).to(self.device), batch,
                    programs.ProgramConfig(
                        filters=fwk.tensor_filters, scores=(),
                        hostname_topokey=max(builder.table.topokey.get(
                            api.LABEL_HOSTNAME), 0),
                        active_topo_keys=active))
                mask = mask & topo_mask
        return mask

    def _gang_backend(self, cfg, needs_topo: bool, hbatch
                      ) -> Tuple[str, Optional[str]]:
        """reference: kubetpu/scheduler.py:1372-1380 — the round this
        cycle runs, decided from the host batch (no device read), and
        why a pallas request runs lax."""
        if self.config.kernel_backend != "pallas":
            return "lax", None
        reason = PB.unsupported_reason(cfg, needs_topo, hbatch)
        return ("lax", reason) if reason is not None else ("pallas", None)

    # ------------------------------------------------------------------ commit

    def _commit(self, fwk: Framework, qp: QueuedPodInfo, state: CycleState,
                pinfo: PodInfo, node_name: str, n_feasible: int,
                host_relevant: bool) -> ScheduleOutcome:
        """reference: kubetpu/scheduler.py:2035-2092 — the host-filter
        re-check against the live NodeInfo, Reserve (Unreserve on
        failure), assume (scheduler.go:435), Permit, then the bind cycle,
        in the cycle or on the binder pool.  A commit failure is not a
        FitError, so it never triggers preemption (scheduler.go:542)."""
        pod = qp.pod
        if host_relevant:
            # the pre-batch host_ok mask predates this batch's assumes;
            # the serial reference filters every pod against them
            ni = self.cache.node_info(node_name)
            if ni is not None:
                st = fwk.run_filter_plugins(state, pod, ni)
                if not st.is_success():
                    return self._fail(
                        fwk, qp, st.message()
                        or "commit-time filter re-check failed",
                        preemption_may_help=False, state=state)
        assumed = None
        try:
            st = fwk.run_reserve_plugins(state, pod, node_name)
            if st.is_success():
                assumed = copy.copy(pod)
                assumed.spec = copy.copy(pod.spec)
                assumed.spec.node_name = node_name
                try:
                    self.cache.assume_pod(assumed, pinfo.with_pod(assumed))
                except ValueError as e:
                    assumed, st = None, Status.error(str(e))
                else:
                    st = fwk.run_permit_plugins(state, pod, node_name)
                    if st.code == Code.WAIT:
                        st = Status.success()
        except BaseException:
            # a plugin raised: no reservation or assume outlives the
            # cycle, and schedule_pending's recovery requeues the pod
            self._unassume(fwk, state, pod, assumed, node_name)
            raise
        if not st.is_success():
            self._unassume(fwk, state, pod, assumed, node_name)
            return self._fail(fwk, qp, st.message(),
                              preemption_may_help=False, state=state)
        if self._bind_pool is not None:
            self._inflight_binds.append(self._bind_pool.submit(
                self._bind_cycle, fwk, qp, state, assumed, node_name))
            # the pool owns the pod now: its failures requeue it
            self._settled.add(pod.uid)
            self._prune_binds()
            err = None
        else:
            err = self._bind_cycle(fwk, qp, state, assumed, node_name,
                                   settled=self._settled)
        return ScheduleOutcome(pod=pod, node=node_name if err is None else "",
                               err=err, n_feasible=n_feasible)

    def _bind_cycle(self, fwk: Framework, qp: QueuedPodInfo,
                    state: CycleState, assumed: api.Pod, node_name: str,
                    settled: Optional[set] = None) -> Optional[str]:
        """reference: kubetpu/scheduler.py:2150-2227 (scheduler.go:628-687):
        WaitOnPermit, PreBind, Bind, PostBind; each failure forgets the
        assumed pod, runs Unreserve and requeues the pod.  Returns the
        failure's message, or None once bound.  settled: the cycle's set
        of pods with an outcome, which the pod joins once bound or
        requeued (None on the binder pool, which settled it at submit)."""
        pod = qp.pod
        failed = None
        try:
            for run, what in ((lambda: fwk.wait_on_permit(pod),
                               "permit rejected"),
                              (lambda: fwk.run_pre_bind_plugins(state, pod,
                                                                node_name),
                               "prebind failed"),
                              (lambda: fwk.run_bind_plugins(state, pod,
                                                            node_name),
                               "bind failed")):
                st = run()
                if not st.is_success():
                    failed = st.message()
                    break
            else:
                self.cache.finish_binding(assumed)
        except BaseException:
            # a plugin raised before the bind: the assume goes, and the
            # pod is requeued (here on the pool; by schedule_pending's
            # recovery in the cycle)
            self._unassume(fwk, state, pod, assumed, node_name)
            if settled is None:
                self._record_failure(qp, "bind cycle raised")
            raise
        if failed is not None:
            self._unassume(fwk, state, pod, assumed, node_name)
            self._record_failure(qp, failed)
        if settled is not None:
            settled.add(pod.uid)
        if failed is not None:
            return failed or what
        fwk.run_post_bind_plugins(state, pod, node_name)
        return None

    def _unassume(self, fwk: Framework, state: CycleState, pod: api.Pod,
                  assumed: Optional[api.Pod], node_name: str) -> None:
        """Undo a commit: forget the assumed pod (if it was assumed), then
        run every Unreserve."""
        if assumed is not None:
            self._forget(assumed)
        fwk.run_unreserve_plugins(state, pod, node_name)

    def _forget(self, assumed: api.Pod) -> None:
        # a rolled-back placement invalidates the chained cluster (it may
        # carry this pod's usage); one locked block, so a cycle never sees
        # the bump without the reset
        with self._chain_lock:
            self._chain = None
            self._chain_seq += 1
        try:
            self.cache.forget_pod(assumed)
        except ValueError:
            pass

    def _prune_binds(self) -> None:
        """Drop the ended bind cycles, reading each one's result: an
        exception a plugin raised on a binder thread surfaces here."""
        pending = []
        for f in self._inflight_binds:
            if f.done():
                f.result()
            else:
                pending.append(f)
        self._inflight_binds = pending

    def wait_for_inflight_binds(self, timeout: float = 10.0) -> None:
        """Block until every bind cycle on the binder pool has ended."""
        deadline = time.time() + timeout
        for fut in list(self._inflight_binds):
            fut.result(timeout=max(0.0, deadline - time.time()))
        self._prune_binds()

    def _fail(self, fwk: Framework, qp: QueuedPodInfo, message: str,
              preemption_may_help: bool = True,
              cycle: Optional[CycleContext] = None,
              state: Optional[CycleState] = None) -> ScheduleOutcome:
        """reference: scheduler.go:391 recordSchedulingFailure + :542-563 —
        preemption runs behind the PostFilter extension point
        (framework.go:516; DefaultPreemption)."""
        pod = qp.pod
        nominated = ""
        if preemption_may_help and fwk.post_filter_plugins:
            state = state if state is not None else CycleState()
            if cycle is not None:
                state.write(DefaultPreemption.CYCLE_CONTEXT_KEY, cycle)
            result, st = fwk.run_post_filter_plugins(state, pod)
            if st.is_success() and result is not None:
                nominated = result.nominated_node_name
        self._record_failure(qp, message, nominated)
        # settled only now: a PostFilter that raised leaves the pod to
        # schedule_pending's recovery
        self._settled.add(pod.uid)
        return ScheduleOutcome(pod=pod, node="", err=message,
                               preemption_may_help=preemption_may_help)

    def _record_failure(self, qp: QueuedPodInfo, message: str,
                        nominated_node: str = "") -> None:
        """reference: kubetpu/scheduler.py:2281-2310."""
        pod = qp.pod
        if nominated_node:
            # requeueing re-registers the pod with the nominator from
            # pod.status (queue._add fallback); carry the fresh nomination
            # so it survives (scheduler.go:352)
            pod.status.nominated_node_name = nominated_node
        try:
            # the cycle captured at pop (scheduler.go:515,559)
            self.queue.add_unschedulable_if_not_present(qp,
                                                        qp.scheduling_cycle)
        except ValueError:
            pass
        try:
            self.store.update_pod_condition(
                pod, api.PodCondition(type=api.POD_SCHEDULED,
                                      status="False",
                                      reason=api.REASON_UNSCHEDULABLE,
                                      message=message),
                nominated_node_name=nominated_node)
        except Exception:
            pass

    # ------------------------------------------------------------------ audit

    def _record_decision(self, pod: api.Pod, outcome: str, **kw) -> None:
        """reference: kubetpu/scheduler.py:2315 — fold one pod's decision
        into the bounded DecisionLog (a no-op with the audit off)."""
        if not self.decisions.enabled:
            return
        self.decisions.record(PodDecision(
            name=pod.metadata.name, namespace=pod.namespace, uid=pod.uid,
            outcome=outcome, cycle=self.cycle_count, **kw))

    def _audit_rows(self, cycle_ctx: CycleContext, failed, host_ok,
                    wave_pods) -> Dict[str, Dict]:
        """reference: kubetpu/scheduler.py:1521-1546 — the failed pods'
        audit rows, with the retry-churn dedup: a persistent unschedulable
        tail fails with the same pod set against the same state every
        cycle, so the last rows are reused while nothing committed, nothing
        was evicted and no preemption wave ran."""
        uids = frozenset(qp.pod.uid for qp in failed)
        cached = self._audit_cache
        if (cached is not None and cached[0] == uids
                and cycle_ctx.commits == 0 and not wave_pods):
            return cached[1]
        rows = self._audit_failures(cycle_ctx, failed, host_ok)
        self._audit_cache = (uids, rows)
        return rows

    @staticmethod
    def _audit_failures(cycle_ctx: CycleContext, failed,
                        host_ok) -> Dict[str, Dict]:
        """reference: kubetpu/scheduler.py:2324-2392 — per-plugin
        attribution for the cycle's failed pods: ONE explain_verdicts
        program and ONE packed [2F+3, B] readback against the cycle-start
        cluster.  Every row of the program is its pod's alone, so it runs
        on the failed rows only (gathered when they are fewer than the
        batch), where the reference runs the whole batch.  Returns uid ->
        PodDecision keyword arguments.  A failure of the program raises."""
        batch = cycle_ctx.batch
        rows = [cycle_ctx.row_of[qp.pod.uid] for qp in failed]
        if len(rows) < batch.batch_cap:
            idx = torch.tensor(rows, dtype=torch.int64,
                               device=batch.valid.device)
            batch = take_rows(batch, idx)
            host_ok = None if host_ok is None else host_ok[idx]
            rows = range(len(rows))
        packed = programs.explain_verdicts(
            cycle_ctx.cluster, batch, cycle_ctx.cfg, host_ok).cpu().numpy()
        filters = cycle_ctx.cfg.filters
        F = len(filters)
        counts = packed[:F].tolist()
        blocking = packed[F:2 * F].tolist()
        no_feas = packed[2 * F].tolist()
        best_node = packed[2 * F + 1].tolist()
        best_score = packed[2 * F + 2].tolist()
        node_infos = cycle_ctx.node_infos
        out: Dict[str, Dict] = {}
        for qp, row in zip(failed, rows):
            info: Dict[str, object] = {
                "rejections": {filters[f]: counts[f][row]
                               for f in range(F) if counts[f][row]},
                "blocking": [filters[f] for f in range(F)
                             if blocking[f][row]]}
            if not no_feas[row] and best_node[row] >= 0:
                # feasible at cycle start, lost to in-batch contention:
                # the node it would have scored best on
                info["best_node"] = node_infos[best_node[row]].node_name
                info["best_score"] = best_score[row] / programs.SCORE_SCALE
            out[qp.pod.uid] = info
        return out

    def close(self) -> None:
        self.queue.close()
        self.cache.close()
        if self._bind_pool is not None:
            self._bind_pool.shutdown(wait=False)


def capacity_violations(store: ClusterStore) -> List[str]:
    """Nodes whose bound pods' requests exceed allocatable (cpu, memory,
    pod count) — the end-to-end check a drain must pass."""
    from .framework.types import compute_pod_resource_request
    from .api.resource import Resource
    used: Dict[str, List[int]] = {}
    for pod in store.list("Pod"):
        nn = pod.spec.node_name
        if not nn:
            continue
        r = compute_pod_resource_request(pod)
        u = used.setdefault(nn, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    bad = []
    for node in store.list("Node"):
        alloc = Resource.from_resource_list(node.status.allocatable)
        u = used.get(node.name, [0, 0, 0])
        if (u[0] > alloc.milli_cpu or u[1] > alloc.memory
                or u[2] > alloc.allowed_pod_number):
            bad.append(node.name)
    return bad
