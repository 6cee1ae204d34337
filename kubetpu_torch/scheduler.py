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
package binds on a pool by default, as ``python -m kubetpu_torch`` does.
A Permit plugin that answers Wait needs ``async_binding=True``: the bind
cycle then runs on a pool of binder threads (``wait_for_inflight_binds``).
Placements do not depend on this setting.  A bind that fails with a
transport error retries on the pod backoff ladder (``bind_retries``),
each attempt first asking the store whether the bind landed.

HTTP extenders (extender.py): with any configured, each cycle pops ONE
pod, as the reference's scheduleOne, and never takes the pipelined
executor; the device scores the pod once (programs.filter_and_score)
and the extenders' filters and weighted priorities refine the choice on
the host (``_schedule_with_extenders``).  An extender that binds binds
the pod in place of the Bind plugins.

Events (utils/events.py): an EventBroadcaster on the store records
Scheduled, FailedScheduling, BindRetried and, per evicted pod, Preempted
(``recorder``; a falsy one turns them off).  Fault injection
(utils/chaos.py): ``KUBETPU_CHAOS`` arms the registry at construction;
disarmed, each seam (dispatch here, the delta scatter, the binder, the
extender and REST transports) is one module attribute read, and the
fire counts fold into ``faults_injected`` after each committed cycle.

The recorders (each disarmed by default, one module attribute read per
seam then): the flight recorder (utils/trace.py: one ``Trace`` per
prepared cycle, its stages and per-pod bind spans), the per-pod SLO
tracker (utils/slo.py: ``_slo_prefix`` and ``_slo_observe_terminal``),
the load-telemetry ring (utils/telemetry.py, ticked at the top of
``schedule_pending``), the cycle journal (utils/journal.py: one record
per committed cycle, ``_journal_append``, from the delta or chain
capture of ``_cluster_for``, the RNG fold and start index of the
dispatch, and the host batch and masks) and devstats (utils/devstats.py:
the cycle tick in ``_prepare_group``, the timed dispatch, the settle
after the readback, the residency ledger of the resident and the
chain).  ``device_flops`` sums the analytic FLOPs of every gang cycle
(utils/flops.py).

The guard rails (each disarmed by default): the kernel-library cache
(utils/compilation.py, chosen at construction, ``KUBETPU_KERNEL_CACHE_DIR``),
deploy-time kernel artifacts (utils/aot.py, ``KUBETPU_AOT_DIR`` armed at
construction and preloaded by ``prewarm``; a recovered dispatch fault
disarms them, the aot->build rung), the sanitizer (utils/sanitize.py,
``KUBETPU_SANITIZE=1``: the NaN and rank-promotion checks on the thread of
``schedule_pending``, ``flush_pipeline`` and ``prewarm``, the card's NaN
index read at the cycle's readback) and the race harness
(utils/racecheck.py, ``KUBETPU_RACE=1``: ``Scheduler._chain_lock`` guards
``_chain`` and ``_chain_seq``).

A cycle has the reference's seams: ``_prepare_group`` (host work up to
the dispatch), ``_dispatch_group`` (the device program, the packed copy
and the next cycle's chain), ``_readback_guarded`` (the one readback,
with the dispatch deadline) and ``_commit_group``.  The synchronous drain
runs them in order.  With ``pipeline_cycles`` in gang mode the depth-k
executor (pipeline.py) keeps up to depth - 1 dispatched cycles
uncommitted, with the same placements.  A cycle whose dispatch raises, or
blows ``dispatch_deadline_seconds``, is recovered before anything of it
commits (``_recover_cycle``: its pods requeue, the chain and the resident
drop, the kernel route stays).  An error of the kernel path itself is
never recovered and raises (``ops/_build.kernel_fault``).  ``run`` serves
on a thread that never dies.

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

import contextlib
import copy
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .api import types as api
from .apis.config import KubeSchedulerConfiguration, KubeSchedulerProfile
from .apis.load import validate as validate_config
from .client.store import ClusterStore
from .extender import MAX_EXTENDER_PRIORITY, ExtenderError, HTTPExtender
from .framework import interface as fw
from .framework.interface import Code, CycleState, Status
from .framework.runtime import Framework
from .framework.types import (PodInfo, QueuedPodInfo, pod_with_affinity,
                              pod_with_required_anti_affinity, wallclock)
from .models import programs
from .models.batch import (PodBatchBuilder, batch_to_device, build_nominated,
                           nominated_to_device, take_rows)
from .models.gang import materialize_assigned, run_auction
from .models.sequential import schedule_sequential
from .parallel import mesh as pmesh
from .ops._build import compile_events, kernel_fault, load_propose
from .pipeline import PipelinedExecutor, depth_from_env
from .plugins.intree import DefaultPreemption, new_in_tree_registry
from .preemption import CycleContext, Preemptor
from .schedqueue.queue import SchedulingQueue
from .state import volumes as vstate
from .state.cache import SchedulerCache, Snapshot
from .state.delta import DeltaTensorizer
from .state.tensors import SnapshotBuilder, vocab_signature
from .utils import aot as uaot
from .utils import chaos as uchaos
from .utils import compilation as ucompilation
from .utils import devstats as udevstats
from .utils import journal as ujournal
from .utils import pallas_backend as PB
from .utils import prng
from .utils import sanitize as usanitize
from .utils import slo as uslo
from .utils import telemetry as utelemetry
from .utils import trace as utrace
from .utils.decisions import DecisionLog, PodDecision
from .utils.device import DeviceLike, resolve_device
from .utils.events import EventBroadcaster
from .utils.flops import gang_cycle_flops
from .utils.intern import pow2_bucket
from .utils.trace import Trace


@dataclass
class ScheduleOutcome:
    pod: api.Pod
    node: str = ""                 # "" => unschedulable
    err: Optional[str] = None
    n_feasible: int = 0
    preemption_may_help: bool = True


@dataclass
class PreparedCycle:
    """reference: kubetpu/scheduler.py:76 — one cycle's host state
    between its prepare and its commit: the unit the pipelined drain
    keeps in flight."""
    fwk: Framework
    chain_seq0: int
    node_infos: list
    states: Dict[str, CycleState]
    live: List[QueuedPodInfo]
    pinfos: List[PodInfo]
    builder: object
    cluster: object
    batch: object
    hbatch: object                 # the host batch (routing reads it)
    host_relevant: Dict[str, bool]
    host_ok: Optional[torch.Tensor]
    score_bias: Optional[torch.Tensor]
    cfg: programs.ProgramConfig
    cycle_ctx: CycleContext
    needs_topo: bool = True
    used_chain: bool = False
    pod_uids: list = field(default_factory=list)
    host_reject: Dict[str, Dict[str, int]] = field(default_factory=dict)
    # the relevance walk, kept so a re-prepare never walks it again
    relevance: Optional[Dict[str, Tuple[bool, bool]]] = None
    # host reads of the auction's progress flags (GangResult.syncs)
    syncs: int = 0
    # the deadline's anchor (wallclock at the dispatch; 0 = never
    # dispatched) and the compile-activity count then (deadline armed)
    dispatch_t0: float = 0.0
    compile_snap: Optional[int] = None
    # host seconds spent on other cycles inside this cycle's
    # dispatch->readback window, and the start of its parking between
    # schedule_pending calls: both are exempt from the deadline
    host_exempt_s: float = 0.0
    parked_t: float = 0.0
    # the cycle's flight-recorder handle (utils/trace.py)
    trace: Optional[Trace] = None
    # the packed readback's end and its wait (the SLO device stage)
    readback_done_t: float = 0.0
    device_wait: float = 0.0
    # the pipeline slot this cycle parked in (0 = dispatched straight
    # behind the commit) and the round its auction ran ("pallas"/"lax")
    ring_slot: int = 0
    kernel_backend: str = "lax"
    # the cycle journal's provenance (armed only): the cluster's input,
    # ("resync"|"delta"|"noop", payload) from the DeltaTensorizer or
    # ("chain", pads), and the RNG fold counter and sequential start
    # index the dispatch consumed
    journal_input: Optional[tuple] = None
    journal_rng: int = 0
    journal_start: int = 0
    # devstats: the timed dispatch of a deep cycle (utils/devstats.py
    # ProgramSample; its seconds are read at the readback, and the commit
    # pairs them with the cycle's analytic FLOPs)
    devstats_sample: object = None


# the CycleState key under which a committed pod's bind cycle finds the
# cycle's flight record and the pod's SLO prefix (written only while a
# recorder is armed)
RECORDERS_KEY = "kubetpu_torch/recorders"


def _copy_to_host(packed: torch.Tensor):
    """(host tensor, event, sanitizer probe): a card tensor is copied
    into pinned host memory without blocking, with an event recorded
    after the copy (and after the armed sanitizer's copy of its NaN
    index, usanitize.stage_probe); a CPU tensor is its own host copy."""
    if not packed.is_cuda:
        return packed, None, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    probe = usanitize.stage_probe()
    event = torch.cuda.Event()
    event.record()
    return host, event, probe


class Scheduler:
    """reference: scheduler.go:69.  ``device`` defaults to CUDA; pass
    device="cpu" to run the plain PyTorch path.  registry: the plugin
    factories (default: plugins/intree.new_in_tree_registry(), to which a
    caller adds its own).  async_binding: run each bind cycle on a binder
    pool (see the module docstring).  seed: the first cycle's PRNG key is
    seed + 1.  metrics: a utils/metrics.SchedulerMetrics to feed.
    recorder: the EventRecorder (default: one of an EventBroadcaster on
    the store; a falsy value records no Events)."""

    def __init__(self, store: ClusterStore,
                 config: Optional[KubeSchedulerConfiguration] = None,
                 registry=None, device: DeviceLike = None,
                 async_binding: bool = False, seed: int = 0, metrics=None,
                 recorder=None):
        # the kernel-library cache directory (a first call, by the
        # embedding application, wins), and KUBETPU_AOT_DIR: deploy-time
        # kernel artifacts, which prewarm loads instead of running nvcc
        ucompilation.enable_persistent_cache()
        uaot.maybe_arm_from_env()
        # KUBETPU_CHAOS / KUBETPU_SLO / KUBETPU_JOURNAL / KUBETPU_DEVSTATS
        # / KUBETPU_TELEMETRY arm those (the flight recorder's
        # KUBETPU_FLIGHT, the sanitizer's KUBETPU_SANITIZE and the race
        # harness's KUBETPU_RACE are read once, at the package's import);
        # disarmed (the default) every seam is one attribute read and the
        # hot path takes zero new locks
        uchaos.maybe_arm_from_env()
        uslo.maybe_arm_from_env()
        ujournal.maybe_arm_from_env()
        udevstats.maybe_arm_from_env()
        utelemetry.maybe_arm_from_env()
        self.device = resolve_device(device)
        self.store = store
        self.metrics = metrics
        if recorder is None:
            # reference: profile/profile.go:33 NewRecorderFactory; the
            # store is the event sink
            self.broadcaster = EventBroadcaster(sink=store)
            recorder = self.broadcaster.new_recorder()
        self.recorder = recorder or None
        self.config = config or KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()])
        if not self.config.profiles:
            self.config.profiles = [KubeSchedulerProfile()]
        registry = registry or new_in_tree_registry()
        # plugin existence is checked against the registry the profiles
        # are built from (reference: framework.go:205 NewFramework)
        validate_config(self.config, registry_names=set(registry))
        self.profiles: Dict[str, Framework] = {
            p.scheduler_name: Framework(registry, p, client=store,
                                        metrics=metrics)
            for p in self.config.profiles}
        self.extenders = [HTTPExtender(e) for e in self.config.extenders]
        self.cache = SchedulerCache(
            expire_listener=lambda pod: self._mark_chain_dirty())
        any_fw = next(iter(self.profiles.values()))
        self.queue = SchedulingQueue(
            sort_key=any_fw.queue_sort_key,
            pod_initial_backoff=self.config.pod_initial_backoff_seconds,
            pod_max_backoff=self.config.pod_max_backoff_seconds,
            metrics=metrics)
        self.snapshot = Snapshot()
        self._rng_counter = seed   # PRNGKey(seed + cycle), as the JAX one
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
        # the device mesh (parallel/mesh.py) of mesh_shape=(pods, nodes):
        # every cycle's program is dispatched over it (the resident
        # cluster and the batch stay whole on self.device, the mesh's
        # controller); None = one device
        self._mesh = (pmesh.make_mesh(tuple(self.config.mesh_shape),
                                      self.device)
                      if self.config.mesh_shape else None)
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
        # the last gang cycle's auction rounds, and the seconds blocked on
        # the packed readbacks, summed (the telemetry ring and the perf
        # harness read both)
        self.last_gang_rounds = 0
        self.device_wait_s = 0.0
        # the analytic device FLOPs of every gang cycle, summed
        # (utils/flops.py)
        self.device_flops = 0.0
        # flight-recorder drops already folded into the metric (serving
        # thread only)
        self._flight_dropped_seen = 0
        # the last _cluster_for refresh's DeltaStats (None when chained)
        self._last_refresh = None
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
        # the serving runtime: the dispatch deadline (0 = off; the env
        # overrides the config), the recovery trail (bounded), the two
        # deadline-exempt cycles after a recovery, the last commit's
        # failure flag (the pipelined drain re-runs cycles dispatched
        # against a failed commit's chain)
        dl = os.environ.get("KUBETPU_DISPATCH_DEADLINE")
        self._dispatch_deadline = float(
            dl if dl else self.config.dispatch_deadline_seconds or 0.0)
        self.recovery_log: deque = deque(maxlen=256)
        # chaos fire counts already folded into faults_injected (serving
        # thread only)
        self._chaos_seen: Dict[str, int] = {}
        # journal counters already folded into the scheduler_journal_*
        # metrics, (records_total, dropped_total) (serving thread only)
        self._journal_seen = (0, 0)
        # profiles whose discarded pipelined cycle applied a delta or
        # resync capture that will never be journaled: the profile's
        # next journaled cycle must re-anchor (serving thread only)
        self._journal_force_anchor: set = set()
        # the chain's ledger registration memo, (profile, pads, nodes)
        self._chain_ledger_key = None
        self._deadline_grace = 0
        self._last_commit_failed = False
        # the depth-k pipelined executor (pipeline.py)
        self._pipeline = PipelinedExecutor(
            self, depth_from_env(self.config.pipeline_depth or 2))
        self._stop = threading.Event()
        self._serve_thread: Optional[threading.Thread] = None
        self._closed = False
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
        self._drop_chain_residency()

    def _drop_chain_residency(self) -> None:
        """reference: kubetpu/scheduler.py:463-472 — the residency
        ledger's seam: a discarded chain's cluster is no longer resident.
        Disarmed: one attribute read.  Called outside _chain_lock."""
        ds = udevstats.devstats()
        if ds is not None:
            ds.drop_group("chain")
            self._chain_ledger_key = None

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
        kubetpu/scheduler.py:1225): nothing popped is lost.  With
        ``pipeline_cycles`` in gang mode with the chain on, the depth-k
        executor runs instead (pipeline.py): outcomes lag up to depth - 1
        cycles, and ``flush_pipeline`` returns the rest.  The armed
        sanitizer checks the cycle's ops on this thread."""
        with usanitize.thread_scope():
            return self._schedule_pending(max_batch, timeout)

    def _schedule_pending(self, max_batch: Optional[int],
                          timeout: float) -> List[ScheduleOutcome]:
        # telemetry tick seam: disarmed this is ONE attribute read; armed,
        # one float compare, and a roll once per window
        tel = utelemetry.ring()
        if tel is not None:
            tel.maybe_tick(self)
        max_batch = max_batch or self.config.batch_size
        if self.extenders:
            # an extender is a per-pod HTTP round trip: the reference's
            # serial semantics (scheduler.go:510 pops one pod)
            max_batch = 1
        self._settled = set()
        if (self.config.pipeline_cycles and not self.extenders
                and self.config.mode == "gang" and self.config.chain_cycles):
            return self._pipeline.drain(max_batch, timeout)
        start = wallclock()
        qpods = self.queue.pop_batch(max_batch, timeout=timeout)
        by_profile: Dict[str, List[QueuedPodInfo]] = {}
        for qp in qpods:
            if not self._skip_pod_schedule(qp.pod):
                by_profile.setdefault(qp.pod.spec.scheduler_name,
                                      []).append(qp)
        outcomes: List[ScheduleOutcome] = []
        try:
            for name, group in by_profile.items():
                outcomes.extend(self._schedule_group(self.profiles[name],
                                                     group))
        except BaseException:
            self._requeue_unsettled(
                [qp for group in by_profile.values() for qp in group])
            raise
        if self.metrics and outcomes:
            self.metrics.observe_cycle(len(outcomes), wallclock() - start)
        return outcomes

    def flush_pipeline(self) -> List[ScheduleOutcome]:
        """reference: kubetpu/scheduler.py:551 — commit every in-flight
        pipelined cycle, oldest first."""
        with usanitize.thread_scope():
            return self._pipeline.flush()

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
        """reference: kubetpu/scheduler.py:584 — one synchronous cycle:
        prepare, dispatch, then readback and commit."""
        prep, outcomes = self._prepare_group(fwk, qpods)
        if prep is None:
            return outcomes
        if self.extenders:
            try:
                return outcomes + self._schedule_with_extenders(prep)
            finally:
                prep.trace.finish()
        with prep.trace.stage("dispatch"):
            try:
                res = self._dispatch_group(prep)
            except Exception as e:   # recover, never lose a pod
                out = self._recover_dispatch_error(prep, e)
                prep.trace.finish(recovered="dispatch-error")
                return outcomes + out
        return outcomes + self._finish_group(prep, res)

    def _prepare_group(self, fwk: Framework, qpods: List[QueuedPodInfo],
                       uncommitted: Optional[List["PreparedCycle"]] = None,
                       relevance: Optional[Dict[str, Tuple[bool, bool]]]
                       = None):
        """reference: kubetpu/scheduler.py:630 — the host half of a cycle,
        up to the dispatch: snapshot, PreFilter, the cycle's cluster
        (chained or refreshed), the batch, the host filter and score
        planes and the nominated overlay.  Returns (PreparedCycle or None,
        early outcomes).  uncommitted: every dispatched-but-uncommitted
        pipelined cycle, whose cluster the delta scatter must not update
        in place (None: the executor's ring)."""
        t = time.perf_counter()
        # devstats' cycle tick (kubetpu/scheduler.py:647-663): every Nth
        # prepared cycle is a deep-timing cycle, whose programs are timed
        # by CUDA event pairs (no pre-drain is needed: an event pair
        # times only what runs between its marks).  Disarmed: one read
        ds = udevstats.devstats()
        if ds is not None:
            ds.begin_cycle()
        # queue depths ride the cycle record; the read takes the queue's
        # lock, so it is gated on the recorder being armed
        depths = (self.queue.depths()
                  if utrace.flight_recorder() is not None else None)
        trace = Trace("Scheduling", profile=fwk.profile_name,
                      pods=len(qpods), queue_depths=depths)
        # the event sequence BEFORE the snapshot: a chain is reusable only
        # if no event landed since the state it embeds
        with self._chain_lock:
            chain_seq0 = self._chain_seq
        self.cache.update_snapshot(self.snapshot)
        node_infos = self.snapshot.node_info_list
        n_nodes = len(node_infos)
        trace.step("Snapshotting scheduler cache and node infos done")
        if self.metrics:
            self.metrics.cache_size.set(n_nodes, "nodes")
            self.metrics.cache_size.set(self.cache.pod_count(), "pods")
            self.metrics.cache_size.set(len(self.cache.assumed_pods),
                                        "assumed_pods")
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
            trace.finish()
            return None, outcomes
        if n_nodes == 0:
            for qp in live:
                outcomes.append(self._fail(fwk, qp, "0/0 nodes are available",
                                           preemption_may_help=False,
                                           state=states[qp.pod.uid]))
                self._record_decision(qp.pod, "unschedulable",
                                      message="0/0 nodes are available")
            trace.finish()
            return None, outcomes
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
        if uncommitted is None:
            uncommitted = self._pipeline.inflight_preps()
        builder, cluster, pod_uids, used_chain, journal_input, t = \
            self._cluster_for(fwk, node_infos, pinfos + nom_pinfos,
                              chain_seq0, uncommitted, t)
        dstats = self._last_refresh
        if trace.rec is not None and dstats is not None:
            # the refresh's spans, dirty rows and resync on the record
            rec = trace.rec
            for name, st0, st1 in dstats.spans:
                rec.record_span(name, st0, st1, parent_id=trace.span_id,
                                delta_rows=dstats.delta_rows)
            rec.meta["delta_rows"] = dstats.delta_rows
            rec.meta["resync"] = dstats.resync
            if dstats.resync:
                rec.event("resync", parent_id=trace.span_id,
                          reason=dstats.reason)
        hbatch = PodBatchBuilder(builder.table).build(
            pinfos, spread_selectors=spread_sels)
        t = self._stage("tensorize", t)
        batch = batch_to_device(hbatch, self.device)
        t = self._stage("upload", t)
        table = builder.table
        B = batch.valid.shape[0]
        N = cluster.allocatable.shape[0]
        if trace.rec is not None:
            # the pod-axis bucket this cycle dispatches in
            trace.rec.meta["pod_bucket"] = int(cluster.pod_valid.shape[0])
        # one walk of the host filters' relevance per pod, shared by the
        # host-filter loop and the commit-time re-check (the pipelined
        # drain walks it first, for its serialize decision)
        if relevance is None:
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
        trace.step("Tensorizing snapshot and pod batch done")
        prep = PreparedCycle(
            fwk=fwk, chain_seq0=chain_seq0, node_infos=node_infos,
            states=states, live=live, pinfos=pinfos, builder=builder,
            cluster=cluster, batch=batch, hbatch=hbatch,
            host_relevant=relevant, host_ok=host_ok, score_bias=score_bias,
            cfg=cfg, cycle_ctx=cycle_ctx,
            needs_topo=self._needs_topo(live, spread_sels),
            used_chain=used_chain, pod_uids=pod_uids,
            host_reject=host_reject, relevance=relevance, trace=trace,
            journal_input=journal_input)
        return prep, outcomes

    def _dispatch_group(self, prep: "PreparedCycle",
                        extra_uncommitted: int = 0):
        """reference: kubetpu/scheduler.py:1024 — the device half of a
        cycle: the mode's program, the packed readback's copy to the host
        and, in gang mode, the chained cluster of the next cycle.  Returns
        (packed host copy, copy event).  The port's auction reads a flag
        on the host once per round, so this returns when its last round
        is done; only the packed copy is left in flight.
        extra_uncommitted: pods of earlier cycles whose commits have not
        landed (the chain's bucket guard)."""
        prep.dispatch_t0 = wallclock()
        if self._dispatch_deadline > 0:
            prep.compile_snap = compile_events()
        # chaos seam (utils/chaos.py "dispatch"): an injected error models
        # the device failing under the program, a stall a hung dispatch;
        # both recovered as any dispatch fault (the route is kept)
        uchaos.raise_or_stall("dispatch")
        fresh_pods = self.cache.pod_count() + extra_uncommitted
        t = time.perf_counter()
        # devstats' timing seam (kubetpu/scheduler.py:1102-1131): on a
        # deep cycle the program runs between a CUDA event pair (the CPU:
        # its wall time), read after the cycle's readback.  Disarmed: one
        # attribute read
        operands = (prep.cluster, prep.batch)
        start = 0
        if self.config.mode == "gang":
            backend = self._gang_backend(prep.cfg, prep.needs_topo,
                                         prep.hbatch)
            self.gang_backends.append(backend)
            prep.kernel_backend = backend[0]
            with udevstats.timed("run_auction", self.device,
                                 operands) as sample:
                if self._mesh is not None:
                    res = pmesh.sharded_schedule_gang(
                        prep.cluster, prep.batch, prep.cfg,
                        self._next_rng(), self._mesh, host_ok=prep.host_ok,
                        intra_batch_topology=prep.needs_topo,
                        score_bias=prep.score_bias)
                else:
                    res = run_auction(prep.cluster, prep.batch, prep.cfg,
                                      self._next_rng(), host_ok=prep.host_ok,
                                      score_bias=prep.score_bias,
                                      intra_batch_topology=prep.needs_topo,
                                      kernel_backend=backend[0])
            prep.devstats_sample = sample
            prep.syncs = res.syncs
            # the auction's verdict rows, shared lazily: preemption reads
            # them only if nothing committed since
            prep.cycle_ctx.set_lazy_verdicts(res.feasible0, res.unresolvable)
            packed = _copy_to_host(res.packed)   # the cycle's one readback
            t = self._stage("auction", t)
            self._chain_next(prep, res, fresh_pods)
            self._stage("chain", t)
        else:
            n_nodes = len(prep.node_infos)
            start = self._next_start_node_index % n_nodes
            kw = dict(hard_pod_affinity_weight=float(
                prep.fwk.hard_pod_affinity_weight),
                host_ok=prep.host_ok, start_index=start,
                score_bias=prep.score_bias)
            with udevstats.timed("schedule_sequential", self.device,
                                 operands) as sample:
                if self._mesh is not None:
                    res = pmesh.sharded_schedule_sequential(
                        prep.cluster, prep.batch, prep.cfg,
                        self._next_rng(), self._mesh, **kw)
                else:
                    res = schedule_sequential(prep.cluster, prep.batch,
                                              prep.cfg, self._next_rng(),
                                              **kw)
            prep.devstats_sample = sample
            packed = _copy_to_host(res.packed)
            self._stage("auction", t)
        if ujournal.journal() is not None:
            # the journal's provenance: the RNG fold counter this dispatch
            # consumed and the sequential start index, what the replayer
            # feeds back into the same program
            prep.journal_rng = self._rng_counter
            prep.journal_start = start
        return packed

    def _readback_group(self, prep: "PreparedCycle", res) -> np.ndarray:
        """reference: kubetpu/scheduler.py:1381 — the cycle's ONE
        device->host readback: wait for the packed [3B+1] copy.  The wait
        is the cycle's device-wait (``device_wait_s``, the readback span's
        ``device_wait_s`` and the SLO device stage)."""
        host, event, probe = res
        with prep.trace.stage("packed-readback") as sp:
            t_dev = wallclock()
            if event is not None:
                event.synchronize()
            t_done = wallclock()
            wait = t_done - t_dev
            prep.readback_done_t = t_done
            prep.device_wait = wait
            if sp is not None:
                sp.args["device_wait_s"] = round(wait, 6)
        self.device_wait_s += wait
        sample = prep.devstats_sample
        if sample is not None:
            # devstats: the readback has waited for this cycle's programs,
            # so their event pairs read without a further wait
            ds = udevstats.devstats()
            with prep.trace.stage("device-fence",
                                  program=sample.program) as sp:
                if ds is not None:
                    ds.settle()
                if sp is not None and sample.seconds is not None:
                    sp.args["device_time_s"] = round(sample.seconds, 6)
        # the sanitizer's NaN index, copied before the event just waited on
        usanitize.check_probe(probe)
        return host.numpy()

    def _readback_guarded(self, prep: "PreparedCycle", res):
        """reference: kubetpu/scheduler.py:1300 — (packed, None) on
        success; (None, recovery outcomes) when the cycle's
        dispatch-to-readback wall time, less the host seconds
        spent on other cycles in that window, exceeded the deadline.  A
        cycle during which a kernel library was built or loaded or a CUDA
        graph captured is exempt (legitimate, bounded first-use work),
        as are the two cycles after a recovery."""
        if prep.parked_t:
            # time parked in the in-flight ring is caller think time
            prep.host_exempt_s += wallclock() - prep.parked_t
            prep.parked_t = 0.0
        packed = self._readback_group(prep, res)
        dl = self._dispatch_deadline
        if dl > 0 and prep.dispatch_t0:
            if self._deadline_grace > 0:
                self._deadline_grace -= 1
            else:
                elapsed = (wallclock() - prep.dispatch_t0
                           - prep.host_exempt_s)
                compiled = (prep.compile_snap is not None
                            and compile_events() != prep.compile_snap)
                if not compiled and elapsed > dl:
                    out = self._recover_cycle(
                        prep, "dispatch+readback %.3fs > deadline %.3fs"
                        % (elapsed, dl), "dispatch-deadline")
                    prep.trace.finish(recovered="dispatch-deadline")
                    return None, out
        return packed, None

    def _finish_group(self, prep: "PreparedCycle", res
                      ) -> List[ScheduleOutcome]:
        """reference: kubetpu/scheduler.py:1347 — readback and commit."""
        packed, recovered = self._readback_guarded(prep, res)
        if packed is None:
            # the cycle never happened as far as state goes: its pods are
            # requeued and its residents dropped; a later pipelined cycle
            # dispatched against its chain must re-run too
            self._last_commit_failed = True
            self._sync_flight_dropped()
            return recovered
        with prep.trace.stage("commit"):
            out = self._commit_group(prep, packed)
        self._finish_trace(prep)
        return out

    def _finish_trace(self, prep: "PreparedCycle") -> None:
        """reference: kubetpu/scheduler.py:1359-1369 — commit a committed
        cycle's flight record (gang: with its auction rounds and the round
        it ran) and fold the recorder's drops into the metric."""
        if self.config.mode == "gang":
            prep.trace.finish(auction_rounds=self.last_gang_rounds,
                              kernel_backend=prep.kernel_backend)
        else:
            prep.trace.finish()
        self._sync_flight_dropped()

    def _sync_chaos_metrics(self) -> None:
        """reference: kubetpu/scheduler.py:1769 — fold the armed chaos
        registry's fire counts into faults_injected (serving thread
        only); disarmed this is one attribute read."""
        reg = uchaos.active()
        if reg is None or self.metrics is None:
            return
        for point, n in reg.counts().items():
            seen = self._chaos_seen.get(point, 0)
            if n > seen:
                self.metrics.faults_injected.inc(point, amount=n - seen)
                self._chaos_seen[point] = n

    def _journal_note_discard(self, prep: "PreparedCycle") -> None:
        """reference: kubetpu/scheduler.py:1649-1662 — a prepared cycle is
        discarded without committing (the pipelined executor's
        re-prepare).  If its journal capture carried resident state (a
        delta scatter or a resync), that state is applied on the device
        but will never be journaled: the profile's next journaled cycle
        re-anchors.  Chain and noop captures carry no resident state."""
        if prep.journal_input is not None \
                and prep.journal_input[0] in ("delta", "resync"):
            self._journal_force_anchor.add(prep.fwk.profile_name)

    def _journal_append(self, jr, jr_seq: int, prep: "PreparedCycle",
                        packed: np.ndarray, outcomes, audit_rows) -> None:
        """reference: kubetpu/scheduler.py:1664-1751 — assemble and append
        one cycle record (armed only; the caller turns any failure into a
        counted drop).  The record is self-contained and HOST data only:
        the host batch, the masks read back to numpy, the delta's numpy
        tables, so a card's journal replays on a CPU-only machine."""
        mode = self.config.mode
        fwk, live = prep.fwk, prep.live
        kind, payload = prep.journal_input or ("unknown", None)
        kernel_backend = prep.kernel_backend if mode == "gang" else "lax"
        hard_w = float(fwk.hard_pod_affinity_weight)
        placements: Dict[str, str] = {}
        blocking: Dict[str, int] = {}
        scheduled = failed = 0
        for i, qp in enumerate(live):
            o = outcomes[i] if i < len(outcomes) else None
            node = o.node if o is not None else ""
            placements[qp.pod.metadata.name] = node
            if node:
                scheduled += 1
            else:
                failed += 1
                info = (audit_rows or {}).get(qp.pod.uid, {})
                for plugin in info.get("blocking", []):
                    blocking[plugin] = blocking.get(plugin, 0) + 1
        host_reasons: Dict[str, int] = {}
        for counts in prep.host_reject.values():
            for reason, n in counts.items():
                host_reasons[reason] = host_reasons.get(reason, 0) + n
        flight = prep.trace.rec
        record = {
            "v": ujournal.RECORD_VERSION,
            "seq": jr_seq,
            "cycle": self.cycle_count,
            "ts": time.time(),
            "mode": mode,
            "profile": fwk.profile_name,
            # ---- inputs ----
            "input": kind,
            "input_payload": payload,
            "batch": prep.hbatch,
            "cfg": prep.cfg,
            "host_ok": (prep.host_ok.cpu().numpy()
                        if prep.host_ok is not None else None),
            "score_bias": (prep.score_bias.cpu().numpy()
                           if prep.score_bias is not None else None),
            "needs_topo": bool(prep.needs_topo),
            "rng_counter": int(prep.journal_rng),
            "start_index": int(prep.journal_start),
            "kernel_backend": kernel_backend,
            "hard_pod_affinity_weight": hard_w,
            "mesh": self._mesh is not None,
            "vocab_sig": vocab_signature(prep.builder.table),
            "n_nodes": len(prep.node_infos),
            # node row order on anchor records only: delta and chain
            # records keep it (a node-set change forces a resync)
            "node_names": ([ni.node_name for ni in prep.node_infos]
                           if kind == "resync" else None),
            "config_digest": ujournal.config_digest(
                mode, fwk.profile_name, prep.cfg, hard_w,
                self.config.kernel_backend),
            # ---- outputs ----
            "packed": np.asarray(packed),
            "rounds": self.last_gang_rounds if mode == "gang" else 0,
            "pods": [(qp.pod.metadata.name, qp.pod.namespace, qp.pod.uid)
                     for qp in live],
            "placements": placements,
            "verdicts": {"scheduled": scheduled, "failed": failed,
                         "blocking": blocking,
                         "host_reasons": host_reasons},
            # ---- linkage ----
            "links": {
                "flight_seq": int(flight.seq) if flight is not None else 0,
                "decision_cycle": self.cycle_count,
                "ring_slot": int(prep.ring_slot),
                "pipeline_depth": int(self._pipeline.depth
                                      if self.config.pipeline_cycles
                                      else 1),
            },
        }
        jr.append(record)

    def _sync_journal_metrics(self) -> None:
        """reference: kubetpu/scheduler.py:1753-1767 — fold the armed
        journal's counters into scheduler_journal_* (serving thread
        only); disarmed this is one attribute read."""
        jr = ujournal.journal()
        if jr is None or self.metrics is None:
            return
        records, dropped = jr.counters()
        seen_r, seen_d = self._journal_seen
        if records > seen_r:
            self.metrics.journal_records.inc(amount=records - seen_r)
        if dropped > seen_d:
            self.metrics.journal_dropped.inc(amount=dropped - seen_d)
        self._journal_seen = (max(records, seen_r), max(dropped, seen_d))
        self.metrics.journal_bytes.set(jr.disk_bytes())

    def _sync_flight_dropped(self) -> None:
        """reference: kubetpu/scheduler.py:1782 — fold the chaos fire
        counts, the journal's counters and new flight-recorder ring drops
        into their monotonic metric counters (serving thread only, so the
        seen-counts need no lock); disarmed this is three attribute
        reads."""
        self._sync_chaos_metrics()
        self._sync_journal_metrics()
        fr = utrace.flight_recorder()
        if fr is None or self.metrics is None:
            return
        dropped = fr.dropped()
        if dropped > self._flight_dropped_seen:
            self.metrics.flight_recorder_dropped.inc(
                amount=dropped - self._flight_dropped_seen)
        if dropped != self._flight_dropped_seen:
            # < happens when the ring was cleared or re-armed mid-run
            self._flight_dropped_seen = dropped

    def _commit_group(self, prep: "PreparedCycle", packed: np.ndarray
                      ) -> List[ScheduleOutcome]:
        """reference: kubetpu/scheduler.py:1403 — commit each placement in
        pod order; failures go through the preemption wave and the
        PostFilter after every commit has landed."""
        t = time.perf_counter()
        fwk, live, states, pinfos = (prep.fwk, prep.live, prep.states,
                                     prep.pinfos)
        node_infos, cycle_ctx, trace = prep.node_infos, prep.cycle_ctx, \
            prep.trace
        n_nodes = len(node_infos)
        B = prep.batch.valid.shape[0]
        self.cycle_count += 1
        if self.config.mode == "gang":
            self.last_gang_rounds = int(packed[3 * B])
            self.gang_rounds.append(self.last_gang_rounds)
            self.gang_syncs.append(prep.syncs)
            # the cycle's analytic FLOPs (kubetpu/scheduler.py:1416-1431),
            # paired on a deep cycle with its own timed seconds
            cyc_flops = gang_cycle_flops(
                prep.cluster, prep.batch, prep.cfg, self.last_gang_rounds,
                intra_batch_topology=prep.needs_topo,
                kernel_backend=prep.kernel_backend)
            self.device_flops += cyc_flops
            sample = prep.devstats_sample
            if sample is not None and sample.seconds is not None:
                ds = udevstats.devstats()
                if ds is not None:
                    ds.attribute_flops("run_auction", cyc_flops,
                                       sample.seconds, sample.in_bytes)
        else:
            self._next_start_node_index = int(packed[3 * B])
        chosen = packed[:B][:len(live)].tolist()
        n_feas = packed[B:2 * B][:len(live)].tolist()
        unres = (packed[2 * B:3 * B][:len(live)] != 0).tolist()
        trace.step("Computing predicates and priorities on device done")
        flight = trace.rec
        # per-pod latency SLO (utils/slo.py): one tracker read per cycle;
        # disarmed, no stage vector is built and no clock is read
        slo_trk = uslo.tracker()
        # the cycle journal (utils/journal.py): this cycle's record id,
        # reserved up front so its pods' SLO exemplars carry it (the record
        # appends after the commit loop).  Disarmed: one attribute read
        jr = ujournal.journal()
        jr_seq = jr.next_seq() if jr is not None else 0
        slo_host_dispatch = 0.0
        if slo_trk is not None and prep.dispatch_t0:
            # the host share of the dispatch->readback window, less the
            # window's host-exempt share (other ring slots' commits and
            # readbacks, pipelined parking), as the JAX package splits it
            slo_host_dispatch = max(prep.readback_done_t - prep.dispatch_t0
                                    - prep.device_wait
                                    - prep.host_exempt_s, 0.0)
        outcomes: List[Optional[ScheduleOutcome]] = []
        failed = []
        commit_failed = False
        for i, qp in enumerate(live):
            if chosen[i] < 0:
                outcomes.append(None)
                failed.append(i)
                continue
            state = states[qp.pod.uid]
            slo = (self._slo_prefix(qp, prep, slo_host_dispatch, flight,
                                    jr_seq)
                   if slo_trk is not None and qp.pop_timestamp else None)
            if flight is not None or slo is not None:
                # the bind cycle's recorder handles ride the pod's state
                state.write(RECORDERS_KEY, (flight, slo))
            outcome = self._commit(fwk, qp, state, pinfos[i],
                                   node_infos[chosen[i]].node_name,
                                   n_feas[i], prep.host_relevant[qp.pod.uid])
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
                with trace.stage("preemption-wave", pods=len(wave_pods)):
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
                                       prep.host_ok, wave_pods, trace)
                      if failed and self.decisions.enabled else {})
        # failures requeue after every commit has landed, as the JAX
        # scheduler defers them: the queue's move-request cycle then
        # reflects this cycle's binds and evictions
        for i in failed:
            qp = live[i]
            msg = f"0/{n_nodes} nodes are available"
            outcomes[i] = self._fail(
                fwk, qp, msg, preemption_may_help=not unres[i],
                cycle=cycle_ctx, state=states[qp.pod.uid])
            self._record_decision(
                qp.pod, "unschedulable", message=msg,
                nominated_node=qp.pod.status.nominated_node_name or "",
                host_reasons=prep.host_reject.get(qp.pod.uid),
                **audit_rows.get(qp.pod.uid, {}))
            if (slo_trk is not None and unres[i] and qp.pop_timestamp
                    and not qp.slo_unres_observed):
                # terminally unresolvable this cycle: record the vector
                # now (there is no bind stage to wait for), once per pod
                # (the requeued pod retries every cluster event)
                qp.slo_unres_observed = True
                self._slo_observe_terminal(
                    slo_trk,
                    self._slo_prefix(qp, prep, slo_host_dispatch, flight,
                                     jr_seq),
                    qp, "unresolvable")
        # a failed commit invalidates the chain (its cluster carries the
        # pod's usage) and every pipelined cycle dispatched against it
        self._last_commit_failed = commit_failed
        if commit_failed and self.config.mode == "gang":
            self._drop_chain()
        if jr is not None:
            # one self-contained replayable record per committed cycle;
            # any failure is a counted drop, never a failed cycle
            try:
                self._journal_append(jr, jr_seq, prep, packed, outcomes,
                                     audit_rows)
            except Exception:
                jr.note_drop()
                logging.getLogger("kubetpu_torch").warning(
                    "cycle journal record %d dropped", jr_seq,
                    exc_info=True)
        self.preempt_stats.append(dict(cycle_ctx.stats))
        self._stage("preempt", t)
        trace.step("Committing placements done")
        trace.log_if_long()
        return outcomes

    @staticmethod
    def _slo_prefix(qp: QueuedPodInfo, prep: "PreparedCycle",
                    host_dispatch: float, flight,
                    journal_seq: int = 0) -> Dict[str, float]:
        """reference: kubetpu/scheduler.py:1602 — the cycle-side half of a
        pod's per-stage latency vector (utils/slo.py):
        queue_wait/backoff/cycle_wait/dispatch/device, plus the
        underscore keys the terminal observer pops (the readback anchor
        of the commit stage, the flight-recorder cycle seq and the
        journal record id the exemplar links to).  Called only with the
        tracker armed and a stamped pop time."""
        return {
            "queue_wait": max(qp.pop_timestamp - qp.timestamp, 0.0),
            "backoff": max(qp.timestamp - qp.initial_attempt_timestamp,
                           0.0),
            "cycle_wait": max((prep.dispatch_t0 or qp.pop_timestamp)
                              - qp.pop_timestamp, 0.0),
            "dispatch": host_dispatch,
            "device": prep.device_wait,
            "_readback_done_t": prep.readback_done_t,
            "_flight_seq": float(flight.seq) if flight is not None else 0.0,
            "_journal_seq": float(journal_seq),
        }

    def _slo_observe_terminal(self, trk, prefix: Dict[str, float],
                              qp: QueuedPodInfo, outcome: str,
                              bind_start: Optional[float] = None) -> None:
        """reference: kubetpu/scheduler.py:1625 — complete a pod's
        cycle-side stage vector with the terminal stages (commit:
        readback -> bind start, or -> now for failures; bind, when one
        ran; e2e) and record it."""
        now = wallclock()
        stages = dict(prefix)
        seq = stages.pop("_flight_seq", 0)
        jseq = stages.pop("_journal_seq", 0)
        rb = stages.pop("_readback_done_t", 0.0)
        end = bind_start if bind_start is not None else now
        stages["commit"] = max(end - rb, 0.0)
        if bind_start is not None:
            stages["bind"] = max(now - bind_start, 0.0)
        stages["e2e"] = now - qp.initial_attempt_timestamp
        pod = qp.pod
        trk.observe_pod(stages, pod=pod.metadata.name,
                        namespace=pod.namespace, uid=pod.uid,
                        outcome=outcome, attempts=qp.attempts,
                        cycle=self.cycle_count, flight_seq=int(seq),
                        journal_seq=int(jseq))

    def _cluster_for(self, fwk: Framework, node_infos, pending, chain_seq0,
                     uncommitted, t: float):
        """reference: kubetpu/scheduler.py:712-826 — the cycle's cluster:
        the chain when its sequence, profile, node count and vocab caps
        still hold, else the profile's DeltaTensorizer refreshed from the
        snapshot (pending: this cycle's and the nominated pods, in that
        order, interned first).  The scatter updates the resident in place
        only while no cycle in ``uncommitted`` reads it.  Returns
        (builder, cluster, pod uid per existing-pod row, chained?, stage
        clock); the refresh's host work counts as tensorize and its device
        copies as upload.  ``_last_refresh`` keeps the refresh's
        DeltaStats (None for a chained cycle) for the flight record."""
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
            self._last_refresh = None
            # the journal's provenance: the previous cycle's auction,
            # materialized at the chain's pad buckets
            journal_input = (("chain", chain["pads"])
                             if ujournal.journal() is not None else None)
            return (chain["builder"], chain["cluster"], chain["pod_uids"],
                    True, journal_input, t)
        delta = self._delta.get(fwk.profile_name)
        if delta is None:
            delta = DeltaTensorizer(
                hard_pod_affinity_weight=fwk.hard_pod_affinity_weight,
                device=self.device, profile=fwk.profile_name)
            self._delta[fwk.profile_name] = delta
        cluster, dstats = delta.refresh(
            node_infos, pending=pending,
            donate=delta.safe_to_donate([p.cluster for p in uncommitted]))
        now = time.perf_counter()
        self.stage_s["upload"] += delta.upload_s
        self.stage_s["tensorize"] += now - t - delta.upload_s
        self._last_refresh = dstats
        if dstats.resync:
            self.resync_count += 1
            self.cluster_sources.append(dstats.reason)
            if dstats.reason == "verify-divergence":
                # the anti-entropy verifier caught the residents diverging
                # from the host mirror: a recovery, not churn
                # (kubetpu/scheduler.py:788-799)
                self.recovery_log.append(
                    {"kind": "verify-resync", "reason": dstats.reason,
                     "cycle": self.cycle_count})
                if self.metrics is not None:
                    self.metrics.recoveries.inc("verify-resync")
        elif dstats.delta_rows > 0:
            self.delta_rows.append(dstats.delta_rows)
            self.delta_cycle_count += 1
            self.cluster_sources.append("delta")
        else:
            self.cluster_sources.append("clean")
        # the journal's capture seam (kubetpu/scheduler.py:807-824): the
        # resync snapshot, delta tables or zero-dirty marker this refresh
        # applied; None when the journal is disarmed
        journal_input = delta.take_capture()
        if journal_input is not None:
            if (fwk.profile_name in self._journal_force_anchor
                    and journal_input[0] != "resync"):
                # a discarded cycle of this profile applied a capture that
                # never journaled, so the resident is ahead of the journal:
                # re-anchor from the mirror (equal to the resident after
                # any successful refresh, the verifier's invariant)
                delta._capture_resync()
                journal_input = delta.take_capture()
            self._journal_force_anchor.discard(fwk.profile_name)
        self._drop_chain()
        # after refresh: a compacting resync swaps the builder
        return (delta.builder, cluster, delta.pod_uid_list(), False,
                journal_input, now)

    def _chain_next(self, prep: "PreparedCycle", res,
                    fresh_pods: int) -> None:
        """reference: kubetpu/scheduler.py:1151-1207 — materialize this
        auction's placements as the next cycle's cluster (before any
        commit), unless chaining is off or the grown pod axis would land
        in a bigger pow2 bucket than a fresh build would use (pow2 slack
        compounds across cycles; a rebuild compacts it).  fresh_pods: the
        cache's pod count at the dispatch plus the pods of cycles
        dispatched but not committed."""
        cluster, batch = prep.cluster, prep.batch
        B_cap = batch.valid.shape[0]
        p_next = int(cluster.pod_valid.shape[0]) + B_cap
        if (not self._chain_enabled()
                or pow2_bucket(p_next) > pow2_bucket(fresh_pods
                                                     + 2 * B_cap)):
            self._drop_chain()
            return
        e_next = (int(cluster.filter_terms.valid.shape[0])
                  + B_cap * batch.raa.valid.shape[1])
        next_cluster = materialize_assigned(
            cluster, batch, res.chosen, res.requested, res.nz,
            res.ports_used, pad_pods_to=pow2_bucket(p_next),
            pad_terms_to=pow2_bucket(e_next), extend_score_terms=True,
            hard_pod_affinity_weight=float(
                prep.fwk.hard_pod_affinity_weight))
        uids = list(prep.pod_uids)
        uids.extend(pi.pod.uid for pi in prep.pinfos)
        uids.extend([None] * (B_cap - len(prep.pinfos)))    # batch padding
        uids.extend([None] * (pow2_bucket(p_next) - len(uids)))
        pads = (pow2_bucket(p_next), pow2_bucket(e_next))
        n_nodes = len(prep.node_infos)
        with self._chain_lock:
            # pads: the journal's provenance, what a chained successor
            # feeds back into materialize_assigned to rebuild this cluster
            self._chain = dict(builder=prep.builder, cluster=next_cluster,
                               pod_uids=uids, seq=prep.chain_seq0,
                               caps=vocab_signature(prep.builder.table),
                               profile=prep.fwk.profile_name,
                               n_nodes=n_nodes, pads=pads)
        # the residency ledger's seam (kubetpu/scheduler.py:1197-1215):
        # the chain is a second resident cluster until the next cycle
        # takes it; registered again only when its shapes move (the
        # has_group check backstops a binder thread's discard)
        ds = udevstats.devstats()
        if ds is not None:
            lkey = (prep.fwk.profile_name,) + pads + (n_nodes,)
            if self._chain_ledger_key != lkey or not ds.has_group("chain"):
                udevstats.register_cluster(
                    "chain", prep.fwk.profile_name, next_cluster, n_nodes,
                    meta={"pads": list(pads)})
                self._chain_ledger_key = lkey

    # ------------------------------------------------------------- recovery

    def _recover_dispatch_error(self, prep: "PreparedCycle",
                                e: Exception) -> List[ScheduleOutcome]:
        """A dispatch that raised: recover the cycle, unless the error is
        the kernel path's own (kernel_fault); then the cycle's pods go
        back to the queue and the error propagates."""
        if kernel_fault(e):
            self._requeue_unsettled(prep.live)
            raise e
        return self._recover_cycle(prep, repr(e), "dispatch-error")

    def _recover_cycle(self, prep: "PreparedCycle", reason: str,
                       kind: str) -> List[ScheduleOutcome]:
        """reference: kubetpu/scheduler.py:1225 — the recovery of a cycle
        whose dispatch raised or blew its deadline (kind
        "dispatch-error" / "dispatch-deadline"), before anything of it
        committed: drop the chain and the profile's resident (the next
        cycle resyncs), and requeue the cycle's pods through backoff; the
        next two cycles are exempt from the deadline.  Unlike the
        reference, the kernel route is kept: the port never hands a
        cycle to the plain round because the kernel path failed
        (utils/pallas_backend.demote is the operator's alone), so the
        one rung a fault demotes is an armed AOT runtime's (aot->build,
        the reference's aot->trace): its libraries build from source
        from then on.  Never raises."""
        logging.getLogger("kubetpu_torch").warning(
            "cycle recovery (%s): %s; %d pods requeued", kind, reason,
            len(prep.live))
        demoted = []
        if uaot.active_runtime() is not None:
            uaot.disarm(reason="%s: %s" % (kind, reason[:200]))
            demoted.append("aot->build")
        with self._chain_lock:
            self._chain = None
            self._chain_seq += 1
        self._delta.pop(prep.fwk.profile_name, None)
        for qp in prep.live:
            try:
                self.queue.add_unschedulable_if_not_present(
                    qp, qp.scheduling_cycle)
            except ValueError:
                pass
            self._settled.add(qp.pod.uid)
        # unschedulable -> backoff/active now; each pod's own backoff
        # paces the retry
        self.queue.move_all_to_active_or_backoff_queue("DispatchRecovery")
        self._deadline_grace = 2
        entry = {"kind": kind, "reason": reason, "pods": len(prep.live),
                 "cycle": self.cycle_count}
        if demoted:
            entry["demoted"] = demoted
        self.recovery_log.append(entry)
        if self.metrics is not None:
            self.metrics.recoveries.inc(kind)
        if prep.trace.rec is not None:
            # the incident instant on the cycle's record
            prep.trace.rec.event(
                "backend-demotion" if demoted else "dispatch-recovery",
                kind=kind, reason=reason[:256], demoted=",".join(demoted))
        err = f"dispatch recovered ({kind}): pod requeued"
        return [ScheduleOutcome(pod=qp.pod, node="", err=err)
                for qp in prep.live]

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
        if self._mesh is not None:
            # the mesh runs the lax round (its tiles, or the replicated
            # program), as kubetpu/scheduler.py:1375 routes it
            return "lax", "mesh"
        reason = PB.unsupported_reason(cfg, needs_topo, hbatch)
        return ("lax", reason) if reason is not None else ("pallas", None)

    # --------------------------------------------------------------- extenders

    def _schedule_with_extenders(self, prep: "PreparedCycle"
                                 ) -> List[ScheduleOutcome]:
        """reference: kubetpu/scheduler.py:1799-1916
        (generic_scheduler.go:497 findNodesThatPassExtenders, :674-706
        the extender Prioritize combine) — one filter-and-score program
        for the batch on the device and ONE readback of its feasibility,
        scores and host score bias; then per pod, on the host: the fit
        re-check against live usage, the extenders' filters (never
        admitting a node outside the device-feasible set), the device
        score plus the bias plus the weighted extender priorities scaled
        to MAX_NODE_SCORE, and a seeded tie-break.  An extender that
        binds binds the pod.  A failed extender fails the pod (unless it
        is ignorable); a pod no node passes goes through the PostFilter."""
        import random
        t = time.perf_counter()
        fwk, live, states = prep.fwk, prep.live, prep.states
        node_infos, cycle_ctx = prep.node_infos, prep.cycle_ctx
        if self._mesh is not None:
            res = pmesh.sharded_filter_and_score(
                prep.cluster, prep.batch, prep.cfg, self._mesh,
                host_ok=prep.host_ok)
        else:
            res = programs.filter_and_score(prep.cluster, prep.batch,
                                            prep.cfg, prep.host_ok)
        planes = [res.feasible.to(res.scores.dtype), res.scores]
        if prep.score_bias is not None:
            planes.append(prep.score_bias.to(res.scores.dtype))
        host = torch.stack(planes).cpu().numpy()
        feasible = (host[0] != 0).tolist()
        score_arr = host[1]
        if prep.score_bias is not None:
            score_arr = score_arr + host[2]
        scores = score_arr.tolist()
        t = self._stage("auction", t)
        self.cycle_count += 1
        n_nodes = len(node_infos)
        node_names = [ni.node_name for ni in node_infos]
        row_of_node = {n: j for j, n in enumerate(node_names)}
        outcomes: List[ScheduleOutcome] = []
        for i, qp in enumerate(live):
            state = states[qp.pod.uid]
            row_feas = feasible[i]
            names = [node_names[j] for j in range(n_nodes) if row_feas[j]]
            # the device mask predates this cycle's assumes: re-check fit
            # against the live usage, so two pods of one batch cannot
            # oversubscribe a node
            pod_res = prep.pinfos[i].resource
            names = [n for n in names
                     if self._fits_live(pod_res, self.cache.node_fit_view(n))]
            row_scores = scores[i]
            dev_score = {node_names[j]: row_scores[j]
                         for j in range(n_nodes) if row_feas[j]}
            exts = [e for e in self.extenders if e.is_interested(qp.pod)]
            err = None
            ext_info: Dict[str, str] = {}
            try:
                for e in exts:
                    before = len(names)
                    names, _ = e.filter(qp.pod, names)
                    # an extender may echo names outside the device-
                    # feasible set (stale cache, typo): never admit those
                    names = [n for n in names if n in dev_score]
                    ext_info[e.url_prefix or "extender"] = (
                        f"filter {before} -> {len(names)} nodes")
                    if not names:
                        break
            except ExtenderError as ex:
                err = f"extender filter failed: {ex}"
            if err is not None:
                outcomes.append(self._fail(fwk, qp, err,
                                           preemption_may_help=False,
                                           state=state))
                self._record_decision(qp.pod, "unschedulable", message=err,
                                      extenders=ext_info)
                continue
            if not names:
                msg = f"0/{n_nodes} nodes are available"
                outcomes.append(self._fail(fwk, qp, msg, cycle=cycle_ctx,
                                           state=state))
                self._record_decision(qp.pod, "unschedulable", message=msg,
                                      extenders=ext_info)
                continue
            combined = {n: 0.0 for n in names}
            try:
                for e in exts:
                    for n, sc in e.prioritize(qp.pod, names).items():
                        if n in combined:
                            combined[n] += sc
            except ExtenderError as ex:
                msg = f"extender prioritize failed: {ex}"
                outcomes.append(self._fail(fwk, qp, msg,
                                           preemption_may_help=False,
                                           state=state))
                self._record_decision(qp.pod, "unschedulable", message=msg,
                                      extenders=ext_info)
                continue
            scale = fw.MAX_NODE_SCORE / MAX_EXTENDER_PRIORITY
            totals = {n: dev_score[n] + combined[n] * scale for n in names}
            best = max(totals.values())
            ties = [n for n in names if totals[n] == best]
            self._rng_counter += 1
            node_name = random.Random(self._rng_counter).choice(ties)
            binders = [e for e in exts if e.is_binder()]
            binder = binders[0].bind if binders else None
            outcome = self._commit(fwk, qp, state, prep.pinfos[i], node_name,
                                   len(names),
                                   prep.host_relevant[qp.pod.uid],
                                   binder_override=binder)
            if outcome.node:
                cycle_ctx.note_commit(i, row_of_node[node_name])
            self._record_decision(
                qp.pod, "scheduled" if outcome.node else "unschedulable",
                node=outcome.node, message=outcome.err or "",
                n_feasible=len(names), extenders=ext_info)
            outcomes.append(outcome)
        self._stage("commit", t)
        return outcomes

    @staticmethod
    def _fits_live(pod_res, view) -> bool:
        """reference: kubetpu/scheduler.py:2009 — NodeResourcesFit's
        essentials against a live fit view (cache.node_fit_view:
        allocatable, requested, pod count; noderesources/fit.go:194-267):
        the pod count always, each channel only when requested."""
        if view is None:
            return False
        alloc, req, n_pods = view
        if n_pods + 1 > alloc.allowed_pod_number:
            return False
        r = pod_res
        if r.milli_cpu > 0 and r.milli_cpu > alloc.milli_cpu - req.milli_cpu:
            return False
        if r.memory > 0 and r.memory > alloc.memory - req.memory:
            return False
        if (r.ephemeral_storage > 0 and r.ephemeral_storage
                > alloc.ephemeral_storage - req.ephemeral_storage):
            return False
        for k, v in r.scalar_resources.items():
            if v > 0 and v > (alloc.scalar_resources.get(k, 0)
                              - req.scalar_resources.get(k, 0)):
                return False
        return True

    # ------------------------------------------------------------------ commit

    def _commit(self, fwk: Framework, qp: QueuedPodInfo, state: CycleState,
                pinfo: PodInfo, node_name: str, n_feasible: int,
                host_relevant: bool, binder_override=None
                ) -> ScheduleOutcome:
        """reference: kubetpu/scheduler.py:2035-2092 — the host-filter
        re-check against the live NodeInfo, Reserve (Unreserve on
        failure), assume (scheduler.go:435), Permit, then the bind cycle,
        in the cycle or on the binder pool.  A commit failure is not a
        FitError, so it never triggers preemption (scheduler.go:542).
        binder_override: the binding extender's bind(pod, node), run in
        place of the Bind plugins."""
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
                self._bind_cycle, fwk, qp, state, assumed, node_name,
                binder_override=binder_override))
            # the pool owns the pod now: its failures requeue it
            self._settled.add(pod.uid)
            self._prune_binds()
            err = None
        else:
            err = self._bind_cycle(fwk, qp, state, assumed, node_name,
                                   settled=self._settled,
                                   binder_override=binder_override)
        return ScheduleOutcome(pod=pod, node=node_name if err is None else "",
                               err=err, n_feasible=n_feasible)

    def _bind_cycle(self, fwk: Framework, qp: QueuedPodInfo,
                    state: CycleState, assumed: api.Pod, node_name: str,
                    settled: Optional[set] = None,
                    binder_override=None) -> Optional[str]:
        """reference: kubetpu/scheduler.py:2121-2227 (scheduler.go:628-687):
        WaitOnPermit, PreBind, Bind, PostBind; each failure forgets the
        assumed pod, runs Unreserve and requeues the pod.  Returns the
        failure's message, or None once bound.  settled: the cycle's set
        of pods with an outcome, which the pod joins once bound or
        requeued (None on the binder pool, which settled it at submit).
        Runs under a "bind" span on the cycle's flight record (from
        whichever thread runs it; capped per record) when the recorder is
        armed; the pod's SLO prefix, when the tracker is armed, is
        completed once the pod is bound.  binder_override: the binding
        extender's bind (reference: scheduler.go:457 extendersBinding),
        run in place of the Bind plugins and their retry ladder.  Both ride the pod's CycleState
        (RECORDERS_KEY); disarmed this reads two module attributes."""
        flight = slo = None
        if (utrace.flight_recorder() is not None
                or uslo.tracker() is not None):
            try:
                flight, slo = state.read(RECORDERS_KEY)
            except KeyError:
                pass
        with (flight.span("bind", pod=qp.pod.metadata.name, node=node_name)
              if flight is not None else utrace._NULL_SPAN):
            pod = qp.pod
            failed = None
            # the bind's start (after PreBind, as the JAX scheduler stamps it):
            # binding_duration and the SLO commit/bind split read it
            bind_start = 0.0

            def bind() -> Status:
                nonlocal bind_start
                bind_start = wallclock()
                if binder_override is None:
                    return self._bind_with_retries(fwk, state, pod,
                                                   node_name)
                try:
                    binder_override(pod, node_name)
                except Exception as e:
                    return Status.error(f"extender bind failed: {e}")
                return Status.success()
            try:
                for run, what in ((lambda: fwk.wait_on_permit(pod),
                                   "permit rejected"),
                                  (lambda: fwk.run_pre_bind_plugins(state, pod,
                                                                    node_name),
                                   "prebind failed"),
                                  (bind, "bind failed")):
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
            if self.metrics:
                now = wallclock()
                self.metrics.binding_duration.observe(now - bind_start)
                self.metrics.pod_scheduled(
                    qp.attempts, now - qp.initial_attempt_timestamp,
                    now - qp.timestamp)
            if slo is not None:
                trk = uslo.tracker()
                if trk is not None:
                    self._slo_observe_terminal(trk, slo, qp, "bound",
                                               bind_start=bind_start)
            if self.recorder:
                self.recorder.event(pod, "Normal", "Scheduled",
                                    f"Successfully assigned "
                                    f"{pod.namespace}/{pod.metadata.name} "
                                    f"to {node_name}")
            return None

    def _bind_with_retries(self, fwk: Framework, state: CycleState,
                           pod: api.Pod, node_name: str) -> Status:
        """reference: kubetpu/scheduler.py:2170-2215 — Bind, and the
        transient-bind retry ladder: a bind that failed with a transport
        error ("binding rejected: ..." from DefaultBinder) retries up to
        ``bind_retries`` times, sleeping the pod backoff ladder between
        attempts.  Bind is not idempotent, so each attempt first asks the
        store: a bind that landed with its response lost is a success
        without a second POST, and a pod that is gone or bound elsewhere
        stops the ladder at once."""
        st = fwk.run_bind_plugins(state, pod, node_name)
        retries = max(int(self.config.bind_retries), 0)
        delay = min(self.config.pod_initial_backoff_seconds,
                    self.config.pod_max_backoff_seconds)
        attempt = 0
        while (not st.is_success() and attempt < retries
               and st.message().startswith("binding rejected:")):
            bound = self._bound_node(pod)
            if bound == node_name:
                # applied, response lost: already bound right
                st = Status.success()
                attempt += 1
                break
            if bound != "":
                break         # gone (None) or bound elsewhere: permanent
            attempt += 1
            time.sleep(delay)
            delay = min(delay * 2, self.config.pod_max_backoff_seconds)
            st = fwk.run_bind_plugins(state, pod, node_name)
        if attempt and st.is_success():
            if self.metrics is not None:
                self.metrics.recoveries.inc("bind-retry")
            if self.recorder:
                self.recorder.event(
                    pod, "Normal", "BindRetried",
                    f"bind succeeded after {attempt} retr"
                    f"{'y' if attempt == 1 else 'ies'}")
        return st

    def _bound_node(self, pod: api.Pod) -> Optional[str]:
        """reference: kubetpu/scheduler.py:2138 — the store's view of a
        pod's binding: its node, "" when it exists unbound, None when it
        is gone or the store cannot be read."""
        try:
            cur = self.store.get_pod(pod.namespace, pod.metadata.name)
        except Exception:
            return None
        return None if cur is None else (cur.spec.node_name or "")

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
        self._drop_chain_residency()
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
        if self.recorder:
            self.recorder.event(pod, "Warning", "FailedScheduling", message)
        try:
            self.store.update_pod_condition(
                pod, api.PodCondition(type=api.POD_SCHEDULED,
                                      status="False",
                                      reason=api.REASON_UNSCHEDULABLE,
                                      message=message),
                nominated_node_name=nominated_node)
        except Exception:
            pass
        if self.metrics:
            self.metrics.pod_unschedulable()

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
                    wave_pods, trace: Trace) -> Dict[str, Dict]:
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
        with trace.stage("decision-audit", pods=len(failed)):
            rows = self._audit_failures(cycle_ctx, failed, host_ok)
        self._audit_cache = (uids, rows)
        return rows

    def _audit_failures(self, cycle_ctx: CycleContext, failed,
                        host_ok) -> Dict[str, Dict]:
        """reference: kubetpu/scheduler.py:2324-2392 — per-plugin
        attribution for the cycle's failed pods: ONE explain_verdicts
        program and ONE packed [2F+3, B] readback against the cycle-start
        cluster.  Every row of the program is its pod's alone, so it runs
        on the failed rows only (gathered when they are fewer than the
        batch), where the reference runs the whole batch.  Returns uid ->
        PodDecision keyword arguments, and bumps
        scheduler_framework_rejections_total{plugin} for each pod's
        blocking plugins (where none blocks alone, joint infeasibility,
        the plugin that fails the most nodes).  A failure of the program
        raises."""
        batch = cycle_ctx.batch
        rows = [cycle_ctx.row_of[qp.pod.uid] for qp in failed]
        if len(rows) < batch.batch_cap:
            idx = torch.tensor(rows, dtype=torch.int64,
                               device=batch.valid.device)
            batch = take_rows(batch, idx)
            host_ok = None if host_ok is None else host_ok[idx]
            rows = range(len(rows))
        # devstats: the audit's readback syncs anyway, so it is timed on
        # every armed failure cycle (source "sync"); disarmed one read
        with udevstats.timed("explain_verdicts", self.device,
                             (cycle_ctx.cluster, batch), source="sync"):
            out = programs.explain_verdicts(cycle_ctx.cluster, batch,
                                            cycle_ctx.cfg, host_ok)
        packed = out.cpu().numpy()
        ds = udevstats.devstats()
        if ds is not None:
            ds.settle()
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
            rej = {filters[f]: counts[f][row]
                   for f in range(F) if counts[f][row]}
            blk = [filters[f] for f in range(F) if blocking[f][row]]
            info: Dict[str, object] = {"rejections": rej, "blocking": blk}
            if not no_feas[row] and best_node[row] >= 0:
                # feasible at cycle start, lost to in-batch contention:
                # the node it would have scored best on
                info["best_node"] = node_infos[best_node[row]].node_name
                info["best_score"] = best_score[row] / programs.SCORE_SCALE
            if self.metrics is not None:
                attributed = blk
                if not attributed and no_feas[row] and rej:
                    # no single filter blocks alone (joint infeasibility):
                    # the one failing the most nodes
                    attributed = [max(rej, key=rej.get)]
                for plugin in attributed:
                    self.metrics.framework_rejections.inc(plugin)
            out[qp.pod.uid] = info
        return out

    # ------------------------------------------------------------- serving

    def prewarm(self) -> bool:
        """reference: kubetpu/scheduler.py:2397 — before the first pod
        arrives, build or load the CUDA kernels and run the mode's
        program once on the current cluster with a synthetic batch, so
        the first served cycle pays neither nvcc nor first allocations.
        Nothing is assumed, bound or queued, and no cycle key is drawn.
        With a serve-mode AOT runtime armed (KUBETPU_AOT_DIR) the kernel
        libraries load from their artifacts first (_prewarm_aot).
        Returns True if a program ran."""
        with usanitize.thread_scope():
            return self._prewarm()

    def _prewarm(self) -> bool:
        rt = uaot.active_runtime()
        if rt is not None and rt.mode == "serve":
            self._prewarm_aot(rt)
        if self.device.type == "cuda" and self.config.mode == "gang" \
                and self.config.kernel_backend == "pallas":
            load_propose()
        snap = Snapshot()
        self.cache.update_snapshot(snap)
        node_infos = snap.node_info_list
        if not node_infos:
            return False
        fwk = next(iter(self.profiles.values()))
        protos = [PodInfo(api.Pod(
            metadata=api.ObjectMeta(name=f"prewarm-{i}", namespace="default",
                                    labels={"kubetpu-prewarm": f"g{i}"}),
            spec=api.PodSpec(containers=[api.Container(
                name="c", image="", resources=api.ResourceRequirements(
                    requests={"cpu": "1m", "memory": "1Mi"}))])))
            for i in range(min(self.config.batch_size, 1024))]
        builder = SnapshotBuilder(
            hard_pod_affinity_weight=fwk.hard_pod_affinity_weight)
        builder.intern_pending(protos)
        cluster = builder.build(node_infos).to_device(self.device)
        batch = batch_to_device(PodBatchBuilder(builder.table).build(protos),
                                self.device)
        cfg = programs.ProgramConfig(
            filters=fwk.tensor_filters, scores=fwk.tensor_scores,
            hostname_topokey=max(builder.table.topokey.get(
                api.LABEL_HOSTNAME), 0),
            plugin_args=fwk.tensor_plugin_args(builder.table))
        rng = prng.PRNGKey(0, device=self.device)
        # the prewarm gets a cycle record of its own (it runs outside any
        # scheduling cycle): one "prewarm" span with its bucket and seconds
        fr = utrace.flight_recorder()
        fr_rec = fr.begin_cycle("prewarm") if fr is not None else None
        t0 = wallclock()
        with (fr_rec.span("prewarm", mode="dry-run") if fr_rec is not None
              else contextlib.nullcontext()) as sp:
            if self.config.mode == "gang" and self._mesh is not None:
                res = pmesh.sharded_schedule_gang(
                    cluster, batch, cfg, rng, self._mesh,
                    intra_batch_topology=False)
            elif self.config.mode == "gang":
                res = run_auction(cluster, batch, cfg, rng,
                                  intra_batch_topology=False,
                                  kernel_backend=self.config.kernel_backend)
            elif self._mesh is not None:
                res = pmesh.sharded_schedule_sequential(
                    cluster, batch, cfg, rng, self._mesh,
                    hard_pod_affinity_weight=float(
                        fwk.hard_pod_affinity_weight))
            else:
                res = schedule_sequential(
                    cluster, batch, cfg, rng,
                    hard_pod_affinity_weight=float(
                        fwk.hard_pod_affinity_weight))
            res.packed.cpu()
            if sp is not None:
                sp.args["bucket"] = int(cluster.pod_valid.shape[0])
                sp.args["seconds"] = round(wallclock() - t0, 4)
        if fr_rec is not None:
            fr.commit_cycle(fr_rec)
        return True

    def _prewarm_aot(self, rt) -> None:
        """reference: kubetpu/scheduler.py:2606 — install and load every
        kernel library the armed runtime's index carries
        (utils/aot.AotRuntime.preload), on a "prewarm" flight span of
        mode "aot-artifact" with its seconds and count loaded.  A library
        whose artifact failed counts recoveries{aot-fallback} and builds
        from source at its first use."""
        fr = utrace.flight_recorder()
        fr_rec = fr.begin_cycle("prewarm") if fr is not None else None
        t0 = wallclock()
        with (fr_rec.span("prewarm", mode="aot-artifact")
              if fr_rec is not None else contextlib.nullcontext()) as sp:
            report = rt.preload()
            if sp is not None:
                sp.args["seconds"] = round(wallclock() - t0, 4)
                sp.args["loaded"] = sum(1 for r in report if r["ok"])
        if fr_rec is not None:
            fr_rec.meta["aot"] = rt.stats()
            fr.commit_cycle(fr_rec)
        loaded = sum(1 for r in report if r["ok"])
        failed = len(report) - loaded
        if failed and self.metrics is not None:
            self.metrics.recoveries.inc("aot-fallback", amount=failed)
        logging.getLogger("kubetpu_torch").info(
            "prewarm: %d kernel artifacts loaded in %.2fs (%d failed, "
            "built from source at first use)", loaded, wallclock() - t0,
            failed)

    def run(self) -> Optional[threading.Thread]:
        """reference: kubetpu/scheduler.py:2733 (scheduler.go:339 Run) —
        start the queue's and the cache's periodic work, prewarm (unless
        the configuration or KUBETPU_PREWARM=0 turns it off), then serve
        on a thread that never dies: a cycle that raises is logged and
        the loop goes on.  Returns that thread, or None when close() ran
        first (also during the prewarm)."""
        if self._closed:
            return None
        self.queue.run()
        self.cache.run()
        if (self.config.prewarm
                and os.environ.get("KUBETPU_PREWARM", "1") != "0"):
            try:
                self.prewarm()
            except Exception:
                logging.getLogger("kubetpu_torch").warning(
                    "prewarm failed; the first cycle pays it", exc_info=True)

        if self._closed:
            return None

        def loop():
            while not self._stop.is_set():
                try:
                    self.schedule_pending(timeout=0.2)
                except Exception:
                    logging.getLogger("kubetpu_torch").error(
                        "scheduling cycle raised", exc_info=True)
                    time.sleep(0.1)
        t = threading.Thread(target=loop, daemon=True,
                             name="kubetpu-scheduler")
        self._serve_thread = t
        t.start()
        return t

    def close(self) -> None:
        """reference: kubetpu/scheduler.py:2787 — idempotent: stop the
        serving loop and join it (bounded), then flush the pipeline (only
        if the loop has ended, so the flush never races a cycle), then
        close the queue, the cache and the bind pool."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        t = self._serve_thread
        serve_loop_live = False
        if (t is not None and t is not threading.current_thread()
                and t.is_alive()):
            t.join(timeout=2.0)
            serve_loop_live = t.is_alive()
        self._serve_thread = None
        if not serve_loop_live:
            try:
                self.flush_pipeline()
            except Exception:
                logging.getLogger("kubetpu_torch").warning(
                    "pipeline flush at close failed", exc_info=True)
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
