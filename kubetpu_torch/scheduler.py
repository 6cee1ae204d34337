"""Scheduler core: queue -> snapshot -> tensorize -> device program ->
packed readback -> assume + bind, on a CUDA device.

reference: pkg/scheduler/scheduler.go (scheduleOne :509, assume :435,
bind :457, recordSchedulingFailure :391) and eventhandlers.go
(addAllEventHandlers :362).  Like the JAX package's scheduler, each cycle
pops a BATCH of pods and places it with one device program:

  schedule_pending -> pop a batch (PrioritySort order) -> cache snapshot
  -> fresh tensorize (SnapshotBuilder + PodBatchBuilder) -> the mode's
  program with PRNGKey(cycle counter) -> ONE readback of ``packed`` ->
  assume + bind through the store; failed pods return to the queue after
  every placement of the cycle has committed.

Modes: "sequential" (the default) replays scheduleOne over the batch in
pod order (models/sequential.py) with the adaptive-sampling start index
kept across cycles; "gang" runs the conflict-free auction
(models/gang.py).  Both run the default plugin family and restrict the
same-pair key loops to the topology keys of the batch's terms
(ProgramConfig.active_topo_keys).  A gang batch whose pods carry pod
(anti-)affinity, spread constraints or a controller spread selector runs
the auction with intra-batch topology, and so the lax round whatever the
configured backend; each cycle's route is recorded in ``gang_backends``.
Pods with volumes are refused in both modes (NotImplementedError).
Deferred, each a
ROADMAP item: the framework extension points (PreFilter/Reserve/Permit/
PreBind/PostBind plugins, host filters and scores), volumes, preemption
and the nominated-pods overlay, extenders, cycle chaining, delta
tensorization, the pipelined drain, and the JAX runtime's journal/chaos/
devstats/AOT utilities.  The JAX scheduler's placements do not depend on
chaining or the delta path (its tests prove both placement-identical to
fresh builds), so a fresh build per cycle gives the same placements.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .api import types as api
from .apis.config import KubeSchedulerConfiguration, KubeSchedulerProfile
from .client.store import ClusterStore
from .framework.types import PodInfo, QueuedPodInfo, pod_with_affinity
from .models import programs
from .models.batch import PodBatchBuilder, batch_to_device
from .models.gang import run_auction
from .models.sequential import schedule_sequential
from .schedqueue.queue import SchedulingQueue
from .state.cache import SchedulerCache, Snapshot
from .state.tensors import SnapshotBuilder
from .utils import pallas_backend as PB
from .utils import prng
from .utils.device import DeviceLike, resolve_device


@dataclass
class ScheduleOutcome:
    pod: api.Pod
    node: str = ""                 # "" => unschedulable
    err: Optional[str] = None
    n_feasible: int = 0
    preemption_may_help: bool = True


class Scheduler:
    """reference: scheduler.go:69.  ``device`` defaults to CUDA; pass
    device="cpu" to run the plain PyTorch path."""

    def __init__(self, store: ClusterStore,
                 config: Optional[KubeSchedulerConfiguration] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.store = store
        self.config = config or KubeSchedulerConfiguration(
            profiles=[KubeSchedulerProfile()])
        if not self.config.profiles:
            self.config.profiles = [KubeSchedulerProfile()]
        self.config.validate()
        self.profiles = {p.scheduler_name: p for p in self.config.profiles}
        self.cache = SchedulerCache()
        self.queue = SchedulingQueue(
            pod_initial_backoff=self.config.pod_initial_backoff_seconds,
            pod_max_backoff=self.config.pod_max_backoff_seconds)
        self.snapshot = Snapshot()
        self._rng_counter = 0   # PRNGKey(cycle) — the JAX scheduler's seed 0
        # rotating node-search start of the sequential replay (reference:
        # nextStartNodeIndex, generic_scheduler.go:451); kept across cycles
        self._next_start_node_index = 0
        # per-cycle diagnostics (the benchmark surface); the gang lists
        # stay empty in sequential mode
        self.cycle_count = 0
        self.gang_rounds: List[int] = []
        self.gang_syncs: List[int] = []
        # (backend, reason) per gang cycle: the round the auction ran
        # ("pallas" or "lax") and, when a pallas request was routed to
        # lax, why (utils/pallas_backend.unsupported_reason)
        self.gang_backends: List[Tuple[str, Optional[str]]] = []
        # host wall seconds per cycle stage, summed over cycles: snapshot,
        # tensorize (numpy build), upload (copy to the device), auction
        # (the mode's program through the packed readback), commit
        # (assume + bind, then the failures)
        self.stage_s: Dict[str, float] = dict.fromkeys(
            ("snapshot", "tensorize", "upload", "auction", "commit"), 0.0)
        self._add_all_event_handlers()

    # ------------------------------------------------------------------ events

    def _add_all_event_handlers(self) -> None:
        """reference: eventhandlers.go:362 addAllEventHandlers."""
        def on_pod(event: str, old, new) -> None:
            pod = new if new is not None else old
            if event == "add":
                if pod.spec.node_name:
                    self._add_pod_to_cache(pod)
                elif self._responsible(pod):
                    self.queue.add(pod)
            elif event == "update":
                if new.spec.node_name and not old.spec.node_name:
                    self._add_pod_to_cache(new)   # bind confirmed
                    self.queue.delete(old)
                    self.queue.assigned_pod_added(new)
                elif new.spec.node_name:
                    try:
                        self.cache.update_pod(old, new)
                    except ValueError:
                        self._add_pod_to_cache(new)
                    self.queue.assigned_pod_updated(new)
                elif self._responsible(new):
                    self.queue.update(old, new)
            elif event == "delete":
                if pod.spec.node_name:
                    try:
                        self.cache.remove_pod(pod)
                    except ValueError:
                        pass
                    self.queue.move_all_to_active_or_backoff_queue(
                        "PodDelete")
                else:
                    self.queue.delete(pod)

        def on_node(event: str, old, new) -> None:
            if event == "add":
                self.cache.add_node(new)
                self.queue.move_all_to_active_or_backoff_queue("NodeAdd")
            elif event == "update":
                self.cache.update_node(old, new)
                self.queue.move_all_to_active_or_backoff_queue("NodeUpdate")
            elif event == "delete":
                try:
                    self.cache.remove_node(old)
                except ValueError:
                    pass

        self.store.subscribe("Pod", on_pod)
        self.store.subscribe("Node", on_node)

    def _add_pod_to_cache(self, pod: api.Pod) -> None:
        try:
            self.cache.add_pod(pod)
        except ValueError:
            pass

    def _responsible(self, pod: api.Pod) -> bool:
        return pod.spec.scheduler_name in self.profiles

    # ------------------------------------------------------------------ cycle

    def _next_rng(self):
        self._rng_counter += 1
        return prng.PRNGKey(self._rng_counter, device=self.device)

    def schedule_pending(self, max_batch: Optional[int] = None,
                         timeout: float = 0.0) -> List[ScheduleOutcome]:
        """Run ONE batched scheduling cycle: pop up to batch_size pods and
        schedule them.  Returns their outcomes ([] when the queue is
        empty)."""
        qpods = self.queue.pop_batch(max_batch or self.config.batch_size,
                                     timeout=timeout)
        qpods = [qp for qp in qpods if not self._skip_pod_schedule(qp.pod)]
        if not qpods:
            return []
        return self._schedule_group(qpods)

    def _skip_pod_schedule(self, pod: api.Pod) -> bool:
        """reference: scheduler.go:691 skipPodSchedule."""
        current = self.store.get_pod(pod.namespace, pod.metadata.name)
        if current is None or current.metadata.deletion_timestamp is not None:
            return True
        return self.cache.is_assumed_pod(pod)

    @staticmethod
    def _check_supported(qpods: List[QueuedPodInfo]) -> None:
        for qp in qpods:
            pod = qp.pod
            if pod.spec.volumes:
                raise NotImplementedError(
                    "pod %s/%s has volumes (ROADMAP: volumes)"
                    % (pod.namespace, pod.metadata.name))

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

    def _schedule_group(self, qpods: List[QueuedPodInfo]
                        ) -> List[ScheduleOutcome]:
        t = time.perf_counter()
        self.cache.update_snapshot(self.snapshot)
        node_infos = self.snapshot.node_info_list
        n_nodes = len(node_infos)
        if n_nodes == 0:
            return [self._fail(qp, "0/0 nodes are available",
                               preemption_may_help=False) for qp in qpods]
        spread_sels = [self.store.default_spread_selector(qp.pod)
                       for qp in qpods]
        self._check_supported(qpods)
        pinfos = [PodInfo(qp.pod) for qp in qpods]
        t = self._stage("snapshot", t)

        # fresh tensorize (host numpy), then one copy to the device
        builder = SnapshotBuilder()
        builder.intern_pending(pinfos)
        host = builder.build(node_infos)
        hbatch = PodBatchBuilder(builder.table).build(
            pinfos, spread_selectors=spread_sels)
        t = self._stage("tensorize", t)
        cluster = host.to_device(self.device)
        batch = batch_to_device(hbatch, self.device)
        t = self._stage("upload", t)
        table = builder.table
        cfg = programs.ProgramConfig(
            filters=programs.DEFAULT_FILTER_PLUGINS,
            scores=programs.DEFAULT_SCORE_PLUGINS,
            hostname_topokey=max(table.topokey.get(api.LABEL_HOSTNAME), 0),
            percentage_of_nodes_to_score=(
                self.config.percentage_of_nodes_to_score),
            active_topo_keys=self._batch_topo_keys(table, pinfos))

        B = batch.valid.shape[0]
        if self.config.mode == "gang":
            needs_topo = self._needs_topo(qpods, spread_sels)
            self.gang_backends.append(self._gang_backend(cfg, needs_topo,
                                                         hbatch))
            res = run_auction(cluster, batch, cfg, self._next_rng(),
                              intra_batch_topology=needs_topo,
                              kernel_backend=self.gang_backends[-1][0])
            packed = res.packed.cpu().numpy()     # the cycle's one readback
            self.gang_rounds.append(int(packed[3 * B]))
            self.gang_syncs.append(res.syncs)
        else:
            start = self._next_start_node_index % n_nodes
            res = schedule_sequential(cluster, batch, cfg, self._next_rng(),
                                      hard_pod_affinity_weight=1.0,
                                      start_index=start)
            packed = res.packed.cpu().numpy()     # the cycle's one readback
            self._next_start_node_index = int(packed[3 * B])
        t = self._stage("auction", t)

        self.cycle_count += 1
        chosen = packed[:B][:len(qpods)].tolist()
        n_feas = packed[B:2 * B][:len(qpods)].tolist()
        unres = (packed[2 * B:3 * B][:len(qpods)] != 0).tolist()
        outcomes: List[Optional[ScheduleOutcome]] = []
        failed = []
        for i, qp in enumerate(qpods):
            if chosen[i] < 0:
                outcomes.append(None)
                failed.append(i)
                continue
            outcomes.append(self._commit(qp, pinfos[i],
                                         node_infos[chosen[i]].node_name,
                                         n_feas[i]))
        # failures requeue after every commit has landed, as the JAX
        # scheduler defers them: the queue's move-request cycle then
        # reflects this cycle's binds
        for i in failed:
            outcomes[i] = self._fail(
                qpods[i], f"0/{n_nodes} nodes are available",
                preemption_may_help=not unres[i])
        self._stage("commit", t)
        return outcomes

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

    def _commit(self, qp: QueuedPodInfo, pinfo: PodInfo, node_name: str,
                n_feasible: int) -> ScheduleOutcome:
        """assume (scheduler.go:435) then bind (scheduler.go:457)."""
        pod = qp.pod
        assumed = copy.copy(pod)
        assumed.spec = copy.copy(pod.spec)
        assumed.spec.node_name = node_name
        try:
            self.cache.assume_pod(assumed, pinfo.with_pod(assumed))
        except ValueError as e:
            return self._fail(qp, str(e), preemption_may_help=False)
        try:
            self.store.bind(pod, node_name)
        except Exception as e:  # the store rejects gone / already-bound pods
            try:
                self.cache.forget_pod(assumed)
            except ValueError:
                pass
            return self._fail(qp, "binding rejected: %s" % e,
                              preemption_may_help=False)
        self.cache.finish_binding(assumed)
        return ScheduleOutcome(pod=pod, node=node_name,
                               n_feasible=n_feasible)

    def _fail(self, qp: QueuedPodInfo, message: str,
              preemption_may_help: bool = True) -> ScheduleOutcome:
        """reference: scheduler.go:391 recordSchedulingFailure (no
        preemption: ROADMAP)."""
        pod = qp.pod
        try:
            self.queue.add_unschedulable_if_not_present(qp,
                                                        qp.scheduling_cycle)
        except ValueError:
            pass
        try:
            self.store.update_pod_condition(
                pod, api.PodCondition(type=api.POD_SCHEDULED,
                                      status="False",
                                      reason=api.REASON_UNSCHEDULABLE,
                                      message=message))
        except Exception:
            pass
        return ScheduleOutcome(pod=pod, node="", err=message,
                               preemption_may_help=preemption_may_help)

    def close(self) -> None:
        self.queue.close()
        self.cache.close()


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
