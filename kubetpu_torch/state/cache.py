"""Scheduler cache: assume/forget protocol + incremental snapshots.

reference: pkg/scheduler/internal/cache/cache.go (schedulerCache :58,
AssumePod :338, FinishBinding :359, ForgetPod :383, AddPod :416,
UpdatePod :452, RemovePod :481, AddNode :514, UpdateSnapshot :202,
cleanupAssumedPods :704) and interface.go (the Cache contract).

The cache optimistically holds "assumed" pods — placed by the scheduler but
not yet confirmed bound by a watch event — with a TTL after binding
finishes (30 s default, reference: scheduler.go:227 durationToExpireAssumedPod).
Every NodeInfo mutation bumps its Generation; UpdateSnapshot copies only
NodeInfos whose generation is newer than the snapshot's, keeping snapshot
cost proportional to churn, not cluster size.  A doubly-linked list keeps
recently-updated nodes at the head so the generation scan can stop early
(reference: cache.go:64 headNode / moveNodeInfoToHead).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..api import types as api
from ..framework.types import NodeInfo, next_generation
from .node_tree import NodeTree

DEFAULT_ASSUME_TTL = 30.0  # reference: scheduler.go:56,227


@dataclass
class _PodState:
    pod: api.Pod
    deadline: Optional[float] = None      # set by FinishBinding
    binding_finished: bool = False


class _NodeItem:
    """Doubly-linked NodeInfo wrapper (reference: cache.go:46 nodeInfoListItem)."""
    __slots__ = ("info", "next", "prev")

    def __init__(self, info: NodeInfo):
        self.info = info
        self.next: Optional["_NodeItem"] = None
        self.prev: Optional["_NodeItem"] = None


class Snapshot:
    """Immutable-by-convention per-cycle view (reference:
    internal/cache/snapshot.go:29 Snapshot)."""

    def __init__(self):
        self.node_info_map: Dict[str, NodeInfo] = {}
        self.node_info_list: List[NodeInfo] = []
        self.have_pods_with_affinity_list: List[NodeInfo] = []
        self.generation = 0

    def num_nodes(self) -> int:
        return len(self.node_info_list)

    def get(self, name: str) -> Optional[NodeInfo]:
        return self.node_info_map.get(name)


class SchedulerCache:
    def __init__(self, ttl: float = DEFAULT_ASSUME_TTL,
                 clock=time.time, cleanup_period: float = 1.0,
                 expire_listener=None):
        # expire_listener(pod): called whenever an assumed pod is dropped
        # by TTL expiry (the lost-watch-event path) so owners of derived
        # state (the scheduler's chained tensors) can invalidate it
        self.expire_listener = expire_listener
        self._ttl = ttl
        self._clock = clock
        self._lock = threading.RLock()
        self.nodes: Dict[str, _NodeItem] = {}  # kubelint: guarded-by(_lock)
        self.head: Optional[_NodeItem] = None  # kubelint: guarded-by(_lock)
        self.node_tree = NodeTree()  # kubelint: guarded-by(_lock)
        self.assumed_pods: Dict[str, bool] = {}      # uid -> true  # kubelint: guarded-by(_lock)
        self.pod_states: Dict[str, _PodState] = {}   # uid -> state  # kubelint: guarded-by(_lock)
        self._stop = threading.Event()
        self._cleanup_period = cleanup_period
        self._thread: Optional[threading.Thread] = None

    # -- linked list --------------------------------------------------------

    def _move_to_head(self, item: _NodeItem) -> None:
        # reference: cache.go:145 moveNodeInfoToHead
        if item is self.head:
            return
        if item.prev is not None:
            item.prev.next = item.next
        if item.next is not None:
            item.next.prev = item.prev
        if self.head is not None:
            self.head.prev = item
        item.next = self.head
        item.prev = None
        self.head = item

    def _remove_from_list(self, item: _NodeItem) -> None:
        # reference: cache.go:166 removeNodeInfoFromList
        if item.prev is not None:
            item.prev.next = item.next
        if item.next is not None:
            item.next.prev = item.prev
        if item is self.head:
            self.head = item.next

    def _node_item(self, name: str) -> _NodeItem:
        item = self.nodes.get(name)
        if item is None:
            item = _NodeItem(NodeInfo())
            self.nodes[name] = item
        return item

    # -- pods ---------------------------------------------------------------

    def assume_pod(self, pod: api.Pod, pinfo=None) -> None:
        """reference: cache.go:338 AssumePod.  pinfo: optional pre-parsed
        PodInfo wrapping this pod (hot-path callers avoid a re-parse)."""
        with self._lock:
            if pod.uid in self.pod_states:
                raise ValueError(f"pod {pod.uid} is in the cache, "
                                 "so can't be assumed")
            self._add_pod(pod, pinfo)
            self.pod_states[pod.uid] = _PodState(pod=pod)
            self.assumed_pods[pod.uid] = True

    def finish_binding(self, pod: api.Pod, now: Optional[float] = None) -> None:
        """reference: cache.go:359 FinishBinding — starts the expiry TTL."""
        with self._lock:
            st = self.pod_states.get(pod.uid)
            if st is not None and self.assumed_pods.get(pod.uid):
                st.binding_finished = True
                st.deadline = (now if now is not None else self._clock()) + self._ttl

    def forget_pod(self, pod: api.Pod) -> None:
        """reference: cache.go:383 ForgetPod."""
        with self._lock:
            st = self.pod_states.get(pod.uid)
            if st is not None and st.pod.spec.node_name != pod.spec.node_name:
                raise ValueError(f"pod {pod.uid} was assumed on "
                                 f"{st.pod.spec.node_name} but assigned to "
                                 f"{pod.spec.node_name}")
            if not self.assumed_pods.get(pod.uid):
                raise ValueError(f"pod {pod.uid} wasn't assumed, "
                                 "so can't be forgotten")
            self._remove_pod(st.pod)
            del self.pod_states[pod.uid]
            del self.assumed_pods[pod.uid]

    def add_pod(self, pod: api.Pod) -> None:
        """Watch-confirmed pod (reference: cache.go:416 AddPod)."""
        with self._lock:
            st = self.pod_states.get(pod.uid)
            if st is not None and self.assumed_pods.get(pod.uid):
                if st.pod.spec.node_name != pod.spec.node_name:
                    # the pod was added to a different node than assumed
                    self._remove_pod(st.pod)
                    self._add_pod(pod)
                self.assumed_pods.pop(pod.uid, None)
                st.deadline = None
                st.pod = pod
            elif st is None:
                self._add_pod(pod)
                self.pod_states[pod.uid] = _PodState(pod=pod)
            else:
                raise ValueError(f"pod {pod.uid} was already in added state")

    def update_pod(self, old: api.Pod, new: api.Pod) -> None:
        """reference: cache.go:452 UpdatePod."""
        with self._lock:
            st = self.pod_states.get(old.uid)
            if st is None:
                raise ValueError(f"pod {old.uid} is not added to cache")
            if self.assumed_pods.get(old.uid):
                raise ValueError(f"assumed pod {old.uid} should not be updated")
            self._remove_pod(st.pod)
            self._add_pod(new)
            st.pod = new

    def remove_pod(self, pod: api.Pod) -> None:
        """reference: cache.go:481 RemovePod."""
        with self._lock:
            st = self.pod_states.get(pod.uid)
            if st is None:
                raise ValueError(f"pod {pod.uid} is not found in cache")
            self._remove_pod(st.pod)
            del self.pod_states[pod.uid]
            self.assumed_pods.pop(pod.uid, None)

    def get_pod(self, pod: api.Pod) -> Optional[api.Pod]:
        with self._lock:
            st = self.pod_states.get(pod.uid)
            return st.pod if st else None

    def is_assumed_pod(self, pod: api.Pod) -> bool:
        with self._lock:
            return bool(self.assumed_pods.get(pod.uid))

    def _add_pod(self, pod: api.Pod, pinfo=None) -> None:
        item = self._node_item(pod.spec.node_name)
        item.info.add_pod(pod, pinfo)
        self._move_to_head(item)

    def _remove_pod(self, pod: api.Pod) -> None:
        item = self.nodes.get(pod.spec.node_name)
        if item is None:
            return
        item.info.remove_pod(pod)
        if item.info.node is None and not item.info.pods:
            # placeholder created by a pod on an unknown node
            self._remove_from_list(item)
            del self.nodes[pod.spec.node_name]
        else:
            self._move_to_head(item)

    # -- nodes --------------------------------------------------------------

    def add_node(self, node: api.Node) -> None:
        """reference: cache.go:514 AddNode."""
        with self._lock:
            item = self._node_item(node.name)
            self.node_tree.add_node(node)
            item.info.set_node(node)
            self._move_to_head(item)

    def update_node(self, old: api.Node, new: api.Node) -> None:
        with self._lock:
            item = self._node_item(new.name)
            self.node_tree.update_node(old, new)
            item.info.set_node(new)
            self._move_to_head(item)

    def remove_node(self, node: api.Node) -> None:
        """reference: cache.go:552 RemoveNode — NodeInfo stays if pods are
        still attached (they may be deleted later)."""
        with self._lock:
            item = self.nodes.get(node.name)
            if item is None:
                raise ValueError(f"node {node.name} is not found")
            item.info.node = None
            item.info.generation = next_generation()
            if not item.info.pods:
                self._remove_from_list(item)
                del self.nodes[node.name]
            else:
                self._move_to_head(item)
            self.node_tree.remove_node(node)

    # -- snapshot -----------------------------------------------------------

    def update_snapshot(self, snapshot: Snapshot) -> None:
        """Incremental snapshot refresh (reference: cache.go:202
        UpdateSnapshot): walk the recently-updated list head-first, copy
        NodeInfos newer than the snapshot generation, rebuild the ordered
        list only when nodes were added/removed or affinity pods changed."""
        with self._lock:
            balanced_gen = snapshot.generation
            update_all = False
            item = self.head
            while item is not None:
                info = item.info
                if info.generation <= balanced_gen:
                    break  # everything older is already in the snapshot
                if info.node is not None:
                    existing = snapshot.node_info_map.get(info.node_name)
                    if existing is None:
                        update_all = True
                    elif bool(existing.pods_with_affinity) != bool(
                            info.pods_with_affinity):
                        update_all = True
                    snapshot.node_info_map[info.node_name] = info.clone()
                item = item.next
            if self.head is not None:
                snapshot.generation = self.head.info.generation
            # removed nodes may still be in the snapshot map — compare
            # against the tree (reference compares nodeTree.numNodes,
            # cache.go:236: ghost NodeInfos with lingering pods don't count)
            if len(snapshot.node_info_map) > self.node_tree.num_nodes:
                live = {n for n, it in self.nodes.items()
                        if it.info.node is not None}
                for name in list(snapshot.node_info_map):
                    if name not in live:
                        del snapshot.node_info_map[name]
                update_all = True
            if update_all or len(snapshot.node_info_list) != len(
                    [i for i in self.nodes.values() if i.info.node is not None]):
                self._rebuild_snapshot_list(snapshot)
            else:
                # refresh affinity sublist from (possibly re-cloned) infos
                snapshot.node_info_list = [
                    snapshot.node_info_map[ni.node_name]
                    for ni in snapshot.node_info_list
                    if ni.node_name in snapshot.node_info_map]
                snapshot.have_pods_with_affinity_list = [
                    ni for ni in snapshot.node_info_list
                    if ni.pods_with_affinity]

    def _rebuild_snapshot_list(self, snapshot: Snapshot) -> None:
        # reference: cache.go:280 updateNodeInfoSnapshotList (zone order)
        snapshot.node_info_list = []
        snapshot.have_pods_with_affinity_list = []
        for name in self.node_tree.list():
            ni = snapshot.node_info_map.get(name)
            if ni is None:
                continue
            snapshot.node_info_list.append(ni)
            if ni.pods_with_affinity:
                snapshot.have_pods_with_affinity_list.append(ni)

    # -- assumed-pod expiry -------------------------------------------------

    def cleanup_assumed_pods(self, now: Optional[float] = None) -> None:
        """reference: cache.go:704 cleanupAssumedPods."""
        now = now if now is not None else self._clock()
        with self._lock:
            for uid in list(self.assumed_pods):
                st = self.pod_states[uid]
                if not st.binding_finished:
                    continue
                if st.deadline is not None and now >= st.deadline:
                    self._expire_pod(uid, st)

    def _expire_pod(self, uid: str, st: _PodState) -> None:
        self._remove_pod(st.pod)
        del self.pod_states[uid]
        del self.assumed_pods[uid]
        if self.expire_listener is not None:
            # the scheduler's chained tensors may still carry this ghost
            # pod's usage — let the owner invalidate them
            self.expire_listener(st.pod)

    def run(self) -> None:
        """Start the periodic expiry loop (reference: cache.go:696 run)."""
        def loop():
            while not self._stop.wait(self._cleanup_period):
                self.cleanup_assumed_pods()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Idempotent: stops and joins the cleanup thread (it sleeps on the
        stop event, so it exits within one wait tick)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._thread = None
