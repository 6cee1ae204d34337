"""In-process cluster state store: the framework's apiserver + informer.

Plays the role the API server + client-go informer machinery play for the
reference scheduler (reference: staging/src/k8s.io/client-go/tools/cache
{reflector,delta_fifo,shared_informer}.go; the scheduler's view of it is
addAllEventHandlers, pkg/scheduler/eventhandlers.go:362).  Durable state
lives here (etcd's role); device tensors are disposable projections of it
(SURVEY.md §5 checkpoint/resume).

Writes go through typed methods that fan events out to subscribers
synchronously in-process — the integration-test shape of the reference
(test/integration/util/util.go StartApiserver/StartScheduler), which is how
the parity harness runs without a real control plane.  The `bind` method is
the pods/<name>/binding subresource (reference:
defaultbinder/default_binder.go:56, pkg/registry/core/pod BindingREST).
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, List, Optional

from ..api import types as api

Handler = Callable[[str, Optional[object], Optional[object]], None]
# handler(event, old, new) with event in {"add", "update", "delete"}

KINDS = ("Pod", "Node", "PersistentVolumeClaim", "PersistentVolume",
         "StorageClass", "CSINode", "Service", "ReplicaSet",
         "ReplicationController", "StatefulSet", "PodDisruptionBudget",
         "Event")


class Conflict(Exception):
    """API write conflict (reference: apierrors.IsConflict paths)."""


class NotFound(Exception):
    pass


class ClusterStore:
    def __init__(self):
        self._lock = threading.RLock()
        self._objs: Dict[str, Dict[str, object]] = {k: {} for k in KINDS}  # kubelint: guarded-by(_lock)
        self._subs: Dict[str, List[Handler]] = {k: [] for k in KINDS}  # kubelint: guarded-by(_lock)

    # -- generic ------------------------------------------------------------

    @staticmethod
    def _key(obj) -> str:
        m = obj.metadata
        return f"{m.namespace}/{m.name}" if getattr(obj, "kind", "") in (
            "Pod", "PersistentVolumeClaim", "Service", "ReplicaSet",
            "ReplicationController", "StatefulSet", "PodDisruptionBudget",
            "Event") \
            else m.name

    def subscribe(self, kind: str, handler: Handler) -> None:
        with self._lock:
            self._subs[kind].append(handler)
            # replay current state as adds (informer initial List)
            current = list(self._objs[kind].values())
        for obj in current:
            handler("add", None, obj)

    def add(self, obj) -> None:
        kind = obj.kind
        with self._lock:
            k = self._key(obj)
            if k in self._objs[kind]:
                raise Conflict(f"{kind} {k} already exists")
            obj.metadata.resource_version += 1
            self._objs[kind][k] = obj
            subs_snapshot = list(self._subs[kind])
        for h in subs_snapshot:
            h("add", None, obj)

    def update(self, obj) -> None:
        kind = obj.kind
        with self._lock:
            k = self._key(obj)
            old = self._objs[kind].get(k)
            if old is None:
                raise NotFound(f"{kind} {k} not found")
            obj.metadata.resource_version = old.metadata.resource_version + 1
            self._objs[kind][k] = obj
            subs_snapshot = list(self._subs[kind])
        for h in subs_snapshot:
            h("update", old, obj)

    def delete(self, obj) -> None:
        kind = obj.kind
        with self._lock:
            k = self._key(obj)
            old = self._objs[kind].pop(k, None)
            if old is None:
                raise NotFound(f"{kind} {k} not found")
            subs_snapshot = list(self._subs[kind])
        for h in subs_snapshot:
            h("delete", old, None)

    def get(self, kind: str, key: str):
        with self._lock:
            return self._objs[kind].get(key)

    def list(self, kind: str) -> List[object]:
        with self._lock:
            return list(self._objs[kind].values())

    # -- typed helpers (what plugins/scheduler use) -------------------------

    def get_pod(self, namespace: str, name: str) -> Optional[api.Pod]:
        return self.get("Pod", f"{namespace}/{name}")

    # -- binding subresource ------------------------------------------------

    def bind(self, pod: api.Pod, node_name: str) -> None:
        """POST pods/<name>/binding (reference: default_binder.go:56).
        Fails if the pod is gone or already bound — the scheduler's
        ForgetPod path handles that (scheduler.go:497)."""
        with self._lock:
            k = f"{pod.namespace}/{pod.metadata.name}"
            current: Optional[api.Pod] = self._objs["Pod"].get(k)
            if current is None:
                raise NotFound(f"pod {k} not found")
            if current.spec.node_name:
                # reference: pkg/registry/core/pod BindingREST rejects any
                # re-bind, even to the same node
                raise Conflict(f"pod {k} is already assigned to node "
                               f"{current.spec.node_name}")
            if self.get("Node", node_name) is None:
                raise NotFound(f"node {node_name} not found")
            old = copy.copy(current)
            old.spec = copy.copy(current.spec)
            current.spec.node_name = node_name
            current.status.phase = api.POD_PENDING
            current.metadata.resource_version += 1
            subs_snapshot = list(self._subs["Pod"])
        for h in subs_snapshot:
            h("update", old, current)

    def update_pod_condition(self, pod: api.Pod, condition: api.PodCondition,
                             nominated_node_name: str = "") -> None:
        """Status patch (reference: scheduler.go:739-755 updatePod)."""
        with self._lock:
            k = f"{pod.namespace}/{pod.metadata.name}"
            current: Optional[api.Pod] = self._objs["Pod"].get(k)
            if current is None:
                raise NotFound(f"pod {k} not found")
            old = copy.copy(current)
            conds = [c for c in current.status.conditions
                     if c.type != condition.type]
            conds.append(condition)
            current.status.conditions = conds
            if nominated_node_name:
                current.status.nominated_node_name = nominated_node_name
            current.metadata.resource_version += 1
            subs_snapshot = list(self._subs["Pod"])
        for h in subs_snapshot:
            h("update", old, current)

    # -- spread selectors (DefaultPodTopologySpread) ------------------------

    def default_spread_selector(self, pod: api.Pod):
        """Combined Service/RC/RS/SS selector for the pod (reference:
        defaultpodtopologyspread helpers, plugins/helper/spread.go
        DefaultSelector).  Returns an api.LabelSelector or None."""
        reqs: List[api.LabelSelectorRequirement] = []
        with self._lock:
            for svc in self._objs["Service"].values():
                if svc.metadata.namespace != pod.namespace or not svc.selector:
                    continue
                if all(pod.metadata.labels.get(k) == v
                       for k, v in svc.selector.items()):
                    reqs.extend(api.LabelSelectorRequirement(k, "In", [v])
                                for k, v in svc.selector.items())
            for rc in self._objs["ReplicationController"].values():
                if rc.metadata.namespace != pod.namespace or not rc.selector:
                    continue
                if all(pod.metadata.labels.get(k) == v
                       for k, v in rc.selector.items()):
                    reqs.extend(api.LabelSelectorRequirement(k, "In", [v])
                                for k, v in rc.selector.items())
            for kind in ("ReplicaSet", "StatefulSet"):
                for rs in self._objs[kind].values():
                    if rs.metadata.namespace != pod.namespace:
                        continue
                    if rs.selector is not None and not rs.selector.is_empty() \
                            and rs.selector.matches(pod.metadata.labels):
                        reqs.extend(rs.selector.requirements())
        if not reqs:
            return None
        return api.LabelSelector(match_expressions=reqs)
