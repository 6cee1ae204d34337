"""HTTP extender: the legacy out-of-process scheduler webhook.

reference: pkg/scheduler/core/extender.go (HTTPExtender :42, Filter :273,
Prioritize :343, Bind :385, send :412, IsInterested :450) with wire types
from staging/src/k8s.io/kube-scheduler/extender/v1.  Filter runs serially
per extender after the device filter pass
(core/generic_scheduler.go:497 findNodesThatPassExtenders); Prioritize
results are weighted and added to the device scores
(:674-702, MaxExtenderPriority=10 scaled to MaxNodeScore).

A copy of kubetpu/extender.py; the Scheduler's extender path is
Scheduler._schedule_with_extenders, preemption's
Preemptor._process_with_extenders.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Tuple

from .api import types as api
from .utils import chaos

MAX_EXTENDER_PRIORITY = 10  # reference: extender/v1/types.go:109
DEFAULT_EXTENDER_TIMEOUT = 5.0


def _pod_doc(pod: api.Pod) -> Dict:
    return {
        "metadata": {"name": pod.metadata.name,
                     "namespace": pod.namespace,
                     "uid": pod.uid,
                     "labels": dict(pod.metadata.labels)},
        "spec": {"nodeName": pod.spec.node_name,
                 "schedulerName": pod.spec.scheduler_name,
                 "priority": pod.spec.priority},
    }


class ExtenderError(Exception):
    pass


class HTTPExtender:
    """reference: core/extender.go:42."""

    def __init__(self, config: Dict):
        self.url_prefix = config.get("urlPrefix", "").rstrip("/")
        self.filter_verb = config.get("filterVerb", "")
        self.prioritize_verb = config.get("prioritizeVerb", "")
        self.bind_verb = config.get("bindVerb", "")
        self.preempt_verb = config.get("preemptVerb", "")
        self.weight = config.get("weight", 1)
        self.timeout = config.get("httpTimeout", DEFAULT_EXTENDER_TIMEOUT)
        self.node_cache_capable = config.get("nodeCacheCapable", False)
        self.ignorable = config.get("ignorable", False)
        self.managed_resources = {r["name"] if isinstance(r, dict) else r
                                  for r in config.get("managedResources", [])}

    # -- wire ---------------------------------------------------------------

    def _send(self, verb: str, args: Dict) -> Dict:
        # reference: extender.go:412 send
        # chaos seam (utils/chaos.py "extender"): a transient webhook
        # transport error — flows through each verb's existing
        # ignorable/ExtenderError handling, never a new failure class
        chaos.raise_or_stall("extender")
        url = f"{self.url_prefix}/{verb}"
        data = json.dumps(args).encode()
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            if resp.status != 200:
                raise ExtenderError(f"{url}: HTTP {resp.status}")
            return json.loads(resp.read().decode() or "{}")

    # -- verbs --------------------------------------------------------------

    def is_interested(self, pod: api.Pod) -> bool:
        """reference: extender.go:450 IsInterested — empty managedResources
        means every pod."""
        if not self.managed_resources:
            return True
        for c in pod.spec.containers + pod.spec.init_containers:
            for rl in (c.resources.requests, c.resources.limits):
                if any(name in self.managed_resources for name in rl):
                    return True
        return False

    def filter(self, pod: api.Pod,
               node_names: List[str]) -> Tuple[List[str], Dict[str, str]]:
        """Returns (feasible node names, failed nodes map)
        (reference: extender.go:273 Filter)."""
        if not self.filter_verb:
            return node_names, {}
        args = {"Pod": _pod_doc(pod), "NodeNames": node_names}
        try:
            result = self._send(self.filter_verb, args)
        except Exception as e:
            if self.ignorable:
                return node_names, {}
            raise ExtenderError(str(e))
        if result.get("Error"):
            raise ExtenderError(result["Error"])
        names = result.get("NodeNames")
        if names is None:
            names = node_names
        failed = result.get("FailedNodes") or {}
        return list(names), dict(failed)

    def prioritize(self, pod: api.Pod,
                   node_names: List[str]) -> Dict[str, float]:
        """Returns node -> weighted score contribution
        (reference: extender.go:343 Prioritize; weight application
        generic_scheduler.go:688)."""
        if not self.prioritize_verb:
            return {}
        args = {"Pod": _pod_doc(pod), "NodeNames": node_names}
        try:
            result = self._send(self.prioritize_verb, args)
        except Exception as e:
            if self.ignorable:
                return {}
            raise ExtenderError(str(e))
        out = {}
        for hp in result or []:
            out[hp["Host"]] = float(hp["Score"]) * self.weight
        return out

    def is_binder(self) -> bool:
        return bool(self.bind_verb)

    def bind(self, pod: api.Pod, node_name: str) -> None:
        """reference: extender.go:385 Bind."""
        args = {"PodName": pod.metadata.name,
                "PodNamespace": pod.namespace,
                "PodUID": pod.uid,
                "Node": node_name}
        result = self._send(self.bind_verb, args)
        if result.get("Error"):
            raise ExtenderError(result["Error"])

    def supports_preemption(self) -> bool:
        return bool(self.preempt_verb)

    def process_preemption(self, pod: api.Pod, node_victims: Dict):
        """reference: core/extender.go:317 ProcessPreemption — the extender
        may trim victims per node or drop nodes entirely; nodes absent from
        its result are no longer preemption candidates.  node_victims maps
        node name -> Victims (kubetpu_torch.preemption)."""
        from .preemption import Victims
        args = {
            "pod": _pod_doc(pod),
            "nodeNameToMetaVictims": {
                name: {
                    "pods": [{"uid": p.uid} for p in v.pods],
                    "numPDBViolations": v.num_pdb_violations,
                } for name, v in node_victims.items()},
        }
        result = self._send(self.preempt_verb, args)
        by_uid = {p.uid: p
                  for v in node_victims.values() for p in v.pods}
        out = {}
        for name, meta in (result.get("nodeNameToMetaVictims") or {}).items():
            if name not in node_victims:
                continue  # never accept nodes we did not offer
            pods = [by_uid[m["uid"]] for m in (meta.get("pods") or [])
                    if m.get("uid") in by_uid]
            out[name] = Victims(
                pods=pods,
                num_pdb_violations=meta.get("numPDBViolations", 0))
        return out
