"""Framework runner: one profile's plugin set.

reference: pkg/scheduler/framework/v1alpha1/framework.go (NewFramework
:205, RunPostFilterPlugins :514, RunBindPlugins :708); the counterpart of
kubetpu/framework/runtime.py.  The enabled plugins split into tensorized
plugins, whose kernel names make the profile's ProgramConfig
(``tensor_filters``, ``tensor_scores``, ``tensor_plugin_args``), and the
host plugins of the points the port runs: Bind and PostFilter.  A profile
takes the default plugin set only (framework/provider.py); custom plugin
sets, host filter and score plugins and the PreFilter/Reserve/Permit/
PreBind/PostBind points are ROADMAP queue 1 (framework extension points).
No Permit plugin exists, so no pod ever waits on one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import types as api
from ..apis.config import KubeSchedulerProfile
from . import interface as fw
from .interface import Code, CycleState, Status, TensorPlugin
from .provider import default_plugins


class Framework:
    """One framework per profile (reference: framework.go:96)."""

    def __init__(self, registry, profile: Optional[KubeSchedulerProfile] = None,
                 client=None):
        self.client = client
        self.profile_name = (profile.scheduler_name if profile
                             else KubeSchedulerProfile().scheduler_name)
        plugins = default_plugins()
        self._instances: Dict[str, fw.Plugin] = {}

        def instantiate(name: str) -> fw.Plugin:
            if name not in self._instances:
                factory = registry.get(name)
                if factory is None:
                    raise ValueError(f"plugin {name} not in registry")
                self._instances[name] = factory(None, self)
            return self._instances[name]

        def point(name, iface) -> List[fw.Plugin]:
            out = []
            for pname, _ in plugins[name]:
                inst = instantiate(pname)
                if not isinstance(inst, iface):
                    raise ValueError(f"plugin {pname} does not implement "
                                     f"{iface.__name__}")
                out.append(inst)
            return out

        self.queue_sort_plugins = point("queue_sort", fw.QueueSortPlugin)
        self.filter_plugins = point("filter", fw.FilterPlugin)
        self.post_filter_plugins = point("post_filter", fw.PostFilterPlugin)
        self.score_plugins = point("score", fw.ScorePlugin)
        self.score_weights = {n: w or 1 for n, w in plugins["score"]}
        self.bind_plugins = point("bind", fw.BindPlugin)

        # -- tensor partition: every filter and score plugin of the
        # default set is tensorized
        self.tensor_filters: Tuple[str, ...] = tuple(
            p.FILTER_KERNEL for p in self.filter_plugins
            if isinstance(p, TensorPlugin) and p.FILTER_KERNEL)
        self.tensor_scores: Tuple[Tuple[str, int], ...] = tuple(
            (p.SCORE_KERNEL, self.score_weights[p.name()])
            for p in self.score_plugins
            if isinstance(p, TensorPlugin) and p.SCORE_KERNEL)
        ipa = self._instances.get("InterPodAffinity")
        self.hard_pod_affinity_weight = getattr(
            ipa, "hard_pod_affinity_weight", 1)

    def tensor_plugin_args(self, table) -> Tuple[Tuple[str, Tuple], ...]:
        """Per-plugin static kernel args resolved against the intern
        table; none of the default set takes any."""
        return ()

    # -- extension points ---------------------------------------------------

    def run_post_filter_plugins(self, state: CycleState, pod: api.Pod,
                                filtered_node_status=None):
        """reference: framework.go:514 RunPostFilterPlugins — run until the
        first SUCCESS or error; UNSCHEDULABLE statuses accumulate.  Returns
        (PostFilterResult or None, Status)."""
        reasons: List[str] = []
        for p in self.post_filter_plugins:
            r, st = p.post_filter(state, pod, filtered_node_status or {})
            if st.is_success():
                return r, st
            if not st.is_unschedulable():
                return None, Status.error(
                    f'error while running "{p.name()}" postfilter plugin: '
                    f'{st.message()}')
            reasons.extend(st.reasons)
        return None, Status(Code.UNSCHEDULABLE, reasons)

    def run_bind_plugins(self, state: CycleState, pod: api.Pod,
                         node_name: str) -> Status:
        """reference: framework.go:708 — SKIP falls through to the next
        binder."""
        for p in self.bind_plugins:
            st = p.bind(state, pod, node_name)
            if st.code == Code.SKIP:
                continue
            return st
        return Status(Code.SKIP, [
            f"all bind plugins skipped binding pod "
            f"{pod.namespace}/{pod.metadata.name}"])

    def iterate_over_waiting_pods(self, fn) -> None:
        """FrameworkHandle (interface.go:493): no Permit plugin runs, so no
        pod is waiting and ``fn`` is never called."""
