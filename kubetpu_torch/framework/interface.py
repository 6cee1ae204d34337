"""Scheduler Framework plugin contract, limited to what the port runs.

reference: pkg/scheduler/framework/v1alpha1/interface.go — Status codes :77,
the extension points' plugin interfaces :228-396, PostFilterResult :522.
The counterpart of kubetpu/framework/interface.py.  Tensorized plugins
declare the kernel names the device programs run (models/programs.py);
the port's profiles carry only the default plugin set, so the extension
points that run host code are Bind (DefaultBinder) and PostFilter
(DefaultPreemption).  PreFilter/Reserve/Permit/PreBind/PostBind plugins,
waiting pods and host filter and score plugins are ROADMAP queue 1
(framework extension points).
"""

from __future__ import annotations

from enum import IntEnum
from typing import Dict, List, Optional, Tuple

from ..api import types as api


class Code(IntEnum):
    """reference: interface.go:77-103."""
    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5


class Status:
    """reference: interface.go:106 Status."""

    __slots__ = ("code", "reasons")

    def __init__(self, code: Code = Code.SUCCESS,
                 reasons: Optional[List[str]] = None):
        self.code = code
        self.reasons = reasons or []

    @classmethod
    def success(cls) -> "Status":
        return cls(Code.SUCCESS)

    @classmethod
    def error(cls, msg: str) -> "Status":
        return cls(Code.ERROR, [msg])

    @classmethod
    def unschedulable(cls, *reasons: str) -> "Status":
        return cls(Code.UNSCHEDULABLE, list(reasons))

    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def is_unschedulable(self) -> bool:
        return self.code in (Code.UNSCHEDULABLE,
                             Code.UNSCHEDULABLE_AND_UNRESOLVABLE)

    def message(self) -> str:
        return ", ".join(self.reasons)

    def __repr__(self) -> str:
        return f"Status({self.code.name}, {self.reasons})"


class CycleState:
    """Per-scheduling-cycle key-value store (reference:
    framework/v1alpha1/cycle_state.go:40).  One cycle's state is read and
    written by the scheduling thread only."""

    def __init__(self):
        self._data: Dict[str, object] = {}

    def read(self, key: str):
        return self._data[key]      # KeyError when absent, as the reference

    def write(self, key: str, value: object) -> None:
        self._data[key] = value


# ---------------------------------------------------------------------------
# plugin interfaces (reference: interface.go:228-396)


class Plugin:
    NAME = "Plugin"

    def name(self) -> str:
        return self.NAME


class QueueSortPlugin(Plugin):
    def sort_key(self, qp) -> tuple:
        """Total-order key of the queue's less-func, taken at enqueue."""
        raise NotImplementedError


class FilterPlugin(Plugin):
    pass


class PostFilterResult:
    """reference: framework/v1alpha1/interface.go:522."""
    __slots__ = ("nominated_node_name",)

    def __init__(self, nominated_node_name: str = ""):
        self.nominated_node_name = nominated_node_name


class PostFilterPlugin(Plugin):
    """Called when no node passed filtering; may make the pod schedulable
    (by preempting).  Statuses: SUCCESS (made schedulable, the result may
    nominate a node), UNSCHEDULABLE (ran fine, could not help), anything
    else is an error (reference: interface.go:278, framework.go:516)."""

    def post_filter(self, state: CycleState, pod: api.Pod,
                    filtered_node_status: Dict[str, Status]
                    ) -> Tuple[Optional[PostFilterResult], Status]:
        raise NotImplementedError


class ScorePlugin(Plugin):
    pass


class BindPlugin(Plugin):
    def bind(self, state: CycleState, pod: api.Pod, node_name: str) -> Status:
        """SKIP passes to the next bind plugin (reference:
        interface.go:376)."""
        raise NotImplementedError


class TensorPlugin(Plugin):
    """A plugin whose Filter/Score semantics are device kernels: the
    framework collects the names into the programs' ProgramConfig instead
    of calling per-node Python methods."""
    FILTER_KERNEL: Optional[str] = None   # name in programs.run_filters
    SCORE_KERNEL: Optional[str] = None    # name in programs.run_scores
