"""Fake scheduler cache for unit tests.

reference: pkg/scheduler/internal/cache/fake/fake_cache.go — a no-op Cache
whose assume/forget/is-assumed behaviors are injectable hooks, so tests can
observe or script the scheduler's cache interactions without real state.
A copy of kubetpu/state/fake.py over the port's API types and Snapshot.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..api import types as api
from .cache import Snapshot


class FakeCache:
    """Drop-in for SchedulerCache in tests: every method is a no-op unless
    a hook is injected (assume_fn / forget_fn / is_assumed_fn / get_pod_fn,
    mirroring fake_cache.go's AssumeFunc et al)."""

    def __init__(self,
                 assume_fn: Optional[Callable[[api.Pod], None]] = None,
                 forget_fn: Optional[Callable[[api.Pod], None]] = None,
                 is_assumed_fn: Optional[Callable[[api.Pod], bool]] = None,
                 get_pod_fn: Optional[Callable[[api.Pod],
                                               Optional[api.Pod]]] = None):
        self.assume_fn = assume_fn
        self.forget_fn = forget_fn
        self.is_assumed_fn = is_assumed_fn
        self.get_pod_fn = get_pod_fn
        self.assumed_pods: Dict[str, bool] = {}

    # -- pods ---------------------------------------------------------------

    def assume_pod(self, pod: api.Pod, pinfo=None) -> None:
        if self.assume_fn:
            self.assume_fn(pod)

    def finish_binding(self, pod: api.Pod, now=None) -> None:
        pass

    def forget_pod(self, pod: api.Pod) -> None:
        if self.forget_fn:
            self.forget_fn(pod)

    def add_pod(self, pod: api.Pod) -> None:
        pass

    def update_pod(self, old: api.Pod, new: api.Pod) -> None:
        pass

    def remove_pod(self, pod: api.Pod) -> None:
        pass

    def get_pod(self, pod: api.Pod) -> Optional[api.Pod]:
        return self.get_pod_fn(pod) if self.get_pod_fn else pod

    def is_assumed_pod(self, pod: api.Pod) -> bool:
        return self.is_assumed_fn(pod) if self.is_assumed_fn else False

    # -- nodes / snapshot ---------------------------------------------------

    def add_node(self, node: api.Node) -> None:
        pass

    def update_node(self, old: api.Node, new: api.Node) -> None:
        pass

    def remove_node(self, node: api.Node) -> None:
        pass

    def node_info(self, name: str):
        return None

    def node_fit_view(self, name: str):
        return None

    def node_count(self) -> int:
        return 0

    def pod_count(self) -> int:
        return 0

    def update_snapshot(self, snapshot: Snapshot) -> None:
        pass

    def cleanup_assumed_pods(self, now=None) -> None:
        pass

    def run(self) -> None:
        pass

    def close(self) -> None:
        pass

    def dump(self) -> Dict[str, object]:
        return {"nodes": {}, "assumed_pods": []}
