"""Cache debugger: dump + cache-vs-store drift comparison on SIGUSR2.

reference: pkg/scheduler/internal/cache/debugger/ — debugger.go:57
(ListenForSignal), comparer.go (CompareNodes/ComparePods against the
informer caches), dumper.go (cache + queue dump).  A copy of
kubetpu/state/debugger.py on the port's own cache, queue and store.  The
drift comparer is the reference's race detector for the assume/forget
protocol, kept host-side though the device snapshots are immutable.
"""

from __future__ import annotations

import logging
import signal
from typing import List, Tuple

LOG = logging.getLogger("kubetpu_torch.debugger")


class CacheComparer:
    """reference: debugger/comparer.go."""

    def __init__(self, store, cache, queue):
        self.store = store
        self.cache = cache
        self.queue = queue

    def compare_nodes(self) -> Tuple[List[str], List[str]]:
        actual = {n.metadata.name for n in self.store.list("Node")}
        cached = {name for name, item in self.cache.nodes.items()
                  if item.info.node is not None}
        missed = sorted(actual - cached)
        redundant = sorted(cached - actual)
        return missed, redundant

    def compare_pods(self) -> Tuple[List[str], List[str]]:
        actual = {p.uid for p in self.store.list("Pod") if p.spec.node_name}
        cached = set(self.cache.pod_states)
        queued = {p.uid for p in self.queue.pending_pods()}
        missed = sorted(actual - cached - queued)
        redundant = sorted(cached - actual - set(self.cache.assumed_pods))
        return missed, redundant

    def compare(self) -> bool:
        """Returns True when cache and store agree; logs drift otherwise."""
        ok = True
        missed, redundant = self.compare_nodes()
        if missed or redundant:
            LOG.error("cache comparer: nodes missed %s redundant %s",
                      missed, redundant)
            ok = False
        missed, redundant = self.compare_pods()
        if missed or redundant:
            LOG.error("cache comparer: pods missed %s redundant %s",
                      missed, redundant)
            ok = False
        return ok


class CacheDumper:
    """reference: debugger/dumper.go."""

    def __init__(self, cache, queue):
        self.cache = cache
        self.queue = queue

    def dump(self) -> str:
        lines = ["Dump of cached NodeInfo:"]
        for name, item in self.cache.nodes.items():
            info = item.info
            lines.append(
                f'Node name: {name}; Requested: cpu={info.requested.milli_cpu}m '
                f'mem={info.requested.memory}; Pods: '
                f'{[p.pod.metadata.name for p in info.pods]}')
        lines.append("Dump of scheduling queue:")
        for p in self.queue.pending_pods():
            lines.append(f"  {p.namespace}/{p.metadata.name}")
        out = "\n".join(lines)
        LOG.info(out)
        return out


class CacheDebugger:
    """reference: debugger/debugger.go:57 — SIGUSR2 triggers dump+compare."""

    def __init__(self, store, cache, queue):
        self.comparer = CacheComparer(store, cache, queue)
        self.dumper = CacheDumper(cache, queue)

    def listen_for_signal(self) -> None:
        def handler(signum, frame):
            self.dumper.dump()
            self.comparer.compare()
        signal.signal(signal.SIGUSR2, handler)
