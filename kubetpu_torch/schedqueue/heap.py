"""Keyed min-heap with push-time sort keys.

reference: pkg/scheduler/internal/heap/heap.go (Heap :127, data :36 — a
keyed heap over interface{} items with Add/Update/Delete/Peek/Pop/Get).

Unlike the Go heap (which re-heapifies via interface methods), this port
snapshots each item's sort key AT PUSH TIME.  Queue code mutates
QueuedPodInfo in place (timestamps, pod updates), which would corrupt a
comparison-at-pop-time heap; freezing the key on push keeps the heapq
invariant regardless of later mutation, and updates simply push a fresh
entry (lazy deletion drops the stale one by sequence number).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple


class Heap:
    def __init__(self, key_func: Callable[[Any], str],
                 sort_key: Callable[[Any], Tuple],
                 metric_recorder=None):
        self._key = key_func
        self._sort_key = sort_key
        self._items: Dict[str, Any] = {}
        self._live_seq: Dict[str, int] = {}
        self._heap: List[Tuple[Tuple, int, str]] = []
        self._seq = itertools.count()
        self._recorder = metric_recorder

    def add(self, item: Any) -> None:
        """Insert or overwrite (reference: heap.go:173 Add — Update is Add)."""
        k = self._key(item)
        if k not in self._items and self._recorder:
            self._recorder.inc()
        seq = next(self._seq)
        self._items[k] = item
        self._live_seq[k] = seq
        heapq.heappush(self._heap, (self._sort_key(item), seq, k))

    update = add

    def delete(self, item: Any) -> bool:
        k = self._key(item)
        if k in self._items:
            del self._items[k]
            del self._live_seq[k]
            if self._recorder:
                self._recorder.dec()
            return True
        return False

    def get(self, item: Any) -> Optional[Any]:
        return self.get_by_key(self._key(item))

    def get_by_key(self, key: str) -> Optional[Any]:
        return self._items.get(key)

    def peek(self) -> Optional[Any]:
        self._drop_stale()
        if not self._heap:
            return None
        return self._items[self._heap[0][2]]

    def pop(self) -> Optional[Any]:
        self._drop_stale()
        if not self._heap:
            return None
        _, _, k = heapq.heappop(self._heap)
        item = self._items.pop(k)
        del self._live_seq[k]
        if self._recorder:
            self._recorder.dec()
        return item

    def _drop_stale(self) -> None:
        while self._heap:
            _, seq, k = self._heap[0]
            if self._live_seq.get(k) != seq:
                heapq.heappop(self._heap)
            else:
                return

    def list(self) -> List[Any]:
        return list(self._items.values())

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, item: Any) -> bool:
        return self._key(item) in self._items
