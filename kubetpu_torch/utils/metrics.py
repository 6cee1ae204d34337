"""Metrics: Prometheus-style registry + the scheduler metric set.

reference: staging/src/k8s.io/component-base/metrics (stability framework
over Prometheus; legacyregistry) and pkg/scheduler/metrics/metrics.go —
schedule_attempts_total :54, e2e_scheduling_duration_seconds :83,
scheduling_algorithm_duration_seconds :92, binding_duration_seconds :130,
pending_pods :155, pod_scheduling_duration_seconds :170,
pod_scheduling_attempts :180, framework_extension_point_duration_seconds
:189, plugin_execution_duration_seconds :200 (10% sampled),
queue_incoming_pods_total :212, scheduler_cache_size :230; queue-depth
gauges via the async MetricRecorder (metric_recorder.go) plumbed into the
heaps (scheduling_queue.go:230-235).

A copy of kubetpu/utils/metrics.py without its SLO and telemetry
exporters (those layers are not ported: ROADMAP queue 1 item 11).  The
port's scheduler feeds the cycle, recovery, binding, attempt, cache-size
and queue series where the JAX scheduler does; the framework's per-point
durations, the journal, chaos and flight-recorder series stay at zero
until item 11.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

# default duration buckets (prometheus.DefBuckets)
DEF_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    def __init__(self, name: str, help_: str, label_names=()):
        self.name, self.help = name, help_
        self.label_names = tuple(label_names)
        self._vals: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, *labels, amount: float = 1.0):
        with self._lock:
            self._vals[labels] = self._vals.get(labels, 0.0) + amount

    def value(self, *labels) -> float:
        with self._lock:
            return self._vals.get(labels, 0.0)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._vals.items())
        for labels, v in items:
            out.append(f"{self.name}{_fmt(self.label_names, labels)} {v}")
        return out


class Gauge(Counter):
    def set(self, value: float, *labels):
        with self._lock:
            self._vals[labels] = value

    def inc(self, *labels, amount: float = 1.0):
        super().inc(*labels, amount=amount)

    def dec(self, *labels):
        super().inc(*labels, amount=-1.0)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._vals.items())
        for labels, v in items:
            out.append(f"{self.name}{_fmt(self.label_names, labels)} {v}")
        return out


class Histogram:
    def __init__(self, name: str, help_: str, label_names=(),
                 buckets=DEF_BUCKETS):
        self.name, self.help = name, help_
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, *labels):
        with self._lock:
            counts = self._counts.setdefault(labels,
                                             [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf
            self._sums[labels] = self._sums.get(labels, 0.0) + value

    def count(self, *labels) -> int:
        with self._lock:
            c = self._counts.get(labels)
            return c[-1] if c else 0

    def sum(self, *labels) -> float:
        with self._lock:
            return self._sums.get(labels, 0.0)

    def percentile(self, q: float, *labels) -> float:
        """Approximate quantile from bucket counts (upper bound)."""
        with self._lock:
            c = self._counts.get(labels)
            c = list(c) if c else None
        if not c or c[-1] == 0:
            return 0.0
        target = q * c[-1]
        for i, b in enumerate(self.buckets):
            if c[i] >= target:
                return b
        # above the largest finite bucket: clamp (keeps JSON outputs finite)
        return self.buckets[-1]

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            snapshot = sorted((k, list(v), self._sums[k])
                              for k, v in self._counts.items())
        for labels, counts, total in snapshot:
            for i, b in enumerate(self.buckets):
                lb = _fmt(self.label_names + ("le",), labels + (str(b),))
                out.append(f"{self.name}_bucket{lb} {counts[i]}")
            lb = _fmt(self.label_names + ("le",), labels + ("+Inf",))
            out.append(f"{self.name}_bucket{lb} {counts[-1]}")
            out.append(f"{self.name}_sum{_fmt(self.label_names, labels)} "
                       f"{total}")
            out.append(f"{self.name}_count{_fmt(self.label_names, labels)} "
                       f"{counts[-1]}")
        return out


def _escape_label(value) -> str:
    """Prometheus text-format label-value escaping (exposition format
    spec): backslash, double-quote and newline must be escaped or a
    label value containing any of them corrupts the whole scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """# HELP escaping per the exposition format: backslash and newline
    (quotes are legal in help text)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(names, values) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + pairs + "}"


class Registry:
    def __init__(self):
        self._metrics: List = []
        self._lock = threading.Lock()

    def register(self, m):
        with self._lock:
            self._metrics.append(m)
        return m

    def expose_text(self) -> str:
        with self._lock:
            lines: List[str] = []
            for m in self._metrics:
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"


class _QueueRecorder:
    """Per-queue depth recorder handed to the heaps
    (reference: metrics/metric_recorder.go PendingPodsRecorder)."""

    def __init__(self, gauge: Gauge, label: str):
        self._g, self._label = gauge, label

    def inc(self):
        self._g.inc(self._label)

    def dec(self):
        self._g.dec(self._label)


SCHEDULER_SUBSYSTEM = "scheduler"


class SchedulerMetrics:
    """The §2.1 metric set (reference: pkg/scheduler/metrics/metrics.go)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry.register
        p = SCHEDULER_SUBSYSTEM
        self.schedule_attempts = r(Counter(
            f"{p}_schedule_attempts_total",
            "Number of attempts to schedule pods, by result.", ("result",)))
        self.e2e_scheduling_duration = r(Histogram(
            f"{p}_e2e_scheduling_duration_seconds",
            "E2e scheduling latency (scheduling algorithm + binding)."))
        self.scheduling_algorithm_duration = r(Histogram(
            f"{p}_scheduling_algorithm_duration_seconds",
            "Scheduling algorithm latency."))
        self.binding_duration = r(Histogram(
            f"{p}_binding_duration_seconds", "Binding latency."))
        self.pod_scheduling_duration = r(Histogram(
            f"{p}_pod_scheduling_duration_seconds",
            "E2e latency for a pod being scheduled, from first attempt.",
            buckets=tuple(0.01 * 2 ** i for i in range(16))))  # :170 (to ~512s)
        self.pod_scheduling_attempts = r(Histogram(
            f"{p}_pod_scheduling_attempts",
            "Number of attempts to successfully schedule a pod.",
            buckets=(1, 2, 4, 8, 16)))
        # observed by framework/runtime.py at the HOST extension points
        # that run once per pod per cycle (PreFilter, PostFilter, Reserve,
        # Permit, PreBind, Bind, PostBind) — NOT the per-(pod, node)
        # Filter loop, whose per-call observe would poison the hot path.
        # The reference's plugin_execution_duration_seconds (per-plugin,
        # 10% sampled) is deliberately NOT ported: host plugins here are
        # the thin residue of a batched device design, per-plugin wall
        # time is meaningless for the jitted families (one fused program
        # serves every plugin), and per-plugin ATTRIBUTION is already
        # served losslessly by the decision audit +
        # scheduler_framework_rejections_total{plugin}.
        self.framework_extension_point_duration = r(Histogram(
            f"{p}_framework_extension_point_duration_seconds",
            "Latency for running all plugins of a specific extension point.",
            ("extension_point", "status")))
        self.queue_incoming_pods = r(Counter(
            f"{p}_queue_incoming_pods_total",
            "Number of pods added to scheduling queues by event and queue type.",
            ("queue", "event")))
        self.pending_pods = r(Gauge(
            f"{p}_pending_pods",
            "Number of pending pods, by the queue type.", ("queue",)))
        # observed by preemption.py: victims per committed preemption
        # (at _commit_victims) and eligible pods served per wave
        self.preemption_victims = r(Histogram(
            f"{p}_preemption_victims", "Number of selected preemption victims",
            buckets=(1, 2, 4, 8, 16, 32, 64)))
        self.preemption_attempts = r(Counter(
            f"{p}_preemption_attempts_total",
            "Total preemption attempts in the cluster till now"))
        self.cache_size = r(Gauge(
            f"{p}_scheduler_cache_size",
            "Number of nodes, pods, and assumed pods in the cache.", ("type",)))
        # observed by framework/runtime.py wait_on_permit, only for pods
        # that actually entered a Wait (result: allowed/rejected/timeout)
        self.permit_wait_duration = r(Histogram(
            f"{p}_permit_wait_duration_seconds",
            "Duration of waiting on permit.", ("result",)))
        # the batch scheduler's own: device program time per batch
        self.device_batch_duration = r(Histogram(
            f"{p}_device_batch_duration_seconds",
            "Jitted schedule program wall time per pod batch."))
        self.device_batch_size = r(Histogram(
            f"{p}_device_batch_size", "Pods per device batch.",
            buckets=(1, 8, 32, 128, 512, 2048, 8192)))
        # observability layer (utils/trace.py flight recorder +
        # utils/decisions.py audit): per-plugin rejection attribution and
        # the recorder ring's drop count
        self.framework_rejections = r(Counter(
            f"{p}_framework_rejections_total",
            "Unschedulable pods attributed to the decisive filter plugin "
            "by the per-pod decision audit.", ("plugin",)))
        self.flight_recorder_dropped = r(Counter(
            f"{p}_flight_recorder_dropped_total",
            "Cycle records dropped by the flight recorder's ring buffer."))
        # self-healing runtime (utils/chaos.py + the recovery machinery):
        # faults the armed chaos registry injected, by point, and the
        # recoveries the runtime performed — dispatch-error /
        # dispatch-deadline recoveries, bind retries, anti-entropy
        # verify resyncs, aot artifact fallbacks
        self.faults_injected = r(Counter(
            f"{p}_faults_injected_total",
            "Faults injected by the armed chaos registry, by point.",
            ("point",)))
        self.recoveries = r(Counter(
            f"{p}_recoveries_total",
            "Self-healing recoveries performed by the runtime, by kind.",
            ("kind",)))
        # durable cycle journal (utils/journal.py): records appended,
        # bytes currently retained on disk, and records dropped — write
        # failures AND size-cap evictions both count (never silent).
        # Synced on the serving thread like the chaos counters.
        self.journal_records = r(Counter(
            f"{p}_journal_records_total",
            "Cycle records appended to the durable journal."))
        self.journal_bytes = r(Gauge(
            f"{p}_journal_bytes",
            "Bytes of cycle records currently retained by the journal."))
        self.journal_dropped = r(Counter(
            f"{p}_journal_dropped_total",
            "Journal records dropped: write failures plus size-cap "
            "evictions."))

    # hooks consumed by queue/scheduler ------------------------------------

    def active_recorder(self):
        return _QueueRecorder(self.pending_pods, "active")

    def backoff_recorder(self):
        return _QueueRecorder(self.pending_pods, "backoff")

    def unschedulable_recorder(self):
        return _QueueRecorder(self.pending_pods, "unschedulable")

    def incoming(self, event: str, queue: str):
        self.queue_incoming_pods.inc(queue, event)

    def observe_cycle(self, n_pods: int, seconds: float):
        if n_pods > 0:
            self.device_batch_size.observe(n_pods)
            self.device_batch_duration.observe(seconds)
            self.scheduling_algorithm_duration.observe(seconds / n_pods)

    def pod_scheduled(self, attempts: int, since_first_attempt: float,
                      e2e: float):
        self.schedule_attempts.inc("scheduled")
        self.pod_scheduling_attempts.observe(attempts)
        self.pod_scheduling_duration.observe(since_first_attempt)
        self.e2e_scheduling_duration.observe(e2e)

    def pod_unschedulable(self):
        self.schedule_attempts.inc("unschedulable")

    def expose_text(self) -> str:
        return self.registry.expose_text()
