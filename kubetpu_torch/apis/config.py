"""Scheduler component configuration objects.

reference: pkg/scheduler/apis/config/types.go — KubeSchedulerConfiguration
:55, KubeSchedulerProfile :115, Plugins :176, PluginSet :217, Plugin :230,
DefaultPercentageOfNodesToScore :251; the counterpart of
kubetpu/apis/config.py.  YAML decoding, defaulting and validation live in
apis/load.py.  The JAX package's serving-runtime knobs are here with its
defaults (leader election, the metrics and health addresses, the dispatch
deadline, bind retries, prewarm, the pipelined drain); meshes are not
ported (ROADMAP queue 1 item 10), and the XLA bucket ladder
``prewarm_ladder`` has no torch counterpart (ROADMAP item 11).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

DEFAULT_SCHEDULER_NAME = "default-scheduler"
DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 0  # 0 => adaptive (types.go:251)
MODES = ("sequential", "gang")
KERNEL_BACKENDS = ("lax", "pallas")

EXTENSION_POINTS = (
    "queue_sort", "pre_filter", "filter", "post_filter", "pre_score",
    "score", "reserve", "permit", "pre_bind", "bind", "post_bind",
    "unreserve",
)


@dataclass
class Plugin:
    """reference: types.go:230 (a name and a score weight)."""
    name: str
    weight: int = 0


@dataclass
class PluginSet:
    """reference: types.go:217."""
    enabled: List[Plugin] = field(default_factory=list)
    disabled: List[Plugin] = field(default_factory=list)


@dataclass
class Plugins:
    """One PluginSet per extension point (reference: types.go:176)."""
    queue_sort: PluginSet = field(default_factory=PluginSet)
    pre_filter: PluginSet = field(default_factory=PluginSet)
    filter: PluginSet = field(default_factory=PluginSet)
    post_filter: PluginSet = field(default_factory=PluginSet)
    pre_score: PluginSet = field(default_factory=PluginSet)
    score: PluginSet = field(default_factory=PluginSet)
    reserve: PluginSet = field(default_factory=PluginSet)
    permit: PluginSet = field(default_factory=PluginSet)
    pre_bind: PluginSet = field(default_factory=PluginSet)
    bind: PluginSet = field(default_factory=PluginSet)
    post_bind: PluginSet = field(default_factory=PluginSet)
    unreserve: PluginSet = field(default_factory=PluginSet)

    def apply(self, custom: Optional["Plugins"]) -> "Plugins":
        """A profile's custom sets merged over these defaults (reference:
        types.go:195 Plugins.Apply / mergePluginSets): per point, the
        defaults minus the disabled ones ("*" disables all), then the
        custom enabled ones."""
        if custom is None:
            return self
        out = Plugins()
        for ep in EXTENSION_POINTS:
            default: PluginSet = getattr(self, ep)
            override: PluginSet = getattr(custom, ep)
            disabled = {p.name for p in override.disabled}
            star = "*" in disabled
            enabled = [p for p in default.enabled
                       if not star and p.name not in disabled]
            enabled += list(override.enabled)
            setattr(out, ep, PluginSet(enabled=enabled))
        return out


@dataclass
class KubeSchedulerProfile:
    """reference: types.go:115.  plugins: custom sets merged over the
    default set (None: the default set); plugin_config: per-plugin
    arguments."""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    plugins: Optional[Plugins] = None
    plugin_config: Dict[str, Any] = field(default_factory=dict)


@dataclass
class KubeSchedulerConfiguration:
    """reference: types.go:55."""
    profiles: List[KubeSchedulerProfile] = field(default_factory=list)
    # the sequential replay searches only the first feasible nodes in
    # rotated order (generic_scheduler.go:379-399); the gang auction always
    # searches every node
    percentage_of_nodes_to_score: int = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE
    pod_initial_backoff_seconds: float = 1.0     # types.go:97
    pod_max_backoff_seconds: float = 10.0        # types.go:103
    # HA / serving (server.py, __main__.py, utils/leaderelection.py)
    leader_election: bool = False
    metrics_bind_address: str = ""
    health_bind_address: str = ""
    # reference: types.go:85 DisablePreemption — off, a pod that fits
    # nowhere is requeued without the PostFilter (no evictions)
    disable_preemption: bool = False
    # reference: types.go:72 Extenders — decoded and validated; a
    # Scheduler refuses them (ROADMAP queue 1 item 8)
    extenders: List[Any] = field(default_factory=list)
    batch_size: int = 256        # pods per device batch (the B axis)
    # "sequential": the serial replay of scheduleOne over the batch
    # (models/sequential.py); "gang": the conflict-free auction
    # (models/gang.py), with intra-batch topology for term-bearing batches
    mode: str = "sequential"
    # "lax": every auction round through the plain PyTorch round;
    # "pallas": rounds after the first through the fused propose kernel
    # (ops/propose.py; the name matches the JAX package's option) for the
    # batches it serves (utils/pallas_backend.py); others run "lax"
    kernel_backend: str = "lax"
    # gang mode: the auction's placements, materialized on the device
    # (models/gang.materialize_assigned), are the next cycle's cluster
    # instead of a refresh; any store event the chain does not account for
    # breaks it (scheduler.py).  The JAX package's default, as here
    chain_cycles: bool = True
    # a cycle whose dispatch raises is recovered: the residents are
    # dropped and the pods requeued (Scheduler._recover_cycle); an error
    # of the kernel path raises instead (ops/_build.kernel_fault).  A cycle
    # whose dispatch-to-readback wall time, less host work on other
    # cycles, exceeds this many seconds is recovered the same way; 0 (the
    # default) turns the deadline off.  Env override:
    # KUBETPU_DISPATCH_DEADLINE
    dispatch_deadline_seconds: float = 0.0
    # a bind that fails with a transport error ("binding rejected: ...")
    # retries this many times on the pod backoff ladder, each attempt
    # first asking the store whether the bind landed (bind is not
    # idempotent)
    bind_retries: int = 2
    # Scheduler.run builds or loads the CUDA kernels and runs one dry
    # cycle before serving, so the first served cycle pays no nvcc
    prewarm: bool = True
    # gang mode with chain_cycles: schedule_pending runs the depth-k
    # pipelined executor (pipeline.py): up to pipeline_depth - 1
    # dispatched cycles stay uncommitted, and outcomes lag as many.
    # Placements equal the synchronous drain's at every depth
    pipeline_cycles: bool = False
    # the most cycles in flight at once; 1 = synchronous.  Env override:
    # KUBETPU_PIPELINE_DEPTH
    pipeline_depth: int = 2
