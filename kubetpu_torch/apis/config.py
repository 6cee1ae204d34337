"""Scheduler component configuration, limited to what the port reads.

reference: pkg/scheduler/apis/config/types.go — KubeSchedulerConfiguration
:55, KubeSchedulerProfile :115, DefaultPercentageOfNodesToScore :251.
The JAX package's configuration carries many more fields (plugins,
extenders, chaining, pipelining, deadlines); the port reads only those
below.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

DEFAULT_SCHEDULER_NAME = "default-scheduler"
DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 0  # 0 => adaptive (types.go:251)
MODES = ("sequential", "gang")
KERNEL_BACKENDS = ("lax", "pallas")


@dataclass
class KubeSchedulerProfile:
    """reference: types.go:115 — the default plugin set only."""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME


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
    # reference: types.go:85 DisablePreemption — off, a pod that fits
    # nowhere is requeued without the PostFilter (no evictions)
    disable_preemption: bool = False

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError("mode must be one of %s" % (MODES,))
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError("kernel_backend must be one of %s"
                             % (KERNEL_BACKENDS,))
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if not 0 <= self.percentage_of_nodes_to_score <= 100:
            raise ValueError("percentage_of_nodes_to_score must lie in "
                             "[0, 100]")
