"""Scheduler component configuration, limited to what the port reads.

reference: pkg/scheduler/apis/config/types.go — KubeSchedulerConfiguration
:55, KubeSchedulerProfile :115.  The JAX package's configuration carries
many more fields (plugins, extenders, chaining, pipelining, deadlines);
the port reads only those below.  ``mode`` must be "gang": the default
"sequential" replay is not ported yet and raises (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

DEFAULT_SCHEDULER_NAME = "default-scheduler"
MODES = ("gang",)
KERNEL_BACKENDS = ("lax", "pallas")


@dataclass
class KubeSchedulerProfile:
    """reference: types.go:115 — the default plugin set only."""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME


@dataclass
class KubeSchedulerConfiguration:
    """reference: types.go:55."""
    profiles: List[KubeSchedulerProfile] = field(default_factory=list)
    pod_initial_backoff_seconds: float = 1.0     # types.go:97
    pod_max_backoff_seconds: float = 10.0        # types.go:103
    batch_size: int = 256        # pods per device batch (the B axis)
    # "sequential" (the reference's default, the serial replay) is not
    # ported yet; the slice serves "gang"
    mode: str = "sequential"
    # "lax": every auction round through the plain PyTorch round;
    # "pallas": rounds after the first through the fused propose kernel
    # (ops/propose.py; the name matches the JAX package's option)
    kernel_backend: str = "lax"

    def validate(self) -> None:
        if self.mode not in MODES:
            raise NotImplementedError(
                "mode %r is not ported (ROADMAP: sequential replay); "
                "use mode='gang'" % self.mode)
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError("kernel_backend must be one of %s"
                             % (KERNEL_BACKENDS,))
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
