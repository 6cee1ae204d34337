"""Which round the gang auction runs a batch through: the content routing
of ``kernel_backend="pallas"`` (kubetpu/utils/pallas_backend.py's
``unsupported_reason`` and ``effective_backend``).

The fused propose kernel (ops/propose.py) reproduces the lax round's
score surface only for term-free batches: its planes are computed once
per auction, and it scores PodTopologySpread through the
no-soft-constraints constant.  So "pallas" serves a batch when no pod
needs intra-batch topology, every score plugin is one the kernel knows,
and no pod carries a soft spread constraint; any other batch runs the lax
round.  The decision is made before the auction from what the batch
holds, and the caller records it.  It is not a fallback: on CUDA tensors
the kernel builds and launches, or raises.

``demote`` (kubetpu/utils/pallas_backend.py:97-115) routes every later
cycle of the process lax, with its reason, until ``reset_demotion``.  In
the port it is the operator's switch alone: the scheduler's cycle
recovery never calls it, so a failing kernel raises instead of handing
its work to the plain round.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..ops.propose import SUPPORTED_SCORES

_lock = threading.Lock()
# the operator's demotion latch: the first reason wins, process-wide
_demotion: Optional[str] = None   # kubelint: guarded-by(_lock)


def demote(reason: str) -> None:
    """Route every later cycle of the process to the lax round, with the
    reason recorded (an operator's choice; nothing in the port calls it);
    idempotent, the first reason wins."""
    global _demotion
    with _lock:
        if _demotion is None:
            _demotion = reason


def demotion() -> Optional[str]:
    with _lock:
        return _demotion


def reset_demotion() -> None:
    global _demotion
    with _lock:
        _demotion = None


def unsupported_reason(cfg, intra_batch_topology: bool,
                       batch=None) -> Optional[str]:
    """None when the propose kernel serves this (cfg, routing, batch)
    with the lax round's placements; else a short reason.  A batch on
    the card costs one device->host read of its soft-constraint flags;
    a host (numpy) batch costs none."""
    demoted = demotion()
    if demoted is not None:
        return "demoted:%s" % demoted
    if intra_batch_topology:
        return "intra-batch-topology"
    for name, _ in cfg.scores:
        if name not in SUPPORTED_SCORES:
            return "score:%s" % name
    valid = getattr(getattr(batch, "spread_soft", None), "valid", None)
    if isinstance(valid, (torch.Tensor, np.ndarray)) and bool(valid.any()):
        return "soft-spread-constraints"
    return None


def effective_backend(cfg, intra_batch_topology: bool,
                      requested: Optional[str], batch=None) -> str:
    """The backend schedule_gang runs for this call."""
    if requested != "pallas":
        return "lax"
    return ("pallas"
            if unsupported_reason(cfg, intra_batch_topology, batch) is None
            else "lax")
