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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.propose import SUPPORTED_SCORES


def unsupported_reason(cfg, intra_batch_topology: bool,
                       batch=None) -> Optional[str]:
    """None when the propose kernel serves this (cfg, routing, batch)
    with the lax round's placements; else a short reason.  A batch on
    the card costs one device->host read of its soft-constraint flags;
    a host (numpy) batch costs none."""
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
