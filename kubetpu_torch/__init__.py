"""PyTorch/CUDA port of the kubetpu batch scheduler.

The JAX package ``kubetpu`` is the reference.  This package keeps its
module names (so each counterpart is easy to find) and imports nothing of
it or of JAX.  Entry points: ``kubetpu_torch.scheduler.Scheduler(store,
config)`` with ``.schedule_pending()`` or ``.run()``, and ``python -m
kubetpu_torch``, on a CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``).

Importing the package arms the cycle flight recorder iff
``KUBETPU_FLIGHT=1`` (utils/trace.py); off, the import touches nothing.
"""

from .utils.trace import maybe_arm_from_env as _maybe_flight

_maybe_flight()
