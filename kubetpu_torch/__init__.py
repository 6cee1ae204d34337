"""PyTorch/CUDA port of the kubetpu batch scheduler.

The JAX package ``kubetpu`` is the reference.  This package keeps its
module names (so each counterpart is easy to find) and imports nothing of
it or of JAX.  Entry points: ``kubetpu_torch.scheduler.Scheduler(store,
config)`` with ``.schedule_pending()`` or ``.run()``, and ``python -m
kubetpu_torch``, on a CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``).
"""
