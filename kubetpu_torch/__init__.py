"""PyTorch/CUDA port of the kubetpu batch scheduler.

The JAX package ``kubetpu`` is the reference.  This package keeps its
module names (so each counterpart is easy to find) and imports nothing of
it or of JAX.  Entry point: ``kubetpu_torch.scheduler.Scheduler(store,
config).schedule_pending()``, on a CUDA device unless the caller passes
``device="cpu"``.
"""
