"""PyTorch/CUDA port of the kubetpu batch scheduler.

The JAX package ``kubetpu`` is the reference.  This package keeps its
module names (so each counterpart is easy to find) and imports nothing of
it or of JAX.  Entry points: ``kubetpu_torch.scheduler.Scheduler(store,
config)`` with ``.schedule_pending()`` or ``.run()``, and ``python -m
kubetpu_torch``, on a CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``).

Importing the package arms the opt-in runtime harnesses, as the JAX
package's import does:

* ``KUBETPU_SANITIZE=1`` (utils/sanitize.py): the NaN and
  rank-promotion checks of every aten op and the compile-count watchdog;
* ``KUBETPU_RACE=1`` (utils/racecheck.py): instrumented locks (order and
  hold-time enforcement) and guarded-attribute mutation checks for the
  threaded host path;
* ``KUBETPU_FLIGHT=1`` (utils/trace.py): the cycle flight recorder.

Off (the default) the import touches nothing.
"""

from .utils.racecheck import maybe_enable_from_env as _maybe_racecheck
from .utils.sanitize import maybe_enable_from_env as _maybe_sanitize
from .utils.trace import maybe_arm_from_env as _maybe_flight

_maybe_sanitize()
_maybe_racecheck()
_maybe_flight()
