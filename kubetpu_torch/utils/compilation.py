"""The kernel-library cache: where the port's compiled CUDA kernels live.

The twin of kubetpu/utils/compilation.py.  The JAX package turns on JAX's
persistent XLA cache so a restart loads its programs instead of
compiling them again.  The port compiles one thing, the kernel libraries
of ``ops/csrc/`` (nvcc, ops/_build.py), each named by a hash of its
source and flags; this module chooses the directory they are cached in,
so a restart, or every process of one deployment, finds them built.

Precedence: an explicit ``cache_dir`` argument, then
``KUBETPU_KERNEL_CACHE_DIR``, then ``kubetpu_torch/_build/`` (listed in
.gitignore).  The first call wins, as the JAX twin respects a
``jax_compilation_cache_dir`` the embedding application already set:
whoever calls first (the application, or the Scheduler's constructor)
fixes the directory for the process, and later calls return it.

No twin: ``jax_persistent_cache_min_compile_time_secs`` and
``jax_persistent_cache_min_entry_size_bytes`` (the JAX module sets both
to 0).  Every kernel library is cached whatever its build time or size.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

ENV = "KUBETPU_KERNEL_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

_lock = threading.Lock()
_enabled: Optional[str] = None  # kubelint: guarded-by(_lock)


def enable_persistent_cache(cache_dir: Optional[str] = None) -> str:
    """Idempotently choose the kernel-library directory (created if
    missing); returns the directory in use."""
    global _enabled
    with _lock:
        if _enabled:
            return _enabled
        chosen = cache_dir or os.environ.get(ENV) or DEFAULT_CACHE_DIR
        os.makedirs(chosen, exist_ok=True)
        _enabled = chosen
        return chosen


def cache_dir() -> str:
    """The directory in use, chosen with the defaults at the first call
    if nothing chose it before."""
    return _enabled or enable_persistent_cache()
