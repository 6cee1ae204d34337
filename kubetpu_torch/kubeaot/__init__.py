"""kubeaot: deploy-time kernel artifacts for the port.

The twin of tools/kubeaot, the build half of utils/aot.py.  ``build
DIR`` compiles every kernel library of ``ops/csrc/`` with nvcc into the
artifact directory DIR (one blob per library and an ``index.json`` keyed
by the environment); ``check DIR`` tells whether DIR can serve this
machine and these sources.  A serving process armed with
``KUBETPU_AOT_DIR=DIR`` then loads the libraries with no CUDA toolkit.

No twin: tools/kubeaot's ``--build`` over the census registry and its
COMPILE_MANIFEST.json sha check, ``--shape``, ``--prune`` and the
committed AOT_INDEX.json gate, all of which describe JAX programs (see
utils/aot.py).
"""

from __future__ import annotations

from typing import Dict, List

from ..ops import _build
from ..utils import aot


def build_store(root: str) -> List[Dict[str, object]]:
    """Capture every library of ops/csrc/ into ``root`` and write its
    index; returns the index rows.  Raises KernelError where nvcc
    fails."""
    rt = aot.capture_runtime(root)
    rows = [rt.capture(name) for name in _build.sources()]
    rt.flush_index()
    return rows
