"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` file compiles with nvcc into a shared library with a
plain C interface, loaded through ctypes (no PyTorch headers, so a build
takes seconds).  Libraries land in ``kubetpu_torch/_build/`` (listed in
.gitignore), named by a hash of the source and flags so an edited source
rebuilds.  Flags: sm_90a, -O3, -fmad=false (no FMA contraction: the
placement contract rounds every product before the add that follows it);
never --use_fast_math (divisions must round correctly).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

from ..utils import trace as _utrace

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false", "-shared",
                           "-Xcompiler", "-fPIC"]


class KernelError(RuntimeError):
    """A kernel that did not build, load or launch.  The scheduler never
    recovers a cycle from it (kernel_fault): it raises."""


def kernel_fault(e: BaseException) -> bool:
    """True for an error of the kernel path, which no recovery may hide:
    a failed build, load or launch of a kernel (KernelError), a broken
    invariant (AssertionError) or a CUDA runtime error (a sticky device
    fault, or a host sync the sync debug mode refuses).  The scheduler's
    cycle then raises.  A CUDA out-of-memory is not one: it is
    recovered."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(e, (KernelError, AssertionError)):
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


_lock = threading.Lock()
_propose_lib: Optional[ctypes.CDLL] = None
# seconds spent compiling, per source (0.0 when the library was cached)
build_seconds: Dict[str, float] = {}
# kernel libraries built or loaded, and CUDA graphs captured, by this
# process: the dispatch deadline exempts a cycle during which it grew
# (the torch twin of the JAX package's compile-activity exemption)
_compile_events = 0


def compile_events() -> int:
    with _lock:
        return _compile_events


def note_compile_event() -> None:
    """Count one library load or CUDA graph capture."""
    global _compile_events
    with _lock:
        _compile_events += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found: the CUDA kernels build on a machine "
                      "with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name,
                                                    digest.hexdigest()[:12]))


def build(name: str) -> str:
    """Compile csrc/<name>.cu if that library is not built yet; returns
    the library path.  The output is written under a temporary name and
    renamed, so concurrent builders never load a half-written file."""
    out = _lib_path(name)
    if os.path.exists(out):
        build_seconds.setdefault(name, 0.0)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = ([nvcc_path()] + NVCC_FLAGS
           + ["-o", tmp, os.path.join(CSRC, name + ".cu")])
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise KernelError("nvcc failed for %s:\n%s\n%s"
                          % (name, res.stdout, res.stderr))
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return out


def load_propose() -> ctypes.CDLL:
    """The propose kernel's library, built at first use.  The build or
    load is an instant event on the flight record of the cycle open on
    this thread (the counterpart of an XLA compile; no-op disarmed)."""
    global _propose_lib, _compile_events
    with _lock:
        if _propose_lib is None:
            _compile_events += 1
            path = build("propose")
            _utrace.note_compile_event(
                "propose", "%s (nvcc %.3f s)" % (
                    os.path.basename(path), build_seconds["propose"]))
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError("cannot load %s: %s" % (path, e)) from e
            p = ctypes.c_void_p
            lib.propose_launch.argtypes = [p] * 19
            lib.propose_launch.restype = ctypes.c_int
            lib.propose_staged_max_n.argtypes = [p]
            lib.propose_staged_max_n.restype = ctypes.c_int
            lib.propose_check_fast_div.argtypes = [
                ctypes.c_longlong, ctypes.c_uint, p, p]
            lib.propose_check_fast_div.restype = ctypes.c_int
            lib.propose_error_string.argtypes = [ctypes.c_int]
            lib.propose_error_string.restype = ctypes.c_char_p
            _propose_lib = lib
        return _propose_lib
