"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` file compiles with nvcc into a shared library with a
plain C interface, loaded through ctypes (no PyTorch headers, so a build
takes seconds).  Libraries land in the kernel-library cache
(utils/compilation.py: ``KUBETPU_KERNEL_CACHE_DIR``, by default
``kubetpu_torch/_build/``, listed in .gitignore), named by a hash of the
source and flags so an edited source rebuilds.  With a serve-mode AOT
runtime armed (utils/aot.py, ``KUBETPU_AOT_DIR``) a library comes from
its deploy-time artifact instead, and no nvcc runs; a missing, stale or
corrupt artifact is a counted miss, and the library then builds from
source as without artifacts.  Flags: sm_90a, -O3, -fmad=false (no FMA
contraction: the placement contract rounds every product before the add
that follows it); never --use_fast_math (divisions must round
correctly).

Every build, cache hit, artifact load and library load is one compile
event (note_compile_event): counted for the dispatch deadline's
exemption, and keyed for the sanitizer's compile-count watchdog, the
compile timer and the flight recorder (utils/sanitize.note_compile).
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

from ..utils import compilation as _ucompilation
from ..utils import sanitize as _usanitize

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false", "-shared",
                           "-Xcompiler", "-fPIC"]


class KernelError(RuntimeError):
    """A kernel that did not build, load or launch.  The scheduler never
    recovers a cycle from it (kernel_fault): it raises."""


def kernel_fault(e: BaseException) -> bool:
    """True for an error of the kernel path, which no recovery may hide:
    a failed build, load or launch of a kernel (KernelError), a broken
    invariant (AssertionError), a sanitizer finding (a NaN's
    FloatingPointError, a RankPromotionError) or a CUDA runtime error (a
    sticky device fault, or a host sync the sync debug mode refuses).
    The scheduler's cycle then raises.  A CUDA out-of-memory is not one:
    it is recovered."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(e, (KernelError, AssertionError, FloatingPointError,
                      _usanitize.RankPromotionError)):
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


_lock = threading.Lock()
_propose_lib: Optional[ctypes.CDLL] = None
# seconds spent compiling, per source (0.0 when the library was cached;
# absent when it came from an artifact)
build_seconds: Dict[str, float] = {}
# where each loaded library came from: "nvcc", "cached" or "artifact"
library_source: Dict[str, str] = {}
# kernel libraries built or loaded, and CUDA graphs captured, by this
# process: the dispatch deadline exempts a cycle during which it grew
# (the torch twin of the JAX package's compile-activity exemption)
_events_lock = threading.Lock()
_compile_events = 0


def compile_events() -> int:
    with _events_lock:
        return _compile_events


def note_compile_event(program: str = "", signature: str = "",
                       seconds: float = 0.0, kind: str = "nvcc") -> None:
    """Count one compile event of ``program`` (kind "nvcc", "cached",
    "artifact", "load" or "capture": a CUDA graph captured), and hand it
    to the sanitizer's seam keyed by ``signature`` (a library's file
    name, a graph's input shapes)."""
    global _compile_events
    with _events_lock:
        _compile_events += 1
    _usanitize.note_compile(program, signature, kind, seconds)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found: the CUDA kernels build on a machine "
                      "with the CUDA toolkit (set CUDA_HOME), or load from "
                      "deploy-time artifacts (KUBETPU_AOT_DIR)")


def source_path(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def lib_digest(name: str) -> str:
    """sha256 of csrc/<name>.cu and the nvcc flags: the library's
    identity."""
    with open(source_path(name), "rb") as fh:
        return hashlib.sha256(fh.read()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()


def lib_name(name: str) -> str:
    return "lib%s-%s.so" % (name, lib_digest(name)[:12])


def _lib_path(name: str) -> str:
    return os.path.join(_ucompilation.cache_dir(), lib_name(name))


def _compile(name: str, out: str) -> float:
    """nvcc csrc/<name>.cu into ``out``, written under a temporary name
    and renamed, so concurrent builders never load a half-written file;
    returns the seconds."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = [nvcc_path()] + NVCC_FLAGS + ["-o", tmp, source_path(name)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise KernelError("nvcc failed for %s:\n%s\n%s"
                          % (name, res.stdout, res.stderr))
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build(name: str) -> str:
    """Compile csrc/<name>.cu if that library is not in the cache yet;
    returns the library path."""
    out = _lib_path(name)
    if os.path.exists(out):
        build_seconds.setdefault(name, 0.0)
        library_source[name] = "cached"
        note_compile_event(name, os.path.basename(out), 0.0, "cached")
        return out
    seconds = _compile(name, out)
    build_seconds[name] = seconds
    library_source[name] = "nvcc"
    note_compile_event(name, os.path.basename(out), seconds, "nvcc")
    return out


def install(name: str, data: bytes) -> str:
    """Write a library's bytes (a verified artifact) into the cache under
    its own name, atomically; returns the path."""
    out = _lib_path(name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, out)
    library_source[name] = "artifact"
    return out


def _library(name: str) -> str:
    """csrc/<name>.cu's library: the armed serve runtime's artifact if
    it has a good one, else built (or found) in the cache."""
    from ..utils import aot as _uaot
    rt = _uaot.active_runtime()
    if rt is not None and rt.mode == "serve":
        path = rt.library(name)
        if path is not None:
            return path
    return build(name)


def _open(path: str) -> ctypes.CDLL:
    """dlopen the propose kernel's library and declare its C interface."""
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
    return lib


def load_propose() -> ctypes.CDLL:
    """The propose kernel's library, taken from an artifact or built at
    first use, then loaded once per process."""
    global _propose_lib
    with _lock:
        if _propose_lib is None:
            path = _library("propose")
            t0 = time.perf_counter()
            _propose_lib = _open(path)
            note_compile_event("propose", os.path.basename(path),
                               time.perf_counter() - t0, "load")
        return _propose_lib


def sources() -> list:
    """The kernel sources of csrc/, by name."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
