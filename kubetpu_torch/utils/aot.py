"""Deploy-time kernel artifacts: the port's kernel libraries, built once
and loaded at serving start with no CUDA toolkit.

The twin of kubetpu/utils/aot.py.  The JAX package compiles its programs
at deploy time (tools/kubeaot) into a versioned artifact directory and
loads them at serving start with no XLA.  The port's one compile step is
nvcc, building each kernel library of ``ops/csrc/`` at first use
(ops/_build.py), so a serving machine without the CUDA toolkit could not
start it.  Here the libraries are built at deploy time
(``python -m kubetpu_torch.kubeaot build DIR``) and loaded from DIR:

* ``AotStore`` — the artifact directory.  One blob per kernel library,
  its bytes as nvcc wrote them, named ``<name>-<sha16>-<env8>.so`` by
  the blob's sha256 and the environment key, plus an ``index.json``
  (the environment and one row per library: its sha256, the source
  digest, the library's cache name, its size).  Blobs are shared
  objects: TRUSTED BUILD OUTPUTS, to load only from directories you
  produced.  ``load`` verifies a blob's sha256, and is the chaos
  ``aot-load`` site: ``corrupt`` truncates the bytes read, as a torn
  deploy would.
* ``AotRuntime`` — the serve and capture halves.  Serve (``arm()``, or
  ``KUBETPU_AOT_DIR`` through ``maybe_arm_from_env``): ``library(name)``
  verifies the artifact, writes it into the kernel-library cache
  (utils/compilation.py) under the library's own name and returns that
  path, which ops/_build.load_propose loads; nvcc never runs.  A missing,
  stale or corrupt artifact is a counted miss, and the library builds
  from source exactly as with no artifacts (the same kernel from the
  same source: no plain version stands in for it; with no nvcc the
  build raises KernelError, as it always did).  Capture (the build
  side): ``capture(name)`` compiles the library with nvcc and stores it.
* The environment key: the torch version, the CUDA version torch was
  built with, the device's name and compute capability, the nvcc flags
  and a digest of ``ops/csrc/``.  A serve runtime whose index was built
  under another key is disabled (``disabled_reason``); arming it
  disarms with that reason (``demotion_reason()``), and every library
  builds from source.

Disarmed (the default) the seam in ops/_build.py is one module
attribute read.

No twin, each for its reason:

* the census-manifest sha (``lowering_sha256``) and ``check_index``
  against COMPILE_MANIFEST.json: that manifest describes only JAX
  programs; a port artifact's identity is its source digest and its
  blob's sha256;
* ``serving_buckets``/``allows_bucket`` and kubeaot's ``--prune``: a
  kernel library serves every shape, and the prewarm ladder they prune
  is n/a in the port (eager torch compiles nothing per shape);
* ``call_signature``, ``static_sig`` and ``dispatch``: eager torch has
  no jit statics or call forms to key; the seam is the library load;
* the north-star gate (bench.py's ``cold_restart_s`` ceiling): the port
  has no benchmark yet.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

LOG = logging.getLogger("kubetpu_torch.aot")

DIR_ENV = "KUBETPU_AOT_DIR"
INDEX_NAME = "index.json"
INDEX_COMMENT = ("Kernel-library artifact index (python -m "
                 "kubetpu_torch.kubeaot build DIR). Blobs are shared "
                 "objects: load them only from directories you produced.")
ENV_FIELDS = ("torch", "cuda", "device", "nvcc_flags", "kernel_digest")


class AotError(RuntimeError):
    """An artifact that cannot serve: missing, unreadable or corrupt."""


# ------------------------------------------------------------ environment


def kernel_digest() -> str:
    """sha256 over ops/csrc/ (file names and bytes): a kernel edit
    changes it, which mismatches every index built before it."""
    from ..ops import _build
    h = hashlib.sha256()
    for f in sorted(os.listdir(_build.CSRC)):
        h.update(f.encode())
        with open(os.path.join(_build.CSRC, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def device_signature() -> str:
    """The current CUDA card's name and compute capability (a library
    built for sm_90a loads on that architecture only), or "cpu"."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    d = torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(d)
    return "%s sm_%d%d" % (torch.cuda.get_device_name(d), major, minor)


def env_signature() -> Dict[str, str]:
    """The environment an artifact set is valid for; any field drifting
    disables the whole index."""
    import torch
    from ..ops import _build
    return {"torch": torch.__version__,
            "cuda": str(torch.version.cuda),
            "device": device_signature(),
            "nvcc_flags": " ".join(_build.NVCC_FLAGS),
            "kernel_digest": kernel_digest()}


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ------------------------------------------------------------------ store


class AotStore:
    """One artifact directory: ``<root>/<name>-<sha16>-<env8>.so`` blobs
    plus ``<root>/index.json``."""

    def __init__(self, root: str):
        self.root = root
        self.index_path = os.path.join(root, INDEX_NAME)

    @staticmethod
    def env_key(env: Dict[str, str]) -> str:
        doc = json.dumps([env.get(f) for f in ENV_FIELDS])
        return hashlib.sha256(doc.encode()).hexdigest()[:8]

    def artifact_name(self, name: str, sha256: str,
                      env: Dict[str, str]) -> str:
        return "%s-%s-%s.so" % (name, sha256[:16], self.env_key(env))

    def save(self, artifact: str, data: bytes) -> int:
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, artifact)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
        return len(data)

    def load(self, artifact: str, sha256: str) -> bytes:
        """The blob's bytes, verified against ``sha256``."""
        try:
            with open(os.path.join(self.root, artifact), "rb") as fh:
                data = fh.read()
        except OSError as e:
            raise AotError("artifact %s unreadable: %s" % (artifact, e)) \
                from e
        # chaos seam (utils/chaos.py "aot-load"): a truncated blob is what
        # a torn deploy or a partial copy produces; the check below turns
        # it into a counted miss, never a loaded half-library
        from . import chaos
        if chaos.action("aot-load") is not None:
            data = data[:max(len(data) // 2, 1)]
        if _sha256(data) != sha256:
            raise AotError("artifact %s: sha256 mismatch (%d bytes read)"
                           % (artifact, len(data)))
        return data

    def write_index(self, env: Dict[str, str], rows: List[dict]) -> str:
        doc = {"_comment": INDEX_COMMENT, "env": env,
               "rows": sorted(rows, key=lambda r: r.get("row") or "")}
        os.makedirs(self.root, exist_ok=True)
        tmp = self.index_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, self.index_path)
        return self.index_path

    def read_index(self) -> Optional[dict]:
        try:
            with open(self.index_path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None


def env_mismatch(built: Dict[str, Any], here: Dict[str, str]
                 ) -> Optional[str]:
    """Why an index built under ``built`` cannot serve ``here`` (None
    when every field matches)."""
    for field in ENV_FIELDS:
        if built.get(field) != here.get(field):
            return ("artifact env mismatch on %s: built %r, serving %r — "
                    "kernel libraries build from source"
                    % (field, built.get(field), here.get(field)))
    return None


# ---------------------------------------------------------------- runtime


class AotRuntime:
    """The serve (or capture) half over one AotStore.

    serve: ``library(name)`` installs the verified artifact into the
    kernel-library cache on first use (an ``aot-load`` flight span holds
    its seconds and hit), and remembers a miss so later calls skip the
    probe.  capture: ``capture(name)`` compiles and stores a library;
    ``flush_index`` writes the index."""

    def __init__(self, store: AotStore, mode: str = "serve",
                 env: Optional[Dict[str, str]] = None):
        assert mode in ("serve", "capture")
        self.store = store
        self.mode = mode
        self.env = env or env_signature()
        self._lock = threading.Lock()
        self._paths: Dict[str, str] = {}      # kubelint: guarded-by(_lock)
        self._missing: Dict[str, str] = {}    # kubelint: guarded-by(_lock)
        self._rows: Dict[str, dict] = {}      # kubelint: guarded-by(_lock)
        self.hits = 0                         # kubelint: guarded-by(_lock)
        self.misses = 0                       # kubelint: guarded-by(_lock)
        self.loads = 0                        # kubelint: guarded-by(_lock)
        self.disabled_reason: Optional[str] = None
        # the index was built under another environment (a demotion at
        # arming, unlike a missing index)
        self.mismatch = False
        if mode == "serve":
            self._load_index()

    def _load_index(self) -> None:
        doc = self.store.read_index()
        if doc is None:
            self.disabled_reason = ("no artifact index at %s"
                                    % self.store.index_path)
            return
        self.disabled_reason = env_mismatch(doc.get("env") or {}, self.env)
        if self.disabled_reason is not None:
            self.mismatch = True
            LOG.warning(self.disabled_reason)
            return
        with self._lock:
            for row in doc.get("rows", []):
                if row.get("program"):
                    self._rows[row["program"]] = row

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"mode": self.mode, "hits": self.hits,
                    "misses": self.misses, "loads": self.loads,
                    "indexed": len(self._rows),
                    "missing": dict(self._missing),
                    "disabled": self.disabled_reason}

    def rows(self) -> List[dict]:
        with self._lock:
            return list(self._rows.values())

    # ---- serve side -----------------------------------------------------

    def _miss(self, name: str, reason: str) -> None:
        LOG.warning("aot: %s builds from source (%s)", name, reason)
        with self._lock:
            self._missing[name] = reason
            self.misses += 1

    def library(self, name: str) -> Optional[str]:
        """The path of ``name``'s library installed from its artifact,
        or None (a counted miss: the caller builds from source)."""
        from ..ops import _build
        from .trace import flight_span
        with self._lock:
            if name in self._paths:
                return self._paths[name]
            if name in self._missing:
                return None
            row = self._rows.get(name)
        if self.disabled_reason is not None:
            self._miss(name, self.disabled_reason)
            return None
        if row is None or not row.get("artifact"):
            self._miss(name, "no artifact for %s" % name)
            return None
        if row.get("source_sha256") != _build.lib_digest(name):
            self._miss(name, "artifact %s built from another source"
                       % row["artifact"])
            return None
        t0 = time.perf_counter()
        with flight_span("aot-load", program=name, hit=True) as sp:
            try:
                path = _build.install(name, self.store.load(
                    row["artifact"], row["sha256"]))
            except (AotError, OSError) as e:
                if sp is not None:
                    sp.args["hit"] = False
                    sp.args["reason"] = str(e)[:256]
                self._miss(name, "%s: %s" % (type(e).__name__, e))
                return None
            seconds = time.perf_counter() - t0
            if sp is not None:
                sp.args["seconds"] = round(seconds, 4)
        with self._lock:
            self._paths[name] = path
            self.hits += 1
            self.loads += 1
        _build.note_compile_event(name, row.get("library", name), seconds,
                                  "artifact")
        return path

    def preload(self) -> List[dict]:
        """Prewarm's fast path (Scheduler.prewarm): install and load
        every indexed library up front.  One report per row: {program,
        seconds, ok} and the reason of a failed one, whose library then
        builds from source at its first use."""
        from ..ops import _build
        report: List[dict] = []
        for row in self.rows():
            name = row["program"]
            t0 = time.perf_counter()
            ok = self.library(name) is not None
            if ok and name == "propose":
                _build.load_propose()
            entry = {"program": name, "ok": ok,
                     "seconds": round(time.perf_counter() - t0, 4)}
            if not ok:
                with self._lock:
                    entry["reason"] = self._missing.get(name)
            report.append(entry)
        return report

    # ---- capture (build) side -------------------------------------------

    def capture(self, name: str) -> dict:
        """Compile csrc/<name>.cu with nvcc and store it; returns its
        index row."""
        from ..ops import _build
        tmp = os.path.join(self.store.root,
                           ".build-%s-%d" % (name, os.getpid()))
        os.makedirs(self.store.root, exist_ok=True)
        try:
            seconds = _build._compile(name, tmp)
            with open(tmp, "rb") as fh:
                data = fh.read()
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        _build.note_compile_event(name, _build.lib_name(name), seconds,
                                  "nvcc")
        sha = _sha256(data)
        artifact = self.store.artifact_name(name, sha, self.env)
        row = {"row": "lib:%s" % name, "program": name,
               "artifact": artifact, "sha256": sha,
               "source_sha256": _build.lib_digest(name),
               "library": _build.lib_name(name),
               "bytes": self.store.save(artifact, data),
               "build_s": round(seconds, 3)}
        with self._lock:
            self._rows[name] = row
            self.loads += 1
        return row

    def flush_index(self) -> str:
        """Write the store's index of this runtime's rows (kubeaot
        captures every library, so the index is whole)."""
        return self.store.write_index(self.env, self.rows())


def check_store(root: str, env: Optional[Dict[str, str]] = None
                ) -> List[str]:
    """Why the artifact directory ``root`` cannot serve this machine and
    these sources ([] when it can): the index's environment, and each
    row's source digest and blob sha256."""
    from ..ops import _build
    store = AotStore(root)
    doc = store.read_index()
    if doc is None:
        return ["no artifact index at %s" % store.index_path]
    failures = []
    why = env_mismatch(doc.get("env") or {}, env or env_signature())
    if why is not None:
        failures.append(why)
    rows = {r.get("program"): r for r in doc.get("rows", [])}
    for name in _build.sources():
        row = rows.get(name)
        if row is None:
            failures.append("no artifact for %s" % name)
            continue
        if row.get("source_sha256") != _build.lib_digest(name):
            failures.append("%s: built from another source" % name)
        try:
            with open(os.path.join(root, row["artifact"]), "rb") as fh:
                sha = _sha256(fh.read())
        except OSError as e:
            failures.append("%s: %s" % (name, e))
            continue
        if sha != row.get("sha256"):
            failures.append("%s: blob sha256 mismatch" % name)
    return failures


# ---------------------------------------------------------------- arming
#
# Same contract as trace.py's recorder arming: _active is read WITHOUT a
# lock on the hot path (rebinding a reference is atomic; a racing reader
# sees old or new), arm/disarm serialize through _active_lock.

_active: Optional[AotRuntime] = None
_active_lock = threading.Lock()
# why the runtime was last disarmed with a reason: an environment
# mismatch at arming, or the scheduler's recovery of a dispatch fault
# ("aot->build"); None = never
_demotion_reason: Optional[str] = None   # kubelint: guarded-by(_active_lock)


def active_runtime() -> Optional[AotRuntime]:
    return _active


def arm(runtime: AotRuntime) -> Optional[AotRuntime]:
    """Arm ``runtime``; returns it, or None for a serve runtime with no
    usable index: with none at all it stays disarmed, and one built
    under another environment disarms with that reason
    (demotion_reason)."""
    global _active
    if runtime.mode == "serve" and runtime.disabled_reason is not None:
        if runtime.mismatch:
            disarm(reason=runtime.disabled_reason)
        return None
    with _active_lock:
        _active = runtime
    return runtime


def disarm(reason: Optional[str] = None) -> None:
    """Disarm the runtime; a non-None reason marks a DEMOTION (an
    unusable artifact set, or the recovery ladder's aot->build rung)
    rather than a clean teardown."""
    global _active, _demotion_reason
    with _active_lock:
        _active = None
        if reason is not None:
            _demotion_reason = reason


def demotion_reason() -> Optional[str]:
    with _active_lock:
        return _demotion_reason


def reset_demotion() -> None:
    """Clear the demotion latch (operator/test hook) so
    maybe_arm_from_env may arm again."""
    global _demotion_reason
    with _active_lock:
        _demotion_reason = None


def serve_runtime(root: str) -> AotRuntime:
    return AotRuntime(AotStore(root), mode="serve")


def capture_runtime(root: str) -> AotRuntime:
    return AotRuntime(AotStore(root), mode="capture")


def maybe_arm_from_env() -> Optional[AotRuntime]:
    """Scheduler-construction hook: arms the serve runtime iff
    KUBETPU_AOT_DIR names a directory whose index matches this
    environment.  Never raises: a bad artifact set must not block
    serving (the libraries build from source); it logs and stays
    disarmed (an environment mismatch with its reason, arm())."""
    root = os.environ.get(DIR_ENV, "")
    if not root:
        return None
    if _active is not None:
        return _active
    if demotion_reason() is not None:
        # demoted in this process: a later Scheduler construction must
        # not silently re-arm the artifact set that faulted (explicit
        # arm() still can, reset_demotion() clears the latch)
        LOG.warning("kernel artifacts stay demoted (%s); libraries build "
                    "from source", demotion_reason())
        return None
    try:
        rt = serve_runtime(root)
    except Exception:
        LOG.warning("KUBETPU_AOT_DIR=%s unusable; serving without kernel "
                    "artifacts", root, exc_info=True)
        return None
    if rt.disabled_reason is not None:
        LOG.warning("kernel artifacts disabled: %s", rt.disabled_reason)
    return arm(rt)
