"""Runtime sanitizer: the dynamic half of the kubelint contract.

The twin of kubetpu/utils/sanitize.py, behind the same opt-in switch
(``KUBETPU_SANITIZE=1``, read at the package's import):

  * the NaN check, twin of ``jax_debug_nans``: a TorchDispatchMode looks
    at every floating output of every aten op and raises
    FloatingPointError naming the op that produced a NaN (NaN only, as
    jax_debug_nans: an inf passes).  On the CPU it raises at the op.  On
    a CUDA tensor it adds no host sync: each check folds into a device
    "first offending op" index (isnan, any, where, minimum: four small
    kernels), the scheduler copies that index to pinned memory before
    the cycle's packed-copy event (``stage_probe``) and reads it after
    its readback waited on that event (``check_probe``), raising there.
    ``check_now`` reads it with a sync, for work outside a cycle, and
    ``sanitized()`` calls it at exit.  A kernel the mode cannot see (K1
    launches through ctypes) hands its floating outputs to
    ``check_outputs``.  Ops recorded while a CUDA graph is captured are
    not checked (the graph's cloned outputs are);
  * rank promotion, twin of ``jax_numpy_rank_promotion="raise"``: the
    mode raises RankPromotionError (a ValueError) on a pointwise aten op
    whose tensor operands differ in rank, none of them 0-dim.  Every
    broadcast of the port is explicit (``[None, :]``, ``unsqueeze``);
  * the compile-count watchdog: every kernel-library build, cache hit,
    load and artifact load and every CUDA graph capture is counted at the
    port's own seams (ops/_build.note_compile_event), keyed (kind:program,
    signature), and fed to the flight recorder.  The same key counted
    twice is a recompile.  The JAX watchdog parses jax's pxla log line;
    the port has no log to parse;
  * donation mismatches: no twin.  Eager torch donates no buffer, so
    ``CompileWatchdog.donation_mismatches`` stays, always empty.

The dispatch-mode stack is per thread.  ``enable_sanitizer()`` enters
the mode on the calling thread; ``thread_scope()`` enters it on a thread
that runs device work (Scheduler.schedule_pending, flush_pipeline and
prewarm, so the serving thread of Scheduler.run too).  Disarmed,
``thread_scope()`` is one module attribute read and the mode is nowhere.

``CompileTimer`` keeps the JAX timer's snapshot keys (compile_s,
cache_load_s, cache_hits, cache_misses), read from the same seams: nvcc
and graph-capture seconds, library and artifact load seconds, cached or
artifact libraries, nvcc builds.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from . import trace as _utrace

ENV_FLAG = "KUBETPU_SANITIZE"

# the device index's value while no op produced a NaN
_NO_HIT = 2 ** 62
# ops recorded on a card between two reads of its index; past this a
# check_now (a sync) trims them
_MAX_PENDING = 1 << 20
# factory ops whose outputs are uninitialized memory
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided",
                            "empty_permuted", "new_empty",
                            "new_empty_strided", "resize_", "set_"})


class RankPromotionError(ValueError):
    """A pointwise op on operands of different ranks (none 0-dim)."""


class CompileWatchdog:
    """Counts kernel-library builds and loads and CUDA graph captures per
    (kind:program, signature), from the port's seams.  A key counted
    more than once is a recompile: the same library built or loaded
    again, or a graph captured again at the same shapes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[Tuple[str, str], int] = {}  # kubelint: guarded-by(_lock)
        # no twin: eager torch donates no buffer
        self.donation_mismatches: List[str] = []

    def note(self, program: str, signature: str) -> None:
        key = (program, signature)
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + 1

    def compile_count(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def recompiled(self) -> Dict[Tuple[str, str], int]:
        """(program, signature) keys counted more than once."""
        with self._lock:
            return {k: c for k, c in self.counts.items() if c > 1}

    def assert_no_recompilation(self) -> None:
        bad = self.recompiled()
        if bad:
            lines = ["%s compiled %d times for %s" % (name, c, sig)
                     for (name, sig), c in sorted(bad.items())]
            raise AssertionError(
                "compile-count watchdog: a kernel or graph built again —"
                "\n  " + "\n  ".join(lines))

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()
            self.donation_mismatches.clear()


# ---------------------------------------------------------------- state


class _SanitizerState:
    def __init__(self):
        self.active = False
        self.watchdog: Optional[CompileWatchdog] = None
        self.scope = None            # the enabling thread's mode scope
        self.scope_thread: Optional[int] = None


_state = _SanitizerState()
_state_lock = threading.Lock()
# read without a lock on the hot path (rebinding is atomic)
_armed = False
_watchdogs: Tuple[CompileWatchdog, ...] = ()
_tls = threading.local()


def sanitize_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "0") not in ("", "0", "false", "False")


def current_watchdog() -> Optional[CompileWatchdog]:
    return _state.watchdog if _state.active else None


# ------------------------------------------------------- the dispatch mode


_pointwise_cache: Dict[object, bool] = {}


def _pointwise(func) -> bool:
    got = _pointwise_cache.get(func)
    if got is None:
        got = _pointwise_cache[func] = torch.Tag.pointwise in func.tags
    return got


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            for y in x:
                if isinstance(y, torch.Tensor):
                    yield y


def _check_ranks(func, args, kwargs) -> None:
    ts = list(_tensors(itertools.chain(args, kwargs.values())))
    ranks = {t.dim() for t in ts if t.dim()}
    if len(ranks) > 1:
        raise RankPromotionError(
            "rank promotion in %s: operands of shapes %s (the port runs "
            "with rank_promotion='raise'; broadcast explicitly with "
            "[None, :] or unsqueeze)"
            % (func, [tuple(t.shape) for t in ts]))


class _DeviceIndex:
    """One card's first offending op: the smallest op number whose
    output held a NaN (_NO_HIT while none did)."""

    def __init__(self, device):
        self.first = torch.full((), _NO_HIT, dtype=torch.int64,
                                device=device)


_index_lock = threading.Lock()
_indices: Dict[torch.device, _DeviceIndex] = {}  # kubelint: guarded-by(_index_lock)
_ops: List[object] = []      # kubelint: guarded-by(_index_lock)
_ops_base = 0                # kubelint: guarded-by(_index_lock)


def _device_check(op, t: torch.Tensor) -> None:
    """Fold ``t``'s NaN check into its card's index: no host sync.
    Called with every dispatch mode off."""
    global _ops_base
    with _index_lock:
        k = _ops_base + len(_ops)
        _ops.append(op)
        idx = _indices.get(t.device)
        if idx is None:
            idx = _indices[t.device] = _DeviceIndex(t.device)
        hit = torch.isnan(t).any()
        idx.first = torch.minimum(idx.first, torch.where(hit, k, _NO_HIT))
        pending = len(_ops)
    if pending > _MAX_PENDING:
        check_now()


def _nan_error(op, where: str = "") -> FloatingPointError:
    return FloatingPointError("invalid value (nan) encountered in %s%s"
                              % (op, where))


def _check_output(op, t: torch.Tensor, inputs_on_card: bool) -> None:
    if not t.is_floating_point() or t.numel() == 0:
        return
    if t.is_cuda:
        if not torch.cuda.is_current_stream_capturing():
            _device_check(op, t)
    elif t.device.type == "cpu" and not inputs_on_card:
        # (a CPU output of a card input may be an asynchronous copy not
        # landed yet; its source was checked on the card)
        if bool(torch.isnan(t).any()):
            raise _nan_error(op)


class _SanitizeMode(TorchDispatchMode):
    """The NaN and rank-promotion checks of every aten op on this
    thread (inside __torch_dispatch__ the mode itself is off, so its own
    checks are not dispatched through it)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _armed:
            return func(*args, **kwargs)
        if _pointwise(func):
            _check_ranks(func, args, kwargs)
        out = func(*args, **kwargs)
        if not func.is_view and \
                func.overloadpacket.__name__ not in _UNINITIALIZED:
            outs = list(_tensors([out]))
            if outs:
                on_card = any(t.is_cuda for t in _tensors(
                    itertools.chain(args, kwargs.values())))
                for t in outs:
                    _check_output(func, t, on_card)
        return out


class _ThreadScope:
    """The mode on the current thread for the scope, unless an outer
    scope of this thread has it on already."""

    def __init__(self):
        self.mode = None

    def __enter__(self):
        depth = getattr(_tls, "depth", 0)
        if depth == 0:
            self.mode = _SanitizeMode()
            self.mode.__enter__()
        _tls.depth = depth + 1
        return self

    def __exit__(self, *exc):
        _tls.depth -= 1
        if self.mode is not None:
            self.mode.__exit__(*exc)
            self.mode = None
        return False


_NULL_SCOPE = contextlib.nullcontext()


def thread_scope():
    """The sanitizer's checks on this thread for a ``with`` block: the
    seam of every port entry that runs device work.  Disarmed: one
    module attribute read and a shared no-op context."""
    if not _armed:
        return _NULL_SCOPE
    return _ThreadScope()


# ------------------------------------------------ device-side NaN reads


def check_outputs(program: str, *tensors) -> None:
    """The NaN check of outputs the dispatch mode never saw (a kernel
    launched through ctypes).  No-op disarmed; no host sync on a card."""
    if not _armed:
        return
    with _disable_current_modes():
        for t in tensors:
            _check_output(program, t, False)


def stage_probe():
    """Before a cycle's packed-copy event is recorded: copy every card's
    index into pinned memory without blocking.  Returns what
    ``check_probe`` reads once that event has been waited on (None
    disarmed, or when no card op was checked)."""
    if not _armed:
        return None
    with _index_lock, _disable_current_modes():
        if not _indices:
            return None
        count = _ops_base + len(_ops)
        hosts = []
        for idx in _indices.values():
            host = torch.empty((), dtype=torch.int64, pin_memory=True)
            host.copy_(idx.first, non_blocking=True)
            hosts.append(host)
    return count, hosts


def _settle(first: int, count: int) -> None:
    """Raise for op number ``first`` (resetting the indices), or drop
    the names of the ops below ``count``, all found clean."""
    global _ops_base
    with _index_lock, _disable_current_modes():
        if first < _NO_HIT:
            i = first - _ops_base
            op = _ops[i] if 0 <= i < len(_ops) else "op #%d" % first
            for idx in _indices.values():
                idx.first.fill_(_NO_HIT)
            _ops_base += len(_ops)
            del _ops[:]
            raise _nan_error(op, " (found at the cycle's readback)")
        drop = min(max(count - _ops_base, 0), len(_ops))
        del _ops[:drop]
        _ops_base += drop


def check_probe(probe) -> None:
    """After the readback waited on the event that follows the probe's
    copies: raise FloatingPointError naming the first op whose output
    held a NaN.  Reads pinned host memory only (no device sync)."""
    if probe is None:
        return
    count, hosts = probe
    _settle(min(int(h) for h in hosts), count)


def check_now() -> None:
    """Read every card's index now (a host sync) and raise as
    check_probe does: for device work outside a scheduling cycle."""
    with _index_lock, _disable_current_modes():
        count = _ops_base + len(_ops)
        firsts = [int(idx.first.item()) for idx in _indices.values()]
    if firsts:
        _settle(min(firsts), count)


# --------------------------------------------------------- arm / disarm


def _install(wd: CompileWatchdog) -> None:
    global _watchdogs
    _watchdogs = _watchdogs + (wd,)


def _remove(wd: CompileWatchdog) -> None:
    global _watchdogs
    _watchdogs = tuple(w for w in _watchdogs if w is not wd)


def enable_sanitizer() -> CompileWatchdog:
    """Idempotently turn the sanitizer on (the mode on this thread, the
    watchdog on every seam); returns the watchdog."""
    global _armed
    with _state_lock:
        if _state.active:
            return _state.watchdog
        wd = CompileWatchdog()
        _install(wd)
        _state.watchdog = wd
        _armed = True
        _state.scope = _ThreadScope().__enter__()
        _state.scope_thread = threading.get_ident()
        _state.active = True
        # torch runs a mode's __torch_dispatch__ with dynamo disabled,
        # which imports torch._dynamo at its first op (seconds, once per
        # process): pay that here, at arming, not in the first cycle
        torch.zeros(()).add_(0)
        import logging
        logging.getLogger("kubetpu_torch.sanitize").info(
            "sanitizer on: NaN check, rank_promotion=raise, compile-count "
            "watchdog")
        return wd


def disable_sanitizer() -> None:
    """Undo enable_sanitizer().  The mode leaves the enabling thread's
    stack when called there; a scope still open elsewhere passes every
    op through unchecked from now on."""
    global _armed, _ops_base
    with _state_lock:
        if not _state.active:
            return
        _armed = False
        if (_state.scope is not None
                and _state.scope_thread == threading.get_ident()):
            _state.scope.__exit__(None, None, None)
        _state.scope = None
        _state.scope_thread = None
        if _state.watchdog is not None:
            _remove(_state.watchdog)
        _state.watchdog = None
        _state.active = False
    with _index_lock:
        _indices.clear()
        _ops_base += len(_ops)
        del _ops[:]


@contextmanager
def sanitized():
    """Scoped sanitizer for tests; reads the card indices (check_now)
    at the end of a block that did not raise.  Joining an already-armed
    sanitizer (KUBETPU_SANITIZE=1 at import) resets its watchdog so the
    block judges only its own work, and leaves it armed on exit.

    ::

        with sanitized() as watchdog:
            run_cycle()
            watchdog.assert_no_recompilation()
    """
    owned = not _state.active
    wd = enable_sanitizer()
    if not owned:
        wd.reset()
    try:
        with thread_scope():
            yield wd
        check_now()
    finally:
        if owned:
            disable_sanitizer()


def install_compile_watchdog() -> CompileWatchdog:
    """Attach only the compile-count watchdog (no NaN or rank checks):
    the observer for a measured run.  With the full sanitizer armed its
    watchdog is shared.  Pair with uninstall_compile_watchdog()."""
    with _state_lock:
        if _state.active:
            return _state.watchdog
        wd = CompileWatchdog()
        _install(wd)
        return wd


def uninstall_compile_watchdog(wd: CompileWatchdog) -> None:
    """Detach a watchdog of install_compile_watchdog(); the full
    sanitizer's own stays until disable_sanitizer()."""
    with _state_lock:
        if _state.active and wd is _state.watchdog:
            return
        _remove(wd)


# -------------------------------------------------------- compile timer


class CompileTimer:
    """Cumulative compile and load seconds from the port's seams:
    compile_s (nvcc and CUDA graph capture), cache_load_s (library and
    artifact loads), cache_hits (a library found built, or taken from an
    artifact), cache_misses (an nvcc build).  Thread-safe; diff two
    snapshot()s with delta() to attribute cost to a phase."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compile_s = 0.0          # kubelint: guarded-by(_lock)
        self.cache_load_s = 0.0       # kubelint: guarded-by(_lock)
        self.cache_hits = 0           # kubelint: guarded-by(_lock)
        self.cache_misses = 0         # kubelint: guarded-by(_lock)

    def note(self, kind: str, seconds: float = 0.0) -> None:
        with self._lock:
            if kind in ("nvcc", "capture"):
                self.compile_s += seconds
            elif kind in ("load", "artifact"):
                self.cache_load_s += seconds
            if kind in ("cached", "artifact"):
                self.cache_hits += 1
            elif kind == "nvcc":
                self.cache_misses += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"compile_s": self.compile_s,
                    "cache_load_s": self.cache_load_s,
                    "cache_hits": self.cache_hits,
                    "cache_misses": self.cache_misses}

    @staticmethod
    def delta(before: Dict[str, float],
              after: Dict[str, float]) -> Dict[str, float]:
        """after - before, per key (seconds rounded to ms)."""
        out = {}
        for k, v in after.items():
            d = v - before.get(k, 0)
            out[k] = round(d, 3) if isinstance(d, float) else d
        return out


_timer: Optional[CompileTimer] = None
_timer_lock = threading.Lock()


def install_compile_timer() -> CompileTimer:
    """Idempotently install the process's one CompileTimer (cumulative
    from its installation; consumers diff snapshots)."""
    global _timer
    with _timer_lock:
        if _timer is None:
            _timer = CompileTimer()
        return _timer


def note_compile(program: str, signature: str, kind: str,
                 seconds: float = 0.0) -> None:
    """One compile event of ``kind`` ("nvcc", "cached", "load",
    "artifact" or "capture") of ``program``: to the compile timer, every
    installed watchdog under (kind:program, signature), and the flight
    record of the cycle open on this thread."""
    t = _timer
    if t is not None:
        t.note(kind, seconds)
    key = "%s:%s" % (kind, program)
    for wd in _watchdogs:
        wd.note(key, signature)
    _utrace.note_compile_event(key, signature)


def maybe_enable_from_env() -> Optional[CompileWatchdog]:
    """Serving-path hook: enables the sanitizer iff KUBETPU_SANITIZE=1.
    Called from kubetpu_torch/__init__.py, so every entry point gets it
    without its own wiring."""
    if sanitize_enabled():
        return enable_sanitizer()
    return None
