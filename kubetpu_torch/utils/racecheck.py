"""Instrumented race harness: the dynamic half of the concurrency contract.

The twin of kubetpu/utils/racecheck.py.  kubelint's concurrency family
(tools/kubelint/rules_concurrency.py, which reads the port's source as
well: ``python -m tools.kubelint kubetpu_torch/ --lock-graph``) proves
lock discipline statically; this module enforces it on a LIVE schedule,
behind one opt-in switch (``KUBETPU_RACE=1``, read at the package's
import), in the spirit of the Go race detector the reference tree runs
in CI:

  * lock instrumentation — ``threading.Lock/RLock/Condition`` constructed
    from kubetpu_torch modules (not the JAX package's ``kubetpu.``)
    return proxies that record per-thread acquisition stacks and hold
    times;
  * runtime lock-order enforcement — the first-seen acquisition order
    between any two lock roles becomes the declared order; acquiring them
    inverted later is reported (the dynamic mirror of the static
    ``concurrency/lock-order`` rule);
  * held-too-long — a lock held longer than ``KUBETPU_RACE_HOLD_MS``
    (default 200) is reported with the holder's stack: device work or I/O
    under a lock convoys every contending thread (the pipelined
    executor, the binder pool and the recorders all take locks).  Every
    hold also goes into ``_Registry.holds`` by lock role (count, total,
    longest, and the holder thread's CPU time over each hold past the
    threshold), so a long hold can be told from the holder's own work
    under the lock (CPU time near the hold) or from time the holder spent
    off the CPU (a wait, or other threads holding the interpreter);
  * guarded-attribute enforcement — the classes in ``GUARDED`` (the same
    ownership map the static family infers) get their ``__setattr__``
    wrapped and their container attributes replaced with checking
    subclasses, so every rebind / dict / list mutation asserts the owning
    lock is held by the mutating thread; a sampling ``sys.setprofile``
    hook additionally catches C-level mutator calls (``dict.pop``,
    ``OrderedDict.move_to_end``…) on guarded containers the subclassing
    cannot reach.  Violations are collected, and ``racechecked()`` asserts
    none happened on teardown.

Coverage envelope (documented, not bugs): reads are not checked (no write
barrier in CPython), subscript stores on non-wrapped container types are
only caught by the profile hook's c_call events, and locks created before
arming stay uninstrumented.  ``sys.setprofile`` is per-thread: threads
spawned while armed keep the (disarmed, short-circuiting) hook after
``disable_racecheck`` — only a process that was never armed pays exactly
nothing.  With the JAX package's harness armed in the same process, the
two lock factories chain (each skips the other's frames to find the
constructing module), and only the profile hook armed last runs.  Off
(the default) this module changes nothing and costs nothing.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

ENV_FLAG = "KUBETPU_RACE"

# the runtime ownership map: mirrors what `python -m tools.kubelint
# kubetpu_torch/ --lock-graph` derives statically (the JAX map's rows
# under the port's module names).  (module, class) -> (lock
# attr, guarded attrs)
GUARDED: Dict[Tuple[str, str], Tuple[str, Tuple[str, ...]]] = {
    ("kubetpu_torch.state.cache", "SchedulerCache"):
        ("_lock", ("nodes", "head", "node_tree", "assumed_pods",
                   "pod_states")),
    ("kubetpu_torch.schedqueue.queue", "PodNominator"):
        ("_lock", ("_nominated", "_nominated_pod_to_node")),
    ("kubetpu_torch.schedqueue.queue", "SchedulingQueue"):
        ("_cond", ("active_q", "backoff_q", "unschedulable_q",
                   "scheduling_cycle", "move_request_cycle", "_closed")),
    ("kubetpu_torch.client.store", "ClusterStore"):
        ("_lock", ("_objs", "_subs", "_assumed_pv")),
    ("kubetpu_torch.utils.events", "EventBroadcaster"):
        ("_lock", ("_cache", "_seq", "_watchers")),
    ("kubetpu_torch.utils.features", "FeatureGate"):
        ("_lock", ("_known", "_enabled")),
    ("kubetpu_torch.scheduler", "Scheduler"):
        ("_chain_lock", ("_chain", "_chain_seq")),
}

_MUTATOR_NAMES = frozenset(
    {"append", "extend", "add", "update", "insert", "setdefault", "pop",
     "popitem", "remove", "discard", "clear", "move_to_end", "appendleft",
     "__setitem__", "__delitem__"})


def _stack(skip: int = 2, limit: int = 8) -> str:
    frames = traceback.format_stack()[:-skip]
    return "".join(frames[-limit:])


class Violation:
    __slots__ = ("kind", "message", "stack", "thread")

    def __init__(self, kind: str, message: str, stack: str = ""):
        self.kind = kind
        self.message = message
        self.stack = stack
        self.thread = threading.current_thread().name

    def __str__(self) -> str:
        s = "[%s] (%s) %s" % (self.kind, self.thread, self.message)
        if self.stack:
            s += "\n" + self.stack
        return s


class _Registry:
    """Process-wide harness state: violations, the lock-order graph, and
    the per-thread held-lock stacks."""

    def __init__(self):
        self.armed = False
        self.hold_ms = 200.0
        self.sample = 1
        self._mu = threading.Lock()
        self.violations: List[Violation] = []  # kubelint: guarded-by(_mu)
        # lock-order edges: (a, b) means a was held while b was acquired
        self.edges: Dict[Tuple[str, str], str] = {}  # kubelint: guarded-by(_mu)
        self._tls = threading.local()
        # id(container) -> (attr description, weakref to owner, lock attr);
        # a finalizer on the container prunes the entry, so a freed
        # container's recycled id can never match a stale record
        self.tracked: Dict[int, Tuple[str, object, str]] = {}  # kubelint: guarded-by(_mu)
        # lock role -> HoldStats of every release while armed
        self.holds: Dict[str, "HoldStats"] = {}  # kubelint: guarded-by(_mu)

    # -- per-thread held stack ---------------------------------------------

    def held(self) -> List["_LockProxy"]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- violations ---------------------------------------------------------

    def report(self, kind: str, message: str, stack: str = "") -> None:
        v = Violation(kind, message, stack)
        with self._mu:
            self.violations.append(v)

    def snapshot(self) -> List[Violation]:
        with self._mu:
            return list(self.violations)

    def reset(self) -> None:
        with self._mu:
            self.violations = []
            self.edges = {}
            self.holds = {}

    # -- lock order ---------------------------------------------------------

    def note_acquire(self, proxy: "_LockProxy") -> None:
        held = self.held()
        if held:
            b = proxy.name
            inversions = []
            with self._mu:
                # inversion: a path b -> ... -> a already exists for some
                # held a, so acquiring b after a contradicts declared order
                for h in held:
                    a = h.name
                    if a == b:
                        continue
                    if self._path(b, a):
                        inversions.append(a)
                for h in held:
                    a = h.name
                    if a != b:
                        self.edges.setdefault((a, b),
                                              "%s then %s" % (a, b))
            for a in inversions:  # outside _mu: report() re-acquires it
                self.report(
                    "lock-order",
                    "acquired %s while holding %s, but the declared order "
                    "(first seen) is %s before %s" % (b, a, b, a), _stack())
        held.append(proxy)

    def _path(self, src: str, dst: str) -> bool:
        seen = {src}
        stack = [src]
        while stack:
            n = stack.pop()
            for (a, b) in self.edges:
                if a == n and b not in seen:
                    if b == dst:
                        return True
                    seen.add(b)
                    stack.append(b)
        return False

    def note_release(self, proxy: "_LockProxy", held_s: float,
                     cpu_s: float = 0.0) -> None:
        held = self.held()
        if proxy in held:
            held.remove(proxy)
        over = held_s * 1000.0 > self.hold_ms
        with self._mu:
            st = self.holds.get(proxy.name)
            if st is None:
                st = self.holds[proxy.name] = HoldStats()
            st.add(held_s, cpu_s, over)
        if over:
            self.report(
                "held-too-long",
                "%s held for %.1f ms (threshold %.0f ms) — blocking work "
                "under a lock convoys every contending thread"
                % (proxy.name, held_s * 1000.0, self.hold_ms), _stack())

    # -- guarded containers --------------------------------------------------

    def track_container(self, obj, desc: str, owner, lock_attr: str) -> None:
        import weakref
        try:
            # plain set (and other non-weakrefable containers) can't carry
            # a finalizer: skip rather than risk id-reuse false positives
            weakref.finalize(obj, self._untrack, id(obj))
            owner_ref = weakref.ref(owner)
        except TypeError:
            return
        with self._mu:
            self.tracked[id(obj)] = (desc, owner_ref, lock_attr)

    def _untrack(self, obj_id: int) -> None:
        with self._mu:
            self.tracked.pop(obj_id, None)

    def check_owned(self, desc: str, owner, lock_attr: str) -> None:
        lock = getattr(owner, lock_attr, None)
        if isinstance(lock, _ConditionProxy):
            lock = lock._lockp
        if isinstance(lock, _LockProxy) and not lock.held_by_current():
            self.report(
                "unguarded-mutation",
                "%s mutated without holding %s" % (desc, lock_attr),
                _stack(skip=3))


class HoldStats:
    """One lock role's holds: count, total and longest seconds, and
    (held ms, the holder thread's CPU ms) of each hold past the
    threshold."""

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.over: List[Tuple[float, float]] = []

    def add(self, held_s: float, cpu_s: float, over: bool) -> None:
        self.count += 1
        self.total_s += held_s
        self.max_s = max(self.max_s, held_s)
        if over:
            self.over.append((held_s * 1e3, cpu_s * 1e3))

    def as_dict(self) -> dict:
        return dict(count=self.count, mean_ms=self.total_s / self.count * 1e3,
                    max_ms=self.max_s * 1e3, over_ms_cpu_ms=list(self.over))


_REG = _Registry()


def registry() -> _Registry:
    return _REG


# ---------------------------------------------------------------------------
# lock proxies


class _LockProxy:
    """Wraps a real Lock/RLock with ownership + order + hold-time
    bookkeeping.  Named after the owning ``Class.attr`` once assigned to a
    guarded class; anonymous locks keep their creation site, which groups
    instances of the same role."""

    _reentrant = False

    def __init__(self, real, name: str):
        self._real = real
        self.name = name
        self._owner: Optional[int] = None
        self._count = 0
        self._t0 = 0.0
        self._c0 = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = threading.get_ident()
        if self._owner == me:
            if not self._reentrant:
                _REG.report(
                    "lock-order",
                    "re-acquiring non-reentrant %s already held by this "
                    "thread — deadlock" % self.name, _stack())
            else:
                self._count += 1
                return self._real.acquire(blocking, timeout)
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._owner = me
            self._count = 1
            self._t0 = time.monotonic()
            self._c0 = time.thread_time()
            _REG.note_acquire(self)
        return ok

    def release(self):
        me = threading.get_ident()
        if self._owner == me:
            self._count -= 1
            if self._count <= 0:
                held_s = time.monotonic() - self._t0
                cpu_s = time.thread_time() - self._c0
                self._owner = None
                _REG.note_release(self, held_s, cpu_s)
        return self._real.release()

    def held_by_current(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _RLockProxy(_LockProxy):
    _reentrant = True


class _ConditionProxy:
    """Condition over an instrumented lock: wait() hands the lock back
    (bookkeeping included) and re-registers it on wake."""

    def __init__(self, lock_proxy: _LockProxy):
        self._lockp = lock_proxy
        self._real = threading.Condition(lock_proxy._real)

    @property
    def name(self) -> str:
        return self._lockp.name

    @name.setter
    def name(self, v: str) -> None:
        self._lockp.name = v

    def acquire(self, *a, **k):
        return self._lockp.acquire(*a, **k)

    def release(self):
        return self._lockp.release()

    def held_by_current(self) -> bool:
        return self._lockp.held_by_current()

    def __enter__(self):
        self._lockp.acquire()
        return self

    def __exit__(self, *exc):
        self._lockp.release()
        return False

    def _pre_wait(self) -> None:
        lp = self._lockp
        held_s = time.monotonic() - lp._t0
        cpu_s = time.thread_time() - lp._c0
        lp._owner = None
        lp._count = 0
        _REG.note_release(lp, held_s, cpu_s)

    def _post_wait(self) -> None:
        lp = self._lockp
        lp._owner = threading.get_ident()
        lp._count = 1
        lp._t0 = time.monotonic()
        lp._c0 = time.thread_time()
        _REG.note_acquire(lp)

    def wait(self, timeout: Optional[float] = None):
        self._pre_wait()
        try:
            return self._real.wait(timeout)
        finally:
            self._post_wait()

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._pre_wait()
        try:
            return self._real.wait_for(predicate, timeout)
        finally:
            self._post_wait()

    def notify(self, n: int = 1):
        return self._real.notify(n)

    def notify_all(self):
        return self._real.notify_all()


# ---------------------------------------------------------------------------
# guarded containers


def _check(desc_owner) -> None:
    desc, owner, lock_attr = desc_owner
    if _REG.armed:
        _REG.check_owned(desc, owner, lock_attr)


class _GuardedDict(dict):
    __slots__ = ("_rc",)

    def __setitem__(self, k, v):
        _check(self._rc)
        return dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        _check(self._rc)
        return dict.__delitem__(self, k)

    def pop(self, *a):
        _check(self._rc)
        return dict.pop(self, *a)

    def popitem(self):
        _check(self._rc)
        return dict.popitem(self)

    def update(self, *a, **k):
        _check(self._rc)
        return dict.update(self, *a, **k)

    def setdefault(self, *a):
        _check(self._rc)
        return dict.setdefault(self, *a)

    def clear(self):
        _check(self._rc)
        return dict.clear(self)


class _GuardedList(list):
    __slots__ = ("_rc",)

    def append(self, x):
        _check(self._rc)
        return list.append(self, x)

    def extend(self, it):
        _check(self._rc)
        return list.extend(self, it)

    def insert(self, i, x):
        _check(self._rc)
        return list.insert(self, i, x)

    def pop(self, *a):
        _check(self._rc)
        return list.pop(self, *a)

    def remove(self, x):
        _check(self._rc)
        return list.remove(self, x)

    def clear(self):
        _check(self._rc)
        return list.clear(self)

    def __setitem__(self, i, v):
        _check(self._rc)
        return list.__setitem__(self, i, v)

    def __delitem__(self, i):
        _check(self._rc)
        return list.__delitem__(self, i)


# ---------------------------------------------------------------------------
# arming / disarming


class _PatchState:
    def __init__(self):
        self.active = False
        self.orig_lock = None
        self.orig_rlock = None
        self.orig_condition = None
        self.wrapped_setattrs: List[Tuple[type, object, bool]] = []
        self.prev_profile = None


_patch = _PatchState()
_patch_mu = threading.Lock()


def race_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "0") not in ("", "0", "false", "False")


def _constructor_frame():
    """The frame that constructed the lock: the factory's caller, past
    the lock factories of any race harness chained in front of this one
    (the JAX package's, armed in the same process)."""
    try:
        f = sys._getframe(3)
    except ValueError:
        return None
    while f is not None and f.f_globals.get("__name__", "").endswith(
            "utils.racecheck"):
        f = f.f_back
    return f


def _kubetpu_caller() -> bool:
    f = _constructor_frame()
    mod = f.f_globals.get("__name__", "") if f is not None else ""
    return mod == "kubetpu_torch" or mod.startswith("kubetpu_torch.")


def _site() -> str:
    f = _constructor_frame()
    if f is None:
        return "<unknown>"
    return "%s:%d" % (os.path.basename(f.f_code.co_filename), f.f_lineno)


def _make_lock_factory(real_cls, proxy_cls):
    def factory(*a, **k):
        if not _REG.armed or not _kubetpu_caller():
            return real_cls(*a, **k)
        return proxy_cls(real_cls(*a, **k), name="lock@" + _site())
    return factory


def _condition_factory(real_condition):
    def factory(lock=None, *a, **k):
        if not _REG.armed or not _kubetpu_caller():
            return real_condition(lock, *a, **k)
        if isinstance(lock, _LockProxy):
            proxy = _ConditionProxy(lock)
        elif lock is not None:
            return real_condition(lock, *a, **k)
        else:
            proxy = _ConditionProxy(
                _RLockProxy(_patch.orig_rlock(), name="cond@" + _site()))
        return proxy
    return factory


def _wrap_setattr(cls, lock_attr: str, attrs: Tuple[str, ...]):
    orig = cls.__setattr__
    had_own = "__setattr__" in cls.__dict__

    def guarded_setattr(self, name, value, _orig=orig, _lock=lock_attr,
                        _attrs=frozenset(attrs), _cname=cls.__name__):
        if _REG.armed:
            # name the lock proxy after its owning class+attr so order
            # edges and reports read as roles, not object ids
            if name == _lock and isinstance(value,
                                            (_LockProxy, _ConditionProxy)):
                value.name = "%s.%s" % (_cname, _lock)
            if name in _attrs:
                first = name not in self.__dict__
                if not first:
                    # rebind of a guarded attr on a live (shared) object
                    _REG.check_owned("%s.%s" % (_cname, name), self, _lock)
                desc = "%s.%s" % (_cname, name)
                if type(value) is dict:
                    value = _GuardedDict(value)
                    value._rc = (desc, self, _lock)
                elif type(value) is list:
                    value = _GuardedList(value)
                    value._rc = (desc, self, _lock)
                elif isinstance(value, (dict, list, set)):
                    # subclassed containers (OrderedDict…): the profile
                    # hook covers their C-level mutators
                    _REG.track_container(value, desc, self, _lock)
        return _orig(self, name, value)

    cls.__setattr__ = guarded_setattr
    _patch.wrapped_setattrs.append((cls, orig, had_own))


def _profile_hook(frame, event, arg):
    """Sampling c_call hook: catches C-level mutators on guarded
    containers the subclass wrapping cannot reach."""
    if event != "c_call" or not _REG.armed:
        return
    tls = _REG._tls
    n = getattr(tls, "n", 0) + 1
    tls.n = n
    if n % _REG.sample:
        return
    try:
        name = getattr(arg, "__name__", "")
        if name not in _MUTATOR_NAMES:
            return
        target = getattr(arg, "__self__", None)
        if target is None:
            return
        rec = _REG.tracked.get(id(target))
        if rec is not None:
            desc, owner_ref, lock_attr = rec
            owner = owner_ref()
            if owner is not None:
                _check((desc, owner, lock_attr))
    except Exception:
        pass


def _import_guarded_classes():
    out = []
    import importlib
    for (mod_name, cls_name), (lock_attr, attrs) in GUARDED.items():
        try:
            mod = importlib.import_module(mod_name)
            cls = getattr(mod, cls_name)
        except Exception:
            # never let a silent import failure shrink the harness's
            # coverage unnoticed — the race gate would report a false clean
            import logging
            logging.getLogger("kubetpu_torch.racecheck").warning(
                "racecheck: cannot instrument %s.%s (import failed); "
                "guarded-attr checks for it are OFF", mod_name, cls_name,
                exc_info=True)
            continue
        out.append((cls, lock_attr, attrs))
    return out


def enable_racecheck(hold_ms: Optional[float] = None,
                     sample: Optional[int] = None) -> _Registry:
    """Idempotently arm the harness.  Locks/objects created AFTER this
    call are instrumented; pre-existing ones are not (document in tests:
    build the system inside the armed scope)."""
    with _patch_mu:
        if _patch.active:
            return _REG
        _REG.hold_ms = (hold_ms if hold_ms is not None else
                        float(os.environ.get("KUBETPU_RACE_HOLD_MS", "200")))
        _REG.sample = max(1, int(sample if sample is not None else
                                 os.environ.get("KUBETPU_RACE_SAMPLE", "1")))
        _patch.orig_lock = threading.Lock
        _patch.orig_rlock = threading.RLock
        _patch.orig_condition = threading.Condition
        threading.Lock = _make_lock_factory(_patch.orig_lock, _LockProxy)
        threading.RLock = _make_lock_factory(_patch.orig_rlock, _RLockProxy)
        threading.Condition = _condition_factory(_patch.orig_condition)
        for cls, lock_attr, attrs in _import_guarded_classes():
            _wrap_setattr(cls, lock_attr, attrs)
        _patch.prev_profile = sys.getprofile()
        threading.setprofile(_profile_hook)
        sys.setprofile(_profile_hook)
        _REG.armed = True
        _patch.active = True
        return _REG


def disable_racecheck() -> None:
    """Restore everything enable touched.  Already-created proxies keep
    working as plain locks; checks stop (armed=False)."""
    with _patch_mu:
        if not _patch.active:
            return
        _REG.armed = False
        threading.Lock = _patch.orig_lock
        threading.RLock = _patch.orig_rlock
        threading.Condition = _patch.orig_condition
        for cls, orig, had_own in _patch.wrapped_setattrs:
            if had_own:
                cls.__setattr__ = orig
            else:
                # the class inherited __setattr__; deleting our wrapper
                # restores inheritance instead of pinning a stale copy
                try:
                    del cls.__setattr__
                except AttributeError:
                    pass
        _patch.wrapped_setattrs = []
        threading.setprofile(None)
        sys.setprofile(_patch.prev_profile)
        _patch.prev_profile = None
        _patch.active = False


def assert_clean() -> None:
    vs = _REG.snapshot()
    if vs:
        raise AssertionError(
            "racecheck: %d violation%s —\n%s"
            % (len(vs), "" if len(vs) == 1 else "s",
               "\n".join(str(v) for v in vs)))


@contextmanager
def racechecked(strict: bool = True, hold_ms: Optional[float] = None,
                sample: Optional[int] = None):
    """Scoped harness for tests::

        with racechecked() as rc:
            sched = Scheduler(store)     # built INSIDE the armed scope
            ...hammer it from threads...
        # strict=True asserts zero violations on exit

    Joining an already-armed harness (KUBETPU_RACE=1 at import) resets the
    violation list so the block judges only its own work, and leaves the
    harness running on exit."""
    owned = not _patch.active
    reg = enable_racecheck(hold_ms=hold_ms, sample=sample)
    prev_hold, prev_sample = reg.hold_ms, reg.sample
    if not owned:
        # joining an env-armed harness: scope the violation list AND any
        # threshold overrides to this block — leaking a stress test's
        # relaxed hold_ms into later tests would silently weaken the gate
        reg.reset()
        if hold_ms is not None:
            reg.hold_ms = hold_ms
        if sample is not None:
            reg.sample = max(1, int(sample))
    try:
        yield reg
        if strict:
            assert_clean()
    finally:
        if owned:
            disable_racecheck()
        else:
            reg.hold_ms, reg.sample = prev_hold, prev_sample
        reg.reset()


def maybe_enable_from_env() -> Optional[_Registry]:
    """Serving-path hook mirroring utils/sanitize.py: arms the harness iff
    KUBETPU_RACE=1, called from kubetpu_torch/__init__ so every entry
    point gets
    it without its own wiring."""
    if race_enabled():
        return enable_racecheck()
    return None
