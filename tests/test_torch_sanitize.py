"""The port's runtime sanitizer (kubetpu_torch/utils/sanitize.py) against
the JAX package's (kubetpu/utils/sanitize.py), on the CPU.

Scheduling cycles in three forms (sequential, gang with the chain off,
chained gang) run under the port's sanitizer (the NaN check of every aten
op, rank promotion raising, the compile-count watchdog) and under the
JAX package's (jax_debug_nans, rank_promotion="raise") on the same
world: every cycle's view and every packed readback are bitwise equal.
A seeded NaN and a seeded rank promotion raise in both packages; the
port's watchdog counts a simulated library build and load and flags a
key counted twice; sanitized() joins an armed sanitizer and leaves no
mode behind; CompileTimer keeps the JAX timer's keys; a NaN inside a
dispatch raises out of schedule_pending instead of being recovered.
The JAX drives run in a spawned child (torch_port_util.jax_process)."""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from kubetpu.utils import sanitize as jsan
from kubetpu_torch.ops import _build
from kubetpu_torch.utils import compilation as tcomp
from kubetpu_torch.utils import sanitize as tsan
from tests.torch_port_util import drive, jax_process, packages
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

MODES = {"sequential": dict(mode="sequential"),
         "gang": dict(mode="gang", chain_cycles=False),
         "chained": dict(mode="gang", chain_cycles=True)}


def _scenario(A, hollow, store, sched):
    for n in hollow.make_nodes(8, zones=2):
        store.add(n)
    for w in range(2):
        for p in hollow.make_pods(6, prefix=f"wave{w}-"):
            store.add(p)
        yield


def _sanitized_drive(pkg, san, kw):
    """The scenario's drive under ``san``'s sanitizer, with every packed
    readback recorded: (cycle views, packed arrays)."""
    packed = []
    cls = pkg.sched.Scheduler
    orig = cls._readback_group

    def spy(self, prep, res):
        out = orig(self, prep, res)
        packed.append(np.array(out))
        return out

    cls._readback_group = spy
    try:
        with san.sanitized():
            views, _ = drive(pkg, _scenario, **kw)
    finally:
        cls._readback_group = orig
    return views, packed


def _jax_drives():
    jpkg = packages()[0]
    return {name: _sanitized_drive(jpkg, jsan, kw)
            for name, kw in MODES.items()}


@pytest.fixture(scope="module")
def jax_drives():
    with jax_process() as ex:
        return ex.submit(_jax_drives).result()


@pytest.mark.parametrize("name", list(MODES))
def test_cycles_under_sanitizer_equal_jax(jax_drives, name):
    tpkg = packages()[1]
    views, packed = _sanitized_drive(tpkg, tsan, MODES[name])
    want_views, want_packed = jax_drives[name]
    assert views == want_views
    assert len(packed) == len(want_packed) > 0
    for got, want in zip(packed, want_packed):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    placed = [o for v in views for o in v["outcomes"] if o[1]]
    assert len(placed) == 12
    assert torch._C._len_torch_dispatch_stack() == 0


# ------------------------------------------------------------ NaN, ranks


def test_seeded_nan_raises_in_both():
    import jax
    import jax.numpy as jnp
    with jsan.sanitized():
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x))(
                jnp.zeros((4,)) - 1.0).block_until_ready()
    with tsan.sanitized():
        with pytest.raises(FloatingPointError, match=r"nan.*aten\.log"):
            torch.log(torch.zeros(4) - 1.0)


def test_seeded_rank_promotion_raises_in_both():
    import jax.numpy as jnp
    with jsan.sanitized():
        with pytest.raises(ValueError, match="rank_promotion|broadcast"):
            _ = jnp.ones((4, 8, 12), bool) | jnp.zeros((12,), bool)
    with tsan.sanitized():
        with pytest.raises(ValueError, match="rank_promotion"):
            _ = torch.ones((4, 8, 12), dtype=torch.bool) | \
                torch.zeros((12,), dtype=torch.bool)
        # explicit broadcasts and 0-dim operands pass
        _ = torch.ones((4, 8, 12), dtype=torch.bool) | \
            torch.zeros((12,), dtype=torch.bool)[None, None, :]
        _ = torch.ones((4, 8)) * torch.tensor(2.0)


def test_device_index_names_the_first_offending_op():
    """The card's deferred check (_device_check folds into an index read
    later) run on CPU tensors: check_now raises naming the first op
    whose output held a NaN, and trims what it found clean."""
    with tsan.sanitized():
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            tsan._device_check("first-clean", torch.ones(3))
            tsan._device_check("the-culprit", torch.tensor([1.0, np.nan]))
            tsan._device_check("later-nan", torch.tensor([np.nan]))
        with pytest.raises(FloatingPointError, match="the-culprit"):
            tsan.check_now()
        with _disable_current_modes():
            tsan._device_check("clean", torch.zeros(2))
        tsan.check_now()
        assert tsan._ops == []


def test_unseen_kernel_outputs_are_checked():
    """K1 launches through ctypes, out of the dispatch mode's sight: its
    wrapper hands its floating output to check_outputs."""
    tsan.check_outputs("propose", torch.tensor([np.nan]))   # disarmed
    with tsan.sanitized():
        tsan.check_outputs("propose", torch.tensor([1, 2]),
                           torch.tensor([0.5]))
        with pytest.raises(FloatingPointError, match="propose"):
            tsan.check_outputs("propose", torch.tensor([np.nan]))


def test_nan_in_dispatch_is_not_recovered(monkeypatch):
    """A sanitizer finding is a fault of the kernel path: it raises out
    of schedule_pending (its pods back in the queue), never a recovered
    dispatch-error."""
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    import kubetpu_torch.scheduler as tsched
    orig = tsched.run_auction

    def nan_auction(*a, **kw):
        torch.sqrt(torch.full((2,), -1.0))
        return orig(*a, **kw)

    monkeypatch.setattr(tsched, "run_auction", nan_auction)
    store = ClusterStore()
    for n in hollow.make_nodes(2):
        store.add(n)
    sched = tsched.Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], mode="gang"), device="cpu")
    try:
        for p in hollow.make_pods(3):
            store.add(p)
        with tsan.sanitized():
            with pytest.raises(FloatingPointError, match="sqrt"):
                sched.schedule_pending()
        assert not sched.recovery_log
        assert len(sched.queue) == 3
    finally:
        sched.close()


# ----------------------------------------------------------- the watchdog


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    monkeypatch.setattr(tcomp, "_enabled", None)
    monkeypatch.setenv(tcomp.ENV, str(tmp_path / "cache"))
    monkeypatch.setattr(_build, "_propose_lib", None)
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "library_source", {})

    def fake_compile(name, out):
        with open(out, "wb") as fh:
            fh.write(b"lib")
        return 0.5

    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build, "_open", lambda path: object())


def test_watchdog_counts_simulated_library_load(fake_build, monkeypatch):
    lib = _build.lib_name("propose")
    events0 = _build.compile_events()
    with tsan.sanitized() as wd:
        _build.load_propose()
        assert wd.counts == {("nvcc:propose", lib): 1,
                             ("load:propose", lib): 1}
        assert wd.compile_count() > 0
        wd.assert_no_recompilation()
        assert not wd.donation_mismatches
        # the same library loaded again by this process: a recompile
        monkeypatch.setattr(_build, "_propose_lib", None)
        _build.load_propose()
        assert wd.recompiled() == {("load:propose", lib): 2}
        with pytest.raises(AssertionError, match="built again"):
            wd.assert_no_recompilation()
        wd.reset()
        assert wd.compile_count() == 0
    # every event also counts for the dispatch deadline's exemption
    assert _build.compile_events() - events0 == 4


def test_watchdog_flags_twice_counted_key_like_jax():
    """The JAX watchdog on its log records and the port's on its seam,
    fed the same two shapes and one repeat: the same verdicts."""
    import logging
    jwd, twd = jsan.CompileWatchdog(), tsan.CompileWatchdog()

    def rec(shape):
        return logging.LogRecord(
            "jax._src.interpreters.pxla", logging.DEBUG, __file__, 1,
            "Compiling prog with global shapes and types "
            "[ShapedArray(float32[%s])]. Argument mapping: (x,)." % shape,
            (), None)

    for shape in ("8,4", "16,4", "8,4"):
        jwd.emit(rec(shape))
        twd.note("capture:prog", "[(%s)]" % shape)
    assert len(jwd.recompiled()) == len(twd.recompiled()) == 1
    assert list(jwd.recompiled().values()) == \
        list(twd.recompiled().values()) == [2]
    assert jwd.compile_count() == twd.compile_count() == 3


def test_install_compile_watchdog_shares_and_detaches():
    wd = tsan.install_compile_watchdog()
    try:
        swd = tsan.enable_sanitizer()
        assert swd is not wd
        assert tsan.install_compile_watchdog() is swd
        tsan.note_compile("p", "s", "capture")
        assert wd.compile_count() == swd.compile_count() == 1
        tsan.uninstall_compile_watchdog(wd)
        tsan.uninstall_compile_watchdog(swd)   # the sanitizer's: stays
        tsan.note_compile("p", "s", "capture")
        assert wd.compile_count() == 1 and swd.compile_count() == 2
    finally:
        tsan.disable_sanitizer()
    assert tsan._watchdogs == ()


# ------------------------------------------------------- arming, scoping


def test_sanitized_joins_env_armed_sanitizer(monkeypatch):
    monkeypatch.setenv(tsan.ENV_FLAG, "1")
    wd = tsan.maybe_enable_from_env()
    assert wd is not None
    try:
        wd.counts[("stale", "x")] = 2
        with tsan.sanitized() as wd2:
            assert wd2 is wd
            assert wd2.compile_count() == 0
        assert tsan.current_watchdog() is wd
        assert torch._C._len_torch_dispatch_stack() == 1
    finally:
        tsan.disable_sanitizer()
    assert tsan.current_watchdog() is None
    assert torch._C._len_torch_dispatch_stack() == 0
    torch.log(torch.zeros(2) - 1.0)        # unchecked again


def test_maybe_enable_from_env_off_by_default(monkeypatch):
    monkeypatch.delenv(tsan.ENV_FLAG, raising=False)
    assert tsan.maybe_enable_from_env() is None
    assert tsan.current_watchdog() is None
    assert tsan.thread_scope() is tsan._NULL_SCOPE


def test_thread_scope_checks_another_thread():
    """The mode stack is per thread: a thread entering thread_scope()
    is checked, one that does not is not."""
    got = {}

    def worker(key, scoped):
        try:
            if scoped:
                with tsan.thread_scope():
                    torch.log(torch.zeros(1) - 1.0)
            else:
                torch.log(torch.zeros(1) - 1.0)
            got[key] = None
        except FloatingPointError as e:
            got[key] = e

    with tsan.sanitized():
        for key, scoped in (("scoped", True), ("bare", False)):
            t = threading.Thread(target=worker, args=(key, scoped))
            t.start()
            t.join()
    assert isinstance(got["scoped"], FloatingPointError)
    assert got["bare"] is None


@pytest.mark.parametrize("flag", ["1", None])
def test_package_import_arms_from_env(flag):
    env = {k: v for k, v in os.environ.items()
           if k not in (tsan.ENV_FLAG, "KUBETPU_RACE")}
    if flag is not None:
        env[tsan.ENV_FLAG] = flag
    code = ("import kubetpu_torch, torch\n"
            "from kubetpu_torch.utils import sanitize, racecheck\n"
            "print(sanitize.current_watchdog() is not None,"
            " torch._C._len_torch_dispatch_stack(),"
            " racecheck.registry().armed)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.path.
                         dirname(os.path.dirname(os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == (["True", "1", "False"] if flag
                                  else ["False", "0", "False"])


# --------------------------------------------------------- compile timer


def test_compile_timer_keys_and_delta_match_jax():
    jt, tt = jsan.CompileTimer(), tsan.CompileTimer()
    assert set(jt.snapshot()) == set(tt.snapshot())
    jt.on_duration("/jax/core/compile/backend_compile_duration", 5.0)
    jt.on_duration("/jax/compilation_cache/cache_retrieval_time_sec", 2.0)
    jt.on_event("/jax/compilation_cache/cache_hits")
    jt.on_event("/jax/compilation_cache/cache_misses")
    tt.note("nvcc", 3.0)
    tt.note("artifact", 2.0)
    assert jt.snapshot() == tt.snapshot()
    s1 = tt.snapshot()
    tt.note("capture", 1.5)
    tt.note("load", 0.25)
    tt.note("cached")
    assert tsan.CompileTimer.delta(s1, tt.snapshot()) == {
        "compile_s": 1.5, "cache_load_s": 0.25, "cache_hits": 1,
        "cache_misses": 0}


def test_compile_timer_thread_safety_and_singleton():
    assert tsan.install_compile_timer() is tsan.install_compile_timer()
    t = tsan.CompileTimer()
    before = t.snapshot()

    def hammer():
        for _ in range(500):
            t.note("nvcc", 0.001)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    d = tsan.CompileTimer.delta(before, t.snapshot())
    assert abs(t.snapshot()["compile_s"] - 2.0) < 1e-6
    assert d["compile_s"] == 2.0 and d["cache_misses"] == 2000
