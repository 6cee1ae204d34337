"""Deploy-time kernel artifacts (kubetpu_torch/utils/aot.py,
kubetpu_torch/kubeaot) on the CPU: the store and its index round trip,
an environment mismatch disarming with its reason, a missing blob as a
counted miss, the chaos ``aot-load:corrupt`` fault as a counted
``aot-fallback`` recovery that rebuilds, the recovery ladder's aot->build
rung, ``maybe_arm_from_env`` against the JAX package's on the same call
sequence, and ``python -m kubetpu_torch.kubeaot``'s exit codes.

The CPU tests run without nvcc or a card, so the library builder
(``_build._compile``) and the ctypes loader (``_build._open``) are
injected; the real build and load run in chip_smoke.py's guards phase.  Where a test keeps the real
builder, the missing nvcc raises KernelError: no plain version stands in
for the kernel."""
import json
import os
from types import SimpleNamespace

import pytest

from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.kubeaot import __main__ as kubeaot_cli
from kubetpu_torch.ops import _build
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.utils import aot
from kubetpu_torch.utils import chaos
from kubetpu_torch.utils import compilation as tcomp
from kubetpu_torch.utils import trace as utrace
from kubetpu_torch.utils.metrics import SchedulerMetrics
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


REAL_COMPILE = _build._compile


class FakeLib:
    def __init__(self, path):
        self.path = path
        with open(path, "rb") as fh:
            self.data = fh.read()


def _fake_bytes(name):
    return b"\x7fELF stand-in for " + name.encode() + b" " + \
        _build.lib_digest(name).encode()


@pytest.fixture
def iso(tmp_path, monkeypatch):
    """A fresh kernel cache, no library loaded, nvcc and dlopen
    injected, nothing armed."""
    compiled, opened = [], []

    def fake_compile(name, out):
        compiled.append(name)
        with open(out, "wb") as fh:
            fh.write(_fake_bytes(name))
        return 0.25

    def fake_open(path):
        opened.append(path)
        return FakeLib(path)

    monkeypatch.setattr(tcomp, "_enabled", None)
    monkeypatch.setenv(tcomp.ENV, str(tmp_path / "cache"))
    monkeypatch.delenv(aot.DIR_ENV, raising=False)
    monkeypatch.delenv(chaos.ENV, raising=False)
    monkeypatch.setattr(_build, "_propose_lib", None)
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "library_source", {})
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build, "_open", fake_open)
    aot.disarm()
    aot.reset_demotion()
    chaos.disarm()
    yield SimpleNamespace(compiled=compiled, opened=opened,
                          root=str(tmp_path / "aot"),
                          cache=str(tmp_path / "cache"))
    aot.disarm()
    aot.reset_demotion()
    chaos.disarm()
    utrace.disarm_flight_recorder()


def _built(iso):
    """An artifact directory built by kubeaot, the compile count reset."""
    assert kubeaot_cli.main(["build", iso.root]) == 0
    del iso.compiled[:]
    return iso.root


def test_store_and_index_round_trip(iso):
    root = _built(iso)
    doc = json.load(open(os.path.join(root, aot.INDEX_NAME)))
    assert doc["env"] == aot.env_signature()
    assert [r["program"] for r in doc["rows"]] == _build.sources()
    row = doc["rows"][0]
    blob = open(os.path.join(root, row["artifact"]), "rb").read()
    assert blob == _fake_bytes("propose")
    assert row["bytes"] == len(blob)
    assert row["library"] == _build.lib_name("propose")
    assert row["artifact"].startswith("propose-" + row["sha256"][:16])
    rt = aot.arm(aot.serve_runtime(root))
    assert rt is aot.active_runtime() and rt.disabled_reason is None
    lib = _build.load_propose()
    # the library came from the artifact: installed in the cache under
    # its own name, loaded once, and no nvcc ran
    assert iso.compiled == []
    assert lib.path == os.path.join(iso.cache, _build.lib_name("propose"))
    assert lib.data == blob
    assert _build.library_source["propose"] == "artifact"
    assert "propose" not in _build.build_seconds
    assert _build.load_propose() is lib and len(iso.opened) == 1
    st = rt.stats()
    assert (st["hits"], st["misses"], st["loads"]) == (1, 0, 1)


def test_env_mismatch_disarms_with_reason(iso):
    root = _built(iso)
    store = aot.AotStore(root)
    doc = store.read_index()
    store.write_index(dict(doc["env"], kernel_digest="0" * 64),
                      doc["rows"])
    rt = aot.serve_runtime(root)
    assert rt.mismatch and "kernel_digest" in rt.disabled_reason
    assert aot.arm(rt) is None
    assert aot.active_runtime() is None
    assert "kernel_digest" in aot.demotion_reason()
    # the library builds from source, exactly as with no artifacts
    _build.load_propose()
    assert iso.compiled == ["propose"]
    assert _build.library_source["propose"] == "nvcc"


def test_missing_blob_is_a_counted_miss(iso):
    root = _built(iso)
    store = aot.AotStore(root)
    doc = store.read_index()
    os.unlink(os.path.join(root, doc["rows"][0]["artifact"]))
    rt = aot.arm(aot.serve_runtime(root))
    report = rt.preload()
    assert [(r["program"], r["ok"]) for r in report] == [("propose", False)]
    assert "unreadable" in report[0]["reason"]
    st = rt.stats()
    assert (st["hits"], st["misses"], st["loads"]) == (0, 1, 0)
    _build.load_propose()
    assert iso.compiled == ["propose"]
    # the miss is remembered: no second probe of the store
    assert rt.library("propose") is None and rt.stats()["misses"] == 1


def test_stale_row_is_a_miss(iso):
    root = _built(iso)
    store = aot.AotStore(root)
    doc = store.read_index()
    doc["rows"][0]["source_sha256"] = "1" * 64
    store.write_index(doc["env"], doc["rows"])
    rt = aot.arm(aot.serve_runtime(root))
    assert rt.library("propose") is None
    assert "another source" in rt.stats()["missing"]["propose"]


def _sched(store, **kw):
    return Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=8, mode="gang",
        kernel_backend="pallas", prewarm=False), device="cpu", **kw)


def test_chaos_corrupt_blob_counts_aot_fallback_and_rebuilds(iso,
                                                            monkeypatch):
    """KUBETPU_CHAOS=aot-load:corrupt:n=1 truncates the blob prewarm
    reads: its sha256 check fails, recoveries{aot-fallback} reads 1, the
    prewarm flight span says so, and the library builds from source."""
    root = _built(iso)
    monkeypatch.setenv(aot.DIR_ENV, root)
    monkeypatch.setenv(chaos.ENV, "aot-load:corrupt:n=1")
    fr = utrace.arm_flight_recorder(capacity=8)
    store = ClusterStore()
    for n in hollow.make_nodes(4):
        store.add(n)
    m = SchedulerMetrics()
    sched = _sched(store, metrics=m)
    try:
        assert aot.active_runtime() is not None
        assert sched.prewarm()
        assert m.recoveries.value("aot-fallback") == 1
        assert chaos.active().counts() == {"aot-load": 1}
        spans = [s for rec in fr.cycles() for s in rec.spans()
                 if s.name == "prewarm" and s.args.get("mode")
                 == "aot-artifact"]
        assert len(spans) == 1 and spans[0].args["loaded"] == 0
        assert "seconds" in spans[0].args
        assert "sha256 mismatch" in aot.active_runtime().stats()[
            "missing"]["propose"]
        _build.load_propose()
        assert iso.compiled == ["propose"]
        assert _build.library_source["propose"] == "nvcc"
    finally:
        sched.close()


def test_prewarm_loads_armed_artifacts(iso, monkeypatch):
    root = _built(iso)
    monkeypatch.setenv(aot.DIR_ENV, root)
    store = ClusterStore()
    for n in hollow.make_nodes(4):
        store.add(n)
    m = SchedulerMetrics()
    sched = _sched(store, metrics=m)
    try:
        assert sched.prewarm()
        assert m.recoveries.value("aot-fallback") == 0
        assert _build.library_source["propose"] == "artifact"
        assert len(iso.opened) == 1 and iso.compiled == []
    finally:
        sched.close()


def test_no_nvcc_and_no_artifact_raises(iso, monkeypatch):
    """With the real builder on a machine without nvcc, a corrupt
    artifact leaves the kernel unbuilt: KernelError, as without
    artifacts, and never the plain version in its place."""
    root = _built(iso)
    monkeypatch.setattr(_build, "_compile", REAL_COMPILE)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", str(os.path.join(root, "no-cuda")))
    chaos.arm(chaos.parse_spec("aot-load:corrupt:n=1"))
    aot.arm(aot.serve_runtime(root))
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _build.load_propose()
    assert _build._propose_lib is None


def test_dispatch_fault_disarms_aot(iso, monkeypatch):
    """A recovered dispatch fault demotes nothing of the kernel route, so
    it disarms an armed runtime: the aot->build rung."""
    root = _built(iso)
    monkeypatch.setenv(aot.DIR_ENV, root)
    monkeypatch.setenv(chaos.ENV, "dispatch:error:n=1")
    store = ClusterStore()
    for n in hollow.make_nodes(4):
        store.add(n)
    sched = _sched(store)
    try:
        for p in hollow.make_pods(4, prefix="w-"):
            store.add(p)
        sched.schedule_pending()
        assert sched.recovery_log[0]["kind"] == "dispatch-error"
        assert sched.recovery_log[0]["demoted"] == ["aot->build"]
        assert aot.active_runtime() is None
        assert aot.demotion_reason().startswith("dispatch-error")
        # the latch keeps a later Scheduler from re-arming the set
        assert aot.maybe_arm_from_env() is None
    finally:
        sched.close()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_maybe_arm_from_env(tmp_path, monkeypatch, package, iso):
    """The JAX test's sequence through each package: a directory with no
    index leaves serving disarmed (no latch), a matching index arms."""
    if package == "jax":
        from kubetpu.utils import aot as mod
    else:
        mod = aot
    mod.disarm()
    mod.reset_demotion()
    monkeypatch.setenv(mod.DIR_ENV, str(tmp_path / "nope"))
    assert mod.maybe_arm_from_env() is None
    assert mod.demotion_reason() is None
    store = mod.AotStore(str(tmp_path / "ok"))
    store.write_index(mod.env_signature(), [])
    monkeypatch.setenv(mod.DIR_ENV, str(tmp_path / "ok"))
    rt = mod.maybe_arm_from_env()
    try:
        assert rt is not None and rt.mode == "serve"
        assert mod.active_runtime() is rt
    finally:
        mod.disarm()


def test_kubeaot_check_exit_codes(iso, capsys):
    assert kubeaot_cli.main(["check", os.path.join(iso.root, "none")]) == 1
    root = _built(iso)
    capsys.readouterr()
    assert kubeaot_cli.main(["check", root, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["clean"] and doc["failures"] == []
    # a blob that changed after the build
    store = aot.AotStore(root)
    row = store.read_index()["rows"][0]
    with open(os.path.join(root, row["artifact"]), "ab") as fh:
        fh.write(b"!")
    assert kubeaot_cli.main(["check", root]) == 1
    assert aot.check_store(root) == ["propose: blob sha256 mismatch"]
    # another machine's environment
    root2 = os.path.join(iso.root, "second")
    assert kubeaot_cli.main(["build", root2]) == 0
    doc = store.read_index()
    aot.AotStore(root2).write_index(dict(doc["env"], device="other"),
                                    aot.AotStore(root2).read_index()["rows"])
    assert kubeaot_cli.main(["check", root2]) == 1
    assert "mismatch on device" in aot.check_store(root2)[0]
