"""The port's surface held to the JAX package's, name by name.

Every module-level function and class, and every method, of
``kubetpu/<path>`` has a twin of the same name in ``kubetpu_torch/<path>``
(``kubetpu/ops/pallas_kernels.py`` maps to ``kubetpu_torch/ops/
propose.py``, the only file-level exception), or a row in JAX_ONLY below
that says where the port does that work, or which decision of ROADMAP
queue 1 item 11 ("the JAX-runtime utilities") makes it n/a.  The same
holds for KubeSchedulerConfiguration's fields and for the ``KUBETPU_*``
environment variables each package reads (string constants that are a
whole variable name).  A row whose name no longer exists in ``kubetpu/``,
or that now exists in the port, fails as stale, so the tables only shrink.

Both trees are read with ``ast``; neither package is imported.
"""
import ast
import functools
import pathlib
import re

import pytest

from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX = ROOT / "kubetpu"
PORT = ROOT / "kubetpu_torch"
FILE_MAP = {"ops/pallas_kernels.py": "ops/propose.py"}

ITEM11 = "n/a, ROADMAP queue 1 item 11"
JIT_ROOT = ("a jax.jit root; the port's %s runs the same program eagerly "
            "(" + ITEM11 + ": eager torch compiles nothing per shape)")
AOT_JIT = ("the AOT seam's jit statics and call signature: " + ITEM11
           + " (a kernel library serves every shape; no jit statics)")
BUCKETS = ("the prewarm bucket ladder: " + ITEM11
           + " (a kernel library serves every shape)")
REGISTRY = ("the mesh-key registry keys jit and AOT statics: " + ITEM11)
XPLANE = ("XPlane ingest: the port's DevStats.ingest_trace folds the "
          "torch.profiler Chrome trace instead (" + ITEM11 + ")")
PXLA = ("reads jax's pxla compile log: the port's watchdog counts at its "
        "build, load and capture seams (CompileWatchdog.note via "
        "ops/_build.note_compile_event), never from a log (" + ITEM11 + ")")
FALLBACK = ("the port records each gang cycle's route and the reason a "
            "pallas request ran lax in Scheduler.gang_backends; routing a "
            "batch by content is not a fallback (utils/pallas_backend.py)")
PREDRAIN = ("devstats' untimed pre-drain of in-flight results before a "
            "fenced cycle: the port times programs by CUDA event pairs, "
            "which need no fence and no pre-drain (" + ITEM11 + ")")

# "path::name" in kubetpu/ -> where the port does that work, or why it is
# n/a
JAX_ONLY = {
    "models/batch.py::gather_batch_rows":
        "no caller in kubetpu/ or its tests; the port's row gather is "
        "models/batch.py take_rows (the rows a caller names, no -1 pad)",
    "models/gang.py::_materialize_assigned":
        JIT_ROOT % "models/gang.py materialize_assigned",
    "models/gang.py::_schedule_gang":
        JIT_ROOT % "models/gang.py schedule_gang (over _gang_program)",
    "models/programs.py::_apply_cluster_delta":
        JIT_ROOT % "models/programs.py apply_cluster_delta (in place)",
    "models/programs.py::_explain_verdicts":
        JIT_ROOT % "models/programs.py explain_verdicts",
    "models/sequential.py::_schedule_sequential":
        JIT_ROOT % "models/sequential.py schedule_sequential",
    "models/sequential.py::_sequential_program":
        "the jit-free scan body that the shard_map path traces; the "
        "port's schedule_sequential is that body, and parallel/shardmap.py "
        "schedule_sequential_mesh calls it",
    "ops/pallas_kernels.py::Buf":
        "a Pallas VMEM scratch descriptor; the CUDA kernel stages through "
        "shared memory under mbarriers (ops/csrc/propose.cu)",
    "ops/pallas_kernels.py::_Layout":
        "the kernel's static layout, named Layout in ops/propose.py",
    "ops/pallas_kernels.py::_layout":
        "builds the layout: ops/propose.py layout_for, packed for the CUDA "
        "kernel by _layout_c",
    "ops/pallas_kernels.py::_make_kernel":
        "the Pallas kernel body: the port's kernel is ops/csrc/propose.cu, "
        "its plain version ops/propose.py propose_plain",
    "ops/pallas_kernels.py::gather_bundle":
        "the window's row gather: the CUDA kernel reads the window's rows "
        "of the whole bundle by index, and propose_plain gathers them in "
        "ops/propose.py _rows_of",
    "ops/pallas_kernels.py::kernel_buffers":
        "the Pallas kernel's VMEM scratch list; the CUDA kernel's shared "
        "memory is laid out in ops/csrc/propose.cu",
    "parallel/mesh.py::_put":
        "jax.device_put onto a NamedSharding; the port places each shard's "
        "piece with a torch copy in parallel/mesh.py _layout",
    "parallel/mesh.py::_shard_host_ok":
        "shards the host mask for the jit program; the port hands it whole "
        "to the controller (parallel/shardmap.py schedule_gang_mesh)",
    "parallel/mesh.py::ambient_mesh":
        "the gspmd partitioner's ambient mesh: " + ITEM11
        + " (torch has no SPMD partitioner)",
    "parallel/shardmap.py::_apply_delta_body":
        "the shard_map body of the delta scatter; the port's shard-local "
        "scatter is _local_delta in apply_cluster_delta_mesh",
    "parallel/shardmap.py::_cluster_specs":
        "shard_map PartitionSpecs of the cluster; the port's shard axes "
        "are parallel/mesh.py _cluster_axes",
    "parallel/shardmap.py::_gang_replicated":
        "the replicated surface under shard_map; the port's "
        "schedule_gang_mesh runs _gang_program on the controller for it",
    "parallel/shardmap.py::_gang_tiled":
        "the tiled round under shard_map; the port's is _tiled_step, the "
        "propose_step of models/gang.py _gang_program",
    "parallel/shardmap.py::_get_mesh": REGISTRY,
    "parallel/shardmap.py::_rep_spec":
        "a replicated PartitionSpec tree; the port's parallel/mesh.py "
        "replicate copies the tree to every shard",
    "parallel/shardmap.py::_shardmap_gang":
        JIT_ROOT % "parallel/shardmap.py schedule_gang_mesh",
    "parallel/shardmap.py::_shardmap_sequential":
        JIT_ROOT % "parallel/shardmap.py schedule_sequential_mesh",
    "parallel/shardmap.py::mesh_key": REGISTRY,
    "parallel/shardmap.py::register_mesh": REGISTRY,
    "pipeline.py::InflightRing.results": PREDRAIN,
    "pipeline.py::PipelinedExecutor.inflight_results": PREDRAIN,
    "plugins/intree.py::DefaultPreemption.name":
        "inherited: framework/interface.py Plugin.name returns NAME",
    "preemption.py::Preemptor._pod_batch1":
        "a one-pod _pods_batch; the port calls _pods_batch([pod], cycle) "
        "in Preemptor._select_nodes_for_preemption",
    "scheduler.py::Scheduler._bind_cycle_inner":
        "the port's _bind_cycle holds the body and opens the flight span "
        "itself (scheduler.py)",
    "scheduler.py::Scheduler._prewarm_ladder": BUCKETS,
    "scheduler.py::Scheduler._prewarm_ladder_step": BUCKETS,
    "scheduler.py::_vocab_caps":
        "an alias of state/tensors.py vocab_signature, which the port's "
        "scheduler calls directly",
    "state/delta.py::DeltaTensorizer._device_terms":
        "the port's DeltaTensorizer._refresh_terms copies them with "
        "state/tensors.py _terms_to_device",
    "utils/aot.py::AotRuntime._capture":
        "serializes a jit executable; the port's AotRuntime.capture builds "
        "and stores the kernel library",
    "utils/aot.py::AotRuntime._load":
        "deserializes an XLA executable; the port's AotRuntime.library "
        "loads the kernel library",
    "utils/aot.py::AotRuntime.allows_bucket": BUCKETS,
    "utils/aot.py::AotRuntime.capture_call":
        "captures a jit call's executable; the port's AotRuntime.capture "
        "(python -m kubetpu_torch.kubeaot build) builds per library",
    "utils/aot.py::AotRuntime.dispatch": AOT_JIT,
    "utils/aot.py::AotRuntime.serving_buckets": BUCKETS,
    "utils/aot.py::AotStore._env_key":
        "AotStore.env_key in the port (a static method)",
    "utils/aot.py::AotStore.remove":
        "called only by kubeaot's --prune: " + ITEM11,
    "utils/aot.py::_kw_defaults": AOT_JIT,
    "utils/aot.py::_leaf_sig": AOT_JIT,
    "utils/aot.py::_note_resident_executable":
        "a loaded XLA executable's device residency; a kernel library is "
        "host code, so the port's ledger has no such row",
    "utils/aot.py::_pkg_root":
        "the port's kernel_digest finds ops/csrc through ops/_build.CSRC",
    "utils/aot.py::call_signature": AOT_JIT,
    "utils/aot.py::dispatch": AOT_JIT,
    "utils/aot.py::pod_bucket_of": BUCKETS,
    "utils/aot.py::static_sig": AOT_JIT,
    "utils/devstats.py::DevStats.clear":
        "no caller in either package",
    "utils/devstats.py::DevStats.ingest_xplane": XPLANE,
    "utils/devstats.py::DevStats.mean_seconds":
        "no caller in either package",
    "utils/devstats.py::_aval_bytes":
        "bytes of a jaxpr aval string; the port reads tensor sizes "
        "(utils/devstats.py _leaf_bytes)",
    "utils/devstats.py::_parse_xplane": XPLANE,
    "utils/devstats.py::_repo_root":
        "finds COMPILE_MANIFEST.json: " + ITEM11 + " (it describes JAX "
        "programs; the port's roofline joins utils/flops.py's count)",
    "utils/devstats.py::manifest_costs":
        "COMPILE_MANIFEST.json's XLA cost rows: " + ITEM11 + " (the "
        "port's roofline joins utils/flops.py's analytic count)",
    "utils/pallas_backend.py::available":
        "the Pallas backend probe: " + ITEM11 + " (K1 builds and "
        "launches or raises)",
    "utils/pallas_backend.py::fallback_counts": FALLBACK,
    "utils/pallas_backend.py::interpret_mode":
        "Pallas interpret mode: " + ITEM11 + " (a CPU tensor takes the "
        "plain version, a CUDA tensor the kernel)",
    "utils/pallas_backend.py::note_fallback": FALLBACK,
    "utils/pallas_backend.py::reset_fallbacks": FALLBACK,
    "utils/sanitize.py::CompileTimer.on_duration":
        "a jax.monitoring listener; the port's CompileTimer.note is called "
        "at the compile seams (utils/sanitize.py note_compile)",
    "utils/sanitize.py::CompileTimer.on_event":
        "a jax.monitoring listener; the port's CompileTimer.note is called "
        "at the compile seams (utils/sanitize.py note_compile)",
    "utils/sanitize.py::CompileWatchdog.emit": PXLA,
    "utils/sanitize.py::CompileWatchdog.note_warning": PXLA,
    "utils/sanitize.py::_arm_pxla_logger": PXLA,
    "utils/sanitize.py::_disarm_pxla_logger": PXLA,
}

# KubeSchedulerConfiguration fields of the JAX package the port lacks
JAX_ONLY_FIELDS = {
    "prewarm_ladder": BUCKETS,
    "enable_profiling": "inert in kubetpu/: no code reads it",
    "enable_contention_profiling": "inert in kubetpu/: no code reads it",
}

# KUBETPU_* variables the JAX package reads and the port does not:
# variable -> (reason, the port's counterpart variable or None)
JAX_ONLY_ENV = {
    "KUBETPU_PALLAS_INTERPRET": (
        "forces Pallas interpret mode: " + ITEM11 + " (a CPU tensor takes "
        "the plain version, a CUDA tensor the kernel)", None),
    "KUBETPU_XLA_CACHE_DIR": (
        "jax's persistent compilation cache directory; the port's kernel "
        "library cache is utils/compilation.py's", "KUBETPU_KERNEL_CACHE_DIR"),
}


@functools.lru_cache(maxsize=None)
def _defs(path: pathlib.Path) -> set:
    """Module-level functions and classes, and methods as Class.name."""
    out = set()

    def walk(body, prefix):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(prefix + n.name)
            elif isinstance(n, ast.ClassDef):
                out.add(prefix + n.name)
                walk(n.body, prefix + n.name + ".")
    walk(ast.parse(path.read_text()).body, "")
    return out


def _twin(rel: str) -> pathlib.Path:
    return PORT / FILE_MAP.get(rel, rel)


def _fields(root: pathlib.Path) -> set:
    tree = ast.parse((root / "apis" / "config.py").read_text())
    cls, = [n for n in tree.body if isinstance(n, ast.ClassDef)
            and n.name == "KubeSchedulerConfiguration"]
    return {n.target.id for n in cls.body if isinstance(n, ast.AnnAssign)}


@functools.lru_cache(maxsize=None)
def _env(root: pathlib.Path) -> set:
    out = set()
    for f in root.rglob("*.py"):
        for n in ast.walk(ast.parse(f.read_text())):
            if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                    and re.fullmatch(r"KUBETPU_[A-Z0-9_]+", n.value)):
                out.add(n.value)
    return out


JAX_FILES = sorted(p.relative_to(JAX).as_posix() for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_FILES)
def test_module_has_its_twins(rel):
    twin = _twin(rel)
    assert twin.is_file(), f"kubetpu/{rel} has no port module {twin}"
    missing = sorted(f"{rel}::{n}" for n in _defs(JAX / rel) - _defs(twin))
    unlisted = [m for m in missing if m not in JAX_ONLY]
    assert not unlisted, (
        f"names of kubetpu/{rel} with no twin in {twin.relative_to(ROOT)} "
        f"and no row in JAX_ONLY: {unlisted}")


def test_no_stale_row():
    stale = []
    for key, reason in JAX_ONLY.items():
        rel, name = key.split("::")
        if not (JAX / rel).is_file() or name not in _defs(JAX / rel):
            stale.append((key, "gone from kubetpu/"))
        elif _twin(rel).is_file() and name in _defs(_twin(rel)):
            stale.append((key, "ported"))
        if len(reason) < 20:
            stale.append((key, "no reason given"))
    assert not stale, stale


def test_configuration_fields_have_twins():
    jax_f, port_f = _fields(JAX), _fields(PORT)
    assert jax_f - port_f == set(JAX_ONLY_FIELDS), (
        sorted(jax_f - port_f), sorted(JAX_ONLY_FIELDS))


def test_environment_variables_have_twins():
    jax_e, port_e = _env(JAX), _env(PORT)
    assert jax_e - port_e == set(JAX_ONLY_ENV), (
        sorted(jax_e - port_e), sorted(JAX_ONLY_ENV))
    for var, (reason, counterpart) in JAX_ONLY_ENV.items():
        assert reason
        assert counterpart is None or counterpart in port_e, (var,
                                                              counterpart)
