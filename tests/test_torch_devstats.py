"""The port's device statistics and FLOP model (kubetpu_torch/utils/
devstats.py, utils/flops.py) on the CPU: gang_cycle_flops and a drain's
device_flops equal the JAX package's, the residency ledger's per-table
bytes and dim tags and the capacity projection equal the JAX package's on
the same world, the roofline equals the JAX package's given the same
peaks, /debug/devicez against the JAX server's document armed and
disarmed, and twins of tests/test_devstats.py: every timed program
recorded (wall time on the CPU; CUDA event pairs only on a card), the
capacity gate within 10%, the ledger's lifecycle, the device-fence span
and the pipeline doc's device block, armed and disarmed placements
identical, the disarmed hot path a no-op, and the profiler capture's
ingest (its CUDA kernel sum on a synthetic trace, its reason on a CPU
capture).

The peaks are the card's: 67 TFLOP/s f32 (TF32 off) and 3.35 TB/s for an
H100 SXM, and the card's own memory; the JAX drives run once per test
run in a spawned child (torch_journal_util.shared_jax)."""
import json
import os

import numpy as np
import pytest

import kubetpu.utils.devstats as jdev
import kubetpu.utils.flops as jflops
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.models.batch import batch_to_device
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.utils import devstats as ud
from kubetpu_torch.utils import flops as tflops
from kubetpu_torch.utils import trace as utrace
from kubetpu_torch.utils.devstats import DevStats
from tests import torch_journal_util as U
from tests.torch_port_util import build_jax, build_port, port_cfg
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


@pytest.fixture(autouse=True)
def _disarmed():
    ud.disarm_devstats()
    utrace.disarm_flight_recorder()
    yield
    ud.disarm_devstats()
    utrace.disarm_flight_recorder()


@pytest.fixture(scope="module")
def jax_drives(tmp_path_factory):
    return U.shared_jax(tmp_path_factory, "drives")


@pytest.fixture(scope="module")
def world():
    """One seeded term-bearing world in both packages: the JAX cluster and
    host batch, and the port's (on the CPU)."""
    jcl, jb, jcfg, _ = build_jax(17, 24, 20, terms=True)
    host, hb = build_port(17, 24, 20, terms=True)
    return jcl, jb, jcfg, host.to_device("cpu"), batch_to_device(hb, "cpu")


def _gang_world(n_nodes, n_pods, batch, infeasible=False):
    store = ClusterStore()
    for i, n in enumerate(hollow.make_nodes(n_nodes, zones=4)):
        store.add(n)
        for p in hollow.make_pods(1, prefix=f"ex-{i}-", group_labels=8):
            p.spec.node_name = n.name
            store.add(p)
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=batch, mode="gang",
        kernel_backend="pallas", chain_cycles=True, pipeline_cycles=True,
        pipeline_depth=2), device="cpu")
    for p in hollow.make_pods(n_pods, prefix="pend-", group_labels=8):
        store.add(p)
    if infeasible:
        store.add(hollow.make_pod("too-big", cpu_milli=999999))
    return store, sched


def _drain(sched):
    outs = []
    while True:
        got = sched.schedule_pending(timeout=0.0)
        if not got:
            break
        outs.extend(got)
    outs.extend(sched.flush_pipeline())
    return outs


def _placements(outs):
    return sorted((o.pod.metadata.name, o.node) for o in outs)


@pytest.fixture(scope="module")
def drains():
    """One armed pipelined gang drain (every cycle timed), its disarmed
    twin, and an armed drain at the doubled shape for the capacity gate."""
    try:
        utrace.disarm_flight_recorder()
        fr = utrace.arm_flight_recorder(capacity=32)
        ud.disarm_devstats()
        ds = ud.arm_devstats(sample_interval=1)
        store, sched = _gang_world(32, 96, 16, infeasible=True)
        armed_outs, ledger_mid = [], None
        for _ in range(4):
            armed_outs.extend(sched.schedule_pending(timeout=0.0))
            led = ds.ledger()
            if ledger_mid is None and any(
                    e["group"] == "chain" for e in led["entries"].values()):
                ledger_mid = led
        armed_outs.extend(_drain(sched))
        out = dict(doc=ds.to_dict(), ledger_mid=ledger_mid,
                   pipeline_doc=fr.to_pipeline_doc(workload="devstats"),
                   spans=[(s.name, dict(s.args)) for rec in fr.cycles()
                          for s in rec.spans()],
                   cycles=sched.cycle_count, armed_outs=armed_outs,
                   flops=sched.device_flops)
        out["ledger_a"] = ds.ledger()
        sched.close()
        utrace.disarm_flight_recorder()
        ud.disarm_devstats()
        store, sched = _gang_world(32, 96, 16, infeasible=True)
        out["disarmed_outs"] = _drain(sched)
        sched.close()
        ds2 = ud.arm_devstats(sample_interval=4)
        store, sched = _gang_world(64, 192, 32)
        _drain(sched)
        out["ledger_b"] = ds2.ledger()
        sched.close()
        return out
    finally:
        utrace.disarm_flight_recorder()
        ud.disarm_devstats()


# ---------------------------------------------------------------- peaks


def test_peaks_are_the_cards(monkeypatch):
    """67 TFLOP/s f32 (the port contracts in f32, TF32 off) and 3.35 TB/s:
    an H100 SXM's, with their overrides; device memory from the card or
    the override, and not measured on a CPU-only host."""
    monkeypatch.delenv(tflops.PEAK_TFLOPS_ENV, raising=False)
    monkeypatch.delenv(ud.PEAK_GBPS_ENV, raising=False)
    monkeypatch.delenv(ud.HBM_GIB_ENV, raising=False)
    assert tflops.peak_flops_per_s() == 67e12
    assert ud.peak_membw_bytes_per_s() == 3.35e12
    import torch
    if not torch.cuda.is_available():
        assert ud.hbm_bytes() is None
        assert ud.project({"entries": {}}, 10, 10)["fits_single_chip"] \
            is None
    monkeypatch.setenv(tflops.PEAK_TFLOPS_ENV, "989")
    monkeypatch.setenv(ud.PEAK_GBPS_ENV, "2000")
    monkeypatch.setenv(ud.HBM_GIB_ENV, "80")
    assert tflops.peak_flops_per_s() == 989e12
    assert ud.peak_membw_bytes_per_s() == 2e12
    assert ud.hbm_bytes() == 80 * 2.0 ** 30


# ---------------------------------------------------------------- FLOPs


@pytest.mark.parametrize("backend", ["pallas", "lax"])
@pytest.mark.parametrize("intra", [True, False])
def test_gang_cycle_flops_equals_jax(world, backend, intra):
    """The same number for the same cluster, batch, cfg, rounds and
    backend, with the batch's keys and with every key."""
    jcl, jb, jcfg, tcl, tb = world
    for keys in ((), (0,)):
        jc = jcfg._replace(active_topo_keys=keys)
        for rounds in (0, 1, 7):
            want = jflops.gang_cycle_flops(jcl, jb, jc, rounds,
                                           intra_batch_topology=intra,
                                           kernel_backend=backend)
            got = tflops.gang_cycle_flops(tcl, tb, port_cfg(jc), rounds,
                                          intra_batch_topology=intra,
                                          kernel_backend=backend)
            assert got == want, (keys, rounds)
            if rounds:
                assert got > 0


@pytest.mark.parametrize("name", ["gang", "gang_lax"])
def test_device_flops_equals_jax(name, jax_drives, tmp_path):
    """A churned gang drain's summed device_flops, both schedulers."""
    want = jax_drives[1][name]["device_flops"]
    got = U.journaled_drive("port", str(tmp_path / name),
                            **U.DRIVES[name])["device_flops"]
    assert got == want > 0


# ----------------------------------------------------------- the roofline


@pytest.mark.parametrize("flops,nbytes", [(1e9, 1e9), (5e12, 1e9)])
def test_roofline_equals_jax_given_same_peaks(monkeypatch, flops, nbytes):
    """The port's roofline of (flops, bytes) is the JAX package's roofline
    of a cost row with those flops and bytes: intensity, regime, bound,
    achieved rate and fraction."""
    monkeypatch.setenv("KUBETPU_PEAK_TFLOPS", "67")
    monkeypatch.setenv("KUBETPU_PEAK_GBPS", "3350")
    row = {"_schedule_gang": {"flops": flops, "bytes_accessed": nbytes,
                              "in_bytes": nbytes, "variant": "t",
                              "lowering_sha256": "x"}}
    want = jdev.roofline("run_auction", 0.01, flops=flops, costs=row)
    got = ud.roofline(0.01, flops=flops, nbytes=nbytes)
    for k in ("arithmetic_intensity", "regime", "roofline_bound_tflops",
              "achieved_tflops", "roofline_fraction", "flops_source"):
        assert got[k] == want[k], k
    assert got["bound_by"] == ("operations" if got["regime"]
                               == "compute-bound" else "bytes")
    # no operation model: a bytes-only bound
    rl = ud.roofline(0.01, nbytes=3.35e9)
    assert rl["flops_source"] == "unmodeled" and rl["bound_by"] == "bytes"
    assert rl["roofline_fraction"] == pytest.approx(0.1)
    assert ud.roofline(0.0, flops=1.0) is None
    assert ud.roofline(1.0) is None


# ------------------------------------------------------- residency ledger


def _ledgers(world):
    jcl, _jb, _jc, tcl, _tb = world
    n = int(tcl.allocatable.shape[0])
    jds, tds = jdev.DevStats(sample_interval=1), DevStats(sample_interval=1)
    jdev._stats, ud._stats = jds, tds
    try:
        jdev.register_cluster("delta-resident", "p", jcl, n,
                              meta={"resyncs": 1})
        ud.register_cluster("delta-resident", "p", tcl, n,
                            meta={"resyncs": 1})
    finally:
        jdev._stats = ud._stats = None
    return jds.ledger(), tds.ledger()


def test_ledger_tables_and_dim_tags_equal_jax(world):
    """One cluster registered by both packages: the same tables, shapes,
    dtypes, bytes, per-dim role tags and axes."""
    want, got = _ledgers(world)
    assert got == want
    ent = got["entries"]["delta-resident/p"]
    assert ent["bytes"] > 0
    assert ent["tables"]["pod_kv"][0]["dims"][0] == "pods"
    assert ent["tables"]["allocatable"][0]["dims"][0] == "nodes"


@pytest.mark.parametrize("nodes,pods,shards", [(24, 64, 1),
                                               (10000, 100000, 8),
                                               (5000, 20000, 4)])
def test_project_equals_jax(world, monkeypatch, nodes, pods, shards):
    monkeypatch.setenv("KUBETPU_HBM_GIB", "80")
    want, got = _ledgers(world)
    assert ud.project(got, nodes, pods, shards=shards) == jdev.project(
        want, nodes, pods, shards=shards)


def test_projection_identity_is_exact(drains):
    led = drains["ledger_a"]
    ent = led["entries"]["delta-resident/default-scheduler"]
    proj = ud.project(led, ent["axes"]["nodes"], ent["axes"]["pods"],
                      groups=("delta-resident",))
    assert proj["total_bytes"] == ent["bytes"]


def test_capacity_gate_within_10pct(drains):
    """The small drain's ledger projected to the doubled shape is within
    10% of the bytes the doubled drain registered."""
    ent_b = drains["ledger_b"]["entries"]["delta-resident/default-scheduler"]
    proj = ud.project(drains["ledger_a"], 64, 64 + 192,
                      groups=("delta-resident",))
    rel = abs(proj["total_bytes"] - ent_b["bytes"]) / ent_b["bytes"]
    assert rel <= 0.10, (proj["total_bytes"], ent_b["bytes"])


def test_ledger_registers_resident_and_chain(drains):
    entries = drains["ledger_a"]["entries"]
    resident = entries["delta-resident/default-scheduler"]
    assert resident["bytes"] > 0 and resident["axes"]["nodes"] == 32
    assert resident["axes"]["pods"] >= 96
    assert {"allocatable", "pod_kv"} <= set(resident["tables"])
    chain = drains["ledger_mid"]["entries"].get("chain/default-scheduler")
    assert chain is not None and chain["bytes"] > 0
    assert len(chain["meta"]["pads"]) == 2


def test_record_bytes_replaces_and_drop_group():
    ds = DevStats(sample_interval=4)
    ds.record_bytes("blobs", "", "row-a", 1000)
    ds.record_bytes("blobs", "", "row-b", 500)
    ds.record_bytes("blobs", "", "row-a", 1200)
    ent = ds.ledger()["entries"]["blobs"]
    assert ent["bytes"] == 1700 and ent["registrations"] == 3
    ds.record_bytes("chain", "p", "cluster", 4096)
    assert ds.has_group("chain")
    ds.drop_group("chain")
    assert not ds.has_group("chain")
    assert ds.ledger()["total_bytes"] == 1700
    # opaque entries pass through the projection unscaled
    assert ud.project(ds.ledger(), 99999, 999999)["total_bytes"] == 1700


def test_dim_tags_survive_node_pod_collision():
    """Node count equal to the pod bucket: the registration tags decide,
    as in the JAX package."""
    def entries():
        return {
            "pod_kv": [{"shape": [256, 512], "dtype": "bool",
                        "bytes": 256 * 512}],
            "allocatable": [{"shape": [256, 12], "dtype": "float32",
                             "bytes": 256 * 12 * 4}],
            "image_size": [{"shape": [256], "dtype": "float32",
                            "bytes": 256 * 4}]}
    axes = {"nodes": 256, "pods": 256, "kv": 512}
    got, want = entries(), entries()
    ud._tag_cluster_dims(got, axes)
    jdev._tag_cluster_dims(want, axes)
    assert got == want
    assert got["image_size"][0]["dims"][0] is None
    led = {"entries": {"delta-resident/p": {
        "group": "delta-resident", "profile": "p", "axes": axes,
        "tables": got, "bytes": 0, "meta": {}, "registrations": 1}}}
    tb = ud.project(led, 512, 100000)["per_table_bytes"]
    assert tb["delta-resident/p/pod_kv"] == int(
        256 * 512 * (131072 / 256) * 2)
    assert tb["delta-resident/p/allocatable"] == 256 * 12 * 4 * 2


# --------------------------------------------------------- program timing


def test_timed_programs_recorded(drains):
    """Every cycle timed (interval 1): the auction per cycle, the scatter
    on delta cycles, the audit on failure cycles; on the CPU by the
    call's wall time, so the reading waits for nothing."""
    doc = drains["doc"]
    progs = doc["programs"]
    ra = progs["run_auction"]
    assert ra["count"] == drains["cycles"]
    assert ra["sources"] == {"fence": ra["count"]}
    assert ra["device_time_s"] > 0
    assert progs["explain_verdicts"]["sources"].get("sync", 0) >= 1
    assert doc["fenced_cycles"] == doc["cycles_seen"] >= drains["cycles"]
    assert doc["fence_wait_s"] == 0.0
    rl = ra["roofline"]
    assert rl["flops_source"] == "analytic"
    assert 0 < rl["roofline_fraction"] < 1.0
    assert rl["achieved_tflops"] > 0
    assert progs["explain_verdicts"]["roofline"]["flops_source"] == \
        "unmodeled"
    assert drains["flops"] > 0


def test_device_fence_span_and_pipeline_block(drains):
    fences = [a for name, a in drains["spans"] if name == "device-fence"]
    assert fences and all(a["program"] == "run_auction"
                          and a["device_time_s"] > 0 for a in fences)
    dev = drains["pipeline_doc"]["device"]
    assert dev["programs"]["run_auction"]["count"] >= 1
    assert dev["ledger_bytes"] > 0
    assert dev["ledger_group_bytes"]["delta-resident"] > 0


def test_sampling_interval(tmp_path):
    """Interval 3: the first cycle after arming and every third after it
    are timed."""
    ds = ud.arm_devstats(sample_interval=3)
    store, sched = _gang_world(8, 40, 8)
    try:
        _drain(sched)
        doc = ds.to_dict()
        assert doc["cycles_seen"] >= sched.cycle_count
        assert doc["fenced_cycles"] == -(-doc["cycles_seen"] // 3)
        assert doc["programs"]["run_auction"]["count"] <= \
            doc["fenced_cycles"]
    finally:
        sched.close()


def test_armed_vs_disarmed_placements_identical(drains):
    armed = _placements(drains["armed_outs"])
    assert armed == _placements(drains["disarmed_outs"])
    assert sum(1 for _, node in armed if node) == 96


def test_disarmed_hot_path_is_noop(monkeypatch):
    """Disarmed, a pipelined gang drain with failure cycles never builds a
    DevStats, ticks a cycle, times or records a program, or walks a
    registration."""
    def boom(*a, **kw):
        raise AssertionError("hot path touched disarmed devstats")

    for name in ("__init__", "begin_cycle", "deep_active", "record_program",
                 "record_ledger", "record_bytes", "settle", "_timed"):
        monkeypatch.setattr(ud.DevStats, name, boom)
    for name in ("register_cluster", "table_entries", "pytree_nbytes"):
        monkeypatch.setattr(ud, name, boom)
    monkeypatch.setattr(ud.ProgramSample, "__init__", boom)
    store, sched = _gang_world(4, 12, 8, infeasible=True)
    try:
        outs = _drain(sched)
        assert sum(1 for o in outs if o.node) == 12
    finally:
        sched.close()


# ------------------------------------------------------------------ HTTP


def _norm(doc):
    if isinstance(doc, dict):
        return {k: _norm(v) for k, v in doc.items()}
    if isinstance(doc, str):
        return doc.replace("kubetpu_torch.", "kubetpu.")
    return doc


def test_debug_devicez_armed_equals_jax(jax_drives, tmp_path):
    """After the same armed drain: the same programs with the same counts
    and sources, the same sampling counts, the same residency ledger, the
    same ?program= filter and the same 400 for an unknown program (the
    roofline joins differ by design: the JAX package's reads XLA cost
    rows of its own lowerings)."""
    want = jax_drives[1]["endpoints"]
    got = U.endpoint_docs("port", str(tmp_path / "e"))
    (wc, w), (gc, g) = want["devicez"], got["devicez"]
    assert gc == wc == 200
    for k in ("armed", "sample_interval", "cycles_seen", "fenced_cycles",
              "ledger"):
        assert g[k] == w[k], k
    assert {p: (d["count"], d["sources"]) for p, d in g["programs"].items()} \
        == {p: (d["count"], d["sources"]) for p, d in w["programs"].items()}
    assert set(g) - {"trace"} == set(w) - {"xplane"}
    (wc, w), (gc, g) = want["devicez_program"], got["devicez_program"]
    assert gc == wc == 200 and set(g["programs"]) == {"run_auction"}
    assert got["devicez_unknown"] == want["devicez_unknown"]
    assert got["devicez_unknown"][0] == 400
    dev = got["pipeline_device"]
    assert set(dev) == set(want["pipeline_device"])
    assert dev["ledger_bytes"] == want["pipeline_device"]["ledger_bytes"]


def test_debug_devicez_disarmed_equals_jax(jax_drives, tmp_path):
    want = jax_drives[1]["endpoints"]["devicez_disarmed"]
    got = U.endpoint_docs("port", str(tmp_path / "e"))["devicez_disarmed"]
    assert got[0] == want[0] == 404
    assert _norm(got[1]) == _norm(want[1])


# ------------------------------------------------------ profiler capture


def _chrome(events):
    return {"traceEvents": events}


def test_trace_ingest_sums_kernels_per_program(tmp_path):
    """A kernel counts toward the program range that holds its launch on
    the host (joined by correlation id); a kernel launched outside any
    range counts nowhere."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "run_auction",
         "tid": 1, "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "apply_cluster_delta",
         "tid": 1, "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 110.0, "dur": 1.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 120.0, "dur": 1.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 15.0, "dur": 1.0, "args": {"correlation": 9}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 300.0, "dur": 1.0, "args": {"correlation": 10}},
        {"ph": "X", "cat": "kernel", "name": "propose", "tid": 7,
         "ts": 200.0, "dur": 30.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "admit", "tid": 7,
         "ts": 240.0, "dur": 12.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "index_copy", "tid": 7,
         "ts": 250.0, "dur": 5.0, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "stray", "tid": 7,
         "ts": 400.0, "dur": 99.0, "args": {"correlation": 10}}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_chrome(ev)))
    ds = DevStats(sample_interval=1)
    st = ds.ingest_trace(str(path))
    assert st["available"] is True and st["records"] == 2
    assert ds.program_stats("run_auction")["sum_s"] == pytest.approx(42e-6)
    assert ds.program_stats("apply_cluster_delta")["sum_s"] == \
        pytest.approx(5e-6)
    assert ds.to_dict()["trace"]["kernels"] == 4
    assert ds.fence_wait_s == 0.0


def test_trace_ingest_records_why_not(tmp_path):
    """No file, no kernel: the reason is recorded, never a silent drop;
    a CPU capture of an armed drain (utils/trace.capture_device_trace)
    holds the program ranges but no CUDA kernel."""
    ds = ud.arm_devstats(sample_interval=1)
    st = ds.ingest_trace(str(tmp_path / "missing.json"))
    assert st["available"] is False and "unreadable" in st["reason"]
    store, sched = _gang_world(4, 8, 8)
    try:
        with utrace.capture_device_trace(str(tmp_path / "cap")) as path:
            _drain(sched)
    finally:
        sched.close()
    st = ds.to_dict()["trace"]
    assert st["path"] == path and os.path.exists(path)
    assert st["available"] is False
    assert st["reason"] == "no CUDA kernel events in the capture"
    assert st["ranges"] >= 1
