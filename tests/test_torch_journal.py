"""The port's cycle journal (kubetpu_torch/utils/journal.py) and its
capture seams (state/delta.py, scheduler.py) on the CPU: the record frame
read and written across the two packages, every record of a churned gang
drain (resync, delta, chain and noop records) and of a sequential drain
equal to the JAX scheduler's record of the same cycle field by field, the
records host data only, and twins of tests/test_journal.py: every
committed cycle journaled, the size cap's counted evictions, seq
resumption, the metrics, the chaos ``journal`` point's drops and skips,
armed and disarmed placements identical, the disarmed hot path a no-op,
and /debug/journal armed and disarmed against the JAX server's document.

The JAX drives run once per test run in a spawned child
(torch_journal_util.shared_jax); the journal is armed by function in
both packages, never through the shared KUBETPU_JOURNAL name."""
import os
import re

import numpy as np
import pytest
import torch

import kubetpu.models.programs as jprog
import kubetpu.utils.journal as jjournal
from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                       KubeSchedulerProfile)
from kubetpu_torch.client.store import ClusterStore
from kubetpu_torch.harness import hollow
from kubetpu_torch.models import programs as tprog
from kubetpu_torch.scheduler import Scheduler
from kubetpu_torch.utils import chaos
from kubetpu_torch.utils import journal as ujournal
from kubetpu_torch.utils.journal import (CycleJournal, JournalCorrupt,
                                         decode_record, encode_record,
                                         read_records)
from kubetpu_torch.utils.metrics import SchedulerMetrics
from tests import torch_journal_util as U
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


@pytest.fixture(autouse=True)
def _disarmed():
    """The journal and chaos are process-global: each test starts and ends
    disarmed."""
    ujournal.disarm_journal()
    chaos.disarm()
    yield
    ujournal.disarm_journal()
    chaos.disarm()


@pytest.fixture(scope="module")
def jax_drives(tmp_path_factory):
    return U.shared_jax(tmp_path_factory, "drives")


@pytest.fixture(scope="module")
def port_drives(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port-drives"))
    return root, {name: U.journaled_drive("port", os.path.join(root, name),
                                          **kw)
                  for name, kw in U.DRIVES.items()}


def _world(n_nodes=4, zones=2):
    store = ClusterStore()
    for n in hollow.make_nodes(n_nodes, zones=zones):
        store.add(n)
    return store


def _sched(store, batch=8, depth=2, mode="gang"):
    cfg = KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=batch, mode=mode,
        kernel_backend="pallas", chain_cycles=True,
        pipeline_cycles=depth > 1, pipeline_depth=depth)
    return Scheduler(store, config=cfg, device="cpu")


def _drain(sched):
    outs = []
    while True:
        got = sched.schedule_pending(timeout=0.0)
        if not got:
            break
        outs.extend(got)
    outs.extend(sched.flush_pipeline())
    return outs


# ------------------------------------------------------------- framing


def test_record_framing_roundtrip_and_corruption():
    rec = {"seq": 7, "cycle": 3, "packed": np.arange(5, dtype=np.int32)}
    blob = encode_record(rec)
    back = decode_record(blob)
    assert back["seq"] == 7
    assert np.array_equal(back["packed"], rec["packed"])
    with pytest.raises(JournalCorrupt, match="truncated"):
        decode_record(blob[: len(blob) // 2])
    with pytest.raises(JournalCorrupt, match="magic"):
        decode_record(b"XXXXX" + blob[5:])
    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF
    with pytest.raises(JournalCorrupt, match="crc"):
        decode_record(bytes(flipped))
    with pytest.raises(JournalCorrupt):
        decode_record(b"")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frame_crosses_packages(direction):
    """A frame one package encodes, the other decodes to the same record:
    the same magic, header, crc and pickle; and both reject the same
    damage."""
    rec = {"seq": 11, "cycle": 4, "input": "noop",
           "packed": np.arange(13, dtype=np.int32),
           "links": {"flight_seq": 2}}
    enc, dec = ((jjournal, ujournal) if direction == "jax_to_port"
                else (ujournal, jjournal))
    blob = enc.encode_record(rec)
    assert blob == dec.encode_record(rec)
    back = dec.decode_record(blob)
    assert back.keys() == rec.keys()
    assert np.array_equal(back["packed"], rec["packed"])
    for bad in (blob[:len(blob) // 2], b"XXXXX" + blob[5:], blob[:3]):
        with pytest.raises(dec.JournalCorrupt):
            dec.decode_record(bad)
        with pytest.raises(enc.JournalCorrupt):
            enc.decode_record(bad)


def test_config_digest_equals_jax():
    """Equal configurations digest equal in both packages."""
    for mode, backend, kw in (("gang", "pallas", {}),
                              ("sequential", "lax",
                               dict(percentage_of_nodes_to_score=50,
                                    active_topo_keys=(0, 2))),
                              ("gang", "lax",
                               dict(hostname_topokey=3,
                                    plugin_args=(("NodeLabel", (1, 2)),)))):
        want = jjournal.config_digest(mode, "p", jprog.ProgramConfig(**kw),
                                      2.0, backend)
        got = ujournal.config_digest(mode, "p", tprog.ProgramConfig(**kw),
                                     2.0, backend)
        assert got == want


# ------------------------------------------------ records against the JAX


@pytest.mark.parametrize("name", sorted(U.DRIVES))
def test_records_equal_jax(name, jax_drives, port_drives):
    """Every record of the drain equals the JAX scheduler's record of the
    same cycle: seq, cycle, input kind, the payload's arrays (the resync
    mirror, the delta tables and terms, the chain's pads), the host batch,
    cfg, masks, rng counter, start index, kernel backend, the packed
    vector, placements, verdict summary and config digest."""
    jroot, jres = jax_drives
    proot, pres = port_drives
    assert pres[name]["views"] == jres[name]["views"]
    want = U.journal_views(os.path.join(jroot, name), "jax")
    got = U.journal_views(os.path.join(proot, name), "port")
    assert len(got) == len(want) == pres[name]["cycles"]
    for (ws, w), (gs, g) in zip(want, got):
        assert ws == gs
        U.assert_same_view(w, g, f"{name} seq {ws}")
    kinds = {v["input"] for _s, v in got}
    if name == "seq":
        assert {"resync", "delta", "noop"} <= kinds
    elif name == "seq_sampled":
        assert any(v["start_index"] for _s, v in got)
    else:
        assert kinds == set(ujournal.INPUT_KINDS)


@pytest.mark.parametrize("name", ["gang", "seq"])
def test_records_hold_host_data_only(name, port_drives):
    """A record pickles no torch tensor (a card's CUDA tensor would not
    load on a CPU-only machine): every leaf is numpy or plain Python."""
    proot, _ = port_drives
    for _seq, rec, why in read_records(os.path.join(proot, name)):
        assert why is None
        leaves = U.flat({k: v for k, v in rec.items()
                         if k != "input_payload"}, raw=True)
        leaves.update(U.flat(U._payload(rec), raw=True))
        for path, v in leaves.items():
            assert not isinstance(v, torch.Tensor), path
            assert v is None or isinstance(
                v, (np.ndarray, bool, int, float, str)), (path, type(v))


def test_every_committed_cycle_journaled(tmp_path):
    d = str(tmp_path / "journal")
    jr = ujournal.arm_journal(d)
    store = _world()
    sched = _sched(store, batch=8, depth=2)
    try:
        for p in hollow.make_pods(32, group_labels=2):
            store.add(p)
        outs = _drain(sched)
        assert sum(1 for o in outs if o.node) == 32
        entries = list(read_records(d))
        assert all(skip is None for _s, _r, skip in entries)
        assert len(entries) == sched.cycle_count
        seqs = [s for s, _r, _k in entries]
        assert seqs == sorted(seqs)
        first = entries[0][1]
        assert first["input"] == "resync"
        assert first["node_names"] is not None
        for _s, rec, _k in entries:
            assert rec["input"] in ujournal.INPUT_KINDS
            assert rec["mode"] == "gang"
            assert rec["packed"].dtype == np.int32
            assert len(rec["pods"]) == (rec["verdicts"]["scheduled"]
                                        + rec["verdicts"]["failed"])
            assert rec["links"]["decision_cycle"] == rec["cycle"]
            assert rec["links"]["pipeline_depth"] == 2
            assert rec["config_digest"] == first["config_digest"]
        st = jr.status()
        assert st["records"] == len(entries)
        assert st["dropped_total"] == 0 and st["bytes"] > 0
    finally:
        sched.close()


@pytest.mark.parametrize("mode,depth", [("gang", 4), ("sequential", 1)])
def test_armed_vs_disarmed_placement_parity(tmp_path, mode, depth):
    """Arming the journal changes no placement: it only observes."""
    def run(arm):
        ujournal.disarm_journal()
        if arm:
            ujournal.arm_journal(str(tmp_path / "parity"))
        try:
            store = _world(n_nodes=3)
            sched = _sched(store, batch=4, depth=depth, mode=mode)
            try:
                for p in hollow.make_pods(24, group_labels=3):
                    store.add(p)
                outs = _drain(sched)
                return sorted((o.pod.metadata.name, o.node) for o in outs)
            finally:
                sched.close()
        finally:
            ujournal.disarm_journal()

    assert run(True) == run(False)


def test_disarmed_hot_path_is_noop(monkeypatch):
    """Journal disarmed: a pipelined drain never constructs a journal,
    reserves a seq, builds a record or pickles a capture."""
    def boom(*a, **kw):
        raise AssertionError("hot path touched the disarmed journal")

    monkeypatch.setattr(ujournal.CycleJournal, "__init__", boom)
    monkeypatch.setattr(ujournal.CycleJournal, "append", boom)
    monkeypatch.setattr(ujournal.CycleJournal, "next_seq", boom)
    monkeypatch.setattr(Scheduler, "_journal_append", boom)
    import kubetpu_torch.state.delta as tdelta
    monkeypatch.setattr(tdelta.pickle, "dumps", boom)
    store = _world()
    sched = _sched(store, batch=8, depth=4)
    try:
        for p in hollow.make_pods(24, group_labels=2):
            store.add(p)
        e = hollow.make_pod("ext")
        e.spec.node_name = "node-0"
        store.add(e)
        outs = _drain(sched)
        assert sum(1 for o in outs if o.node) == 24
        for delta in sched._delta.values():
            assert delta.capture is None
    finally:
        sched.close()


# ------------------------------------------------------------ size cap


def test_size_cap_eviction_counted_never_silent(tmp_path):
    jr = ujournal.arm_journal(str(tmp_path / "cap"), max_bytes=30_000)
    store = _world()
    sched = _sched(store, batch=4, depth=2)
    try:
        for p in hollow.make_pods(32, group_labels=2):
            store.add(p)
        _drain(sched)
        records, dropped = jr.counters()
        assert records == sched.cycle_count
        assert dropped > 0, "size cap never evicted"
        assert jr.disk_bytes() <= 30_000
        entries = list(read_records(jr.dir))
        assert len(entries) == records - dropped
        assert entries[0][0] > 1
        assert jr.status()["dropped_total"] == dropped
    finally:
        sched.close()


def test_malformed_max_bytes_env_falls_back(tmp_path, monkeypatch):
    monkeypatch.setenv(ujournal.MAX_BYTES_ENV, "256MiB")
    j = CycleJournal(str(tmp_path / "junk-env"))
    assert j.max_bytes == ujournal.DEFAULT_MAX_BYTES


def test_restarted_journal_resumes_seq(tmp_path):
    d = str(tmp_path / "resume")
    j1 = CycleJournal(d)
    s1 = j1.next_seq()
    assert j1.append({"seq": s1, "cycle": 1, "links": {}})
    j2 = CycleJournal(d)
    assert j2.next_seq() == s1 + 1
    assert j2.counters() == (0, 0)
    assert j2.seqs() == [s1]


def test_journal_metrics_synced(tmp_path):
    jr = ujournal.arm_journal(str(tmp_path / "metrics"))
    metrics = SchedulerMetrics()
    store = _world()
    sched = _sched(store, batch=8, depth=2)
    sched.metrics = metrics
    try:
        for p in hollow.make_pods(16, group_labels=2):
            store.add(p)
        _drain(sched)
        text = metrics.expose_text()
        records, _ = jr.counters()
        assert records == sched.cycle_count
        assert re.search(r"^scheduler_journal_records_total %s(\.0)?$"
                         % records, text, re.M)
        assert re.search(r"^scheduler_journal_bytes %s(\.0)?$"
                         % jr.disk_bytes(), text, re.M)
        # a counter never incremented renders its HELP and TYPE only
        assert "# TYPE scheduler_journal_dropped_total counter" in text
    finally:
        sched.close()


# ------------------------------------------------------ chaos "journal"


def test_chaos_write_error_degrades_to_drop(tmp_path):
    """An injected write fault drops the record and counts it; the cycle
    commits normally."""
    jr = ujournal.arm_journal(str(tmp_path / "err"))
    chaos.arm(chaos.ChaosRegistry(seed=3).arm_point("journal", "error",
                                                    n=2))
    store = _world()
    sched = _sched(store, batch=8, depth=2)
    try:
        for p in hollow.make_pods(24, group_labels=2):
            store.add(p)
        outs = _drain(sched)
        assert sum(1 for o in outs if o.node) == 24
        records, dropped = jr.counters()
        assert dropped == 2
        assert records == sched.cycle_count - 2
        assert len(list(read_records(jr.dir))) == records
        assert chaos.active().counts()["journal"] == 2
    finally:
        sched.close()


@pytest.mark.parametrize("mode,reason", [("truncate", "truncated"),
                                         ("corrupt", "crc mismatch")])
def test_chaos_damage_skipped_at_read(tmp_path, mode, reason):
    """journal:truncate and journal:corrupt land a damaged frame on disk
    (armed from the JAX package's spec grammar); the reader yields one
    per-record skip reason and decodes the rest."""
    d = str(tmp_path / mode)
    ujournal.arm_journal(d)
    chaos.arm(chaos.parse_spec(f"seed=1,journal:{mode}:n=1"))
    store = _world()
    sched = _sched(store, batch=8, depth=1)
    try:
        for p in hollow.make_pods(24, group_labels=2):
            store.add(p)
        _drain(sched)
    finally:
        sched.close()
    entries = list(read_records(d))
    skips = [why for _s, _r, why in entries if why is not None]
    assert len(skips) == 1 and reason in skips[0]
    assert sum(1 for _s, r, _w in entries if r is not None) \
        == len(entries) - 1 == sched.cycle_count - 1


# ----------------------------------------------------------- endpoints


def _norm(doc):
    """A document with the package's own names and paths made neutral."""
    if isinstance(doc, dict):
        return {k: _norm(v) for k, v in doc.items()
                if k not in ("dir", "bytes", "replay_hint")}
    if isinstance(doc, str):
        return doc.replace("kubetpu_torch.", "kubetpu.")
    return doc


def test_debug_journal_armed_equals_jax(jax_drives, tmp_path):
    """/debug/journal after the same armed drain: the JAX server's
    document (records, totals, drops, seq and cycle span, the flight and
    decision linkage rates), the SLO exemplars carrying journal ids, and
    the pipeline doc's journal block."""
    want = jax_drives[1]["endpoints"]
    got = U.endpoint_docs("port", str(tmp_path / "endpoints"))
    assert got["cycles"] == want["cycles"]
    code, doc = got["journal"]
    assert code == want["journal"][0] == 200
    assert _norm(doc) == _norm(want["journal"][1])
    assert doc["records"] == got["cycles"] and doc["bytes"] > 0
    assert doc["flight_link_rate"] == 1.0
    assert doc["replay_hint"] == ("python -m kubetpu_torch.kubereplay "
                                  + doc["dir"])
    assert got["exemplar_journal_seqs"] == want["exemplar_journal_seqs"]
    assert all(s > 0 for s in got["exemplar_journal_seqs"])
    assert _norm(got["pipeline_journal"]) == _norm(want["pipeline_journal"])


def test_debug_journal_disarmed_equals_jax(jax_drives, tmp_path):
    want = jax_drives[1]["endpoints"]["journal_disarmed"]
    got = U.endpoint_docs("port", str(tmp_path / "e"))["journal_disarmed"]
    assert got[0] == want[0] == 200
    assert _norm(got[1]) == _norm(want[1])
    assert got[1]["armed"] is False and "KUBETPU_JOURNAL" in got[1]["hint"]
