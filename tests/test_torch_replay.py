"""The port's journal replayer (kubetpu_torch/kubereplay) on the CPU: its
report of each journal equals tools.kubereplay's report of the JAX
scheduler's journal of the same drive: the bit-match of every cycle
(gang under pallas and lax, sequential, two interleaved profiles), the
first divergent cycle with its per-pod diff (a tampered record), the
truncated, corrupt and missing records skipped with ``broken-lineage``
until the next anchor, a window warmed up from its anchor, and the
counterfactuals (a score weight that moves pods, an unknown plugin,
kernelBackend, and pipelineDepth, which must move none); and the CLI's
exit codes, the CUDA default that raises without a card, mesh records
skipped, and a journal replayed on the CPU by the same report whether
it was written by a pipelined or a synchronous drain.

The JAX drives and replays run once per test run in a spawned child
(torch_journal_util.shared_jax)."""
import json
import os
import re

import pytest
import torch

from kubetpu_torch.kubereplay import replay_journal
from kubetpu_torch.kubereplay.__main__ import main as kubereplay_main
from kubetpu_torch.kubereplay.__main__ import parse_counterfactual
from kubetpu_torch.utils import journal as ujournal
from kubetpu_torch.utils.journal import (decode_record, encode_record,
                                         read_records)
from tests import torch_journal_util as U
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


@pytest.fixture(scope="module")
def jax_drives(tmp_path_factory):
    return U.shared_jax(tmp_path_factory, "drives")


@pytest.fixture(scope="module")
def jax_replays(tmp_path_factory, jax_drives):
    return U.shared_jax(tmp_path_factory, "replays", jax_drives[0])[1]


@pytest.fixture(scope="module")
def port_drives(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port-drives"))
    return root, U.all_drives("port", root)


@pytest.fixture(scope="module")
def port_replays(tmp_path_factory, port_drives):
    return U.all_replays("port", str(tmp_path_factory.mktemp("port-rep")),
                         port_drives[0])


def _norm(report):
    """A report with the frame sizes in truncation reasons left out (a
    pickle names its package, so the two packages' frames differ in
    length)."""
    out = dict(report)
    out["skipped"] = [
        {**s, "reason": re.sub(r"\(\d+ of \d+ bytes\)", "(n of m bytes)",
                               s["reason"])} for s in report["skipped"]]
    return out


@pytest.mark.parametrize("name", sorted(U.REPLAYS))
def test_replay_report_equals_jax(name, jax_replays, port_replays):
    """One replay of one journal, both replayers: every count, skip and
    reason, divergence with its per-pod diff, digest and counterfactual
    block equal."""
    assert _norm(port_replays[name]) == _norm(jax_replays[name])


def test_replays_bit_match(port_replays, port_drives):
    """Every undamaged journal replays bit for bit, every cycle."""
    for name in ("gang", "gang_lax", "seq", "seq_sampled", "two_profiles"):
        rep = port_replays[name]
        assert rep["bit_match"] is True, name
        assert rep["skipped"] == [] and rep["divergences"] == []
        assert rep["replayed"] == rep["matched"] == rep["records"] >= 3
    assert len(port_replays["gang"]["config_digests"]) == 1
    assert len(port_replays["two_profiles"]["config_digests"]) == 2


def test_damage_skips_until_the_next_anchor(port_replays, port_drives):
    """A truncated, corrupt or missing record breaks the lineage only
    until the next resync anchor, and the rest still bit-matches."""
    kinds = [rec["input"] for _s, rec, _w in
             read_records(os.path.join(port_drives[0], "gang"))]
    for name in ("truncate", "corrupt", "gap"):
        rep = port_replays[name]
        assert rep["bit_match"] is True, name
        skipped = [s["seq"] for s in rep["skipped"]]
        first = skipped[0]
        anchor = next(i + 1 for i, k in enumerate(kinds)
                      if i + 1 > first and k == "resync")
        assert skipped == [s for s in range(first, anchor)
                           if name != "gap" or s != 2], (name, skipped)
        assert all("broken-lineage" in s["reason"]
                   for s in rep["skipped"][name != "gap":])
        assert rep["matched"] == rep["replayed"] == \
            rep["considered"] - len(skipped)


def test_divergence_attributed_to_first_cycle(port_replays):
    """A tampered record is the first divergent cycle, with the pod that
    moved named in its diff."""
    for name, seq in (("tamper", 6), ("seq_tamper", 6)):
        d = port_replays[name]["first_divergence"]
        assert d is not None and d["seq"] == seq, name
        assert len(d["pod_diff"]) == 1
        assert d["pod_diff"][0]["recorded_node"] != \
            d["pod_diff"][0]["replayed_node"]
    # keep_going replays past it, and the rest still matches
    rep = port_replays["tamper"]
    assert rep["replayed"] == rep["records"]
    assert rep["matched"] == rep["replayed"] - 1


def test_counterfactuals(port_replays):
    """A weight that moves pods reports divergence and never gates;
    pipelineDepth and the recorded backend's twin move nothing; an
    unknown plugin skips each record."""
    cf = port_replays["cf_weight"]["counterfactual"]
    assert cf["divergent_cycles"] > 0 and cf["diverged_pods"] > 0
    assert port_replays["cf_weight"]["bit_match"] is None
    for name in ("cf_depth", "cf_backend"):
        cf = port_replays[name]["counterfactual"]
        assert cf["divergent_cycles"] == cf["diverged_pods"] == 0, name
        assert cf["utilization"]["delta"]["spread_std"] == 0.0
    rep = port_replays["cf_unknown"]
    assert rep["replayed"] == 0
    assert "NoSuchPlugin" in rep["skipped"][0]["reason"]


def test_window_warms_up_from_its_anchor(port_replays):
    rep = port_replays["window"]
    assert rep["window"] == [7, 10]
    assert rep["considered"] == rep["replayed"] == rep["matched"] == 4


def test_cli_exit_codes(port_drives, tmp_path, capsys):
    """0 for a held bit-match and for a counterfactual, 2 for a
    divergence, 1 for nothing replayable; --json prints the report."""
    d = os.path.join(port_drives[0], "gang")
    assert kubereplay_main([d, "--device", "cpu"]) == 0
    assert "bit-match oracle HELD" in capsys.readouterr().out
    assert kubereplay_main([d, "--device", "cpu", "--counterfactual",
                            "pipelineDepth=4"]) == 0
    capsys.readouterr()
    assert kubereplay_main([d, "--device", "cpu", "--json",
                            "--window", "2:3"]) == 0
    assert json.loads(capsys.readouterr().out)["considered"] == 2
    bad = U.derive(d, str(tmp_path / "bad"), "tamper", "port")
    assert kubereplay_main([bad, "--device", "cpu"]) == 2
    assert "FIRST DIVERGENCE at seq 6" in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    assert kubereplay_main([str(empty), "--device", "cpu"]) == 1
    assert parse_counterfactual(["scoreWeight:ImageLocality=3",
                                 "kernelBackend=lax"]) == {
        "score_weights": {"ImageLocality": 3}, "kernel_backend": "lax"}
    with pytest.raises(SystemExit):
        parse_counterfactual(["kernelBackend=tpu"])


def test_cli_json_report(port_drives, capsys):
    d = os.path.join(port_drives[0], "seq")
    assert kubereplay_main([d, "--device", "cpu", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["bit_match"] is True and doc["dir"] == d


def test_default_device_is_cuda(port_drives):
    """Without a card and without device="cpu" the replay raises rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        replay_journal(os.path.join(port_drives[0], "gang"))


def test_mesh_records_skip(port_drives, tmp_path):
    """A record of a mesh profile skips with unsupported-mesh, as the JAX
    replayer skips it, and breaks its lineage until the next anchor."""
    src = os.path.join(port_drives[0], "gang")
    dst = U.derive(src, str(tmp_path / "m"), "gap", "port")
    names = sorted(os.listdir(dst))
    path = os.path.join(dst, names[0])
    with open(path, "rb") as f:
        rec = decode_record(f.read())
    rec["mesh"] = True
    with open(path, "wb") as f:
        f.write(encode_record(rec))
    rep = replay_journal(dst, device="cpu")
    assert rep["skipped"][0] == {"seq": 1, "reason": "unsupported-mesh"}
    assert rep["bit_match"] is True


def test_pipelined_drain_replays_bit_identical(tmp_path):
    """A depth-4 pipelined gang drain with node churn (chained segments,
    delta cycles, resync anchors, cycles parked in the ring) replays bit
    for bit."""
    import copy
    from kubetpu_torch.apis.config import (KubeSchedulerConfiguration,
                                           KubeSchedulerProfile)
    from kubetpu_torch.client.store import ClusterStore
    from kubetpu_torch.harness import hollow
    from kubetpu_torch.scheduler import Scheduler
    d = str(tmp_path / "journal")
    ujournal.disarm_journal()
    ujournal.arm_journal(d)
    store = ClusterStore()
    nodes = [hollow.make_node(f"rp-node-{i}", zone=f"zone-{i % 3}",
                              cpu_milli=8000 if i % 2 else 3000)
             for i in range(12)]
    for n in nodes:
        store.add(n)
    sched = Scheduler(store, config=KubeSchedulerConfiguration(
        profiles=[KubeSchedulerProfile()], batch_size=8, mode="gang",
        kernel_backend="pallas", chain_cycles=True, pipeline_cycles=True,
        pipeline_depth=4), device="cpu")
    try:
        for p in hollow.make_pods(160, prefix="rp-", group_labels=4,
                                  cpu_milli=150):
            store.add(p)
        i = 0
        while sched.schedule_pending(timeout=0.0):
            i += 1
            if i % 5 == 0:
                n = copy.deepcopy(nodes[i % len(nodes)])
                n.metadata.labels["flap"] = f"v{i}"
                store.update(n)
        sched.flush_pipeline()
    finally:
        sched.close()
        ujournal.disarm_journal()
    recs = [rec for _s, rec, _w in read_records(d)]
    assert len(recs) == sched.cycle_count >= 20
    assert {"resync", "delta", "chain"} <= {r["input"] for r in recs}
    assert any(r["links"]["ring_slot"] > 0 for r in recs)
    rep = replay_journal(d, device="cpu")
    assert rep["bit_match"] is True
    assert rep["matched"] == len(recs) and rep["skipped"] == []
