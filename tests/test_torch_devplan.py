"""The port's capacity planner (python -m kubetpu_torch.devplan) against
tools/devplan.py: one seeded world registered into each package's
devstats ledger, each ledger saved as a /debug/devicez document, and the
two planners run over them at the same shapes and the same card
capacity (KUBETPU_HBM_GIB) print the same projection and exit with the
same status: 0 fits, 2 does not, 1 unusable input.  The port's planner
also refuses to guess a capacity: with no card and no KUBETPU_HBM_GIB
its input is unusable."""
import json

import pytest

import kubetpu.utils.devstats as jdev
import tools.devplan as jplan
from kubetpu_torch import devplan as tplan
from kubetpu_torch.models.batch import batch_to_device
from kubetpu_torch.utils import devstats as tdev
from tests.torch_port_util import build_jax, build_port
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    """The same seeded cluster registered by both packages' DevStats,
    saved as devicez documents: {"jax": path, "torch": path}."""
    jcl, _jb, _jc, _ = build_jax(17, 24, 20, terms=True)
    host, hb = build_port(17, 24, 20, terms=True)
    tcl = host.to_device("cpu")
    batch_to_device(hb, "cpu")
    n = int(tcl.allocatable.shape[0])
    jds = jdev.DevStats(sample_interval=1)
    tds = tdev.DevStats(sample_interval=1)
    jdev._stats, tdev._stats = jds, tds
    try:
        jdev.register_cluster("delta-resident", "p", jcl, n)
        tdev.register_cluster("delta-resident", "p", tcl, n)
    finally:
        jdev._stats = tdev._stats = None
    root = tmp_path_factory.mktemp("devplan")
    out = {}
    for name, ds in (("jax", jds), ("torch", tds)):
        path = root / (name + "-devicez.json")
        path.write_text(json.dumps({"ledger": ds.ledger()}))
        out[name] = str(path)
    return out


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("gib,nodes,pods,shards,status", [
    ("80", 24, 64, 1, 0),
    ("80", 10000, 100000, 8, 0),
    ("0.001", 5000, 20000, 4, 2),
    ("0.00001", 24, 64, 1, 2),
])
def test_projection_and_status_equal_jax(ledgers, capsys, monkeypatch, gib,
                                         nodes, pods, shards, status):
    monkeypatch.setenv("KUBETPU_HBM_GIB", gib)
    args = ["--nodes", str(nodes), "--pods", str(pods), "--shards",
            str(shards)]
    jrc, jout = _run(jplan.main, [ledgers["jax"], "--json"] + args, capsys)
    trc, tout = _run(tplan.main, [ledgers["torch"], "--json"] + args,
                     capsys)
    assert trc == jrc == status
    want, got = json.loads(jout), json.loads(tout)
    assert got == want
    assert got["total_bytes"] > 0
    # the human-readable report exits the same way
    assert _run(tplan.main, [ledgers["torch"]] + args, capsys)[0] == status


def test_ledger_discovery_equals_jax(ledgers):
    raw = json.load(open(ledgers["torch"]))["ledger"]
    for doc in (raw, {"ledger": raw}, {"detail": {"device_ledger": raw}},
                {"headline": {}, "detail": {"device_ledger": raw}},
                {"nope": 1}):
        assert tplan.find_ledger(doc) == jplan.find_ledger(doc)
    assert tplan.find_ledger({"ledger": raw}) is raw


def test_unusable_input_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("KUBETPU_HBM_GIB", "80")
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    garbled = tmp_path / "garbled.json"
    garbled.write_text("{not json")
    for path in (bad, garbled, tmp_path / "missing.json"):
        argv = [str(path), "--nodes", "1", "--pods", "1"]
        assert _run(jplan.main, argv, capsys)[0] == 1
        assert _run(tplan.main, argv, capsys)[0] == 1


def test_no_capacity_is_unusable(ledgers, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("KUBETPU_HBM_GIB", raising=False)
    rc = tplan.main([ledgers["torch"], "--nodes", "24", "--pods", "64"])
    assert rc == 1
    assert "KUBETPU_HBM_GIB" in capsys.readouterr().err
