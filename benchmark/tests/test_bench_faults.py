"""The rest of a run with the timed path broken underneath: the gang
auction's answer altered where it is produced.  Each fault must turn
``correct`` false."""

import os

import pytest
import torch

from kbench import driver, registry


def _broken(kind, orig):
    def run_auction(cluster, batch, cfg, rng, **kw):
        res = orig(cluster, batch, cfg, rng, **kw)
        chosen = res.chosen.clone()
        n = int(cluster.node_valid.sum())
        if kind == "unchanged":        # the step leaves the state as it was
            chosen[:] = -1
        elif kind == "half":           # half of the batch left out
            chosen[1::2] = -1
        elif kind == "altered":        # each answer moved to the next node
            chosen = torch.where(chosen >= 0, (chosen + 1) % n, chosen)
        packed = res.packed.clone()
        packed[:chosen.shape[0]] = chosen
        return res._replace(chosen=chosen, packed=packed)
    return run_auction


@pytest.mark.parametrize("cell", ("k8s5k-default.fill-churn",
                                  "k8s5k-default.spread-churn",
                                  "k8s5k-autoscaler.fill-churn"))
@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
def test_fault_is_not_correct(cell, kind, monkeypatch):
    from kubetpu_torch import scheduler as S
    monkeypatch.setattr(S, "run_auction", _broken(kind, S.run_auction))
    bench = registry.Benchmark(os.path.dirname(registry.HERE))
    out = driver.run_cell(bench, cell, 11, 0.5, False,
                          "cpu", 0.0, shrink=dict(nodes=48, batch_size=24))
    assert not out["correct"], out["checks"]
