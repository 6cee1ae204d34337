"""The benchmark's command on the card, briefly (skips without one):

    python -m pytest benchmark/tests/test_bench_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from kbench import registry

ROOT = os.path.dirname(registry.HERE)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
def test_command_on_the_card(cuda_card, trace):
    p = subprocess.run(
        [sys.executable, os.path.join(registry.HERE, "run.py"),
         "--workload", "k8s5k-default.fill-churn", "--seed", "3000000017",
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert 0 < out["metrics"]["k1_roofline"]["value"] <= 100


def test_command_refuses_without_a_card(monkeypatch):
    """Without a card the command exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, os.path.join(registry.HERE, "run.py"),
         "--workload", "k8s5k-default.fill-churn", "--seed", "1",
         "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
