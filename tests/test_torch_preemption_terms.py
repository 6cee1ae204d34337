"""Term-bearing preemption worlds through the port's Scheduler and
kubetpu.scheduler.Scheduler (tests/test_torch_preemption.run_both: every
cycle's outcomes, deleted victims in order, pods' nodes, nominations and
PodScheduled conditions, and queues equal), in both modes.  Bound pods
carry required anti-affinity and preemptors carry spread constraints or
anti-affinity, so every what-if takes the per-pod reprieve
(kubetpu_torch/preemption.py _whatif_reprieve; the JAX one through
tests/torch_port_util.jax_whatif_reprieve_mapped)."""
import pytest

import kubetpu_torch.preemption as tpre
from tests.test_torch_preemption import MODES, check_world
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [13, 14])
def test_term_world(mode, seed, monkeypatch):
    calls = []
    reprieve = tpre._whatif_reprieve

    def counted(*args):
        calls.append(1)
        return reprieve(*args)
    monkeypatch.setattr(tpre, "_whatif_reprieve", counted)
    check_world(seed, True, None, mode)
    assert calls, "no what-if took the per-pod reprieve"
