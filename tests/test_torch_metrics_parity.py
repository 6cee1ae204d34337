"""The port's metrics scrape against the JAX scheduler's after the same
drain, on the CPU: the framework's per-point durations
(``framework_extension_point_duration_seconds{extension_point,status}``
counts) and the permit waits (``permit_wait_duration_seconds{result}``
counts) on kubetpu_torch/harness/plugin_worlds.py's world, whose profile
runs a recording plugin at every extension point with Permit pairs and
injected Reserve, Permit and PreBind failures, binding on the binder
pool; and the preemption series (``preemption_attempts_total``,
``preemption_victims``) on a preemption world in both modes.  The
preemption drain with Events and injected bind faults is in
tests/test_torch_events.py, the verify-resync recovery in
tests/test_torch_chaos.py.  The JAX drains run in a spawned child
(torch_port_util.jax_process)."""
import pytest

from kubetpu_torch.harness import plugin_worlds as PW
from kubetpu_torch.harness import preempt_worlds as PRW
from tests.torch_port_util import (drive, jax_process, metrics_scrape,
                                   packages)
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

CHILD_TIMEOUT = 600.0
FAIL_AT = {"p6": "Reserve", "p9": "Permit", "p13": "PreBind"}


def _modules(name):
    if name == "jax":
        from kubetpu.framework import interface as fw
        from kubetpu.plugins import intree
        from kubetpu.utils.metrics import SchedulerMetrics
    else:
        from kubetpu_torch.framework import interface as fw
        from kubetpu_torch.plugins import intree
        from kubetpu_torch.utils.metrics import SchedulerMetrics
    jpkg, tpkg = packages()
    return (jpkg if name == "jax" else tpkg), fw, intree, SchedulerMetrics


def points_drive(name, seed, mode, backend):
    """The plugin world (24 nodes x 40 pods, batches of 16) through
    package ``name``'s scheduler with a metrics registry: the scrape."""
    pkg, fw, intree, SchedulerMetrics = _modules(name)
    reg = dict(intree.new_in_tree_registry())
    reg[PW.POINTS] = PW.points_plugin(fw, seed, [], FAIL_AT)
    metrics = SchedulerMetrics()

    def scenario(A, H, store, sched):
        nodes, existing, pending, services = PW.world(A, seed, 24, 40)
        PW.populate(store, nodes, existing, services)
        for p in pending:
            store.add(p)
        yield
    drive(pkg, scenario, max_cycles=3, mode=mode, backend=backend,
          batch=16, profile=PW.profile(pkg.config, False), registry=reg,
          async_binding=True, metrics=metrics)
    return metrics_scrape(metrics)


def preempt_drive(name, seed, mode):
    """A seeded preemption world (20 nodes, 12 preemptors, parked
    nominations) through package ``name``'s scheduler: the scrape."""
    pkg, _fw, _intree, SchedulerMetrics = _modules(name)
    metrics = SchedulerMetrics()

    def scenario(A, H, store, sched):
        w = PRW.world(A, seed, 20, 12)
        PRW.populate(store, w)
        for p, nn in w.parked:
            sched.queue.add_nominated_pod(p, nn)
        for p in w.pending:
            store.add(p)
        yield
    drive(pkg, scenario, mode=mode, batch=8, metrics=metrics)
    return metrics_scrape(metrics)


def _in_child(fn, *args):
    import jax
    try:
        return fn("jax", *args)
    finally:
        jax.clear_caches()


@pytest.fixture(scope="module")
def jax_proc():
    with jax_process() as ex:
        yield ex


@pytest.mark.parametrize("seed,mode,backend", [
    (0, "gang", "pallas"), (2, "sequential", "lax")])
def test_point_durations_and_permit_waits_match_jax(seed, mode, backend,
                                                    jax_proc):
    """Per (extension point, status) the same number of observations,
    per result the same number of permit waits."""
    fut = jax_proc.submit(_in_child, points_drive, seed, mode, backend)
    got = points_drive("port", seed, mode, backend)
    want = fut.result(timeout=CHILD_TIMEOUT)
    points = {k for k in got
              if k.startswith("scheduler_framework_extension_point")}
    for point, status in (("PreFilter", "Success"), ("Reserve", "Error"),
                          ("Permit", "Wait"), ("Permit", "Unschedulable"),
                          ("PreBind", "Error"), ("Bind", "Success"),
                          ("PostBind", "Success")):
        key = ('scheduler_framework_extension_point_duration_seconds_count'
               '{extension_point="%s",status="%s"}' % (point, status))
        assert key in points, key
    assert got['scheduler_permit_wait_duration_seconds_count'
               '{result="allowed"}'] > 0
    assert got == want


@pytest.mark.parametrize("mode", ["sequential", "gang"])
def test_preemption_metrics_match_jax(mode, jax_proc):
    """preemption_attempts_total and the preemption_victims histogram
    (buckets, count and sum) equal the JAX scheduler's."""
    fut = jax_proc.submit(_in_child, preempt_drive, 12, mode)
    got = preempt_drive("port", 12, mode)
    want = fut.result(timeout=CHILD_TIMEOUT)
    assert got["scheduler_preemption_attempts_total"] > 0
    assert got["scheduler_preemption_victims_count"] > 0
    assert got == want
