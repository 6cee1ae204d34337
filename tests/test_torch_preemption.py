"""The port's Scheduler against kubetpu.scheduler.Scheduler on the failure
path: the PostFilter preemption wave (kubetpu_torch/preemption.py) and the
nominated-pods overlay, in both modes (the sequential replay and gang
under "pallas").

Each scenario is built twice, in both packages' API types, and driven
through both schedulers cycle by cycle (tests/torch_port_util.drive: the
queues run on a fake clock that passes every backoff between cycles).
After every cycle the test compares the cycle's outcomes, the victims
deleted in it in deletion order, every pod's node, nomination and
PodScheduled condition, and the queue's contents (active, backoff,
unschedulable, the nominator) — all equal.

Here: seeded kubetpu_torch/harness/preempt_worlds.py worlds without
terms (the batched wave; binding PDBs and parked nominations, one world
under a cap of one candidate), disable_preemption, and
pick_one_node_for_preemption.  The term-bearing worlds (the per-pod
reprieve) are tests/test_torch_preemption_terms.py; the scenarios of
tests/test_preemption.py, tests/test_preemption_wave.py and
tests/test_nominated_topology.py are tests/test_torch_preemption_scenarios.py
(three files, so each runs in a few minutes).  The JAX reprieve runs
through tests/torch_port_util.jax_whatif_reprieve_mapped (its vmap cannot
run on XLA:CPU)."""
import pytest

import kubetpu.preemption as jpre
import kubetpu_torch.preemption as tpre
from kubetpu_torch.harness import preempt_worlds as PW
from tests.torch_port_util import drive, packages
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

MODES = ["sequential", "gang"]


def run_both(scenario, mode, **kw):
    """The scenario through both schedulers; every cycle's view equal.
    Returns the port's views and scheduler."""
    jp, tp = packages()
    want, _ = drive(jp, scenario, mode=mode, **kw)
    got, sched = drive(tp, scenario, mode=mode, **kw)
    assert len(got) == len(want), (len(got), len(want))
    for c, (w, g) in enumerate(zip(want, got)):
        for field in w:
            assert g[field] == w[field], (
                "cycle %d: %s differs\n jax  %s\n port %s"
                % (c, field, w[field], g[field]))
    assert sched.preempt_wave_failures == 0
    return got, sched


def _deleted(views):
    return [d for v in views for d in v["deleted"]]


# ---------------------------------------------------------------------------
# seeded worlds


def world_scenario(seed, n_nodes, n_pending, terms, max_candidates=None,
                   max_wave_elements=None):
    def scenario(A, H, store, sched):
        w = PW.world(A, seed, n_nodes, n_pending, terms=terms)
        PW.populate(store, w)
        for p, nn in w.parked:
            sched.queue.add_nominated_pod(p, nn)
        if max_candidates is not None:
            sched.preemptor.max_candidates = max_candidates
        if max_wave_elements is not None:
            sched.preemptor.max_wave_elements = max_wave_elements
        for p in w.pending:
            store.add(p)
        yield
    return scenario


def check_world(seed, terms, cap, mode):
    """A seeded world through both schedulers; it evicted, nominated and
    ran waves."""
    views, sched = run_both(world_scenario(seed, 20, 12, terms, cap), mode)
    assert _deleted(views)
    assert any(v["nominated"] for v in views)
    assert sum(s["waves"] for s in sched.preempt_stats) > 0
    return sched


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,terms,cap", [(11, False, None),
                                            (12, False, 1)])
def test_seeded_world(mode, seed, terms, cap):
    """Term-free worlds: the batched wave (one with a cap of one
    candidate); the term-bearing ones are tests/test_torch_preemption_terms.py."""
    check_world(seed, terms, cap, mode)


@pytest.mark.parametrize("mode", MODES)
def test_wave_split(mode, monkeypatch):
    """A wave whose [B, C, K, R] element count passes max_wave_elements
    splits along the pod axis (_WaveUnion); the split changes nothing
    the JAX package's split does not."""
    unions = []
    union = tpre._WaveUnion

    def counted(waves):
        unions.append(len(waves))
        return union(waves)
    monkeypatch.setattr(tpre, "_WaveUnion", counted)
    run_both(world_scenario(11, 20, 12, False, max_wave_elements=1 << 11),
             mode)
    assert unions and max(unions) > 1


@pytest.mark.parametrize("mode", MODES)
def test_direct_preempt_builds_its_cycle(mode):
    """Preemptor.preempt called with no cycle context (a direct call):
    the preemptor snapshots and tensorizes for itself (_build_cycle) and
    deletes and nominates as the JAX package's does."""
    results = []
    for pkg, iface in zip(packages(), ("kubetpu.framework.interface",
                                       "kubetpu_torch.framework.interface")):
        import importlib
        CycleState = importlib.import_module(iface).CycleState

        def scenario(A, H, store, sched):
            w = PW.world(A, 11, 20, 6, terms=False)
            PW.populate(store, w)
            for p, nn in w.parked:
                sched.queue.add_nominated_pod(p, nn)
            for p in w.pending:
                store.add(p)
            fwk = sched.profiles["default-scheduler"]
            for p in w.pending:
                results.append(sched.preemptor.preempt(
                    fwk, CycleState(), store.get_pod("default",
                                                     p.metadata.name)))
            # the victims left
            results.append(sorted(p.metadata.name
                                  for p in store.list("Pod")))
            return
            yield
        views, _ = drive(pkg, scenario, max_cycles=0, mode=mode)
    half = len(results) // 2
    assert results[:half] == results[half:] and any(results[:half - 1])
    n_pods = len(PW.world(packages()[1].api, 11, 20, 6).bound) + 6
    assert len(results[half - 1]) < n_pods      # something was evicted


@pytest.mark.parametrize("mode", MODES)
def test_disable_preemption(mode):
    views, sched = run_both(world_scenario(11, 20, 12, False), mode,
                            disable_preemption=True)
    assert sched.preemptor is None
    assert not _deleted(views)


def test_wave_equals_serial_victims():
    """tests/test_preemption_wave.py's golden on the port: the batched
    wave deletes the same victims and nominates the same nodes as one
    preemptor per cycle."""
    from tests.test_torch_preemption_scenarios import (wave_batched,
                                                       wave_serial)
    _, tp = packages()
    serial, _ = drive(tp, wave_serial, max_cycles=3)
    batched, _ = drive(tp, wave_batched, max_cycles=1)
    assert _deleted(serial) == _deleted(batched) == [
        "cheap-0-victim-0", "cheap-1-victim-0", "cheap-2-victim-0"]

    def nominations(views):
        return {name: nom for name, _, nom, _ in views[-1]["pods"]
                if name.startswith("high")}
    assert nominations(serial) == nominations(batched) == {
        "high-0": "node-0", "high-1": "node-1", "high-2": "node-2"}


@pytest.mark.parametrize("a,pa,ta,b,pb,tb", [
    ([100], 1, 0.0, [100, 100], 0, 0.0),     # fewest PDB violations
    ([50, 10], 0, 0.0, [40, 40], 0, 0.0),    # lowest highest priority
    ([40, 30], 0, 0.0, [40, 20], 0, 0.0),    # lowest priority sum
    ([40, 20, 0], 0, 0.0, [40, 20], 0, 0.0),  # fewest victims
    ([40], 0, 100.0, [40], 0, 200.0),        # latest start of the top one
    ([40], 0, 200.0, [40], 0, 200.0)])       # first in order
def test_pick_one_node_lexicographic(a, pa, ta, b, pb, tb):
    """pick_one_node_for_preemption's six criteria, the port's against the
    JAX package's on the same victim maps."""
    picks = []
    for pkg, mod in zip(packages(), (jpre, tpre)):
        def mk(prios, pdb, ts):
            pods = []
            for pr in prios:
                p = pkg.hollow.make_pod(f"v{len(pods)}", priority=pr)
                p.metadata.creation_timestamp = ts
                pods.append(p)
            return mod.Victims(pods=pods, num_pdb_violations=pdb)
        picks.append(mod.pick_one_node_for_preemption(
            {"a": mk(a, pa, ta), "b": mk(b, pb, tb)}))
    assert picks[0] == picks[1]
