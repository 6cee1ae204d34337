"""tests/test_preemption.py's, tests/test_preemption_wave.py's and
tests/test_nominated_topology.py's scenarios as differential cases: the
port's Scheduler against kubetpu.scheduler.Scheduler, in both modes, every
cycle's outcomes, deleted victims (in order), pods' nodes, nominations and
PodScheduled conditions, and queue contents equal
(tests/test_torch_preemption.run_both).  The JAX package's compile-once
check (it counts XLA's compiles) has no counterpart."""
import pytest

from tests.test_torch_preemption import MODES, run_both
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)


def _victims(store, H, node, n, prio=0, cpu=1500, prefix=None):
    for i in range(n):
        p = H.make_pod(f"{prefix or node}-victim-{i}", cpu_milli=cpu,
                       priority=prio)
        p.metadata.creation_timestamp = float(i)
        p.spec.node_name = node
        store.add(p)


def _add(store, H, name, cpu, prio, ts=100.0, **kw):
    p = H.make_pod(name, cpu_milli=cpu, priority=prio, **kw)
    p.metadata.creation_timestamp = ts
    store.add(p)
    return p


def preempts_lower_priority(A, H, store, sched):
    for n in H.make_nodes(2, cpu_milli=3000):
        store.add(n)
    _victims(store, H, "node-0", 2)
    _victims(store, H, "node-1", 2)
    _add(store, H, "high", 2000, 100)
    yield


def equal_priority(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=1000))
    _victims(store, H, "n1", 1, prio=50, cpu=900)
    _add(store, H, "peer", 500, 50)
    yield


def respects_pdb(A, H, store, sched):
    for n in H.make_nodes(2, cpu_milli=2000):
        store.add(n)
    _victims(store, H, "node-0", 1, cpu=1800)
    p = store.get_pod("default", "node-0-victim-0")
    p.metadata.labels["app"] = "guarded"
    store.update(p)
    _victims(store, H, "node-1", 1, cpu=1800)
    store.add(A.PodDisruptionBudget(
        metadata=A.ObjectMeta(name="pdb"),
        selector=A.LabelSelector(match_labels={"app": "guarded"}),
        disruptions_allowed=0))
    _add(store, H, "high", 1000, 10)
    yield


def unresolvable_not_candidates(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=1000, labels={"disk": "hdd"}))
    _victims(store, H, "n1", 1, cpu=900)
    p = H.make_pod("p", cpu_milli=500, priority=10)
    p.spec.node_selector = {"disk": "ssd"}
    store.add(p)
    yield


def nomination_not_stolen(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=2000))
    _victims(store, H, "n1", 1, cpu=2000)
    _add(store, H, "high", 2000, 100)
    yield
    _add(store, H, "sneak", 2000, 0, ts=200.0)
    yield


def higher_ignores_lower_nominations(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=2000))
    _victims(store, H, "n1", 1, cpu=2000)
    _add(store, H, "mid", 2000, 50)
    yield
    _add(store, H, "boss", 2000, 100, ts=200.0)
    yield


def own_nomination_in_batch(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=2000))
    _victims(store, H, "n1", 1, cpu=2000)
    _add(store, H, "high", 2000, 100)
    yield
    _add(store, H, "sneak", 2000, 0, ts=200.0)


def candidate_trim(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=1000))
    sched.preemptor.max_candidates = 1
    for name in ("a", "b"):
        store.add(H.make_node(f"node-{name}", cpu_milli=1000))
    _victims(store, H, "node-a", 1, prio=10, cpu=900)
    _victims(store, H, "node-b", 1, prio=5, cpu=900)
    _victims(store, H, "n1", 1, prio=20, cpu=900)
    _add(store, H, "high", 500, 100)
    yield


# tests/test_preemption_wave.py's scenarios


def _three_nodes(A, H, store):
    for i in range(3):
        store.add(H.make_node(f"node-{i}", cpu_milli=2000))
        _victims(store, H, f"node-{i}", 1, prio=5, cpu=900,
                 prefix=f"keep-{i}")
        _victims(store, H, f"node-{i}", 1, prio=i + 1, cpu=900,
                 prefix=f"cheap-{i}")


def wave_serial(A, H, store, sched):
    _three_nodes(A, H, store)
    for i in range(3):
        _add(store, H, f"high-{i}", 1100, 100, ts=100.0 + i)
        yield


def wave_batched(A, H, store, sched):
    _three_nodes(A, H, store)
    for i in range(3):
        _add(store, H, f"high-{i}", 1100, 100, ts=100.0 + i)
    yield


def wave_contention_one_winner(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=4000))
    _victims(store, H, "n1", 4, cpu=900, prefix="filler")
    for i in range(2):
        _add(store, H, f"high-{i}", 600, 100, ts=100.0 + i)
    yield


def wave_contention_loser_fails(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=2000))
    _victims(store, H, "n1", 2, cpu=900, prefix="v")
    for i in range(2):
        _add(store, H, f"high-{i}", 1100, 100, ts=100.0 + i)
    yield


def wave_pdb_snapshot_order(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=2000))
    for name, prio in (("victim-a", 0), ("victim-b", 5)):
        p = H.make_pod(name, cpu_milli=900, priority=prio)
        p.metadata.labels["app"] = "guarded"
        p.metadata.creation_timestamp = 1.0
        p.spec.node_name = "n1"
        store.add(p)
    store.add(A.PodDisruptionBudget(
        metadata=A.ObjectMeta(name="pdb"),
        selector=A.LabelSelector(match_labels={"app": "guarded"}),
        disruptions_allowed=1))
    _add(store, H, "high", 1100, 100)
    yield


def victim_unknown_resource(A, H, store, sched):
    store.add(H.make_node("n1", cpu_milli=1000))
    v = H.make_pod("weird-victim", cpu_milli=900, priority=0)
    v.spec.containers[0].resources.requests["example.com/weird"] = "3"
    v.metadata.creation_timestamp = 1.0
    v.spec.node_name = "n1"
    store.add(v)
    _add(store, H, "high", 500, 100)
    yield


# tests/test_nominated_topology.py's scenarios: pods parked in the
# nominator (as a preemptor is while its victims terminate)


def _nominate(sched, pod, node):
    pod.status.nominated_node_name = node
    sched.queue.add_nominated_pod(pod, node)


def _anti(A, app):
    return A.Affinity(pod_anti_affinity=A.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=[
            A.PodAffinityTerm(
                label_selector=A.LabelSelector(match_labels={"app": app}),
                topology_key=A.LABEL_HOSTNAME)]))


def _pod(H, name, labels, prio):
    p = H.make_pod(name, labels=labels, priority=prio)
    p.metadata.creation_timestamp = 50.0
    return p


def repelled_by_nominated_anti(A, H, store, sched):
    for n in H.make_nodes(2):
        store.add(n)
    nom = _pod(H, "nom", {"app": "x"}, 1000)
    nom.spec.affinity = _anti(A, "y")
    _nominate(sched, nom, "node-0")
    store.add(_pod(H, "low", {"app": "y"}, 0))
    yield


def repelled_by_own_anti(A, H, store, sched):
    for n in H.make_nodes(2):
        store.add(n)
    _nominate(sched, _pod(H, "nom", {"app": "x"}, 1000), "node-0")
    p = _pod(H, "low", {"team": "z"}, 0)
    p.spec.affinity = _anti(A, "x")
    store.add(p)
    yield


def higher_ignores_nominated(A, H, store, sched):
    store.add(H.make_nodes(1)[0])
    nom = _pod(H, "nom", {"app": "x"}, 10)
    nom.spec.affinity = _anti(A, "y")
    _nominate(sched, nom, "node-0")
    store.add(_pod(H, "boss", {"app": "y"}, 1000))
    yield


def nominated_skews_spread(n_nominated):
    def scenario(A, H, store, sched):
        for n in H.make_nodes(2):
            store.add(n)
        for i in range(n_nominated):
            _nominate(sched, _pod(H, f"nom{i}", {"grp": "g"}, 1000),
                      "node-0")
        p = _pod(H, "low", {"grp": "g"}, 0)
        H.with_spread(p, A.LABEL_HOSTNAME, max_skew=1, when="DoNotSchedule")
        store.add(p)
        yield
    return scenario


SCENARIOS = {
    "preempts_lower_priority": preempts_lower_priority,
    "equal_priority": equal_priority,
    "respects_pdb": respects_pdb,
    "unresolvable_not_candidates": unresolvable_not_candidates,
    "nomination_not_stolen": nomination_not_stolen,
    "higher_ignores_lower_nominations": higher_ignores_lower_nominations,
    "own_nomination_in_batch": own_nomination_in_batch,
    "candidate_trim": candidate_trim,
    "wave_serial": wave_serial,
    "wave_batched": wave_batched,
    "wave_contention_one_winner": wave_contention_one_winner,
    "wave_contention_loser_fails": wave_contention_loser_fails,
    "wave_pdb_snapshot_order": wave_pdb_snapshot_order,
    "victim_unknown_resource": victim_unknown_resource,
    "repelled_by_nominated_anti": repelled_by_nominated_anti,
    "repelled_by_own_anti": repelled_by_own_anti,
    "higher_ignores_nominated": higher_ignores_nominated,
    "nominated_skews_spread": nominated_skews_spread(1),
    "two_nominated_force_spread": nominated_skews_spread(2),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario(name, mode):
    run_both(SCENARIOS[name], mode)


