"""The plain reference on small worlds built by hand."""

import os

import numpy as np
import pytest

from kbench import reference, registry, spec
from kbench.plugins import Plugins

LEAST = [["NodeResourcesLeastAllocated", 1],
         ["NodeResourcesBalancedAllocation", 1]]
GI = 1 << 30
MI = 1 << 20
PLUGINS = Plugins()


def _world(templates, bound=(), pending="p", nodes=4, zones=2):
    config = dict(nodes=nodes, zones=zones, batch_size=4,
                  node=dict(cpu_milli=4000, mem_bytes=32 * GI, pods=110))
    mix = dict(templates=templates, bound=[], trace={"cycles": 1},
               pending=dict(template=pending, backlog_batches=1),
               departures=dict(templates=[pending]))
    w = spec.build_world(config, mix, 0)
    w.bound = list(bound)
    return w


def _spread(key, skew):
    return dict(key=key, max_skew=skew, when="DoNotSchedule",
                match={"g": "m"})


FILL = {"p": dict(cpu_milli=900, mem_bytes=500 * MI)}
SPREAD = {"p": dict(cpu_milli=100, mem_bytes=500 * MI, labels={"g": "m"},
                    spread=[_spread(spec.LABEL_ZONE, 1)])}
HOST = {"p": dict(cpu_milli=100, mem_bytes=500 * MI, labels={"g": "m"},
                  spread=[_spread(spec.LABEL_HOSTNAME, 1)])}


def _cycle(w, binds, unbound=()):
    led = reference.Ledger(w)
    rec = led.begin_cycle()
    for i, node in enumerate(binds):
        led.pending("x%d" % i, "p")
        led.outcome(rec, "x%d" % i, True)
        led.bind(rec, "x%d" % i, node)
    for name in unbound:
        led.pending(name, "p")
        led.outcome(rec, name, False)
    led.end_cycle(rec)
    return reference.check(led, LEAST)


def _score(w, cpu, mem):
    u = reference.Usage(np.array([cpu]), np.array([mem]), np.array([1]), {})
    w1 = _world(FILL, nodes=1, zones=1)
    return int(reference.node_score(w1, LEAST, u)[0])


def test_kube_scheduler_score_formulas():
    least = PLUGINS.score("NodeResourcesLeastAllocated").least_allocated
    most = PLUGINS.score("NodeResourcesMostAllocated").most_allocated
    bal = PLUGINS.score(
        "NodeResourcesBalancedAllocation").balanced_allocation
    # least_allocated.go: (4000 - 3000) * 100 / 4000 = 25
    assert least(np.int64(3000), np.int64(4000)) == 25
    assert most(np.int64(3000), np.int64(4000)) == 75
    assert least(np.int64(5000), np.int64(4000)) == 0
    # balanced_allocation.go: (1 - |0.5 - 0.25|) * 100 = 75
    assert bal(np.int64(2000), np.int64(8), np.int64(4000),
               np.int64(32)) == 75


def test_sound_cycle_reads_zero():
    w = _world(FILL)
    nums = _cycle(w, [0, 1, 2, 3])
    assert nums["wrong"] == 0 and nums["score_gap"] <= 0


def test_overcommit_and_unknown_node_are_wrong():
    w = _world(FILL)
    assert _cycle(w, [0] * 5)["wrong"] == 1      # 4,500m on a 4,000m node
    assert _cycle(w, [0, -1])["wrong"] == 1


def test_pod_left_pending_with_room_is_wrong():
    w = _world(FILL)
    assert _cycle(w, [0], unbound=["y"])["wrong"] == 1
    # every node full at the end: leaving it pending is right
    full = [(f"b{i}-{n}", "p", n) for n in range(4) for i in range(4)]
    w = _world(FILL, bound=full)
    assert _cycle(w, [], unbound=["y"])["wrong"] == 0


def test_score_gap_of_a_loaded_node_against_an_open_empty_one():
    bound = [("b0", "p", 0), ("b1", "p", 0), ("b2", "p", 0)]
    w = _world(FILL, bound=bound)
    gap = _cycle(w, [0])["score_gap"]
    s = [_score(w, 900 * k, 500 * MI * k) for k in (1, 4)]
    assert gap == s[0] - s[1] > 0


def test_spread_skew_is_wrong_where_the_zone_got_the_pod():
    w = _world(SPREAD, nodes=4, zones=2)     # zone 0: nodes 0, 2
    assert _cycle(w, [0, 1])["wrong"] == 0
    assert _cycle(w, [0, 2])["wrong"] == 1    # zone 0 at 2, zone 1 at 0
    # a pending constrained pod while a zone could take it
    bound = [("m0", "p", 0)]
    w = _world(SPREAD, bound=bound)
    assert _cycle(w, [1], unbound=["y"])["wrong"] == 1


def test_hostname_spread_is_held_per_node():
    w = _world(HOST, nodes=3, zones=1)
    assert _cycle(w, [0, 1, 2, 0])["wrong"] == 0  # node 0 at 2, least 1
    assert _cycle(w, [0, 0, 1])["wrong"] == 1     # node 0 at 2, node 2 at 0
    # a node's own domain is no wider than the node: a pending pod while
    # the least-loaded node could take it is wrong
    assert _cycle(w, [0, 1], unbound=["y"])["wrong"] == 1


def test_spread_pod_carries_every_constraint_to_the_program():
    from kubetpu_torch.api import types
    from kbench import objects
    both = {"p": dict(SPREAD["p"], spread=[_spread(spec.LABEL_HOSTNAME, 5),
                                           _spread(spec.LABEL_ZONE, 5)])}
    w = _world(both)
    pod = objects.make_pod(w, "x", w.templates["p"])
    got = [(c.topology_key, c.max_skew, c.when_unsatisfiable)
           for c in pod.spec.topology_spread_constraints]
    assert got == [(types.LABEL_HOSTNAME, 5, "DoNotSchedule"),
                   (types.LABEL_ZONE, 5, "DoNotSchedule")]
    assert objects.make_node(w, 3).metadata.labels[types.LABEL_ZONE] == \
        "zone-1"


def test_unknown_template_key_is_refused():
    with pytest.raises(KeyError):
        _world({"p": dict(cpu_milli=100, mem_bytes=MI, no_such_feature=1)})


def test_a_deletion_no_feature_accounts_for_is_wrong():
    w = _world(FILL, bound=[("b0", "p", 0)])
    led = reference.Ledger(w)
    rec = led.begin_cycle()
    led.evict(rec, "b0")
    led.end_cycle(rec)
    assert reference.check(led, LEAST)["wrong"] == 1


@pytest.mark.parametrize("kind", reference.CONTROLS)
def test_controls_break_the_guarantees_at_a_small_size(kind):
    """Each control fails one of each cell's numbers: the uniform one
    ``wrong``, the feasible one (filters kept, scores ignored)
    ``score_gap`` alone."""
    bench = registry.Benchmark(os.path.dirname(registry.HERE))
    for w in bench.spec["workloads"]:
        cell = w["name"]
        config, mix = spec.scaled(bench.config(w["config"]),
                                  bench.traffic(w["traffic"]), 300, 100)
        limits = bench.limits(cell)
        for seed in (1, 2, 3):
            nums = reference.control_run(
                spec.build_world(config, mix, seed, bench.plugins), seed,
                10, config["reference_scores"], kind)
            assert any(nums[k] > v for k, v in limits.items()), (cell, seed,
                                                                 nums)
            if kind == "feasible":
                assert nums["wrong"] == 0, (cell, seed, nums)
