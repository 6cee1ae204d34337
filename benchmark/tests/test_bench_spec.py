"""The frozen traffic generator: seeded, the same sizes for every seed."""

import collections
import os

from kbench import registry, spec

BIG_SEED = 2 ** 31 + 12345


def _cell(name, nodes=64, batch=32):
    bench = registry.Benchmark(os.path.dirname(registry.HERE))
    cell = bench.cell(name)
    return spec.scaled(bench.config(cell["config"]),
                       bench.traffic(cell["traffic"]), nodes, batch)


def _drive(config, mix, seed, steps=4):
    world = spec.build_world(config, mix, seed)
    loop = spec.ClosedLoop(world, seed)
    trail = []
    for i in range(steps):
        gone, new = loop.step(5 if i else 0)
        for name in new[:7]:
            loop.bound(name, mix["pending"]["template"])
        trail.append((gone, new))
    return world, trail


def test_same_seed_same_world_and_traffic():
    config, mix = _cell("k8s5k-default.fill-churn")
    w1, t1 = _drive(config, mix, BIG_SEED)
    w2, t2 = _drive(config, mix, BIG_SEED)
    assert w1.bound == w2.bound
    assert t1 == t2


def test_seeds_change_choices_not_sizes():
    config, mix = _cell("k8s5k-default.fill-churn")
    w1, t1 = _drive(config, mix, 1)
    w2, t2 = _drive(config, mix, 2)
    assert len(w1.bound) == len(w2.bound) == round(2.4 * 64)
    c1 = sorted(collections.Counter(n for _, _, n in w1.bound).values())
    c2 = sorted(collections.Counter(n for _, _, n in w2.bound).values())
    assert c1 == c2 and set(c1) == {2, 3}
    assert w1.bound != w2.bound
    assert [len(g) for g, _ in t1] == [len(g) for g, _ in t2]
    assert [len(n) for _, n in t1] == [len(n) for _, n in t2]


def test_spread_world_per_zone_and_per_node():
    config, mix = _cell("k8s5k-default.spread-churn", nodes=5000, batch=1000)
    w = spec.build_world(config, mix, BIG_SEED)
    init = [n for name, t, n in w.bound if t == "init"]
    measured = [n for name, t, n in w.bound if t == "measured"]
    assert sorted(init) == list(range(5000))
    per_zone = collections.Counter(int(w.node_zone[n]) for n in measured)
    assert per_zone == {z: 333 for z in range(3)}
    assert len(set(measured)) == 999


def test_backlog_topped_up_and_departures_from_bound_pool():
    config, mix = _cell("k8s5k-default.fill-churn")
    world = spec.build_world(config, mix, 5)
    loop = spec.ClosedLoop(world, 5)
    gone, new = loop.step(0)
    assert gone == [] and len(new) == 2 * 32
    for name in new[:10]:
        loop.bound(name, "filler")
    gone, new2 = loop.step(10)
    assert len(gone) == 10 and len(set(gone)) == 10
    assert len(new2) == 10 and len(loop.pending) == 64
    pool = {n for n, t, _ in world.bound} | set(new[:10])
    assert set(gone) <= pool
