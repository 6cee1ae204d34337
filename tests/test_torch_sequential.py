"""The port's sequential replay (kubetpu_torch/models/sequential.py)
against kubetpu.models.sequential, and its Scheduler in the default mode
against the JAX scheduler and the committed placement goldens.

Differential worlds come from kubetpu_torch/harness/seq_worlds.py, built
in both packages' API types, with every default filter and score family
live; both sides read identical state (JAX tensors cross as numpy
leaves) and, unless a case says otherwise, the JAX selectHost plane.
Every SeqResult field is compared bitwise (tolerance 0)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu.api.types as japi
import kubetpu.apis.config as jconf
import kubetpu.client.store as jstore
import kubetpu.scheduler as jsched
import kubetpu_torch.api.types as tapi
import kubetpu_torch.apis.config as tconf
import kubetpu_torch.client.store as tstore
import kubetpu_torch.harness.hollow as thollow
import kubetpu_torch.scheduler as tsched
from kubetpu.models import sequential as jseq
from kubetpu_torch.harness import seq_worlds
from kubetpu_torch.models.batch import batch_to_device
from kubetpu_torch.models import sequential as tseq
from kubetpu_torch.ops import kernels as tK
from tests.torch_port_util import (assert_same, build_jax_seq, carry,
                                   jax_gumbel, port_cfg)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           "placements.json")


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The replay issues a few hundred small ops per pod; on a shared CPU
    torch's multi-threaded gemv costs milliseconds each.  One intra-op
    thread gives the same bits (every reduction here is exact)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(rng):
    return torch.tensor(np.asarray(rng).astype(np.int64))


# seed, nodes, pods, percentage_of_nodes_to_score, start_index, host_ok,
# score_bias.  150 and 130 nodes put the sampled search below the
# feasible count (limit 100), so the rotation and the sampling scatter bind
CASES = [
    (0, 40, 24, 100, 0, False, False),     # sampling off
    (1, 150, 40, 0, 7, False, False),      # adaptive sampling, start 7
    (2, 130, 64, 30, 3, True, False),      # 30%, random host_ok
    (3, 64, 48, 0, 0, False, True),        # score_bias, contended
    (4, 150, 60, 0, 149, True, True),      # everything at once
]


@pytest.mark.parametrize("seed,n_nodes,n_pods,pct,start,use_host,use_bias",
                         CASES)
def test_sequential_matches_reference(seed, n_nodes, n_pods, pct, start,
                                      use_host, use_bias):
    jcl, jb, cfg, _ = build_jax_seq(seed, n_nodes, n_pods)
    cfg = cfg._replace(percentage_of_nodes_to_score=pct)
    tcl, tb, _ = carry(jcl, jb)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    rs = np.random.RandomState(seed)
    host_ok = rs.rand(B, N) < 0.85 if use_host else None
    bias = ((rs.rand(B, N) * 7.0).astype(np.float32) if use_bias else None)
    rng = jax.random.PRNGKey(seed + 5)
    gum = jax_gumbel(rng, B, N)
    want = jseq.schedule_sequential(
        jcl, jax.tree.map(jnp.asarray, jb), cfg, rng, start_index=start,
        host_ok=None if host_ok is None else jnp.asarray(host_ok),
        score_bias=None if bias is None else jnp.asarray(bias))
    got = tseq.schedule_sequential(
        tcl, tb, port_cfg(cfg), _key(rng), start_index=start,
        host_ok=None if host_ok is None else torch.tensor(host_ok),
        score_bias=None if bias is None else torch.tensor(bias),
        gumbel=torch.tensor(np.asarray(gum)))
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f)
    # the world exercises what the case claims
    chosen = np.asarray(want.chosen)
    assert (chosen >= 0).sum() > n_pods // 2
    if pct < 100 and n_nodes > 100:
        assert int(np.asarray(want.n_feasible).max()) == 100
        assert int(want.next_start) != start


def test_worlds_carry_every_family():
    """The differential worlds hold every default family's inputs: pod
    (anti-)affinity, preferred terms, hard and soft spread (zone and
    hostname, two constraints on one pod), Service selectors, hostPorts,
    taints, existing pods' filter and score terms."""
    jcl, jb, cfg, _ = build_jax_seq(4, 150, 60)
    assert jb.ra.valid.any() and jb.raa.valid.any() and jb.pref.valid.any()
    assert (jb.raa.valid.sum(axis=1) == 2).any()
    assert (jb.pref.weight < 0).any()
    assert jb.spread.valid.any() and jb.spread_soft.valid.any()
    assert (jb.spread.valid.sum(axis=1) == 2).any()
    soft_keys = set(np.asarray(jb.spread_soft.topo_key)[jb.spread_soft.valid])
    assert cfg.hostname_topokey in soft_keys and len(soft_keys) == 2
    assert np.asarray(jb.spread_selector.sel_valid).any()
    assert (jb.ports_hot.sum(axis=1) > 0).any()
    assert np.asarray(jcl.taints).any()
    assert np.asarray(jcl.filter_terms.valid).any()
    assert np.asarray(jcl.score_terms.valid).any()


def test_own_plane_picks_what_categorical_picks():
    """The port's own plane (utils/prng.select_plane) in place of the JAX
    one: its argmax over the tie set picks what
    jax.random.categorical(fold_in(rng, i), logits) picks."""
    jcl, jb, cfg, _ = build_jax_seq(6, 150, 40)
    cfg = cfg._replace(percentage_of_nodes_to_score=0)
    tcl, tb, _ = carry(jcl, jb)
    rng = jax.random.PRNGKey(9)
    want = jseq.schedule_sequential(jcl, jax.tree.map(jnp.asarray, jb), cfg,
                                    rng, start_index=11)
    got = tseq.schedule_sequential(tcl, tb, port_cfg(cfg), _key(rng),
                                   start_index=11)
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f)


def test_port_builders_match_reference():
    """The smoke's inputs (seq_worlds.port_inputs: the port's own API
    types and builders) replay as the JAX package's build of the same
    world does."""
    jcl, jb, cfg, _ = build_jax_seq(7, 150, 40)
    cfg = cfg._replace(percentage_of_nodes_to_score=0)
    host, hbatch, host_key = seq_worlds.port_inputs(7, 150, 40)
    assert host_key == cfg.hostname_topokey
    rng = jax.random.PRNGKey(2)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    gum = jax_gumbel(rng, B, N)
    want = jseq.schedule_sequential(jcl, jax.tree.map(jnp.asarray, jb), cfg,
                                    rng, start_index=37)
    got = tseq.schedule_sequential(
        host.to_device("cpu"), batch_to_device(hbatch, "cpu"), port_cfg(cfg),
        _key(rng), start_index=37, gumbel=torch.tensor(np.asarray(gum)))
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f)


@pytest.mark.parametrize("pct", [0, 5, 30, 100])
def test_num_feasible_nodes_to_find(pct):
    n = np.arange(0, 6001, dtype=np.int32)
    want = jseq._num_feasible_nodes_to_find(jnp.asarray(n), pct)
    got = tseq._num_feasible_nodes_to_find(torch.tensor(n), pct)
    assert_same(want, got, "numFeasibleNodesToFind")


# sizes s <= 20,000 at which XLA:CPU's f32 log(s + 2) (the reference's
# soft-spread weight) differs from the correctly rounded value the port
# takes; each by one ulp (ROADMAP queue 3)
LOG_ULP_SIZES = (
    5, 45, 47, 177, 333, 381, 400, 427, 432, 624, 713, 714, 719, 728, 793,
    856, 1164, 1312, 1331, 1383, 1421, 1429, 1431, 1451, 1467, 1532, 1560,
    1575, 1577, 1753, 1779, 1880, 1915, 1948, 2313, 2434, 2479, 2502, 2524,
    2529, 2775, 2776, 2843, 2855, 2858, 2860, 2862, 2882, 2889, 2918, 3098,
    3278, 3397, 3466, 3623, 3731, 3769, 3797, 3826, 4350, 4469, 4751, 4933,
    5269, 5303, 5482, 5656, 5689, 5737, 5868, 5902, 5934, 6075, 6104, 6182,
    6195, 6254, 6277, 6342, 6364, 6404, 6421, 6519, 6589, 6747, 6776, 6779,
    6947, 7110, 7176, 7239, 7733, 8073, 8717, 8942, 9309, 9343, 9394, 9440,
    9547, 9740, 10119, 10511, 10652, 10674, 10679, 10910, 10962, 10997,
    11080, 11103, 11141, 11165, 11214, 11425, 11449, 11496, 11540, 11558,
    11652, 11775, 11820, 11834, 11851, 11875, 11934, 11972, 12012, 12020,
    12025, 12040, 12116, 12158, 12219, 12351, 12573, 12612, 12663, 12758,
    12774, 12797, 12813, 12972, 13118, 13261, 13718, 13921, 13975, 13983,
    14092, 14174, 14346, 14560, 14954, 15194, 15310, 17234, 17882, 18092,
    18236, 18516, 18752, 18817, 18912, 18968, 19172, 19304, 19583, 19707,
    19827, 19853, 19939)


def test_spread_log_weight_ulps():
    """The port's weight log(size + 2) equals jnp.log's bit for bit for
    every size 0..20,000.  XLA:CPU's f32 log is not correctly rounded: it
    differs from the correctly rounded value on exactly LOG_ULP_SIZES, by
    one ulp (the record of where a float64-then-round log would miss)."""
    s = np.arange(0, 20001, dtype=np.float32)
    port = tK.spread_log_weight(torch.tensor(s)).numpy()
    ref = np.asarray(jnp.log(jnp.asarray(s) + 2.0))
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))
    exact = np.log((s + np.float32(2.0)).astype(np.float64)).astype(
        np.float32)
    diff = np.nonzero(ref.view(np.int32) != exact.view(np.int32))[0]
    assert tuple(diff.tolist()) == LOG_ULP_SIZES
    ulps = np.abs(ref.view(np.int32).astype(np.int64)
                  - exact.view(np.int32).astype(np.int64))
    assert ulps.max() == 1


@pytest.mark.parametrize("name", ["NodeLabel", "RequestedToCapacityRatio",
                                  "NodeResourceLimits"])
def test_unported_plugin_raises(name):
    """These three scorers were refused by the replay until the framework
    extension points were ported; each now runs, with its default
    arguments, and the replay equals the JAX package's on every SeqResult
    field (tests/test_torch_profiles.py holds them with real
    arguments)."""
    jcl, jb, cfg, _ = build_jax_seq(0, 8, 4)
    tcl, tb, _ = carry(jcl, jb)
    cfg = cfg._replace(scores=cfg.scores + ((name, 1),))
    rng = jax.random.PRNGKey(3)
    want = jseq.schedule_sequential(jcl, jax.tree.map(jnp.asarray, jb), cfg,
                                    rng)
    got = tseq.schedule_sequential(tcl, tb, port_cfg(cfg), _key(rng))
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f)


# ---------------------------------------------------------------------------
# the Scheduler in its default mode


def _golden_world(world):
    """tests/test_placement_goldens.py's worlds, in the port's API types."""
    store = tstore.ClusterStore()
    for n in thollow.make_nodes(100, zones=4):
        store.add(n)
    prefix = "basic-" if world == "basic" else "topo-"
    pods = thollow.make_pods(100, prefix=prefix, group_labels=10)
    if world == "topology":
        for i, p in enumerate(pods):
            if i % 2 == 0:
                thollow.with_anti_affinity(p, tapi.LABEL_HOSTNAME)
            if i % 3 == 0:
                thollow.with_spread(p, tapi.LABEL_ZONE, when="ScheduleAnyway")
    return store, pods


@pytest.mark.parametrize("world", ["basic", "topology"])
def test_placement_goldens(world):
    """The port's Scheduler under a default configuration (sequential,
    adaptive sampling) places the golden worlds pod for pod as the
    committed trace records (read, never written)."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)[world]["sequential"]
    store, pods = _golden_world(world)
    cfg = tconf.KubeSchedulerConfiguration(
        profiles=[tconf.KubeSchedulerProfile()], batch_size=100)
    assert cfg.mode == "sequential"
    sched = tsched.Scheduler(store, config=cfg, device="cpu")
    for p in pods:
        store.add(p)
    got = {}
    for _ in range(10):
        out = sched.schedule_pending()
        if not out:
            break
        got.update({o.pod.metadata.name: o.node for o in out})
    sched.close()
    diffs = {k: (want.get(k), got.get(k)) for k in set(want) | set(got)
             if want.get(k) != got.get(k)}
    assert not diffs, f"{len(diffs)} placements differ: {list(diffs)[:5]}"
    assert all(got.values())


def _drain_world(A, store_mod, seed, n_nodes, n_pods):
    nodes, existing, pending = seq_worlds.term_world(A, seed, n_nodes,
                                                     n_pods)
    store = store_mod.ClusterStore()
    for svc in seq_worlds.services(A):
        store.add(svc)
    for n in nodes:
        store.add(n)
        for p in existing[n.name]:
            store.add(p)
    return store, pending


def _drain(sched, store, pending):
    for p in pending:
        store.add(p)
    placed, n_feas, starts = {}, {}, []
    while True:
        out = sched.schedule_pending()
        if not out:
            break
        for o in out:
            placed[o.pod.metadata.name] = o.node
            if o.node:
                n_feas[o.pod.metadata.name] = o.n_feasible
        starts.append(sched._next_start_node_index)
    sched.close()
    return placed, n_feas, starts


@pytest.mark.parametrize("seed,n_nodes,n_pods,batch", [
    (21, 150, 56, 16),    # four cycles, sampling binds every cycle
    (22, 48, 40, 16),     # small cluster: sampling on but not binding
])
def test_sequential_drain_matches_reference(seed, n_nodes, n_pods, batch):
    """Multi-cycle drains of a term-bearing world: the port's Scheduler
    (its own selectHost plane) and the JAX scheduler, both in sequential
    mode with adaptive sampling, give every pod the same node, the same
    n_feasible, and the same start-index rotation after every cycle."""
    store, pending = _drain_world(japi, jstore, seed, n_nodes, n_pods)
    jcfg = jconf.KubeSchedulerConfiguration(
        profiles=[jconf.KubeSchedulerProfile()], batch_size=batch,
        mode="sequential", prewarm=False)
    want = _drain(jsched.Scheduler(store, config=jcfg, async_binding=False),
                  store, pending)
    store, pending = _drain_world(tapi, tstore, seed, n_nodes, n_pods)
    tcfg = tconf.KubeSchedulerConfiguration(
        profiles=[tconf.KubeSchedulerProfile()], batch_size=batch)
    sched = tsched.Scheduler(store, config=tcfg, device="cpu")
    got = _drain(sched, store, pending)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(want[2]) >= 3
    assert sum(1 for v in want[0].values() if v) > n_pods // 2
    assert tsched.capacity_violations(store) == []
