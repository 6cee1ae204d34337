"""Each ported function of ops/kernels.py and models/programs.py equals
its kubetpu twin bitwise on churned worlds (tests/test_pallas_gang.py's
generator, here built in both packages' API types), for several seeds.
Both sides read identical state: the JAX tensors cross to the port as
numpy leaves."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.ops import kernels as JK
from kubetpu_torch.ops import kernels as TK
from kubetpu_torch.models import programs as tprog
from kubetpu.models import programs as jprog
from tests.torch_port_util import assert_same, build_jax, carry, port_cfg
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

SEEDS = [0, 1, 2]


@functools.lru_cache(maxsize=None)
def world(seed):
    """(jax cluster, dense jax batch, port cluster, port batch, masks)."""
    n_nodes, n_pods = [(12, 9), (37, 20), (64, 48)][seed]
    jcl, jb, cfg, _ = build_jax(seed, n_nodes, n_pods, terms=True)
    tcl, tb, jbd = carry(jcl, jb)
    rs = np.random.RandomState(seed)
    B, N = jbd.req.shape[0], jcl.allocatable.shape[0]
    feas = rs.rand(B, N) < 0.7
    return jcl, jbd, tcl, tb, cfg, feas


def _both(seed, jfn, tfn):
    jcl, jb, tcl, tb, cfg, feas = world(seed)
    return (jfn(jcl, jb, jnp.asarray(feas), cfg),
            tfn(tcl, tb, torch.tensor(feas), port_cfg(cfg)))


def _cmp(a, b, ctx):
    if isinstance(a, tuple):
        assert len(a) == len(b), ctx
        for i, (x, y) in enumerate(zip(a, b)):
            _cmp(x, y, f"{ctx}[{i}]")
    elif hasattr(a, "_fields"):
        for f in a._fields:
            _cmp(getattr(a, f), getattr(b, f), f"{ctx}.{f}")
    elif isinstance(a, dict):
        assert set(a) == set(b), ctx
        for k in a:
            _cmp(a[k], b[k], f"{ctx}[{k}]")
    else:
        assert_same(a, b, ctx)


# (name, jax fn, port fn) over (cluster, batch, feasible, cfg)
CASES = {
    "fit_filter": (lambda c, b, f, g: JK.fit_filter(c, b),
                   lambda c, b, f, g: TK.fit_filter(c, b)),
    "fit_rows": (lambda c, b, f, g: JK.fit_rows(
                     b.req, c.allocatable[:1] - 50.0 * jnp.arange(
                         b.req.shape[0], dtype=jnp.float32)[:, None]),
                 lambda c, b, f, g: TK.fit_rows(
                     b.req, c.allocatable[:1] - 50.0 * torch.arange(
                         b.req.shape[0], dtype=torch.float32)[:, None])),
    "node_name_filter": (lambda c, b, f, g: JK.node_name_filter(c, b),
                         lambda c, b, f, g: TK.node_name_filter(c, b)),
    "node_unschedulable_filter": (
        lambda c, b, f, g: JK.node_unschedulable_filter(c, b),
        lambda c, b, f, g: TK.node_unschedulable_filter(c, b)),
    "node_ports_filter": (lambda c, b, f, g: JK.node_ports_filter(c, b),
                          lambda c, b, f, g: TK.node_ports_filter(c, b)),
    "taint_filter": (lambda c, b, f, g: JK.taint_filter(c, b),
                     lambda c, b, f, g: TK.taint_filter(c, b)),
    "node_affinity_filter": (lambda c, b, f, g: JK.node_affinity_filter(c, b),
                             lambda c, b, f, g: TK.node_affinity_filter(c, b)),
    "spread_filter": (
        lambda c, b, f, g: JK.spread_filter(c, b, JK.node_affinity_filter(c, b)),
        lambda c, b, f, g: TK.spread_filter(c, b, TK.node_affinity_filter(c, b))),
    "interpod_filter": (lambda c, b, f, g: JK.interpod_filter(c, b),
                        lambda c, b, f, g: TK.interpod_filter(c, b)),
    "interpod_score_pre": (lambda c, b, f, g: JK.interpod_score_pre(c, b),
                           lambda c, b, f, g: TK.interpod_score_pre(c, b)),
    "interpod_score_raw": (lambda c, b, f, g: JK.interpod_score_raw(c, b),
                           lambda c, b, f, g: TK.interpod_score_raw(c, b)),
    "interpod_score": (lambda c, b, f, g: JK.interpod_score(c, b, f),
                       lambda c, b, f, g: TK.interpod_score(c, b, f)),
    "per_node_counts": (
        lambda c, b, f, g: JK.per_node_counts(JK.default_spread_match_ns(c, b),
                                              c.pod_node, c.allocatable.shape[0]),
        lambda c, b, f, g: TK.per_node_counts(TK.default_spread_match_ns(c, b),
                                              c.pod_node, c.allocatable.shape[0])),
    "samepair_pods_to_nodes": (
        lambda c, b, f, g: JK._samepair_pods_to_nodes(
            c, c.pod_valid[None, :].repeat(3, 0), jnp.array([0, 1, -1]),
            c.pod_node, c.pod_valid),
        lambda c, b, f, g: TK._samepair_pods_to_nodes(
            c, c.pod_valid[None, :].repeat(3, 1), torch.tensor([0, 1, -1]),
            c.pod_node, c.pod_valid)),
    "samepair_nodes": (
        lambda c, b, f, g: JK._samepair_nodes(
            c, c.node_valid[None, :].repeat(3, 0), jnp.array([1, 0, 7])),
        lambda c, b, f, g: TK._samepair_nodes(
            c, c.node_valid[None, :].repeat(3, 1), torch.tensor([1, 0, 7]))),
    "balanced_allocation_score": (
        lambda c, b, f, g: JK.balanced_allocation_score(c, b),
        lambda c, b, f, g: TK.balanced_allocation_score(c, b)),
    "least_allocated_score": (
        lambda c, b, f, g: JK.least_allocated_score(c, b),
        lambda c, b, f, g: TK.least_allocated_score(c, b)),
    "most_allocated_score": (
        lambda c, b, f, g: JK.most_allocated_score(c, b),
        lambda c, b, f, g: TK.most_allocated_score(c, b)),
    "node_affinity_score": (lambda c, b, f, g: JK.node_affinity_score(c, b),
                            lambda c, b, f, g: TK.node_affinity_score(c, b)),
    "taint_toleration_score": (
        lambda c, b, f, g: JK.taint_toleration_score(c, b),
        lambda c, b, f, g: TK.taint_toleration_score(c, b)),
    "image_locality_score": (lambda c, b, f, g: JK.image_locality_score(c, b),
                             lambda c, b, f, g: TK.image_locality_score(c, b)),
    "prefer_avoid_pods_score": (
        lambda c, b, f, g: JK.prefer_avoid_pods_score(c, b),
        lambda c, b, f, g: TK.prefer_avoid_pods_score(c, b)),
    "default_spread_match_ns": (
        lambda c, b, f, g: JK.default_spread_match_ns(c, b),
        lambda c, b, f, g: TK.default_spread_match_ns(c, b)),
    "default_spread_score": (lambda c, b, f, g: JK.default_spread_score(c, b),
                             lambda c, b, f, g: TK.default_spread_score(c, b)),
    "default_spread_normalize": (
        lambda c, b, f, g: JK.default_spread_normalize(
            c, b, JK.default_spread_score(c, b) + (jnp.arange(
                c.allocatable.shape[0]) % 3)[None, :], f),
        lambda c, b, f, g: TK.default_spread_normalize(
            c, b, TK.default_spread_score(c, b) + (torch.arange(
                c.allocatable.shape[0]) % 3)[None, :], f)),
    "default_normalize": (
        lambda c, b, f, g: (JK.default_normalize(JK.node_affinity_score(c, b),
                                                 f, False),
                            JK.default_normalize(
                                JK.taint_toleration_score(c, b), f, True)),
        lambda c, b, f, g: (TK.default_normalize(TK.node_affinity_score(c, b),
                                                 f, False),
                            TK.default_normalize(
                                TK.taint_toleration_score(c, b), f, True))),
    # the sequential replay's pair machinery: node and pod pair ids of the
    # batch's term keys, a scatter of per-node values (feasible mask x
    # node index, ids -1 dropped) and the gather back
    "pod_topo_pairs": (
        lambda c, b, f, g: JK.pod_topo_pairs(c, b.raa.topo_key.reshape(-1)),
        lambda c, b, f, g: TK.pod_topo_pairs(c, b.raa.topo_key.reshape(-1))),
    "pair_scatter": (
        lambda c, b, f, g: JK.pair_scatter(
            f * (jnp.arange(f.shape[1]) % 5)[None, :],
            JK.node_topo_pairs(c, b.pref.topo_key[:, 0]), c.kv.shape[1]),
        lambda c, b, f, g: TK.pair_scatter(
            f * (torch.arange(f.shape[1]) % 5)[None, :],
            TK.node_topo_pairs(c, b.pref.topo_key[:, 0]), c.kv.shape[1])),
    "pair_gather": (
        lambda c, b, f, g: JK.pair_gather(
            JK.pair_scatter(f, JK.node_topo_pairs(c, b.ra.topo_key[:, 0]),
                            c.kv.shape[1]),
            JK.node_topo_pairs(c, b.ra.topo_key[:, 0])),
        lambda c, b, f, g: TK.pair_gather(
            TK.pair_scatter(f, TK.node_topo_pairs(c, b.ra.topo_key[:, 0]),
                            c.kv.shape[1]),
            TK.node_topo_pairs(c, b.ra.topo_key[:, 0]))),
    "spread_state_hard": (
        lambda c, b, f, g: JK._spread_state(
            c, b, b.spread, JK.node_affinity_filter(c, b),
            c.node_valid[None, :] & jnp.ones(f.shape, bool)),
        lambda c, b, f, g: TK._spread_state(
            c, b, b.spread, TK.node_affinity_filter(c, b),
            c.node_valid[None, :].expand(f.shape))),
    "spread_state_soft": (
        lambda c, b, f, g: JK._spread_state(
            c, b, b.spread_soft, jnp.zeros(f.shape, bool),
            f & JK.node_affinity_filter(c, b)),
        lambda c, b, f, g: TK._spread_state(
            c, b, b.spread_soft, torch.zeros(f.shape, dtype=torch.bool),
            f & TK.node_affinity_filter(c, b))),
    "run_filters": (lambda c, b, f, g: jprog.run_filters(c, b, g),
                    lambda c, b, f, g: tprog.run_filters(c, b, g)),
    "static_raw_scores": (lambda c, b, f, g: jprog.static_raw_scores(c, b, g),
                          lambda c, b, f, g: tprog.static_raw_scores(c, b, g)),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_reference(name, seed):
    jfn, tfn = CASES[name]
    a, b = _both(seed, jfn, tfn)
    _cmp(a, b, name)


@pytest.mark.parametrize("seed", SEEDS)
def test_run_scores_matches_reference(seed):
    """The weighted combine of the default family, soft spread
    constraints included (the full PodTopologySpread scorer)."""
    jcl, jb, tcl, tb, cfg, feas = world(seed)
    assert np.asarray(jb.spread_soft.valid).any()
    aff_j = JK.node_affinity_filter(jcl, jb)
    aff_t = TK.node_affinity_filter(tcl, tb)
    a = jprog.run_scores(jcl, jb, cfg, jnp.asarray(feas), aff_j)
    b = tprog.run_scores(tcl, tb, port_cfg(cfg), torch.tensor(feas), aff_t)
    _cmp(a, b, "run_scores")


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_tiebreak_argmax_matches_reference(seed):
    rs = np.random.RandomState(seed)
    total = rs.randint(0, 4, size=(33, 77)).astype(np.float32)
    f = rs.rand(33, 77) < 0.6
    f[3] = False
    gum = rs.gumbel(size=(33, 77)).astype(np.float32)
    gum[:, 10] = gum[:, 11]          # exact gumbel ties: first index wins
    neg = float(-2 ** 62)
    a = JK.gumbel_tiebreak_argmax(jnp.asarray(total), jnp.asarray(f),
                                  jnp.asarray(gum), 5, neg)
    b = TK.gumbel_tiebreak_argmax(torch.tensor(total), torch.tensor(f),
                                  torch.tensor(gum), 5, neg)
    _cmp(tuple(a), tuple(b), "gumbel_tiebreak_argmax")


def test_idiv_matches_reference():
    rs = np.random.RandomState(0)
    a = rs.randint(0, 10 ** 6, size=5000).astype(np.float32)
    b = rs.randint(1, 3000, size=5000).astype(np.float32)
    assert_same(JK._idiv(jnp.asarray(a), jnp.asarray(b)),
                TK._idiv(torch.tensor(a), torch.tensor(b)), "_idiv")
    np.testing.assert_array_equal(
        TK._idiv(torch.tensor(a), torch.tensor(b)).numpy(),
        (a.astype(np.int64) // b.astype(np.int64)).astype(np.float32))


def test_zone_weight_constant_rounded_once():
    """1 - 2/3 computed in double then rounded to f32 (0.33333334), not
    f32(1) - f32(2/3) (0.3333333)."""
    assert np.float32(TK.ONE_MINUS_ZONE_W) == np.float32(1.0 - 2.0 / 3.0)
    assert np.float32(TK.ONE_MINUS_ZONE_W) != (np.float32(1.0)
                                              - np.float32(2.0 / 3.0))
