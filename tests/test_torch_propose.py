"""The port's fused propose step (kubetpu_torch/ops/propose.py) against
the TPU kernel it replaces, kubetpu.ops.pallas_kernels.propose, run in
interpret mode on the CPU.  prop/act/best are compared bitwise over
churned worlds (ports, taints, zones, InterPodAffinity raws, a host bias
plane, windowed rows read by index, out of order and with sentinels,
zero-feasible pods, a non-default score layout) and over synthetic
bundles whose N and W are not multiples of any tile.  The CUDA kernel is
held against the plain version on the card in
tests/test_torch_propose_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.models import programs as jprog
from kubetpu.ops import kernels as JK
from kubetpu.ops import pallas_kernels as JPK
from kubetpu_torch.harness import propose_worlds as PW
from kubetpu_torch.harness.propose_worlds import GENERIC_SCORES
from kubetpu_torch.models.programs import ProgramConfig as TConfig
from kubetpu_torch.ops import propose as TPK
from tests.torch_port_util import (assert_same, build_jax, jax_gumbel,
                                   port_cfg)


def _port_bundle(jbundle, cfg, has_bias):
    """The reference's bundle in the port's layout: node tables through
    the port's own node_tables (allocT channel-major, zone ids)."""
    b = {k: torch.tensor(np.asarray(v)) for k, v in jbundle.items()
         if k not in ("alloc", "zone")}
    b.update(TPK.node_tables(torch.tensor(np.asarray(jbundle["alloc"])),
                             torch.tensor(np.asarray(jbundle["zone"]))))
    b["layout"] = TPK.layout_for(cfg, has_bias)
    return b


def _carry_state(rs, jcl, B):
    N = jcl.allocatable.shape[0]
    req = np.asarray(jcl.requested).copy()
    extra = rs.randint(0, 3, size=(N,)).astype(np.float32)
    req[:, 0] += 100.0 * extra
    req[:, 3] += extra
    nz = np.asarray(jcl.nonzero_requested).copy()
    nz[:, 0] += 100.0 * extra
    live = rs.rand(B) < 0.85
    return req, nz, live


def world_bundle(seed, n_nodes, n_pods, with_bias):
    jcl, jb, cfg, _ = build_jax(seed, n_nodes, n_pods)
    from kubetpu.models.batch import densify_for
    jbd = densify_for(jcl, jax.tree.map(jnp.asarray, jb))
    static_ok, _, _ = jprog.run_filters(
        jcl, jbd, cfg, skip=("NodeResourcesFit", "NodePorts"))
    ports_ok0 = JK.node_ports_filter(jcl, jbd)
    pre = dict(jprog.static_raw_scores(jcl, jbd, cfg))
    pre["interpod_score"] = JK.interpod_score_pre(jcl, jbd)
    pre["default_spread"] = JK.default_spread_match_ns(jcl, jbd)
    B, N = jbd.req.shape[0], jcl.allocatable.shape[0]
    rs = np.random.RandomState(seed)
    bias = (jnp.asarray(rs.randint(-3, 4, size=(B, N)).astype(np.float32))
            if with_bias else None)
    jbundle = JPK.build_bundle(jcl, jbd, cfg, static_ok, ports_ok0, pre, bias,
                               jax_gumbel(jax.random.PRNGKey(seed), B, N))
    req, nz, live = _carry_state(rs, jcl, B)
    P = jbd.ports_hot.shape[1]
    ports_used = (rs.rand(N, P) < 0.3).astype(np.float32)
    return cfg, jbundle, live, req, nz, ports_used


def _compare(cfg, jbundle, has_bias, live, req, nz, ports_used, ctx,
             rows=None):
    """The Pallas kernel (interpret mode) against the port's propose.
    rows: window rows of the bundle (sentinels >= B allowed); the JAX
    side takes them as the JAX package's gang loop does, through
    gather_bundle, the port by index.  live is per window row."""
    N = jbundle["alloc"].shape[0]
    B = jbundle["mask"].shape[0]
    if rows is None:
        rows = np.arange(B, dtype=np.int64)
    jsub = JPK.gather_bundle(jbundle, jnp.asarray(rows.astype(np.int32)), B)
    jp, ja, jbest = JPK.propose(jsub, cfg, jnp.asarray(live),
                                jnp.asarray(req), jnp.asarray(nz),
                                jnp.asarray(ports_used), n_nodes=N,
                                interpret=True)
    tb = _port_bundle(jbundle, port_cfg(cfg), has_bias)
    tp, ta, tbest = TPK.propose(tb, torch.tensor(rows, dtype=torch.int64),
                                torch.tensor(live), torch.tensor(req),
                                torch.tensor(nz), torch.tensor(ports_used))
    assert_same(jp, tp, ctx + " prop")
    assert_same(ja, ta, ctx + " act")
    assert_same(jbest, tbest, ctx + " best")
    return np.asarray(ja)


@pytest.mark.parametrize("seed,n_nodes,n_pods,bias", [
    (0, 12, 9, False), (1, 37, 20, True), (2, 64, 48, False),
    (3, 150, 30, True)])
def test_plain_propose_matches_pallas(seed, n_nodes, n_pods, bias):
    cfg, jb, live, req, nz, pu = world_bundle(seed, n_nodes, n_pods, bias)
    act = _compare(cfg, jb, bias, live, req, nz, pu, f"world {seed}")
    assert act.any()


@pytest.mark.parametrize("seed", [4, 5])
def test_plain_propose_windowed_rows(seed):
    """A windowed sub-round: the port reads the window's rows of the
    whole-batch bundle by index (out of order, sentinels >= B padding the
    window with live False there -> the no-op proposal), the JAX package
    gathers them first."""
    cfg, jb, live, req, nz, pu = world_bundle(seed, 40, 30, seed % 2 == 1)
    B = jb["mask"].shape[0]
    rows = np.array([9, 3, B, 17, 1, 8, B + 5, 4, 0, B], np.int64)
    wlive = live[np.clip(rows, 0, B - 1)] & (rows < B)
    act = _compare(cfg, jb, seed % 2 == 1, wlive, req, nz, pu, "window",
                   rows=rows)
    assert not act[rows >= B].any() and act.any()


@pytest.mark.parametrize("Z", [1, 3, 8, 16])
def test_node_tables_zone_ids(Z):
    """node_tables' per-node zone id reproduces the one-hot zone_hot,
    nodes with no zone included (id -1), and a zone-less cluster (Z=0)
    becomes one all-zero column as in the JAX package's bundle."""
    rs = np.random.RandomState(Z)
    N = 57
    zone = np.zeros((N, Z), np.float32)
    zi = rs.randint(0, Z + 1, N)
    zone[np.arange(N)[zi < Z], zi[zi < Z]] = 1.0
    t = TPK.node_tables(torch.zeros(N, 5), torch.tensor(zone))
    assert t["zid"].dtype == torch.int32 and t["n_zones"] == Z
    assert_same(np.where(zi < Z, zi, -1).astype(np.int32), t["zid"], "zid")
    assert_same(zone, TPK.zone_onehot(t["zid"], t["n_zones"]), "zone_hot")
    # a world's zone_hot, built by the JAX package
    jcl, _, _, _ = build_jax(Z, 30, 4)
    zh = np.asarray(jcl.zone_hot)
    t = TPK.node_tables(torch.tensor(np.asarray(jcl.allocatable)),
                        torch.tensor(zh))
    assert_same(zh, TPK.zone_onehot(t["zid"], t["n_zones"]), "world")
    empty = TPK.node_tables(torch.zeros(N, 5), torch.zeros(N, 0))
    assert empty["n_zones"] == 1 and bool((empty["zid"] == -1).all())


def test_plain_propose_zero_feasible():
    cfg, jb, live, req, nz, pu = world_bundle(6, 20, 16, False)
    jb = dict(jb)
    mask = np.asarray(jb["mask"]).copy()
    mask[::2] = False
    jb["mask"] = jnp.asarray(mask)
    act = _compare(cfg, jb, False, live, req, nz, pu, "zero-feasible")
    assert not act[::2].any()


def synthetic(seed, W, N, with_bias, Z=8, scores=None, extreme=False):
    """A propose input built directly (the port's seeded world builder,
    handed to the JAX package as its bundle): N and W off every tile
    boundary, Z zones (more than 8 takes the CUDA kernel's shared-memory
    zone sums); scores: a layout other than the default family; extreme:
    division operands outside the CUDA kernel's fast division range."""
    w = PW.world(seed, W, N, with_bias, Z, scores, extreme=extreme)
    cfg = (jprog.ProgramConfig(scores=scores) if scores
           else jprog.ProgramConfig())
    assert JPK.plane_order(cfg, with_bias) == w["layout"].planes
    bundle = {k: jnp.asarray(w[k])
              for k in ("planes", "mask", "ipa_any", "skip", "breq", "bnz",
                        "bports", "alloc", "zone")}
    return cfg, bundle, w["live"], w["req"], w["nz"], w["ports_used"]


@pytest.mark.parametrize("seed,W,N,bias,Z", [
    (10, 37, 200, False, 8), (11, 130, 333, True, 8), (12, 5, 1000, False, 8),
    (13, 1, 129, True, 8), (14, 20, 300, True, 16)])
def test_plain_propose_synthetic_shapes(seed, W, N, bias, Z):
    cfg, jb, live, req, nz, pu = synthetic(seed, W, N, bias, Z)
    _compare(cfg, jb, bias, live, req, nz, pu, f"synthetic {seed}")


@pytest.mark.parametrize("seed,scores", [(18, None), (19, GENERIC_SCORES)])
def test_plain_propose_extreme_divisions(seed, scores):
    """Huge allocatable cpu and NodeAffinity raws near 2**-50: the
    divisions the CUDA kernel recomputes with __fdiv_rn, under both of
    its instantiations."""
    cfg, jb, live, req, nz, pu = synthetic(seed, 30, 257, True,
                                           scores=scores, extreme=True)
    _compare(cfg, jb, True, live, req, nz, pu, f"extreme {seed}")


def test_propose_refuses_unported_scores():
    cfg = TConfig(scores=(("RequestedToCapacityRatio", 1),))
    with pytest.raises(NotImplementedError):
        TPK.layout_for(cfg, False)


@pytest.mark.parametrize("seed", [16, 17])
def test_plain_propose_generic_layout(seed):
    """A layout other than the default family (Most/LeastAllocated,
    weights 2 and 3, a bias plane), with window rows out of order."""
    cfg, jb, live, req, nz, pu = synthetic(seed, 24, 150, True,
                                           scores=GENERIC_SCORES)
    rows = np.array([5, 2, 23, 24, 11, 0, 30], np.int64)
    wlive = live[np.clip(rows, 0, 23)] & (rows < 24)
    _compare(cfg, jb, True, wlive, req, nz, pu, "generic", rows=rows)
