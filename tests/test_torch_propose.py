"""The port's fused propose step (kubetpu_torch/ops/propose.py) against
the TPU kernel it replaces, kubetpu.ops.pallas_kernels.propose, run in
interpret mode on the CPU.  prop/act/best are compared bitwise over
churned worlds (ports, taints, zones, InterPodAffinity raws, a host bias
plane, windowed rows with sentinels, zero-feasible pods) and over
synthetic bundles whose N and W are not multiples of any tile.  The CUDA
kernel is held against the plain version on the card in the last test,
which skips here (no CUDA device on the CPU test machine)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.models import programs as jprog
from kubetpu.ops import kernels as JK
from kubetpu.ops import pallas_kernels as JPK
from kubetpu_torch.models.programs import ProgramConfig as TConfig
from kubetpu_torch.ops import propose as TPK
from tests.torch_port_util import (assert_same, build_jax, jax_gumbel,
                                   port_cfg)


def _port_bundle(jbundle, cfg, has_bias):
    """The reference's bundle in the port's layout: node tables
    channel-major through the port's own node_tables."""
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


def _compare(cfg, jbundle, has_bias, live, req, nz, ports_used, ctx):
    N = jbundle["alloc"].shape[0]
    jp, ja, jbest = JPK.propose(jbundle, cfg, jnp.asarray(live),
                                jnp.asarray(req), jnp.asarray(nz),
                                jnp.asarray(ports_used), n_nodes=N,
                                interpret=True)
    tb = _port_bundle(jbundle, port_cfg(cfg), has_bias)
    tp, ta, tbest = TPK.propose(tb, torch.tensor(live), torch.tensor(req),
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
    """A windowed sub-round: pod-side tensors row-gathered, the sentinel
    row B padding the window (live False there -> the no-op proposal)."""
    cfg, jb, live, req, nz, pu = world_bundle(seed, 40, 30, seed % 2 == 1)
    B = jb["mask"].shape[0]
    rows = np.array([1, 3, 4, 8, 9, 17, B, B], np.int32)
    jsub = JPK.gather_bundle(jb, jnp.asarray(rows), B)
    wlive = live[np.clip(rows, 0, B - 1)] & (rows < B)
    _compare(cfg, jsub, seed % 2 == 1, wlive, req, nz, pu, "window")
    tsub = TPK.gather_bundle(_port_bundle(jb, port_cfg(cfg), seed % 2 == 1),
                             torch.tensor(rows), B)
    for k in ("planes", "mask", "breq", "bports", "skip", "ipa_any"):
        assert_same(jsub[k], tsub[k], k)


def test_plain_propose_zero_feasible():
    cfg, jb, live, req, nz, pu = world_bundle(6, 20, 16, False)
    jb = dict(jb)
    mask = np.asarray(jb["mask"]).copy()
    mask[::2] = False
    jb["mask"] = jnp.asarray(mask)
    act = _compare(cfg, jb, False, live, req, nz, pu, "zero-feasible")
    assert not act[::2].any()


def synthetic(seed, W, N, with_bias, Z=8):
    """A propose input built directly: N and W off every tile boundary,
    Z zones (more than 8 takes the CUDA kernel's shared-memory zone
    sums)."""
    rs = np.random.RandomState(seed)
    cfg = jprog.ProgramConfig()
    order = JPK.plane_order(cfg, with_bias)
    planes = []
    for name in order:
        if name == "gumbel":
            planes.append(rs.gumbel(size=(W, N)))
        elif name == "ipa_raw":
            planes.append(rs.randint(-3, 4, (W, N)) * (rs.rand(W, 1) < 0.5))
        elif name == "bias":
            planes.append(rs.randint(-2, 3, (W, N)))
        else:
            planes.append(rs.randint(0, 4, (W, N)))
    R, P = 5, 8
    alloc = np.zeros((N, R), np.float32)
    alloc[:, 0], alloc[:, 1], alloc[:, 3] = 4000, 32768, 110
    alloc[:, 4] = rs.randint(0, 3, N)
    zone = np.zeros((N, Z), np.float32)
    zi = rs.randint(0, Z + 1, N)
    zone[np.arange(N)[zi < Z], zi[zi < Z]] = 1.0
    breq = np.zeros((W, R), np.float32)
    breq[:, 0] = rs.randint(0, 20, W) * 100
    breq[:, 1] = rs.randint(0, 16, W) * 256
    breq[:, 3] = 1
    breq[:, 4] = rs.randint(0, 2, W)
    mask = rs.rand(W, N) < 0.9
    mask[rs.rand(W) < 0.1] = False
    bundle = dict(
        planes=jnp.asarray(np.stack(planes).astype(np.float32)),
        mask=jnp.asarray(mask), ipa_any=jnp.asarray(rs.rand(W) < 0.5),
        skip=jnp.asarray(rs.rand(W) < 0.1), breq=jnp.asarray(breq),
        bnz=jnp.asarray(np.maximum(breq[:, :2], 100.0)),
        bports=jnp.asarray((rs.rand(W, P) < 0.1).astype(np.float32)),
        alloc=jnp.asarray(alloc), zone=jnp.asarray(zone))
    req = np.zeros((N, R), np.float32)
    req[:, 0] = rs.randint(0, 40, N) * 100
    req[:, 1] = rs.randint(0, 120, N) * 256
    req[:, 3] = rs.randint(0, 111, N)
    nz = req[:, :2].copy()
    pu = (rs.rand(N, P) < 0.1).astype(np.float32)
    return cfg, bundle, rs.rand(W) < 0.9, req, nz, pu


@pytest.mark.parametrize("seed,W,N,bias,Z", [
    (10, 37, 200, False, 8), (11, 130, 333, True, 8), (12, 5, 1000, False, 8),
    (13, 1, 129, True, 8), (14, 20, 300, True, 16)])
def test_plain_propose_synthetic_shapes(seed, W, N, bias, Z):
    cfg, jb, live, req, nz, pu = synthetic(seed, W, N, bias, Z)
    _compare(cfg, jb, bias, live, req, nz, pu, f"synthetic {seed}")


def test_propose_refuses_unported_scores():
    cfg = TConfig(scores=(("RequestedToCapacityRatio", 1),))
    with pytest.raises(NotImplementedError):
        TPK.layout_for(cfg, False)


def test_cuda_kernel_matches_plain():
    """On the card: the CUDA kernel equals the plain version bitwise
    (chip_smoke.py runs the same check at full width).  The last case
    takes the kernel's size-selected branches: 16 zones (shared-memory
    zone sums) and N > 16384 (feasibility recomputed in the second
    pass)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU or "
                    "interpret mode (run on the GPU machine)")
    for seed, W, N, bias, Z in [(10, 37, 200, False, 8),
                                (11, 130, 333, True, 8),
                                (15, 9, 17000, True, 16)]:
        cfg, jb, live, req, nz, pu = synthetic(seed, W, N, bias, Z)
        tb = _port_bundle(jb, port_cfg(cfg), bias)
        dev = {k: (v.cuda() if torch.is_tensor(v) else v)
               for k, v in tb.items()}
        args = [torch.tensor(x).cuda() for x in (live, req, nz, pu)]
        k = TPK.propose_cuda(dev, *args)
        p = TPK.propose_plain(dev, *args)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
