"""The port's gang auction (kubetpu_torch/models/gang.py) against
kubetpu.models.gang.schedule_gang: every GangResult field — placements,
win scores, rounds, carries, diagnostics and the packed readback — is
bitwise equal, under kernel_backend "lax" and "pallas" (the JAX side in
interpret mode), at full width and with a small residual window, under
the same rng.  Both sides read identical state and the JAX gumbel plane
(see tests/test_torch_prng.py for why the plane is shared)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetpu.models import gang as jgang
from kubetpu_torch.models import gang as tgang
from tests.torch_port_util import (assert_same, build_jax, carry,
                                   jax_gumbel, port_cfg)

CASES = [
    # seed, nodes, pods, residual_window
    (0, 12, 40, 0),       # contended: many rounds, full-width loop
    (1, 37, 20, 512),     # window wider than the batch == full width
    (2, 6, 30, 4),        # deep windowed residual rounds
    (3, 64, 48, 8),
]


@pytest.mark.parametrize("backend", ["lax", "pallas"])
@pytest.mark.parametrize("seed,n_nodes,n_pods,rw", CASES)
def test_gang_matches_reference(seed, n_nodes, n_pods, rw, backend):
    jcl, jb, cfg, _ = build_jax(seed, n_nodes, n_pods)
    tcl, tb, _ = carry(jcl, jb)
    rng = jax.random.PRNGKey(seed + 11)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    gum = jax_gumbel(rng, B, N)
    want = jgang.schedule_gang(jcl, jb, cfg, rng, intra_batch_topology=False,
                               residual_window=rw, kernel_backend=backend)
    got = tgang.schedule_gang(tcl, tb, port_cfg(cfg),
                              torch.tensor(np.asarray(rng).astype(np.int64)),
                              intra_batch_topology=False, residual_window=rw,
                              kernel_backend=backend,
                              gumbel=torch.tensor(np.asarray(gum)))
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f"{backend} {f}")
    # the Python round loop reads the device once per round
    assert got.syncs == int(got.rounds)


@pytest.mark.parametrize("seed,n_nodes,n_pods,rw", [(7, 10, 70, 16),
                                                     (8, 24, 90, 32)])
def test_gang_windowed_pallas_drain(seed, n_nodes, n_pods, rw):
    """A windowed world (B > residual_window, so windows carry sentinel
    rows): the pallas sub-round, which reads the window's rows of the
    whole-batch bundle by index (device="cpu": the plain version), and
    the lax sub-round find the JAX package's placements and every
    GangResult field."""
    jcl, jb, cfg, _ = build_jax(seed, n_nodes, n_pods)
    tcl, tb, _ = carry(jcl, jb)
    rng = jax.random.PRNGKey(seed)
    B, N = jb.req.shape[0], jcl.allocatable.shape[0]
    assert B > rw
    gum = torch.tensor(np.asarray(jax_gumbel(rng, B, N)))
    want = jgang.schedule_gang(jcl, jb, cfg, rng, intra_batch_topology=False,
                               residual_window=rw, kernel_backend="pallas")
    got = {}
    for backend in ("pallas", "lax"):
        got[backend] = tgang.schedule_gang(
            tcl, tb, port_cfg(cfg),
            torch.tensor(np.asarray(rng).astype(np.int64)),
            intra_batch_topology=False, residual_window=rw,
            kernel_backend=backend, gumbel=gum)
        for f in want._fields:
            assert_same(getattr(want, f), getattr(got[backend], f),
                        f"{backend} {f}")
    assert int(want.rounds) > 1
    assert torch.equal(got["pallas"].chosen, got["lax"].chosen)


def test_gang_own_gumbel_matches_shared_plane():
    """Drawing the plane in the port (no gumbel argument) gives the same
    placements here: a 1-ulp log difference flips a tie only when two
    tied nodes' gumbels lie within an ulp."""
    jcl, jb, cfg, _ = build_jax(5, 20, 24)
    tcl, tb, _ = carry(jcl, jb)
    rng = jax.random.PRNGKey(3)
    want = jgang.schedule_gang(jcl, jb, cfg, rng, intra_batch_topology=False)
    got = tgang.schedule_gang(tcl, tb, port_cfg(cfg),
                              torch.tensor([0, 3]), intra_batch_topology=False)
    assert_same(want.chosen, got.chosen, "chosen")


def test_gang_refuses_topology():
    jcl, jb, cfg, _ = build_jax(0, 6, 4)
    tcl, tb, _ = carry(jcl, jb)
    with pytest.raises(NotImplementedError, match="intra-batch topology"):
        tgang.schedule_gang(tcl, tb, port_cfg(cfg), torch.tensor([0, 1]))


def test_gang_refuses_inexact_sums():
    jcl, jb, cfg, _ = build_jax(0, 6, 4)
    tcl, tb, _ = carry(jcl, jb)
    tb = tb._replace(req=tb.req + torch.where(tb.valid[:, None],
                                              float(2 ** 23), 0.0))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tgang.schedule_gang(tcl, tb, port_cfg(cfg), torch.tensor([0, 1]),
                            intra_batch_topology=False)
