"""Tensorization parity: the port's SnapshotBuilder / PodBatchBuilder give
the JAX package's arrays and pad buckets on the same world, and the
carry-across (JAX leaves -> numpy -> port tensors) keeps every leaf's
value, dtype and shape.  Bitwise."""
import jax
import numpy as np
import pytest
import torch

from kubetpu_torch.models.batch import batch_to_device
from kubetpu_torch.state.tensors import ClusterTensors
from tests.torch_port_util import (assert_same, build_jax, build_port,
                                   carry, to_numpy_tree)
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

WORLDS = [(0, 12, 9), (1, 37, 20), (2, 64, 48)]


def _walk(a, b, ctx):
    """Compare a JAX-side leaf tree with a port-side one leaf by leaf."""
    if hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__, ctx
        for f in a._fields:
            _walk(getattr(a, f), getattr(b, f), f"{ctx}.{f}")
    elif a is None:
        assert b is None, ctx
    else:
        assert_same(a, b, ctx)


@pytest.mark.parametrize("seed,n_nodes,n_pods", WORLDS)
@pytest.mark.parametrize("terms", [False, True])
def test_snapshot_builder_matches_reference(seed, n_nodes, n_pods, terms):
    _, _, _, jhost = build_jax(seed, n_nodes, n_pods, terms)
    thost, _ = build_port(seed, n_nodes, n_pods, terms)
    ja, ta = jhost.arrays, thost.arrays
    assert set(ja) == set(ta)
    for k in ja:
        if k == "_pod_rows":
            # uid -> row; uids come from each package's own process-wide
            # counter, so compare the rows in pod order, not the uid keys
            assert list(ja[k].values()) == list(ta[k].values()), k
        elif k == "_kv_cap":
            assert ja[k] == ta[k], k
        elif k in ("filter_terms", "score_terms"):
            _walk(ja[k], ta[k], k)
        else:
            assert_same(ja[k], ta[k], k)
    # the pad buckets the gumbel plane and every kernel shape depend on
    for k in ("allocatable", "pod_node", "_kv_ids", "_pod_kv_ids"):
        assert ja[k].shape == ta[k].shape, k


@pytest.mark.parametrize("seed,n_nodes,n_pods", WORLDS)
@pytest.mark.parametrize("terms", [False, True])
def test_pod_batch_builder_matches_reference(seed, n_nodes, n_pods, terms):
    _, jbatch, _, _ = build_jax(seed, n_nodes, n_pods, terms)
    _, tbatch = build_port(seed, n_nodes, n_pods, terms)
    _walk(jbatch, tbatch, "batch")
    assert jbatch.req.shape[0] == tbatch.req.shape[0]   # B = pow2_bucket


@pytest.mark.parametrize("seed,n_nodes,n_pods", WORLDS)
def test_to_device_matches_reference(seed, n_nodes, n_pods):
    """HostClusterArrays.to_device densifies kv/pod_kv like the JAX
    package, and copies (never aliases) the host mirror."""
    jcl, _, _, _ = build_jax(seed, n_nodes, n_pods, True)
    thost, _ = build_port(seed, n_nodes, n_pods, True)
    tcl = thost.to_device("cpu")
    _walk(jcl, tcl, "cluster")
    before = thost.arrays["requested"].copy()
    tcl.requested.add_(1.0)
    np.testing.assert_array_equal(thost.arrays["requested"], before)


@pytest.mark.parametrize("seed,n_nodes,n_pods", WORLDS)
def test_carry_across_round_trip(seed, n_nodes, n_pods):
    jcl, jb, _, _ = build_jax(seed, n_nodes, n_pods, True)
    tcl, tb, jb_dense = carry(jcl, jb)
    assert isinstance(tcl, ClusterTensors)
    _walk(jcl, tcl, "cluster")
    _walk(jb_dense, tb, "batch")
    # and back: numpy leaves of the port tensors equal the originals
    back = jax.tree.map(lambda x: x.numpy(), tb)
    _walk(jb_dense, back, "batch-back")


def test_batch_to_device_copies():
    _, tbatch = build_port(0, 12, 9)
    dev = batch_to_device(tbatch, "cpu")
    dev.req.add_(1.0)
    assert not np.array_equal(np.asarray(tbatch.req), dev.req.numpy())
    assert isinstance(dev.ra.valid, torch.Tensor)
