"""The port's Threefry stream (kubetpu_torch/utils/prng.py) against
jax.random with jax_threefry_partitionable=True (pinned by the JAX
package, kubetpu/models/programs.py:29).

Keys, fold_in, random bits and uniforms are compared bitwise.  The gumbel
transform's two logs are the one place the port and XLA:CPU may round
differently: measured on this suite's draws, about 23% of float32 gumbels
differ, by at most one ulp of max(|g|, 1) (torch's CPU log vs XLA's;
near g = 0 the outer log cancels, so the bound is absolute there).  That is why the gang/propose tests hand both sides the JAX
gumbel plane; the test below pins that bound and reports the rate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu.models.programs  # noqa: F401  (pins threefry_partitionable)
from kubetpu_torch.utils import prng

SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**32 - 1]


def _jax_key(seed):
    return np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_bitwise(seed):
    np.testing.assert_array_equal(_jax_key(seed), prng.PRNGKey(seed).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bitwise(seed):
    data = np.array([0, 1, 2, 3, 511, 4095, 2**20, 2**31 - 1], np.int32)
    k = jax.random.PRNGKey(seed)
    want = jax.vmap(lambda d: jax.random.fold_in(k, d))(jnp.asarray(data))
    got = prng.fold_in(prng.PRNGKey(seed), torch.tensor(data))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (64,), (3, 5), (2, 3, 17)])
@pytest.mark.parametrize("seed", [0, 3, 99])
def test_random_bits_bitwise(seed, shape):
    k = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(5))
    want = jax.vmap(lambda kk: jax.random.bits(kk, shape))(keys)
    got = prng.random_bits(prng.fold_in(prng.PRNGKey(seed), torch.arange(5)),
                           shape)
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())


@pytest.mark.parametrize("seed", [0, 5])
def test_uniform_bitwise(seed):
    tiny = float(np.finfo(np.float32).tiny)
    k = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(16))
    for lo in (0.0, tiny):
        want = jax.vmap(lambda kk: jax.random.uniform(
            kk, (999,), jnp.float32, minval=lo, maxval=1.0))(keys)
        got = prng.uniform(prng.fold_in(prng.PRNGKey(seed), torch.arange(16)),
                           (999,), lo, 1.0)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_gumbel_within_one_ulp_and_rate(record_property):
    k = jax.random.PRNGKey(2024)
    keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(64))
    want = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(
        kk, (4096,), jnp.float32))(keys))
    # One intra-op thread: in a pytest-xdist worker, torch's CPU build
    # has been seen to miscompute one thread's share (~1/8 of the values,
    # errors ~1e-4) of the process's FIRST multi-threaded vectorised
    # exp/log; later calls are right.  The draw here is large enough to go
    # parallel, so pin it to one thread to measure the log, not that race.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = prng.gumbel(prng.fold_in(prng.PRNGKey(2024), torch.arange(64)),
                          (4096,)).numpy()
    finally:
        torch.set_num_threads(threads)
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    ratio = np.abs(want - got) / ulp
    worst = int(np.argmax(ratio))
    assert ratio.flat[worst] <= 1.0, (
        "gumbel off by more than one ulp of max(|g|, 1): %d values, worst "
        "%r (jax) vs %r (port)" % (int((ratio > 1).sum()), want.flat[worst],
                                   got.flat[worst]))
    rate = float(np.mean(want != got))
    record_property("gumbel_ulp_mismatch_rate", rate)
    print("gumbel ulp-mismatch rate vs jax (CPU): %.4f" % rate)
    assert rate < 0.5
