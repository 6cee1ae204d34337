"""The port's Threefry stream (kubetpu_torch/utils/prng.py) against
jax.random with jax_threefry_partitionable=True (pinned by the JAX
package, kubetpu/models/programs.py:29).

Keys, fold_in, random bits, uniforms and gumbels are compared bitwise.
The gumbel's two f32 logs are XLA:CPU's polynomial
(kubetpu_torch/utils/xla_math.xla_log_f32): torch's own log rounds
differently in about 23% of the gumbels.  xla_log_f32 is held against
jnp.log on a strided sweep of every positive normal float's bit patterns,
and its fused multiply-add (a float64 sum rounded to float32) against
exact arithmetic, on constructed cases whose float64 sum lands exactly on
a float32 midpoint.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubetpu.models.programs  # noqa: F401  (pins threefry_partitionable)
from kubetpu_torch.utils import prng
from kubetpu_torch.utils.xla_math import fma_f32, xla_log_f32
from tests.torch_port_util import (  # noqa: F401 (autouse fixtures)
    port_test_settings, release_jax_programs)

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
    """The port's gumbels equal jax.random.gumbel's bit for bit (this test
    once bounded a one-ulp difference and its rate; the rate is now 0)."""
    k = jax.random.PRNGKey(2024)
    keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(64))
    want = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(
        kk, (4096,), jnp.float32))(keys))
    got = prng.gumbel(prng.fold_in(prng.PRNGKey(2024), torch.arange(64)),
                      (4096,)).numpy()
    rate = float(np.mean(want.view(np.int32) != got.view(np.int32)))
    record_property("gumbel_ulp_mismatch_rate", rate)
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("seed,shape", [(0, (1,)), (3, (256, 4096)),
                                        (7, (5, 999)), (2**31 - 1, (3, 4, 33)),
                                        (2**32 - 1, (1000,))])
def test_gumbel_bitwise(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    # both logs' arguments are positive normals, xla_log_f32's domain
    tiny = float(np.finfo(np.float32).tiny)
    u = prng.uniform(prng.PRNGKey(seed), shape, tiny, 1.0)
    inner = -xla_log_f32(u)
    assert bool((u >= tiny).all()) and bool((inner >= tiny).all())
    assert bool((inner <= 88.0).all())


def test_select_plane_bitwise():
    """The selectHost plane: row i is gumbel(fold_in(rng, i), (N,))."""
    from tests.torch_port_util import jax_gumbel
    want = np.asarray(jax_gumbel(jax.random.PRNGKey(11), 37, 515))
    got = prng.select_plane(prng.PRNGKey(11), 37, 515).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("lo,hi,stride", [
    (0x00800000, 0x7F800000, 4099),      # every binade of positive normals
    (0x3F000000, 0x3F800000, 7),         # [0.5, 1): the polynomial's own range
    (0x3F800000, 0x40000000, 7)])        # [1, 2)
def test_xla_log_sweep(lo, hi, stride):
    x = np.arange(lo, hi, stride, dtype=np.int64).astype(np.uint32).view(
        np.float32)
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = xla_log_f32(torch.from_numpy(x.copy())).numpy()
    bad = np.nonzero(want.view(np.int32) != got.view(np.int32))[0]
    assert bad.size == 0, ("%d of %d differ, first x=%r"
                           % (bad.size, x.size, x[bad[:3]]))


def _round_f32(q: Fraction) -> np.float32:
    """An exact rational rounded to nearest float32, ties to even."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.float32(c).view(np.int32)) & 1))
    return np.float32(best)


def test_fma_double_rounding_guard():
    """a * b + c whose float64 sum is an exact float32 midpoint while the
    exact sum is not: the guard steps toward the exact side.  Naive
    float64-then-float32 rounding ties to even and gets both wrong."""
    u = np.float32(2.0 ** -23)
    a = np.float32(2.0 ** -24) * (np.float32(1) + u)
    cases = [(a, np.float32(1) - u, np.float32(1) + u),       # below: stays
             (a, -(np.float32(1) - u), np.float32(1) + 3 * u)]  # above: up
    for x, y, z in cases:
        exact = _round_f32(Fraction(float(x)) * Fraction(float(y))
                           + Fraction(float(z)))
        naive = np.float32(np.float64(x) * np.float64(y) + np.float64(z))
        assert naive != exact          # the case does hit the midpoint
        got = fma_f32(*[torch.tensor([v]) for v in (x, y, z)]).numpy()[0]
        assert got.view(np.int32) == exact.view(np.int32)
    # and random operands of the polynomial's magnitudes
    r = np.random.RandomState(0)
    x, y, z = (r.randn(3, 2000) * [[1.0], [0.3], [0.2]]).astype(np.float32)
    got = fma_f32(torch.from_numpy(x), torch.from_numpy(y),
                  torch.from_numpy(z)).numpy()
    want = np.array([_round_f32(Fraction(float(p)) * Fraction(float(q))
                                + Fraction(float(s)))
                     for p, q, s in zip(x, y, z)], np.float32)
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
