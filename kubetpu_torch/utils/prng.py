"""Counter-based random numbers that reproduce jax.random's bits.

The scheduler's selectHost tie-break draws one gumbel row per pod from
``fold_in(PRNGKey(cycle), pod_row)``.  The placements depend on those
bits, so the port computes the same Threefry-2x32 stream that the JAX
package draws with ``jax_threefry_partitionable=True``:

* a key is a pair of 32-bit words; ``PRNGKey(seed)`` is ``(seed >> 32,
  seed & 0xffffffff)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key`` and
  the two output words are the new key; ``split(key, n)``'s key i hashes
  ``(i >> 32, i & 0xffffffff)``, so it is ``fold_in(key, i)``;
* ``random_bits(key, shape)`` hashes, for element ``i`` of the row-major
  flattened shape, the counter pair ``(i >> 32, i & 0xffffffff)`` and
  xors the two output words;
* ``uniform(key, shape, lo, 1)`` puts the top 23 bits into the mantissa
  of a float in [1, 2), subtracts 1, scales into [lo, 1) and clamps at lo;
* ``gumbel`` is the "low" mode, ``-log(-log(uniform(tiny, 1)))``, with
  XLA:CPU's f32 log (utils/xla_math.xla_log_f32).

Words live in int64 tensors masked to 32 bits, so every shift, add and
rotate is exact on both the CPU and the card.  Keys are int64 tensors of
shape ``[..., 2]``; a batch of keys draws a batch of rows.  Every draw
equals jax.random's bit for bit on the CPU and the card
(tests/test_torch_prng.py): torch's own ``log`` rounds differently from
XLA's in about a quarter of the gumbels, so the log is XLA's polynomial.

``select_plane`` draws a batch's selectHost rows at once.  The JAX
package's sequential replay draws ``jax.random.categorical(fold_in(rng,
i), logits)`` per pod, which is ``argmax(gumbel(fold_in(rng, i), (N,)) +
logits)``; its logits are 0 on the score ties and -2**62 elsewhere, and a
gumbel plus -2**62 rounds to -2**62, so the draw equals
``argmax(where(ties, gumbel_row, -2**62))`` with first-index ties — the
gang auction's tie-break over the same row.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .xla_math import xla_log_f32

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """Threefry-2x32 with 20 rounds over broadcastable int64 words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) as an int64 [2] tensor (0 <= seed < 2**32,
    the range a 32-bit JAX seed covers)."""
    if not 0 <= seed <= _M32:
        raise ValueError("PRNGKey seed must lie in [0, 2**32): %d" % seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """jax.random.fold_in for one key [2] and many data words [...]:
    returns keys [..., 2]."""
    data = data.to(torch.int64) & _M32
    h0, h1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([h0, h1], dim=-1)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """jax.random.split(key, num) under jax_threefry_partitionable=True:
    key i hashes the counter pair (i >> 32, i & 0xffffffff), which for
    num < 2**32 is fold_in(key, i).  Returns keys [num, 2]."""
    return fold_in(key, torch.arange(num, dtype=torch.int64,
                                     device=key.device))


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random words: keys [..., 2] -> int64 [..., *shape]."""
    n = 1
    for d in shape:
        n *= int(d)
    lead = keys.shape[:-1]
    idx = torch.arange(n, dtype=torch.int64,
                       device=keys.device).reshape((1,) * len(lead) + (n,))
    k1 = keys[..., 0].reshape(lead + (1,))
    k2 = keys[..., 1].reshape(lead + (1,))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(tuple(lead) + tuple(shape))


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    bits = random_bits(keys, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # filled on the device: no host->device copy
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.gumbel(key, shape, float32) in its default "low" mode."""
    u = uniform(keys, shape, _TINY, 1.0)
    return -xla_log_f32(-xla_log_f32(u))


def select_plane(rng: torch.Tensor, B: int, N: int) -> torch.Tensor:
    """The [B, N] selectHost plane of a batch: row i is
    ``gumbel(fold_in(rng, i), (N,))``, drawn on rng's device."""
    keys = fold_in(rng, torch.arange(B, dtype=torch.int64,
                                     device=rng.device))
    return gumbel(keys, (N,))
