"""XLA:CPU's float32 ``log``, bit for bit, in PyTorch.

The JAX package takes two f32 logs whose bits reach a placement: the
selectHost gumbel plane (``jax.random.gumbel`` = ``-log(-log(u))``) and
the soft-spread weight ``log(size + 2)`` (podtopologyspread/scoring.go:286,
``kubetpu/ops/kernels.py``).  XLA:CPU does not round its log correctly: it
evaluates Cephes' ``logf`` polynomial (Eigen's ``plog_float``) with fused
multiply-adds.  torch's own ``log`` rounds differently in about a quarter
of the gumbels, and a correctly rounded log differs at 172 weights up to
size 20,000.  ``xla_log_f32`` reproduces that polynomial step by step:

    m, e = frexp(x)                  m in [0.5, 1)
    small = m < sqrt(1/2);  t = (m - 1) + (small ? m : 0);  e -= small
    x2 = t*t;  x3 = x2*t
    y  = fma(p0, t, p1);  y1 = fma(p3, t, p4);  y2 = fma(p6, t, p7)
    y  = fma(y, t, p2);   y1 = fma(y1, t, p5);  y2 = fma(y2, t, p8)
    y  = fma(y, x3, y1);  y  = fma(y, x3, y2);  y = fma(y, x3, f32(e*q1))
    r  = f32(fma(x2, -0.5, t) + y);  r = fma(e, q2, r)

torch has no fused multiply-add, so each ``fma`` runs in float64: the
product of two floats is exact there, the add rounds once to float64 and
the result rounds to float32.  That second rounding is wrong only when
the float64 sum lands exactly on a float32 midpoint while the exact sum
does not: the TwoSum residual of the add says which side the exact sum
lies on, and the sum steps one float64 ulp that way before rounding.
The same tensor ops run on the CPU and the card.

The domain is the positive normal floats (the gumbel's ``u >= tiny`` and
``-log(u)`` in (0, 87.4], the weight's ``size + 2 >= 2``): zero,
denormals, infinities and NaN are not handled.
"""

from __future__ import annotations

import torch

# Cephes logf (Eigen plog_float)
_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
      -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
      2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_Q1 = -2.12194440e-4
_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524
_HALF_F32_ULP = 1 << 28     # an f32 midpoint's low 29 f64 mantissa bits
_LOW29 = (1 << 29) - 1


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """a * b + c rounded once to float32, for float32 operands whose
    results stay normal (the polynomial's range)."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b                       # exact: 24 + 24 bits
    s = p + c
    # TwoSum residual of s = p + c: the exact p + c is s + err
    bp = s - c
    err = (c - (s - bp)) + (p - bp)
    mid = (s.view(torch.int64) & _LOW29) == _HALF_F32_ULP
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(mid & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's ``jnp.log`` of float32 ``x`` (positive normals)."""
    x = x.to(torch.float32)
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    small = m < _f32(_SQRTHF, x)
    zero = torch.zeros_like(m)
    t = (m - 1.0) + torch.where(small, m, zero)
    e = e - torch.where(small, torch.ones_like(e), zero)
    x2 = t * t
    x3 = x2 * t
    p = [_f32(v, x) for v in _P]
    y = fma_f32(p[0], t, p[1])
    y1 = fma_f32(p[3], t, p[4])
    y2 = fma_f32(p[6], t, p[7])
    y = fma_f32(y, t, p[2])
    y1 = fma_f32(y1, t, p[5])
    y2 = fma_f32(y2, t, p[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * _f32(_Q1, x))
    r = fma_f32(x2, _f32(-0.5, x), t) + y
    return fma_f32(e, _f32(_Q2, x), r)
