"""Regularized incomplete beta function and its inverse (port of
grtcode_tpu/clouds/beta.py).

PyTorch has no ``betainc``.  The cloud sampler only calls it with integer
shape parameters, where it is a finite binomial sum,

    I_x(p, q) = sum_{j=p}^{n} C(n, j) x^j (1 - x)^(n - j),  n = p + q - 1,

evaluated here in float64 (powers by repeated multiplication, so every
device gives the same value) and rounded to float32.  The inverse is the
JAX package's fixed-iteration bisection: 40 halvings of [0, 1] with the
same comparison.
"""
from __future__ import annotations

from math import comb

import torch


def _integer(v, name):
    if float(v) != int(v) or int(v) < 1:
        raise ValueError(f"{name}={v!r}: the binomial form of I_x(p, q) "
                         "needs positive integer shape parameters")
    return int(v)


def _betainc(p: int, q: int, x: torch.Tensor) -> torch.Tensor:
    """I_x(p, q) of float32 ``x`` in [0, 1], as float32."""
    n = p + q - 1
    x = x.to(torch.float64)
    xp = [torch.ones_like(x)]
    yp = [torch.ones_like(x)]
    for _ in range(n):
        xp.append(xp[-1] * x)
        yp.append(yp[-1] * (1.0 - x))
    total = torch.zeros_like(x)
    for j in range(p, n + 1):
        total = total + comb(n, j) * xp[j] * yp[n - j]
    return total.to(torch.float32)


def beta_value(p, q, x) -> torch.Tensor:
    """Regularized incomplete beta I_x(p, q) for integer p, q, x clipped
    to [0, 1]."""
    p, q = _integer(p, "p"), _integer(q, "q")
    x = torch.clamp(torch.as_tensor(x, dtype=torch.float32), 0.0, 1.0)
    return _betainc(p, q, x)


def beta_inverse(p, q, y, iters: int = 40) -> torch.Tensor:
    """x such that I_x(p, q) = y, by bisection on the monotone CDF."""
    p, q = _integer(p, "p"), _integer(q, "q")
    y = torch.clamp(torch.as_tensor(y, dtype=torch.float32), 0.0, 1.0)
    lo, hi = torch.zeros_like(y), torch.ones_like(y)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = _betainc(p, q, mid) < y
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)
