"""Stochastic cloud subcolumns (port of grtcode_tpu/clouds/stochastic.py).

The JAX package draws with ``jax.random``; :mod:`..utils.prng` draws the
same bits, so each column's subcolumn here is the one JAX draws from the
same key.  Every function is batched over leading column axes: ``keys`` is
``(..., 2)`` and the per-layer fields ``(..., nlayers)``.  The draws
(:func:`cloudiness`) are kept apart from the transforms
(:func:`condensate_from_cloudiness`), so the transforms can be tested with
given uniforms.
"""
from __future__ import annotations

import torch

from ..utils import prng
from .beta import beta_inverse, beta_value


def overlap_parameter(altitude, scale_length):
    """Exponential-decorrelation overlap alpha_i = exp(-|z_i - z_{i+1}| /
    L); altitude (..., nlayers) [km], returns (..., nlayers - 1)."""
    z = torch.as_tensor(altitude)
    return torch.exp(-torch.abs(z[..., :-1] - z[..., 1:]) / scale_length)


def cloudiness(keys, overlap, num_layers: int) -> torch.Tensor:
    """Rank-correlated random cloudiness per layer: layer i+1 copies layer
    i's rank with probability overlap[i].  ``keys`` (..., 2) each split
    into the layer draws and the copy draws, as the JAX function splits
    its key.  Returns (..., nlayers) uniforms in [0, 1)."""
    kx, kr = prng.split(keys, 2).unbind(-2)
    x = prng.uniform(kx, num_layers)
    r = prng.uniform(kr, num_layers - 1)
    if not isinstance(overlap, torch.Tensor):      # an array-like
        overlap = torch.as_tensor(overlap)
    overlap = overlap.to(x.device)
    out = [x[..., 0]]
    for i in range(1, num_layers):
        out.append(torch.where(r[..., i - 1] <= overlap[..., i - 1],
                               out[-1], x[..., i]))
    return torch.stack(out, dim=-1)


def condensate_from_cloudiness(x, cloud_fraction, lwc, iwc, p: int = 5,
                               q: int = 5):
    """The liquid / ice condensate of a subcolumn with cloudiness ``x``,
    drawn from the total-water beta PDF: zero where the layer is clear
    (``x <= 1 - cloud_fraction``)."""
    cf = torch.as_tensor(cloud_fraction, dtype=torch.float32)
    lw = torch.as_tensor(lwc, dtype=torch.float32)
    iw = torch.as_tensor(iwc, dtype=torch.float32)
    cloudy = x > (1.0 - cf)
    qs, xs = beta_inverse(p, q, torch.stack([1.0 - cf, x])).unbind(0)
    # Width (b - a) of the PDF (alpha ignored, as in the reference).
    denom = (p / float(p + q)) * (1.0 - beta_value(p + 1, q, qs)) - qs * cf
    total_water = lw + iw
    w = torch.where(torch.abs(denom) > 1e-12, total_water / denom, 0.0)
    total_condensate = w * (xs - qs)
    liquid_fraction = torch.where(
        total_water > 0.0, lw / torch.clamp(total_water, min=1e-30), 0.0)
    ql = torch.where(cloudy, total_condensate * liquid_fraction, 0.0)
    qi = torch.where(cloudy, total_condensate * (1.0 - liquid_fraction), 0.0)
    return ql, qi


def sample_condensate(keys, cloud_fraction, lwc, iwc, overlap, p: int = 5,
                      q: int = 5):
    """Draw the liquid / ice condensate of one subcolumn per key: (ql, qi)
    each (..., nlayers), zero where the subcolumn is clear."""
    cf = torch.as_tensor(cloud_fraction, dtype=torch.float32)
    x = cloudiness(keys, overlap, cf.shape[-1])
    return condensate_from_cloudiness(x, cf, lwc, iwc, p, q)
