"""Four-stream longwave solver (port of grtcode_tpu/solvers/longwave.py).

The per-wavenumber column of the reference becomes the vector axis and the
batch axis is written out; the two layer recurrences (down, then up) are
Python loops over layers holding all four streams of every column and
wavenumber at once.  Absorption-only: ``tau_eff = tau (1 - omega)``.

Shapes: tau/omega (..., nlayers, nw); t_surf (...,); t_layers
(..., nlayers); t_levels (..., nlevels); emis (..., nw); w (nw,).  Returns
per-wavenumber fluxes [W cm m-2], each (..., nlevels, nw).  Level 0 is the
top of the atmosphere.
"""
from __future__ import annotations

import torch

from .. import constants
from ..utils.graphs import device_constant
from .planck import effective_planck, planck_law


def longwave_fluxes(tau, omega, t_surf, t_layers, t_levels, emis, w):
    """Longwave up/down fluxes per wavenumber at every level."""
    tau_eff = tau * (1.0 - omega)
    nlayers = tau.shape[-2]
    c1 = device_constant(tuple(constants.LW_STREAM_SECANTS), tau.device,
                         tau.dtype)[:, None, None]          # (4, 1, 1)
    c2 = device_constant(tuple(constants.LW_STREAM_WEIGHTS), tau.device,
                         tau.dtype)[:, None]                # (4, 1)

    # Extinction per stream: exp(min(c1_j tau, MAX_EXP_ARG)).
    ext = torch.exp(torch.clamp(c1 * tau_eff[..., None, :, :],
                                max=constants.MAX_EXP_ARG))  # (..., 4, L, nw)

    # Effective Planck sources for the two passes.
    b_down = effective_planck(t_layers[..., None], t_levels[..., 1:, None],
                              w, tau_eff)                     # (..., L, nw)
    b_up = effective_planck(t_layers[..., None], t_levels[..., :-1, None],
                            w, tau_eff)

    def streams_sum(i4):
        return (c2 * i4).sum(-2)                              # (..., nw)

    # Downward pass: I_{i+1} = (1 - ext_i) B_i + I_i ext_i.
    i_down = torch.zeros_like(ext[..., 0, :])                 # (..., 4, nw)
    flux_down = [torch.zeros_like(tau[..., 0, :])]
    for i in range(nlayers):
        ext_i = ext[..., i, :]
        i_down = (1.0 - ext_i) * b_down[..., i, None, :] + i_down * ext_i
        flux_down.append(streams_sum(i_down))

    # Surface reflection + emission.
    e = emis[..., None, :]
    b_surf = planck_law(t_surf[..., None], w)[..., None, :]
    i_up = e * b_surf + (1.0 - e) * i_down

    # Upward pass, bottom layer to top.
    flux_up = [streams_sum(i_up)]
    for i in reversed(range(nlayers)):
        ext_i = ext[..., i, :]
        i_up = (1.0 - ext_i) * b_up[..., i, None, :] + i_up * ext_i
        flux_up.append(streams_sum(i_up))
    return (torch.stack(flux_up[::-1], dim=-2),
            torch.stack(flux_down, dim=-2))
