"""Float64 check of the port's solvers against the f64 reference-C goldens
(counterpart of the repo's ``tools/x64_validate.py``).

The production pipeline is float32 by design.  This check backs the
remaining precision claim with a float64 run: the port's LW and SW solvers
(``solvers.longwave.longwave_fluxes``, ``solvers.shortwave.shortwave_fluxes``),
which follow tau's dtype, run in float64 on the cases the compiled f64
reference harnesses dumped (``tests/data/lw_golden.txt``,
``sw_golden.txt``; the cases of ``tests/test_longwave.py`` and
``tests/test_shortwave.py``, copied here) and must agree to the goldens'
print precision: relative error with a floor of ``RTOL x`` the case's
largest flux, at most ``RTOL x 10``.  A result that is not float64 fails.

    python -m grtcode_tpu_torch.x64_validate [--device cuda:0|cpu]
        [--golden-dir DIR]

prints one line per comparison (8 LW, 12 SW), then ``X64 OK`` and exits 0,
or ``X64 FAILED`` and exits 1.  The default device is ``cuda:0``; without a
GPU it exits unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .solvers.longwave import longwave_fluxes
from .solvers.shortwave import shortwave_fluxes

RTOL = 3e-9   # goldens are printed at %.9e (10 significant digits)
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data")

# (nlevels, t_surf, emis, t_top, t_bottom, tau_scale, w0, dw, nw): the cases
# of tools/goldens/lw_harness.c (tests/test_longwave.py's CASES).
LW_CASES = [
    (11, 294.2, 0.98, 210.0, 290.0, 1.7, 200.0, 250.0, 12),
    (8, 300.0, 1.0, 230.0, 299.0, 80.0, 500.0, 100.0, 8),
    (21, 288.0, 0.9, 200.0, 287.0, 1e-6, 900.0, 300.0, 6),
    (5, 265.0, 0.35, 215.0, 260.0, 0.6, 1200.0, 400.0, 5),
]

# (nlevels, mu_dir, mu_dif, alpha_dir, alpha_dif, tau_scale, omega_base,
# g_base, nw): tools/goldens/sw_harness.c (tests/test_shortwave.py's CASES).
SW_CASES = [
    (11, 0.66277427, 0.5, 0.3, 0.25, 0.8, 0.9, 0.85, 10),
    (8, 0.9, 0.5, 0.1, 0.1, 2.0, 0.2, 0.4, 6),
    (6, 0.4, 0.5, 0.5, 0.45, 1.2, 1.0, 0.7, 6),
    (9, 0.7, 0.5, 0.2, 0.2, 50.0, 0.95, 0.8, 4),
    (12, 0.55, 0.5, 0.6, 0.55, 1e-7, 0.5, 0.3, 4),
    (7, 0.8, 0.5, 0.25, 0.2, 1.5, 0.0, 0.0, 4),
]


def lw_case_inputs(nlevels, t_top, t_bottom, tau_scale, w0, dw, nw):
    """(t_layers, t_levels, tau, w) of an LW case, as the harness makes
    them (tests/test_longwave.py's ``_case_inputs``)."""
    nlayers = nlevels - 1
    t_levels = t_top + (t_bottom - t_top) * np.arange(nlevels) / (nlevels - 1)
    t_layers = 0.5 * (t_levels[:-1] + t_levels[1:])
    w = w0 + dw * np.arange(nw)
    i = np.arange(nlayers)[:, None]
    tau = tau_scale * (0.5 + 0.5 * np.sin(0.01 * w[None, :] + i)) * \
        (i + 1) / nlayers
    tau = np.maximum(tau, 0.0)
    return t_layers, t_levels, tau, w


def sw_case_inputs(nlevels, tau_scale, omega_base, g_base, nw):
    """(tau, omega, g) of an SW case (tests/test_shortwave.py's
    ``_case_inputs``)."""
    nlayers = nlevels - 1
    i = np.arange(nlayers)[:, None]
    k = np.arange(nw)[None, :]
    tau = tau_scale * (0.3 + 0.7 * ((i + k) % 5) / 4.0)
    omega = np.minimum(omega_base * (0.5 + 0.5 * ((i * 3 + k) % 7) / 6.0), 1.0)
    g = g_base * ((i + 2 * k) % 4) / 3.0
    return tau, omega, g


def _golden_blocks(path, cases):
    """Each case's (nw, nlevels, 2) block of a golden file: per wavenumber,
    per level, up then down."""
    golden = np.loadtxt(path)
    offset = 0
    for case in cases:
        nlevels, nw = case[0], case[8]
        n = nlevels * nw * 2
        yield golden[offset:offset + n].reshape(nw, nlevels, 2)
        offset += n


def _compare(band, ci, fu, fd, block):
    """One record per flux direction: the worst relative error with the
    floor RTOL x the case's largest flux, and whether it is float64 and
    within RTOL x 10."""
    scale = block.max()
    out = []
    for got, ref, name in ((fu, block[:, :, 0].T, "up"),
                           (fd, block[:, :, 1].T, "down")):
        is64 = got.dtype == torch.float64
        g = got.detach().cpu().numpy()
        worst = float((np.abs(g - ref) / np.maximum(np.abs(ref),
                                                     RTOL * scale)).max())
        out.append(dict(band=band, case=ci, direction=name, max_rel=worst,
                        dtype=str(got.dtype),
                        ok=bool(is64 and worst <= RTOL * 10)))
    return out


def validate(device, golden_dir: str = GOLDEN_DIR) -> list[dict]:
    """Every comparison of both solvers in float64 on ``device``."""
    dev = torch.device(device)
    f64 = torch.float64

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=f64,
                               device=dev)

    records = []
    lw = _golden_blocks(os.path.join(golden_dir, "lw_golden.txt"), LW_CASES)
    for ci, (case, block) in enumerate(zip(LW_CASES, lw)):
        nlevels, t_surf, emis, t_top, t_bot, tau_scale, w0, dw, nw = case
        t_layers, t_levels, tau, w = lw_case_inputs(
            nlevels, t_top, t_bot, tau_scale, w0, dw, nw)
        fu, fd = longwave_fluxes(
            t(tau), torch.zeros((nlevels - 1, nw), dtype=f64, device=dev),
            t(t_surf), t(t_layers), t(t_levels),
            torch.full((nw,), emis, dtype=f64, device=dev), t(w))
        records += _compare("lw", ci, fu, fd, block)

    sw = _golden_blocks(os.path.join(golden_dir, "sw_golden.txt"), SW_CASES)
    for ci, (case, block) in enumerate(zip(SW_CASES, sw)):
        (nlevels, mu_dir, mu_dif, a_dir, a_dif, tau_s, om_b, g_b,
         nw) = case
        tau, omega, g = sw_case_inputs(nlevels, tau_s, om_b, g_b, nw)
        fu, fd = shortwave_fluxes(
            t(tau), t(omega), t(g), t(mu_dir), t(mu_dif),
            torch.full((nw,), a_dir, dtype=f64, device=dev),
            torch.full((nw,), a_dif, dtype=f64, device=dev), t(1.0),
            torch.ones((nw,), dtype=f64, device=dev))
        records += _compare("sw", ci, fu, fd, block)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; 'cpu' to run "
                         "without a GPU)")
    ap.add_argument("--golden-dir", default=GOLDEN_DIR,
                    help="directory of lw_golden.txt and sw_golden.txt "
                         "(default: the repository's tests/data)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device; pass "
                         "--device cpu to run on the CPU")
    records = validate(dev, args.golden_dir)
    for r in records:
        print(f"{r['band']} case {r['case']} {r['direction']}: max rel "
              f"{r['max_rel']:.2e} ({r['dtype']}) "
              f"{'ok' if r['ok'] else 'FAIL'}")
    failures = sum(not r["ok"] for r in records)
    if failures:
        print(f"X64 FAILED ({failures} of {len(records)} comparisons) on "
              f"{dev}")
        return 1
    print(f"X64 OK: float64 solvers match the f64 reference goldens to "
          f"print precision on {dev} ({len(records)} comparisons)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
