"""The deployments and reference fluxes of the kept configurations, pinned:
sha256 digests of every band array, the solar spectrum, the
``Atmosphere`` the program is given for every column of the smoke cut
(profiles, sun and surface spectra), and one lit column's float64
reference fluxes on the CPU, at two seeds.  The digests were taken before
the columns moved into ``rtbench/layouts/`` and the shortwave solver into
``rtbench/reference/sw_two_stream.py``; a change that moves what the
benchmark feeds either side for these configurations shows here."""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from rtbench import deployment, program
from rtbench.reference import rt

from ._files import config

# (configuration, seed): digests of (bands, solar, atmosphere, fluxes).
PINNED = {
    ("rfmip_irf", 7): (
        "924d84bc0ff31021e6c6056f2b25907900e2b852e2b2aa403d6d975555d88790",
        "08ef54b8c9a631d377d928030d56b8715b704d4bbf1be1136fa63daa6147c85d",
        "5d91e6fc565f956358539874f80a71f7bfcb67b277556d6382476b6fbdc624ca",
        "678d446191879db036ba5408d337291242b4103c9b677606bac5d4876ce79593",
    ),
    ("rfmip_irf", 2147483653): (
        "8e896857e6851fe7ed7ab6da51746452ae7bbe791ada9eceac3da799ff80fa19",
        "08ef54b8c9a631d377d928030d56b8715b704d4bbf1be1136fa63daa6147c85d",
        "b7eafd267dbd6c2a4d641ecb5fb9c23f7a3e95a289b5a02117af93706bbe50c8",
        "fa6bd0c392f2d9b9ecfe364d2833d6a2c9c45b652d3bbcb6dfe1b6c0ade97651",
    ),
    ("rfmip_irf_fine", 7): (
        "a5445ab66f77aab41f4941944a7eb40976d044cdf1715b9040bb0c04a89f9d11",
        "08ef54b8c9a631d377d928030d56b8715b704d4bbf1be1136fa63daa6147c85d",
        "5d91e6fc565f956358539874f80a71f7bfcb67b277556d6382476b6fbdc624ca",
        "ff399654beeb071488d23d69bbb2e32a215d0697fa98b23e51ae405bf74e2349",
    ),
    ("rfmip_irf_fine", 2147483653): (
        "a3d375497e5c7bf9e3c2dec115dda5e91e31045d5e3a1e8440304c8ff99b95d2",
        "08ef54b8c9a631d377d928030d56b8715b704d4bbf1be1136fa63daa6147c85d",
        "b7eafd267dbd6c2a4d641ecb5fb9c23f7a3e95a289b5a02117af93706bbe50c8",
        "f3e2fd10e95e2d1518d902d9fc720fd4846f86a5d83323bd6069a740cdd12915",
    ),
    ("rfmip_irf_fine_lw", 7): (
        "d149246cb48da8da87f4ca01a06daf38499d331c5170e2a1aa21f78ab19f3844",
        "dc937b59892604f5a86ac96936cd7ff09e25f18ae6b758e8014a24c7fa039e91",
        "5d91e6fc565f956358539874f80a71f7bfcb67b277556d6382476b6fbdc624ca",
        "a56ddbc311f679cbe391f4d7bea8a8c34a57caa0c93a95076f9b88d352d3a608",
    ),
    ("rfmip_irf_fine_lw", 2147483653): (
        "beb3473b0ee1cc0e4accee5a5f6ee28d17ebc8b2759848a17e3375e7808dd789",
        "dc937b59892604f5a86ac96936cd7ff09e25f18ae6b758e8014a24c7fa039e91",
        "b7eafd267dbd6c2a4d641ecb5fb9c23f7a3e95a289b5a02117af93706bbe50c8",
        "e4c0a584ae1f5b9b1561579725cef950051b0e395e398f93a68b046a4d875407",
    ),
    ("rfmip_irf_lw", 7): (
        "7922767f6b42cca80eea2eb24258d88e9da1e2cdee874e5b26ed953d2dd565e6",
        "dc937b59892604f5a86ac96936cd7ff09e25f18ae6b758e8014a24c7fa039e91",
        "5d91e6fc565f956358539874f80a71f7bfcb67b277556d6382476b6fbdc624ca",
        "074986755b970c44270583a9e0e283eea19663c5bef65b363e5754f4ed3ddd02",
    ),
    ("rfmip_irf_lw", 2147483653): (
        "272ec5ec6f400e20f78e720915456287ce1f15d87513f0dbb4b771e7ace33dde",
        "dc937b59892604f5a86ac96936cd7ff09e25f18ae6b758e8014a24c7fa039e91",
        "b7eafd267dbd6c2a4d641ecb5fb9c23f7a3e95a289b5a02117af93706bbe50c8",
        "26324c1a1ebdfb2581d3d2efd17d1dfa42066893e8df168663206f7634e16f54",
    ),
}


def _feed(h, value):
    if value is None or isinstance(value, (bool, str)):
        h.update(repr(value).encode())
    elif isinstance(value, dict):
        for k in sorted(value, key=str):
            h.update(repr(k).encode())
            _feed(h, value[k])
    elif isinstance(value, (list, tuple)):
        for v in value:
            _feed(h, v)
    else:
        a = np.ascontiguousarray(np.asarray(value, np.float64))
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())


def digest(value) -> str:
    h = hashlib.sha256()
    _feed(h, value)
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_kept_configurations_are_bit_identical(name, seed):
    torch.set_num_threads(2)
    dep = deployment.build(config(name), seed, smoke=True)
    bands = {b: {f.name: getattr(band, f.name)
                 for f in dataclasses.fields(band)}
             for b, band in dep.bands.items()}
    e, s = np.meshgrid(np.arange(dep.experiments), np.arange(dep.sites),
                       indexing="ij")
    e, s = e.ravel(), s.ravel()
    atm = program.atmosphere(dep.columns(e, s, dep.profiles["mu_site"][s]))
    fields = {f.name: getattr(atm, f.name) for f in dataclasses.fields(atm)}
    ref = rt.column_fluxes(dep, dep.column(1, 2, 0.6))
    got = tuple(digest(v) for v in (bands, dep.solar, fields, ref))
    assert got == PINNED[(name, seed)]
