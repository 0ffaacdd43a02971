"""The port's native HITRAN scanner (``grtcode_tpu_torch.native``) and its
hook in ``gas_optics.hitran.parse_par_file``.

* the ``LineCatalog`` fields are byte-identical across the port's native
  path, the port's Python path and the JAX package's ``parse_par_file``,
  with and without a line-center window, on a file of mixed molecules
  and isotopologue codes;
* both bounds negative disable the window; a missing file is OSError and
  a short record ValueError on both paths;
* ``parse_par_file.parses`` counts the parses by path, and a library that
  cannot be built falls back to Python with one warning naming the
  error.
"""
import dataclasses
import logging
import os

import numpy as np
import pytest

from grtcode_tpu.gas_optics import hitran as jhitran
from grtcode_tpu_torch import native
from grtcode_tpu_torch.gas_optics import hitran


def _record(mol, iso_ch, vnn, snn, yair, yself, en, n, d):
    """One 160-char fixed-width HITRAN2012 record (tests/test_hitran.py)."""
    rec = (f"{mol:2d}{iso_ch}{vnn:12.6f}{snn:10.3E}" + " " * 10 +
           f"{yair:5.4f}"[:5] + f"{yself:5.3f}"[:5] +
           f"{en:10.4f}" + f"{n:4.2f}" + f"{d:8.6f}"[:8])
    return rec + " " * (160 - len(rec))


@pytest.fixture(scope="module")
def par(tmp_path_factory):
    path = tmp_path_factory.mktemp("par") / "mix.par"
    rng = np.random.default_rng(11)
    recs = []
    for i in range(400):
        recs.append(_record(int(rng.integers(1, 4)), "1A20"[i % 4],
                            float(rng.uniform(100, 5000)),
                            float(rng.uniform(1e-25, 1e-20)),
                            float(rng.uniform(0.01, 0.09)),
                            float(rng.uniform(0.1, 0.4)),
                            float(rng.uniform(0, 3000)),
                            float(rng.uniform(0.3, 0.9)),
                            float(rng.uniform(-0.009, 0.009))))
    path.write_text("\n".join(recs) + "\n")
    return str(path)


def _fields(cat):
    return {f.name: getattr(cat, f.name) for f in dataclasses.fields(cat)}


def _assert_same(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == fb[k].dtype and v.shape == fb[k].shape, k
            assert v.tobytes() == fb[k].tobytes(), k
        else:
            assert v == fb[k], k


@pytest.mark.parametrize("mol", [1, 2])
@pytest.mark.parametrize("window", [(-1.0, -1.0), (200.0, 4500.0),
                                    (1000.0, 1000.0)])
def test_native_python_and_jax_catalogs_are_byte_identical(par, mol, window,
                                                           monkeypatch):
    before = dict(hitran.parse_par_file.parses)
    got = hitran.parse_par_file(par, mol, *window)
    assert hitran.parse_par_file.parses["native"] == before["native"] + 1
    assert got.num_lines > 0 or window == (1000.0, 1000.0)
    want = jhitran.parse_par_file(par, mol, *window)
    _assert_same(got, want)
    monkeypatch.setattr(native, "parse_par_native", lambda *a, **k: None)
    py = hitran.parse_par_file(par, mol, *window)
    assert hitran.parse_par_file.parses["python"] == before["python"] + 1
    _assert_same(py, want)


def test_window_disabled_only_when_both_bounds_negative(par):
    everything = native.parse_par_native(par, 1)
    assert np.array_equal(native.parse_par_native(par, 1, -1.0, -5.0)[1],
                          everything[1])
    lo = native.parse_par_native(par, 1, -1.0, 3000.0)[1]
    assert 0 < lo.size < everything[1].size and lo.max() <= 3000.0
    assert hitran.parse_par_file(par, 1, -1.0, 3000.0).num_lines == lo.size


@pytest.mark.parametrize("path_kind", ["native", "python"])
def test_errors(tmp_path, path_kind, monkeypatch):
    if path_kind == "python":
        monkeypatch.setattr(native, "parse_par_native",
                            lambda *a, **k: None)
    with pytest.raises(OSError):
        hitran.parse_par_file(str(tmp_path / "missing.par"), 1)
    short = tmp_path / "short.par"
    short.write_text(_record(1, "1", 1000.0, 1e-20, 0.06, 0.3, 100.0, 0.5,
                             0.001) + "\n" + "1 1 1000.0\n")
    with pytest.raises(ValueError):
        hitran.parse_par_file(str(short), 1)


def test_native_return_codes(tmp_path):
    """A file that cannot be opened is OSError (rc -1 is too), rc -2 (a
    short record) ValueError, and the capacity is size // 161 + 2
    records."""
    with pytest.raises(OSError):
        native.parse_par_native(str(tmp_path / "missing.par"), 1)
    bad = tmp_path / "bad.par"
    bad.write_text("x" * 20 + "\n")
    with pytest.raises(ValueError, match="rc -2"):
        native.parse_par_native(str(bad), 1)
    one = tmp_path / "one.par"
    one.write_text(_record(1, "1", 1000.0, 1e-20, 0.06, 0.3, 100.0, 0.5,
                           0.001) + "\n")
    assert os.path.getsize(one) // 161 + 2 == 3
    assert native.parse_par_native(str(one), 1)[1].tolist() == [1000.0]


def test_unbuildable_library_warns_once_and_falls_back(par, monkeypatch,
                                                       caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    before = dict(hitran.parse_par_file.parses)
    with caplog.at_level(logging.WARNING, logger="grtcode_tpu_torch"):
        a = hitran.parse_par_file(par, 1)
        b = hitran.parse_par_file(par, 1)
    warned = [r for r in caplog.records if "native HITRAN" in r.message]
    assert len(warned) == 1 and "g++ not found" in warned[0].message
    assert hitran.parse_par_file.parses["python"] == before["python"] + 2
    assert hitran.parse_par_file.parses["native"] == before["native"]
    _assert_same(a, b)
    assert not native.available()
