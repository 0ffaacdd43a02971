"""The traffic generator: the same calls for the same seed, other calls
for another, the same work for every seed, every key warmed up, and the
program's rule for which calls day compaction splits.  Every mix file is
tested, also those that no cell names yet."""
import collections

import numpy as np
import pytest

from grtcode_tpu_torch.framework.driver import bucket_pad
from rtbench import deployment, traffic

from ._files import MIXES, config, mix as mix_file


def _calls(name, seed, smoke=False):
    dep = deployment.build(config("rfmip_irf_fine"), seed, smoke=smoke)
    mix = mix_file(name)
    return dep, mix, traffic.calls(mix, dep, seed)


def _flat(calls):
    return np.concatenate([np.r_[c.expts, c.sites, c.mu] for c in calls])


@pytest.mark.parametrize("cell", MIXES)
def test_deterministic_per_seed_and_different_across_seeds(cell):
    seed = 2 ** 31 + 17
    _, _, a = _calls(cell, seed)
    _, _, b = _calls(cell, seed)
    _, _, c = _calls(cell, seed + 1)
    assert np.array_equal(_flat(a), _flat(b))
    assert not np.array_equal(_flat(a), _flat(c))


def test_inputs_deterministic_per_seed():
    cfg = config("rfmip_irf")
    one, two = (deployment.build(cfg, 5, smoke=True) for _ in range(2))
    other = deployment.build(cfg, 6, smoke=True)
    for mol, p in one.bands["lw"].lines.items():
        assert np.array_equal(p["vnn"], two.bands["lw"].lines[mol]["vnn"])
        assert not np.array_equal(p["s0"],
                                  other.bands["lw"].lines[mol]["s0"])
    assert np.array_equal(one.profiles["t_lev"], two.profiles["t_lev"])


@pytest.mark.parametrize("cell", MIXES)
def test_every_seed_runs_the_same_work(cell):
    """The same multiset of (columns, lit columns) per call for any seed
    where the mix sets the lit columns; with the sites' own angles every
    call is of one size, more than half lit (one masked batch) and lit
    alike to a column, whatever the seed."""
    mix = _calls(cell, 1)[1]
    if mix["zenith"] == "lit_pattern":
        def shape(seed):
            return collections.Counter((c.size, c.lit)
                                       for c in _calls(cell, seed)[2])
        assert shape(1) == shape(2 ** 31 + 99)
    else:
        for seed in (1, 2 ** 31 + 99):
            calls = _calls(cell, seed)[2]
            lit = [c.lit for c in calls]
            assert {c.size for c in calls} == {calls[0].size}
            assert max(lit) - min(lit) <= 1 and min(lit) > calls[0].size / 2


@pytest.mark.parametrize("cell", MIXES)
def test_each_column_takes_its_sites_sun(cell):
    """Every site's own angle with ``"site"``, the sun anywhere in the sky
    with ``"lit_pattern"``: no mix keeps the sun low."""
    dep, mix, calls = _calls(cell, 12)
    mu = np.concatenate([c.mu for c in calls])
    assert -1.0 <= mu.min() and mu.max() <= 1.0
    if mix["zenith"] == "lit_pattern":
        assert mu.max() > 0.9 and mu.min() < -0.9
    else:
        sites = np.concatenate([c.sites for c in calls])
        assert np.all(dep.profiles["mu_site"][sites] == mu)


def test_half_lit_pattern_and_its_keys():
    _, mix, calls = _calls("seg8_halflit", 8)
    pattern = sorted(mix["lit_per_call"])
    n = len(pattern)
    for b in range(0, len(calls), n):
        assert sorted(c.lit for c in calls[b:b + n]) == pattern
    assert sum(pattern) * 2 == 8 * n            # half of the columns lit
    warm = traffic.warmup(calls)
    assert sorted({c.lit for c in warm}) == sorted(set(pattern))
    assert len(warm) == 2 * len(set(pattern))
    mu = np.concatenate([c.mu for c in calls])
    assert mu.min() > -1.0 and mu.max() <= 1.0


@pytest.mark.parametrize("cell", MIXES)
def test_checked_columns_hold_a_lit_and_a_night_one(cell):
    _, mix, calls = _calls(cell, 4)
    picked = traffic.checked(calls[:5], mix["checked_columns"], 4)
    assert len(picked) == len(set(picked)) == mix["checked_columns"]
    lit = [calls[i].mu[j] > 0 for i, j in picked]
    assert lit[0] and not lit[1]


def test_compaction_is_the_programs_rule():
    for B in range(1, 34):
        for lit in range(B + 1):
            mu = np.r_[np.ones(lit), -np.ones(B - lit)]
            call = traffic.Call(np.zeros(B, int), np.zeros(B, int), mu)
            split = 0 < lit < B and \
                bucket_pad(np.arange(lit), B).size < B
            assert call.compacted == split, (B, lit)


def test_a_compacted_call_gives_the_first_lit_and_night_columns():
    _, mix, calls = _calls("seg8_halflit", 8)
    assert any(c.compacted for c in calls)
    for seed in range(20):
        (i, j), (k, m) = traffic.checked(calls, mix["checked_columns"],
                                         seed)[:2]
        assert i == k and calls[i].compacted
        assert calls[i].mu[j] > 0.0 >= calls[k].mu[m]
