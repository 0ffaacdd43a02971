"""The one traffic generator: a mix file's parameters, a deployment and
the run's seed give the list of calls a run cycles through.

A call is the columns of one ``RadiationDriver.run``: an (experiment,
site) pair and a cosine of zenith each.  Mix parameters:

* ``columns_per_call``: a number, or ``"all_sites"``;
* ``sites``: ``"in_order"`` (all sites), ``"contiguous"`` (a slice of
  the sites from a start drawn from the seed, wrapping round), or
  ``"random"`` (distinct (site, experiment) pairs drawn from all of them);
* ``experiments``: ``"cycle"`` (call k takes experiment e0 + k, e0 drawn
  from the seed) or ``"random"`` (with ``sites: "random"``);
* ``zenith``: ``"site"`` (each site's own angle) or ``"lit_pattern"``:
  the calls come in blocks of ``len(lit_per_call)`` calls whose numbers of
  lit columns are the list, in an order drawn from the seed, so every seed
  runs the same amount of work; a lit column's cosine is drawn from (0, 1],
  a night one's from (-1, 0];
* ``spectral_chunks``: the ``run(spectral_chunks=...)`` argument;
* ``distinct_calls``: how many calls are made before the list repeats;
* ``checked_columns``: how many columns of the completed calls the
  reference checks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .deployment import Deployment, rng


@dataclasses.dataclass(frozen=True)
class Call:
    expts: np.ndarray
    sites: np.ndarray
    mu: np.ndarray

    @property
    def size(self) -> int:
        return int(self.sites.size)

    @property
    def lit(self) -> int:
        return int(np.count_nonzero(self.mu > 0.0))

    @property
    def compacted(self) -> bool:
        """Whether the program's day compaction splits the call into a lit
        and a night step: some but not all columns lit, and the lit
        columns' power-of-two bucket smaller than the batch (otherwise
        the whole batch runs once with the day mask)."""
        if self.lit in (0, self.size):
            return False
        bucket = 1 << (self.lit - 1).bit_length()
        return bucket < self.size


def calls(mix: dict, dep: Deployment, seed: int) -> list[Call]:
    """The mix's ``distinct_calls`` calls, in order."""
    g = rng(seed, 4)
    nsite, nexpt = dep.sites, dep.experiments
    pool = nsite * nexpt if mix["sites"] == "random" else nsite
    B = pool if mix["columns_per_call"] == "all_sites" \
        else min(int(mix["columns_per_call"]), pool)
    e0 = int(g.integers(nexpt))
    pattern = mix.get("lit_per_call")
    out = []
    for k in range(int(mix["distinct_calls"])):
        if mix["sites"] == "random":
            pick = g.choice(nsite * nexpt, B, replace=False)
            sites, expts = pick % nsite, pick // nsite
        else:
            start = 0 if mix["sites"] == "in_order" else int(g.integers(nsite))
            sites = (start + np.arange(B)) % nsite
            expts = np.full(B, (e0 + k) % nexpt)
        if mix["zenith"] == "site":
            mu = dep.profiles["mu_site"][sites]
        else:
            if k % len(pattern) == 0:
                block = g.permutation(pattern)
            lit = np.zeros(B, bool)
            lit[g.choice(B, int(block[k % len(pattern)]), replace=False)] = \
                True
            mu = np.where(lit, 1.0 - g.random(B), -g.random(B))
        out.append(Call(np.asarray(expts), np.asarray(sites), mu))
    return out


def warmup(call_list: list[Call]) -> list[Call]:
    """Two calls for each number of lit columns the list holds (the first
    call with that number): the program's keys depend on the batch and its
    lit columns only, and each key runs eagerly at its first call and is
    captured at its second."""
    first = {}
    for c in call_list:
        first.setdefault((c.size, c.lit), c)
    return [c for c in first.values() for _ in range(2)]


def checked(completed: list[Call], count: int, seed: int) -> list:
    """``count`` (call index, column) pairs of the completed calls drawn
    from the seed: a lit column first and a night column next where the
    calls hold any, both of one compacted call where a call was
    compacted (so the scatter-back of both steps is checked), then the
    rest at random, all distinct."""
    g = rng(seed, 5)
    pairs = [(i, j) for i, c in enumerate(completed) for j in range(c.size)]
    order = [pairs[i] for i in g.permutation(len(pairs))]
    split = [i for i, c in enumerate(completed) if c.compacted]
    if split:
        first = split[int(g.integers(len(split)))]
        order = [p for p in order if p[0] == first] + \
            [p for p in order if p[0] != first]
    picked = []
    for want in (True, False):
        for i, j in order:
            if (completed[i].mu[j] > 0.0) == want:
                picked.append((i, j))
                break
    for p in order:
        if len(picked) >= count:
            break
        if p not in picked:
            picked.append(p)
    return picked[:count]
