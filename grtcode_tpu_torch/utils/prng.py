"""Counter-based random numbers that reproduce ``jax.random`` bit for bit.

The JAX package draws its stochastic cloud subcolumns from ``jax.random``
with the default threefry2x32 generator in its partitionable form.  This
module is the same generator in plain PyTorch integer arithmetic, so the
port draws exactly the subcolumns the JAX package draws:

* a key is a ``(..., 2)`` int64 tensor holding two uint32 words (int64
  because ``torch.uint32`` supports few operations; every add is masked
  back to 32 bits);
* ``prng_key(seed)`` = ``jax.random.PRNGKey(seed)``;
* ``split(keys, n)`` = ``jax.random.split(key, n)``: threefry of the
  counters ``(0, i)``;
* ``fold_in(keys, data)`` = ``jax.random.fold_in(key, data)``: threefry
  of ``(0, data)``;
* ``uniform(keys, n)`` = ``jax.random.uniform(key, (n,))``: the xor of
  threefry's two output words of the counters ``(0, i)``, its top 23 bits
  as the mantissa of a float in [1, 2), minus 1.

Every function is vectorised over the leading axes of ``keys`` (one call
draws for every column) and runs on the keys' device with the same bits
everywhere.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                       # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000                     # float32 1.0


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(keys, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``keys`` (``(..., 2)``); every operand broadcasts.  Returns the two
    output words as int64 tensors of uint32 values."""
    k0, k1 = keys[..., 0], keys[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """The (2,) key of ``jax.random.PRNGKey(seed)``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _counters(keys, n):
    """The counter words (0, i) for i < n on the keys' device."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    return torch.zeros_like(i), i


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``(..., n, 2)``: the n keys ``jax.random.split`` derives from each
    key."""
    b0, b1 = threefry2x32(keys[..., None, :], *_counters(keys, n))
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``keys`` (..., 2) and integer
    ``data`` broadcast against each other's leading axes (one key folded
    with a vector of column ids gives one key per column)."""
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _MASK
    b0, b1 = threefry2x32(keys, torch.zeros_like(data), data)
    return torch.stack([b0, b1], dim=-1)


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., n)`` float32 in [0, 1): ``jax.random.uniform(key, (n,))``
    for every key."""
    b0, b1 = threefry2x32(keys[..., None, :], *_counters(keys, n))
    bits = ((b0 ^ b1) >> 9) | _ONE_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0
