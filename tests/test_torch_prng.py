"""The port's counter-based generator (grtcode_tpu_torch/utils/prng.py)
against jax.random (threefry2x32, partitionable): keys, splits, fold-ins
over a vector of column ids and uniforms, bit for bit, at several seeds
and shapes."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from grtcode_tpu_torch.utils import prng

SEEDS = (0, 1, 42, 123456789, 2 ** 31 - 1)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    torch.set_num_threads(2)


def _bits(a):
    return np.asarray(a).astype(np.int64)


def test_jax_draws_with_partitionable_threefry():
    """The form of jax.random the port reproduces."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    assert np.array_equal(_bits(jax.random.PRNGKey(seed)),
                          prng.prng_key(seed).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 16])
def test_split_matches(seed, n):
    key = jax.random.PRNGKey(seed)
    got = prng.split(prng.prng_key(seed), n).numpy()
    assert got.shape == (n, 2)
    assert np.array_equal(_bits(jax.random.split(key, n)), got)
    # Splitting a batch of keys splits each one.
    keys = jax.random.split(key, 3)
    want = np.stack([_bits(jax.random.split(k, n)) for k in keys])
    assert np.array_equal(want, prng.split(torch.as_tensor(_bits(keys)),
                                           n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_over_column_ids_matches(seed):
    key = jax.random.PRNGKey(seed)
    ids = np.array([0, 1, 2, 7, 31, 1000, 65535, 2 ** 31 - 1])
    want = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.asarray(ids, jnp.int32))
    got = prng.fold_in(prng.prng_key(seed), torch.as_tensor(ids))
    assert got.shape == (ids.size, 2)
    assert np.array_equal(_bits(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 53, 54, 4097])
def test_uniform_matches(seed, n):
    keys = jax.random.split(jax.random.PRNGKey(seed), 5)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))
    got = prng.uniform(torch.as_tensor(_bits(keys)), n).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == (5, n)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0
