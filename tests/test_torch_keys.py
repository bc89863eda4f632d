"""The port's threefry key chain is bit-exact with jax.random (threefry2x32,
jax_threefry_partitionable=True): PRNGKey, fold_in, the engine's chunk_keys
and 32-bit bits, over several seeds, p-indices and tile ranges, and split,
uniform and bernoulli (the encoder's draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpcsim_tpu.parallel.mesh import chunk_keys as ref_chunk_keys

from qldpcsim_torch.convert import keys_from_reference
from qldpcsim_torch.parallel.keys import chunk_keys
from qldpcsim_torch.utils import threefry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 1, 12345, 2**31 - 1]


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_reference_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    kt = threefry.prng_key(seed)
    assert np.array_equal(_np(k), kt.numpy())
    for data in (0, 1, 7, 2**31 - 1, 2**32 - 1):
        assert np.array_equal(_np(jax.random.fold_in(k, data)),
                              threefry.fold_in(kt, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p_index", [0, 3])
@pytest.mark.parametrize("start,count", [(0, 64), (130, 7), (2**32 - 3, 6)])
def test_chunk_keys(seed, p_index, start, count):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), p_index)
    kt = threefry.fold_in(threefry.prng_key(seed), p_index)
    if start + count > 2**32:   # the reference's uint32 iota wraps
        idx = (np.arange(start, start + count) % 2**32).astype(np.uint32)
        ref = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.asarray(idx))
    else:
        ref = ref_chunk_keys(key, start, count)
    assert np.array_equal(_np(ref), chunk_keys(kt, start, count).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (3, 50), (64, 544)])
def test_random_bits(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    kt = threefry.fold_in(threefry.prng_key(seed), 5)
    ref = jax.random.bits(key, shape, jnp.uint32)
    assert np.array_equal(_np(ref), threefry.random_bits(kt, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 4, 7])
def test_split(seed, num):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    kt = threefry.fold_in(threefry.prng_key(seed), 2)
    out = threefry.split(kt, num)
    assert out.shape == (num, 2)
    assert np.array_equal(_np(jax.random.split(key, num)), out.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(5,), (64, 30), (33, 257)])
def test_uniform_and_bernoulli(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
    kt = threefry.fold_in(threefry.prng_key(seed), 9)
    u = threefry.uniform(kt, shape)
    assert u.dtype == torch.float32
    assert np.array_equal(np.asarray(jax.random.uniform(key, shape)),
                          u.numpy())
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    for p in (0.5, 0.1, 1.0 / 3.0):
        ref = jax.random.bernoulli(key, p, shape)
        out = threefry.bernoulli(kt, p, shape)
        assert out.dtype == torch.bool
        assert np.array_equal(np.asarray(ref), out.numpy())


def test_random_bits_batched_over_keys_is_vmap():
    keys = ref_chunk_keys(jax.random.PRNGKey(9), 0, 5)
    ref = jax.vmap(lambda k: jax.random.bits(k, (4, 33), jnp.uint32))(keys)
    out = threefry.random_bits(keys_from_reference(np.asarray(keys)), (4, 33))
    assert np.array_equal(_np(ref), out.numpy())


def test_keys_from_reference_rejects_wrong_layout():
    with pytest.raises(ValueError):
        keys_from_reference(np.zeros((3, 2), np.int32))
    with pytest.raises(ValueError):
        keys_from_reference(np.zeros((3,), np.uint32))
    with pytest.raises(ValueError):
        threefry.prng_key(-1)
    assert keys_from_reference(np.zeros((3, 2), np.uint32)).dtype == torch.int64
