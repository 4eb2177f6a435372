"""Port parity: the threefry PRNG against ``jax.random``, bit for bit
(partitionable threefry, the jax default here)."""
import jax
import numpy as np
import pytest

from repro_torch.core import prng

SEEDS = (0, 3, 65, 1023)
SHAPES = ((16, 1024), (26, 2), (1024,))


def test_reference_uses_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_exact(seed):
    key = prng.PRNGKey(seed, device="cpu")
    jkey = jax.random.PRNGKey(seed)
    assert np.array_equal(key.numpy(), np.asarray(jkey, np.int64))
    for num in (2, 26):
        assert np.array_equal(prng.split(key, num).numpy(),
                              np.asarray(jax.random.split(jkey, num),
                                         np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.0, 2048.0),
                                    (-3.0, 5.5)])
def test_uniform_bit_exact(seed, shape, bounds):
    got = prng.uniform(prng.PRNGKey(seed, device="cpu"), shape, *bounds)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         minval=bounds[0],
                                         maxval=bounds[1]))
    assert got.numpy().dtype == want.dtype == np.float32
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_batched_keys_equal_per_key_draws():
    keys = prng.split(prng.PRNGKey(7, device="cpu"), 5)
    jkeys = jax.random.split(jax.random.PRNGKey(7), 5)
    got = prng.uniform(keys, (300,), 0.0, 100.0)
    assert got.shape == (5, 300)
    for i in range(5):
        want = jax.random.uniform(jkeys[i], (300,), minval=0.0,
                                  maxval=100.0)
        assert np.array_equal(got[i].numpy(), np.asarray(want))


def test_block_is_prefix_of_taller_draw():
    key = prng.PRNGKey(0, device="cpu")
    short = prng.uniform(key, (16, 1024))
    tall = prng.uniform(key, (64, 1024))
    assert np.array_equal(short.numpy(), tall[:16].numpy())


def test_negative_seed_rejected():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1, device="cpu")
