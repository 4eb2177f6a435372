"""Port parity: the threefry PRNG against ``jax.random``, bit for bit
(partitionable threefry, the jax default here): keys, splits, fold-ins,
uniform, bernoulli and normal draws, and the XLA float32 functions
behind them; and the original stream, ``prng.threefry_partitionable
(False)`` against JAX under ``jax.threefry_partitionable(False)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng, xla_math
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 65, 0x0FA17, 2 ** 32 - 1])
def test_fold_in_bit_exact(seed, data):
    got = prng.fold_in(prng.PRNGKey(seed, device="cpu"), data)
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    assert np.array_equal(got.numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.0, 0.05, 0.5, 1.0])
def test_bernoulli_bit_exact(seed, p):
    got = prng.bernoulli(prng.PRNGKey(seed, device="cpu"), p, (16, 1024))
    want = jax.random.bernoulli(jax.random.PRNGKey(seed), p, (16, 1024))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES + ((1 << 18,),))
def test_normal_bit_exact(seed, shape):
    """``normal`` is XLA's float32 erf_inv lowering written out op for
    op (its log1p polynomial and fused multiply-adds), so the draws are
    the reference's bit for bit, tails included."""
    got = prng.normal(prng.PRNGKey(seed, device="cpu"), shape)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_batched_split_equals_per_key_split():
    keys = prng.split(prng.PRNGKey(3, device="cpu"), 4)
    both = prng.split(keys, 3)
    assert both.shape == (4, 3, 2)
    for i in range(4):
        assert torch.equal(both[i], prng.split(keys[i], 3))
    with pytest.raises(ValueError):
        prng.split(torch.zeros(3, dtype=torch.int64))


def test_transcendentals_match_xla_on_a_dense_grid():
    """log1p, erf_inv and exp against XLA's float32 functions over both
    branches of each (small and large log1p arguments, the w < 5 and
    w >= 5 erf_inv polynomials, exp's clamped range)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-0.999, 4.0, 1 << 16),
                        -rng.uniform(0, 1e-3, 1024),
                        [0.0, 0.41421354, 0.41421357, -0.41421357]]
                       ).astype(np.float32)
    u = np.clip(rng.uniform(-1, 1, 1 << 16), -0.9999999, 0.9999999
                ).astype(np.float32)
    z = np.concatenate([rng.normal(0, 6, 1 << 16), [-100.0, 100.0, 0.0]]
                       ).astype(np.float32)
    for got, want in (
            (xla_math.log1p(torch.from_numpy(x)), jnp.log1p(x)),
            (xla_math.erf_inv(torch.from_numpy(u)), jax.lax.erf_inv(u)),
            (xla_math.exp(torch.from_numpy(z)), jnp.exp(z))):
        want = np.asarray(want)
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_powf_is_the_c_library_call():
    base = np.linspace(0.01, 30.0, 4096, dtype=np.float32)
    got = xla_math.powf(torch.from_numpy(base), -1.0 / 1.5)
    want = np.asarray(jnp.asarray(base) ** (-1.0 / 1.5))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


ORIGINAL_SHAPES = SHAPES + ((7,), (3, 5), (1,))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 26])
def test_original_stream_split_bit_exact(seed, num):
    key = prng.PRNGKey(seed, device="cpu")
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num),
                          np.int64)
    with prng.threefry_partitionable(False):
        got = prng.split(key, num)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", ORIGINAL_SHAPES)
def test_original_stream_draws_bit_exact(seed, shape):
    """uniform (and a shifted range), normal and bernoulli; odd counts
    hash a padded last pair."""
    key = prng.PRNGKey(seed, device="cpu")
    jkey = jax.random.PRNGKey(seed)
    with jax.threefry_partitionable(False):
        want = [np.asarray(jax.random.uniform(jkey, shape)),
                np.asarray(jax.random.uniform(jkey, shape, minval=0.0,
                                              maxval=2048.0)),
                np.asarray(jax.random.normal(jkey, shape)),
                np.asarray(jax.random.bernoulli(jkey, 0.3, shape))]
    with prng.threefry_partitionable(False):
        got = [prng.uniform(key, shape), prng.uniform(key, shape, 0.0, 2048.0),
               prng.normal(key, shape), prng.bernoulli(key, 0.3, shape)]
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32))
    assert np.array_equal(got[3].numpy(), want[3])


def test_original_stream_batched_keys_and_fold_in():
    """A batch of keys draws what each key draws alone (as ``vmap`` over
    JAX's original stream does); ``fold_in`` is the same in both
    streams."""
    with jax.threefry_partitionable(False):
        jkeys = jax.random.split(jax.random.PRNGKey(7), 5)
        want = [np.asarray(jax.random.uniform(k, (33,))) for k in jkeys]
        want_split = [np.asarray(jax.random.split(k, 3), np.int64)
                      for k in jkeys]
        want_fold = np.asarray(jax.random.fold_in(jkeys[0], 65), np.int64)
    with prng.threefry_partitionable(False):
        keys = prng.split(prng.PRNGKey(7, device="cpu"), 5)
        got = prng.uniform(keys, (33,))
        got_split = prng.split(keys, 3)
        got_fold = prng.fold_in(keys[0], 65)
    for i in range(5):
        assert np.array_equal(got[i].numpy(), want[i])
        assert np.array_equal(got_split[i].numpy(), want_split[i])
    assert np.array_equal(got_fold.numpy(), want_fold)
    assert torch.equal(got_fold, prng.fold_in(keys[0], 65))


def test_original_stream_is_scoped_and_refuses_offsets():
    key = prng.PRNGKey(0, device="cpu")
    on = prng.uniform(key, (16,))
    with prng.threefry_partitionable(False):
        assert not prng.partitionable()
        off = prng.uniform(key, (16,))
        with prng.threefry_partitionable(True):
            assert torch.equal(prng.uniform(key, (16,)), on)
        with pytest.raises(ValueError, match="offset"):
            prng.uniform(key, (16,), offset=16)
        # No prefix property: a block is not the head of a taller draw.
        assert not torch.equal(prng.uniform(key, (32,))[:16], off)
    assert prng.partitionable()
    assert not torch.equal(on, off)
    assert torch.equal(prng.uniform(key, (16,)), on)
