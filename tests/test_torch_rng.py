"""Port parity (a): the torch RNG is bit-exact with the JAX package's.

Keys, ``fold_in``, ``uniform`` and the per-stream-prime Halton draws must
give the same 32-bit words as ``jax.random`` under
``jax_threefry_partitionable=True`` (pinned in conftest), for many
(seed, pixel, sample, bounce, stream) tuples. Tolerance: none — the
comparisons are on the bit patterns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.ops import rng as jrng
from pathtracing_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

SEEDS = [0, 7, 2**31 + 12345]
SAMPLES = [0, 1, 5, 1023, 65537]
PIXELS = np.random.RandomState(0).randint(0, 1920 * 1080, 96)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x, np.float32).view(np.uint32)


def _jax_keys(seed, sample):
    return jax.vmap(
        lambda p: jrng.pixel_sample_key(jnp.uint32(seed), p, sample)
    )(jnp.asarray(PIXELS, jnp.int32))


def _torch_keys(seed, sample):
    return trng.pixel_sample_key(seed, torch.as_tensor(PIXELS), sample)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sample", SAMPLES)
def test_pixel_sample_key_bits(seed, sample):
    kj = np.asarray(jax.random.key_data(_jax_keys(seed, sample)))
    kt = _torch_keys(seed, sample).numpy()
    np.testing.assert_array_equal(kj.astype(np.int64), kt)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounce", [0, 1, 7])
@pytest.mark.parametrize("stream", [trng.STREAM_NEE, trng.STREAM_SCATTER,
                                    trng.STREAM_RR])
def test_stream_uniform_bits(seed, bounce, stream):
    kj, kt = _jax_keys(seed, 3), _torch_keys(seed, 3)
    for n in (None, 2, 3, 5):
        shape = () if n is None else (n,)
        uj = jax.vmap(lambda k: jax.random.uniform(
            jrng.stream_key(k, bounce, stream), shape, dtype=jnp.float32
        ))(kj)
        ut = trng.uniform(trng.stream_key(kt, bounce, stream), n)
        np.testing.assert_array_equal(_bits(uj), _bits(ut))


def test_fold_in_wraps_negative_data():
    k = jax.random.key(5)
    for x in (-1, -(2**31), 2**31 - 1):
        kj = np.asarray(jax.random.key_data(
            jax.random.fold_in(k, jnp.int32(x))))
        kt = trng.fold_in(trng.key(5), x)
        np.testing.assert_array_equal(kj.astype(np.int64), kt.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sample", SAMPLES)
@pytest.mark.parametrize("stream", sorted(trng._LD_PAIR_BASES))
def test_ld_pair_bits(seed, sample, stream):
    a, b = jax.vmap(lambda p: jrng.ld_pair(
        jnp.uint32(seed), p, jnp.int32(sample), stream
    ))(jnp.asarray(PIXELS, jnp.int32))
    ta, tb = trng.ld_pair(seed, torch.as_tensor(PIXELS), sample, stream)
    np.testing.assert_array_equal(_bits(a), _bits(ta))
    np.testing.assert_array_equal(_bits(b), _bits(tb))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stream", sorted(trng._LD_SCALAR_BASES))
def test_ld_scalar_bits(seed, stream):
    for sample in SAMPLES:
        a = jax.vmap(lambda p: jrng.ld_scalar(
            jnp.uint32(seed), p, jnp.int32(sample), stream
        ))(jnp.asarray(PIXELS, jnp.int32))
        ta = trng.ld_scalar(seed, torch.as_tensor(PIXELS), sample, stream)
        np.testing.assert_array_equal(_bits(a), _bits(ta))


def test_per_ray_sample_index_matches_scalar():
    """A tensor of sample ids draws what the same ids as scalars draw."""
    pix = torch.as_tensor(PIXELS[:8])
    ss = torch.arange(8, dtype=torch.int64) * 3
    a, _ = trng.ld_pair(0, pix, ss, trng.STREAM_NEE)
    for i in range(8):
        b, _ = trng.ld_pair(0, pix[i:i + 1], int(ss[i]), trng.STREAM_NEE)
        assert _bits(a[i:i + 1]) == _bits(b)
