"""Port parity (a): the torch RNG is bit-exact with the JAX package's.

Keys, ``fold_in``, ``uniform`` and the per-stream-prime Halton draws must
give the same 32-bit words as ``jax.random`` under
``jax_threefry_partitionable=True`` (pinned in conftest), for many
(seed, pixel, sample, bounce, stream) tuples. Tolerance: none — the
comparisons are on the bit patterns. CPU tensors take the plain version
and never load the CUDA kernels of ``csrc/rng.cu``; the module imports and
draws without ``nvcc``.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.ops import rng as jrng
from pathtracing_tpu_torch.ops import cuda_build
from pathtracing_tpu_torch.ops import rng as trng

torch.set_num_threads(2)

SEEDS = [0, 7, 2**31 + 12345]
SAMPLES = [0, 1, 5, 1023, 65537]
PIXELS = np.random.RandomState(0).randint(0, 1920 * 1080, 96)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize("n", [None, 1, 3, 25])
def test_random_bits_bits(n):
    kj, kt = _jax_keys(2**31 + 12345, 5), _torch_keys(2**31 + 12345, 5)
    shape = () if n is None else (n,)
    bj = jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(kj)
    bt = trng.random_bits(kt, n)
    assert bt.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(bj).astype(np.int64), bt.numpy())


# --- The two routes: CPU tensors take the plain version ----------------------


@pytest.fixture
def no_library(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor loaded the RNG kernels")

    monkeypatch.setattr(cuda_build, "load", refuse)


@pytest.mark.parametrize("check", [
    lambda: test_pixel_sample_key_bits(2**31 + 12345, 65537),
    lambda: test_stream_uniform_bits(7, 1, trng.STREAM_NEE),
    test_fold_in_wraps_negative_data,
    lambda: test_random_bits_bits(3),
    lambda: test_ld_pair_bits(7, 1023, trng.STREAM_LENS),
    lambda: test_ld_scalar_bits(0, trng.STREAM_TIME),
    test_per_ray_sample_index_matches_scalar,
], ids=["pixel_sample_key", "stream_key_uniform", "key_fold_in",
        "random_bits", "ld_pair", "ld_scalar", "ld_per_ray"])
def test_cpu_tensors_never_load_the_kernels(no_library, check):
    """Every public entry on CPU tensors gives the JAX bits with the
    library's loader refusing."""
    check()


def test_rng_imports_and_draws_without_nvcc(tmp_path):
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(d, "nvcc")))
    env = dict(os.environ, PATH=path, CUDA_HOME=str(tmp_path / "none"))
    code = ("from pathtracing_tpu_torch.ops import cuda_build, rng\n"
            "try:\n    cuda_build.nvcc_path()\n"
            "except RuntimeError:\n    pass\n"
            "else:\n    raise SystemExit('found nvcc')\n"
            "print(rng.uniform(rng.key(3), 2).tolist())\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == str(
        trng.uniform(trng.key(3), 2).tolist()).split()


def test_rng_source_is_built_like_the_others():
    assert "rng" in cuda_build.sources()
    path = cuda_build._library_path("rng")
    assert path == cuda_build._library_path("rng")
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith("librng-")
    assert {"arch=compute_90a,code=sm_90a", "--fmad=false"} <= set(
        cuda_build.NVCC_FLAGS)
    with open(os.path.join(cuda_build.CSRC, "rng.cu")) as f:
        src = f.read()
    # Self-contained, with a plain C interface.
    assert re.findall(r"#include\s*(\S+)", src) == ["<cuda_runtime.h>",
                                                    "<cstdint>"]
    assert 'extern "C"' in src
    assert set(re.findall(r"\bint (ptpu_\w+)\(", src)) == set(
        trng._SIGNATURES)
