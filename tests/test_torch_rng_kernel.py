"""The counter-based generator's kernels (``csrc/rng.cu``) against the plain
int64 version of ``ops/rng.py`` (the ``*_torch`` functions), bit for bit.

On the card (tests marked ``card``; they skip without one) every public
entry takes its kernel on CUDA tensors and is held against its plain
version on the same tensors: a scalar key against a data batch, a key batch
against an int, batch against batch; ``n`` None, 1, 2, 3 and 25; negative
ints, ints of 2^31 and past 2^32, seeds with the high 32 bits set; the
sample index as an int and per lane; every stream of ``_LD_PAIR_BASES``
and ``_LD_SCALAR_BASES``; and a 1080p wave. No entry makes a blocking copy
to the card, and each makes one launch. The suite's ``conftest.py`` imports
JAX, which the machine with the card lacks, so run them there with

    python -m pytest tests/test_torch_rng_kernel.py --noconftest -q

On the CPU the same source is compiled by the host C++ compiler against a
stand-in for the CUDA runtime that runs a grid's blocks one after another,
and the kernel route (the real wrappers and C interface) is held against
the plain version on CPU tensors.
"""

import ctypes
import re
import types

import pytest
import torch

from pathtracing_tpu_torch.ops import cuda_build
from pathtracing_tpu_torch.ops import rng
from pathtracing_tpu_torch.utils import metrics

SEEDS = [0, 7, 2**31 + 12345, (0xABCDEF01 << 32) | 0x12345678, -3]
INTS = [0, 1, -1, -(2**31), 2**31 - 1, 2**31, 2**32 + 17]
SAMPLES = [0, 1, 1023, 65537, 2**31 + 3, -2]
NS = [None, 1, 2, 3, 3 * 8 + 1]
LANES = 4099
ENTRIES = ["key", "fold_in", "random_bits", "uniform", "pixel_sample_key",
           "stream_key", "ld_scalar", "ld_pair"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the RNG kernels run only on the card "
                    "(the CPU tests hold their source through a host build)")
    return torch.device("cuda")


def _same(a, b, what):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
        return
    assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device), what
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), what


def _inputs(dev, lanes=LANES):
    g = torch.Generator().manual_seed(lanes)
    pix = torch.randint(0, 1920 * 1080, (lanes,), generator=g)
    wide = torch.randint(-2**31, 2**31 - 1, (lanes,), generator=g)
    return types.SimpleNamespace(
        pix=pix.to(dev), pix32=pix.to(torch.int32).to(dev),
        keys=rng.pixel_sample_key_torch(2**33 + 9, pix.to(dev), 3),
        one=rng.key_torch(2**33 + 9, dev),
        datas=[*INTS, torch.tensor(5, device=dev),
               torch.tensor(-7, dtype=torch.int32, device=dev),
               wide.to(dev), wide.to(torch.int32).to(dev),
               (wide << 9).to(dev)],
        samples=[*SAMPLES, torch.tensor(9, device=dev),
                 (torch.arange(lanes) * 3 + 2**31 - 40).to(dev)])


def _cases(entry, x):
    """(label, arguments) of every case of one public entry."""
    if entry == "key":
        return [(s, (s, x.one.device)) for s in SEEDS]
    if entry == "fold_in":
        return [((kn, i), (k, d)) for kn, k in (("one", x.one),
                                                ("batch", x.keys))
                for i, d in enumerate(x.datas)]
    if entry in ("random_bits", "uniform"):
        return [((kn, n), (k, n)) for kn, k in (("one", x.one),
                                                ("batch", x.keys))
                for n in NS]
    if entry == "pixel_sample_key":
        return [((s, i), (s, p, smp)) for s in SEEDS
                for p in (x.pix, x.pix32)
                for i, smp in enumerate(x.samples)]
    if entry == "stream_key":
        return [((i, tag), (x.keys, b, tag))
                for i, b in enumerate([0, 7, *x.datas[7:10]])
                for tag in (rng.STREAM_NEE, rng.STREAM_SCATTER,
                            rng.STREAM_RR, 2**31 + 5)]
    bases = rng._LD_SCALAR_BASES if entry == "ld_scalar" else \
        rng._LD_PAIR_BASES
    return [((s, tag, i), (s, p, smp, tag)) for s in SEEDS[1:4]
            for p in (x.pix, x.pix32) for tag in sorted(bases)
            for i, smp in enumerate(x.samples)]


def _check_entry(entry, x):
    kernel, plain = getattr(rng, entry), getattr(rng, entry + "_torch")
    for label, args in _cases(entry, x):
        _same(kernel(*args), plain(*args), (entry, label))


def _two_calls_each(x):
    """The first and last case of each entry (ints, then tensors)."""
    calls = []
    for entry in ENTRIES:
        cases = _cases(entry, x)
        calls += [(entry, cases[0][1]), (entry, cases[-1][1])]
    return calls


def _launches_and_syncs(x):
    """Launch spans and host syncs of two calls of each entry in a step."""
    metrics.enable()
    try:
        with metrics.step():
            for entry, args in _two_calls_each(x):
                getattr(rng, entry)(*args)
    finally:
        metrics.disable()
    s = metrics.steps()[-1]
    return s["spans"][rng.LAUNCH_SPAN]["count"], s["host_syncs"]


# --- On the card ------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_equals_plain_on_the_card(card, entry):
    _check_entry(entry, _inputs(card))
    torch.cuda.synchronize()


@pytest.mark.card
def test_kernels_equal_plain_on_a_1080p_wave(card):
    pix = torch.arange(1920 * 1080, device=card)
    lanes_sample = torch.randint(0, 2**20, pix.shape, device=card)
    keys = rng.pixel_sample_key(2**33 + 5, pix, 17)
    _same(keys, rng.pixel_sample_key_torch(2**33 + 5, pix, 17), "psk")
    kd = rng.fold_in(keys, 3)
    _same(kd, rng.fold_in_torch(keys, 3), "fold_in")
    _same(rng.stream_key(keys, 2, rng.STREAM_NEE),
          rng.stream_key_torch(keys, 2, rng.STREAM_NEE), "stream_key")
    for n in NS:
        _same(rng.uniform(kd, n), rng.uniform_torch(kd, n), ("uniform", n))
        _same(rng.random_bits(kd, n), rng.random_bits_torch(kd, n),
              ("random_bits", n))
    for smp in (17, lanes_sample):
        for tag in rng._LD_PAIR_BASES:
            _same(rng.ld_pair(2**33 + 5, pix, smp, tag),
                  rng.ld_pair_torch(2**33 + 5, pix, smp, tag), ("pair", tag))
        for tag in rng._LD_SCALAR_BASES:
            _same(rng.ld_scalar(2**33 + 5, pix, smp, tag),
                  rng.ld_scalar_torch(2**33 + 5, pix, smp, tag),
                  ("scalar", tag))


@pytest.mark.card
def test_no_entry_makes_a_blocking_copy_on_the_card(card):
    x = _inputs(card)
    calls = _two_calls_each(x)
    for entry, args in calls:          # builds and loads the library
        getattr(rng, entry)(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for entry, args in calls:
            getattr(rng, entry)(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    metrics.reset()
    assert _launches_and_syncs(x) == (2 * len(ENTRIES), 0)
    metrics.reset()


# --- The same source through a host build, on the CPU -----------------------

_STAND_IN = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
struct Dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local Dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __uint2float_rn(uint32_t x) { return static_cast<float>(x); }
inline float __double2float_rn(double x) { return static_cast<float>(x); }
inline float __uint_as_float(uint32_t x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
namespace emu {
template <typename F>
void launch(long long grid, int block, F body) {
  gridDim.x = static_cast<unsigned>(grid);
  blockDim.x = block;
  for (long long b = 0; b < grid; ++b)
    for (int t = 0; t < block; ++t) {
      blockIdx.x = static_cast<unsigned>(b);
      threadIdx.x = t;
      body();
    }
}
}  // namespace emu
"""


def _host_source(src: str) -> str:
    """``src`` with each ``kernel<<<grid, block, ...>>>(args)`` rewritten
    as ``emu::launch(grid, block, [&] { kernel(args); })``."""
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        name = re.search(r"(\w+(?:<[^<>;]*>)?)\s*$", src[i:j])
        k = src.index(">>>", j)
        grid, block = [c.strip() for c in src[j + 3:k].split(",")[:2]]
        p = q = src.index("(", k)
        depth = 0
        while True:
            depth += (src[q] == "(") - (src[q] == ")")
            if depth == 0:
                break
            q += 1
        out += [src[i:i + name.start(1)],
                f"emu::launch({grid}, {block}, [&] {{ {name.group(1)}"
                f"({src[p + 1:q]}); }})"]
        i = q + 1
    return "".join(out) + src[i:]


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    import subprocess

    d = tmp_path_factory.mktemp("rng_host")
    (d / "cuda_runtime.h").write_text(_STAND_IN)
    with open(f"{cuda_build.CSRC}/rng.cu") as f:
        (d / "rng.cpp").write_text(_host_source(f.read()))
    lib = d / "librng_host.so"
    subprocess.run([cuda_build.cxx_path(), "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", f"-I{d}",
                    "-o", str(lib), str(d / "rng.cpp")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def host_route(monkeypatch, host_build):
    """The kernel route on CPU tensors, through the host build."""
    for fn, argtypes in rng._SIGNATURES.items():
        f = getattr(host_build, fn)
        f.argtypes, f.restype = list(argtypes), ctypes.c_int
    monkeypatch.setattr(rng, "_on_card", lambda device: device is not None)
    monkeypatch.setattr(rng.cuda_build, "load",
                        lambda name, signatures: host_build)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=None))
    return torch.device("cpu")


def test_host_build_rewrites_every_launch():
    with open(f"{cuda_build.CSRC}/rng.cu") as f:
        src = f.read()
    host = _host_source(src)
    assert "<<<" not in host and ">>>" not in host
    assert host.count("emu::launch(") == src.count("<<<") == 5


@pytest.mark.parametrize("entry", ENTRIES)
def test_kernel_source_equals_plain_through_a_host_build(host_route, entry):
    _check_entry(entry, _inputs(host_route, lanes=517))


def test_kernel_route_broadcasts_as_plain(host_route):
    x = _inputs(host_route, lanes=35)
    k3 = x.keys.reshape(5, 7, 2)
    for k, d in ((k3[:, :1], x.pix[:7]), (x.keys[:, None][:5], x.pix[:3]),
                 (k3, torch.arange(7)), (x.keys[:0], 3)):
        _same(rng.fold_in(k, d), rng.fold_in_torch(k, d), "fold_in")
        _same(rng.uniform(k, 2), rng.uniform_torch(k, 2), "uniform")
    p2 = x.pix.reshape(5, 7)
    for smp in (torch.arange(7), torch.arange(5)[:, None], 4):
        _same(rng.ld_pair(3, p2, smp, rng.STREAM_LENS),
              rng.ld_pair_torch(3, p2, smp, rng.STREAM_LENS), "ld_pair")
        _same(rng.pixel_sample_key(3, p2, smp),
              rng.pixel_sample_key_torch(3, p2, smp), "pixel_sample_key")


def test_kernel_route_launches_once_an_entry_and_never_syncs(host_route):
    metrics.reset()
    assert _launches_and_syncs(_inputs(host_route, lanes=33)) == (
        2 * len(ENTRIES), 0)
    metrics.reset()
