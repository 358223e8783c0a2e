"""Port parity: the lobes of queue A item 11 in ``ops/materials.py``:
anisotropic GGX (``ggx_eval_aniso``, ``ggx_sample_aniso`` and the
``aniso`` column of ``scatter``), the rough dielectric (``param2``) and
the dispersive dielectric (``disp`` with ``throughput``), fed the same
numpy inputs in both packages.

Tolerances are those of tests/test_torch_shading.py's ``scatter`` and
``ggx_eval`` checks: directions atol 1e-5, weights atol/rtol 1e-5, pdfs
atol 1e-5 / rtol 5e-4 (the NDF's cancelling denominator), evals rtol
1e-4 / atol 1e-6, on the lanes whose discrete outcome agrees; at least
99.9% of lanes must agree (a lane whose accept test, Fresnel choice or
channel pick sits within float noise of its threshold may flip; measured:
none flips on these inputs). The rough dielectric's weights take the
pdf's rtol 5e-4 (measured, see its test). Lanes of other types, and rows
whose optional column is 0, equal the column-free ``scatter`` bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.ops import materials as jmat
from pathtracing_tpu_torch.ops import materials as tmat

torch.set_num_threads(2)

N = 4096


def _hemisphere_inputs(n, seed):
    rs = np.random.RandomState(seed)
    normal = rs.randn(n, 3)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d_in = rs.randn(n, 3)
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    flip = (d_in * normal).sum(1) > 0
    d_in[flip] *= -1
    return normal.astype(np.float32), d_in.astype(np.float32), rs


def _unit(rs, n):
    v = rs.randn(n, 3)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _run_scatter(args, **cols):
    out_j = jmat.scatter(*(jnp.asarray(x) for x in args),
                         **{k: jnp.asarray(v) for k, v in cols.items()})
    out_t = tmat.scatter(*(torch.as_tensor(x) for x in args),
                         **{k: torch.as_tensor(v) for k, v in cols.items()})
    return ([np.asarray(x) for x in out_j], out_t)


def _assert_scatter_agrees(out_j, out_t, weight_rtol=1e-5):
    d_j, a_j, s_j, p_j = out_j
    d_t, a_t, s_t, p_t = (x.numpy() for x in out_t)
    agree = (s_j == s_t) & (np.abs(d_j - d_t).max(axis=1) < 1e-3)
    assert agree.mean() > 0.999
    np.testing.assert_allclose(d_j[agree], d_t[agree], atol=1e-5)
    np.testing.assert_allclose(a_j[agree], a_t[agree], atol=1e-5,
                               rtol=weight_rtol)
    np.testing.assert_allclose(p_j[agree], p_t[agree], atol=1e-5, rtol=5e-4)
    return s_t


def _other_lanes_unchanged(args, out_t, keep):
    plain = tmat.scatter(*(torch.as_tensor(x) for x in args))
    keep = torch.as_tensor(keep)
    for a, b in zip(out_t, plain):
        assert torch.equal(a[keep], b[keep])


def test_ggx_eval_aniso_matches():
    normal, view, rs = _hemisphere_inputs(N, 21)
    view = -view
    light = _unit(rs, N)
    f0 = rs.rand(N, 3).astype(np.float32)
    alpha = (rs.rand(N) * 0.6).astype(np.float32)
    aniso = (rs.rand(N) * 0.99).astype(np.float32)
    aniso[::7] = 0.0
    args = (f0, alpha, aniso, normal, view, light)
    fj, pj = jmat.ggx_eval_aniso(*(jnp.asarray(x) for x in args))
    ft, pt = tmat.ggx_eval_aniso(*(torch.as_tensor(x) for x in args))
    np.testing.assert_allclose(np.asarray(fj), ft.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=1e-4,
                               atol=1e-6)
    assert (pt.numpy() > 0).mean() > 0.3


def test_ggx_sample_aniso_matches():
    normal, d_in, rs = _hemisphere_inputs(N, 22)
    alpha = (rs.rand(N) * 0.6 + 0.01).astype(np.float32)
    aniso = (rs.rand(N) * 0.99).astype(np.float32)
    u1, u2 = rs.rand(N).astype(np.float32), rs.rand(N).astype(np.float32)
    args = (alpha, aniso, normal, d_in, u1, u2)
    out_j = jmat.ggx_sample_aniso(*(jnp.asarray(x) for x in args))
    out_t = tmat.ggx_sample_aniso(*(torch.as_tensor(x) for x in args))
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5)


def test_scatter_aniso_ggx_matches():
    normal, d_in, rs = _hemisphere_inputs(N, 23)
    albedo = rs.rand(N, 3).astype(np.float32)
    param = (rs.rand(N) * 0.5 + 0.01).astype(np.float32)
    aniso = (rs.rand(N) * 0.95).astype(np.float32)
    aniso[::5] = 0.0                     # isotropic rows among them
    mt = np.where(np.arange(N) % 4 == 3, tmat.TYPE_LAMBERTIAN,
                  tmat.TYPE_GGX).astype(np.int32)
    args = (mt, albedo, param, np.zeros((N, 3), np.float32), normal, d_in,
            rs.rand(N) > 0.3, rs.rand(N, 5).astype(np.float32))
    out_j, out_t = _run_scatter(args, aniso=aniso)
    s_t = _assert_scatter_agrees(out_j, out_t)
    assert s_t.mean() > 0.5
    _other_lanes_unchanged(args, out_t, (aniso == 0.0)
                           | (mt == tmat.TYPE_LAMBERTIAN))


def test_scatter_rough_dielectric_matches():
    normal, d_in, rs = _hemisphere_inputs(N, 24)
    tint = (rs.rand(N, 3) * 0.5 + 0.5).astype(np.float32)
    ior = (1.0 + rs.rand(N)).astype(np.float32)
    rough = (rs.rand(N) * 0.5).astype(np.float32)
    mt = np.where(np.arange(N) % 4 == 3, tmat.TYPE_DIELECTRIC,
                  tmat.TYPE_ROUGH_DIELECTRIC).astype(np.int32)
    args = (mt, tint, ior, np.zeros((N, 3), np.float32), normal, d_in,
            rs.rand(N) > 0.3, rs.rand(N, 5).astype(np.float32))
    out_j, out_t = _run_scatter(args, param2=rough)
    # Measured: 3 of 4,096 lanes, all at grazing incidence (n·v 0.066 to
    # 0.106), weigh up to 1.6e-4 apart relative: their refracted direction
    # differs by an ulp-level 8e-6, which G1 at |n·l| magnifies. The pdf's
    # rtol (the GGX NDF's) covers them.
    s_t = _assert_scatter_agrees(out_j, out_t, weight_rtol=5e-4)
    d_t = out_t[0].numpy()
    rd = mt == tmat.TYPE_ROUGH_DIELECTRIC
    # Both events occur: reflection and transmission through h.
    cos_out = (d_t * normal).sum(1)
    assert ((cos_out > 0) & rd & s_t).any() and ((cos_out < 0) & rd
                                                  & s_t).any()
    assert (~s_t[rd]).any()                # back-facing h terminates
    _other_lanes_unchanged(args, out_t, ~rd)


def test_scatter_dispersive_dielectric_matches():
    normal, d_in, rs = _hemisphere_inputs(N, 25)
    tint = (rs.rand(N, 3) * 0.5 + 0.5).astype(np.float32)
    ior = (1.3 + rs.rand(N) * 0.5).astype(np.float32)
    disp = (rs.rand(N) * 0.15).astype(np.float32)
    disp[::6] = 0.0
    throughput = rs.rand(N, 3).astype(np.float32)
    throughput[::9, 1] = 0.0             # a channel the path lost
    throughput[::37] = 0.0               # a dead path
    mt = np.where(np.arange(N) % 4 == 3, tmat.TYPE_METAL,
                  tmat.TYPE_DIELECTRIC).astype(np.int32)
    args = (mt, tint, ior, np.zeros((N, 3), np.float32), normal, d_in,
            rs.rand(N) > 0.3, rs.rand(N, 5).astype(np.float32))
    out_j, out_t = _run_scatter(args, disp=disp, throughput=throughput)
    _assert_scatter_agrees(out_j, out_t)
    a_t = out_t[1].numpy()
    on = (mt == tmat.TYPE_DIELECTRIC) & (disp > 0) & (throughput.sum(1) > 0)
    # One channel carries the weight tint_c / p_c; lost channels never.
    assert ((a_t[on] > 0).sum(1) == 1).all()
    assert (a_t[on & (throughput[:, 1] == 0.0), 1] == 0.0).all()
    _other_lanes_unchanged(args, out_t, ~on)


@pytest.mark.parametrize("column", ["param2", "disp", "aniso"])
def test_zero_columns_change_nothing(column):
    """A scene that carries a column where every row is 0 (or no row is of
    the column's type) renders its lanes as the column-free scatter."""
    normal, d_in, rs = _hemisphere_inputs(1024, 26)
    mt = rs.randint(0, 6, 1024).astype(np.int32)
    mt[mt == tmat.TYPE_ROUGH_DIELECTRIC] = tmat.TYPE_DIELECTRIC
    args = (mt, rs.rand(1024, 3).astype(np.float32),
            (rs.rand(1024) + 1.0).astype(np.float32),
            rs.rand(1024, 3).astype(np.float32), normal, d_in,
            rs.rand(1024) > 0.3, rs.rand(1024, 5).astype(np.float32))
    kw = {column: torch.zeros(1024)}
    if column == "disp":
        kw["throughput"] = torch.ones((1024, 3))
    out = tmat.scatter(*(torch.as_tensor(x) for x in args), **kw)
    plain = tmat.scatter(*(torch.as_tensor(x) for x in args))
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
