"""Heterogeneous participating media (the JAX package's ``ops/volume.py``):
a dense voxel grid of density in a world box, delta tracking for free
flights and ratio tracking for shadow-ray transmittance.

Extinction at a point is ``density(x) * (sigma_s + sigma_a)``, so the
single-scattering albedo is the constant ``sigma_s / (sigma_s +
sigma_a)``: a collision multiplies the throughput by it and continues by
Henyey–Greenstein phase sampling.

Each walk runs at a per-ray constant majorant (``_ray_rate``): the
maximum of ``coarse_ray`` (the coarse super-voxel majorants, dilated by a
3³ max-pool) over ``ray_samples`` points at most one coarse cell apart
along the ray's clipped segment, a true bound of the extinction along
it. With a constant rate the i-th collision distance is a prefix sum of
exponential flights, so a round draws ``BATCH_K`` flights at once and
evaluates their densities in one gather; rounds repeat while a lane is
unresolved, up to ``ceil(n_steps / BATCH_K)``. Every draw depends only on
the lane's key and the round index, so a round takes only the lanes
still walking, and the result of each lane is the one the JAX package's
all-lane loop gives. The sequential per-cell walks
(``sample_distance_seq``, ``transmittance_seq``) are the JAX package's
estimator cross-check, kept for the tests.

The round draws are threefry streams folded from ``STREAM_VOL`` and
``STREAM_VOLT`` (``ops.rng``), as the JAX package draws them; grid-free
scenes never fold them. ``BATCH_K`` is the JAX default of 8, a constant:
another K changes the streams.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pathtracing_tpu_torch.ops import rng
from pathtracing_tpu_torch.utils import metrics

# fold_in salts that keep the ratio-tracking walks of the three NEE arms
# (area light, environment, delta light) on disjoint sub-streams.
SALT_NEE = 1
SALT_ENV = 2
SALT_DELTA = 3

# Flights per batched walk round.
BATCH_K = 8


@dataclasses.dataclass(frozen=True, eq=False)
class VolumeGrid:
    """Dense voxel-grid medium in a world box (the JAX ``VolumeGrid``).

    ``density`` (Nz, Ny, Nx) f32 >= 0, scaled by ``sigma_s``/``sigma_a``
    (0-d f32) into scattering/absorption coefficients; voxel values sit at
    cell centers and lookups clamp to the boundary cells. ``majorant`` is
    the grid-max extinction, ``n_steps`` the walks' flight cap. An
    optional ``emission`` grid times ``emit_color`` makes the medium emit.
    ``coarse`` holds the dilated per-super-voxel extinction maxima and
    ``coarse_ray`` their 3³ max-pool (None: one global majorant);
    ``ray_samples`` is the per-ray majorant sample count (0 without the
    coarse grids)."""

    density: torch.Tensor
    sigma_s: torch.Tensor
    sigma_a: torch.Tensor
    g: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    majorant: torch.Tensor
    emission: torch.Tensor = None
    emit_color: torch.Tensor = None
    coarse: torch.Tensor = None
    coarse_ray: torch.Tensor = None
    n_steps: int = 64
    ray_samples: int = 0

    @property
    def albedo(self):
        """Constant single-scattering albedo sigma_s / sigma_t."""
        return self.sigma_s / torch.clamp(self.sigma_s + self.sigma_a,
                                          min=1e-20)


_INT_FIELDS = ("n_steps", "ray_samples")


def to_device(vol, device) -> VolumeGrid:
    """A VolumeGrid on ``device`` from one whose fields are numpy arrays
    or tensors (the JAX grid mapped through ``np.asarray``), or from a
    dict of its fields."""
    get = (vol.get if isinstance(vol, dict)
           else lambda f: getattr(vol, f, None))
    fields = {}
    for f in dataclasses.fields(VolumeGrid):
        x = get(f.name)
        if f.name in _INT_FIELDS:
            fields[f.name] = int(x if x is not None else f.default)
        elif x is not None:
            fields[f.name] = torch.as_tensor(
                np.array(x.cpu() if torch.is_tensor(x) else x, np.float32),
                device=device)
    return VolumeGrid(**fields)


def _coarse_majorants(density, block):
    """Per-super-voxel max of ``density`` over ``block``³ fine voxels,
    dilated by one voxel on every side (a trilinear lookup in a cell
    reaches the voxel centers one voxel outside it). Host numpy."""
    nz, ny, nx = density.shape
    pad = np.pad(density, 1, mode="edge")
    ncz = -(-nz // block)
    ncy = -(-ny // block)
    ncx = -(-nx // block)
    out = np.zeros((ncz, ncy, ncx), np.float32)
    for cz in range(ncz):
        for cy in range(ncy):
            for cx in range(ncx):
                out[cz, cy, cx] = pad[
                    cz * block:(cz + 1) * block + 2,
                    cy * block:(cy + 1) * block + 2,
                    cx * block:(cx + 1) * block + 2,
                ].max()
    return out


def build_grid(density, bbox_min, bbox_max, sigma_s, sigma_a=0.0, g=0.0,
               n_steps=None, emission=None, emit_color=None,
               coarse_block=8, device="cpu") -> VolumeGrid:
    """Host constructor (numpy in, tensors on ``device`` out), with the
    JAX package's tables and refusals. ``coarse_block``: fine voxels per
    super-voxel per axis; 0 disables the coarse grids (global-majorant
    walks)."""
    density = np.ascontiguousarray(np.asarray(density, np.float32))
    if density.ndim != 3:
        raise ValueError("density grid must be (Nz, Ny, Nx)")
    if float(density.min()) < 0.0:
        raise ValueError("density grid must be non-negative")
    sigma_s = float(sigma_s)
    sigma_a = float(sigma_a)
    if sigma_s + sigma_a <= 0.0:
        raise ValueError("volume needs sigma_s + sigma_a > 0")
    bmin = np.asarray(bbox_min, np.float32)
    bmax = np.asarray(bbox_max, np.float32)
    if not np.all(bmax > bmin):
        raise ValueError("volume bbox must have positive extent")
    if emission is not None:
        emission = np.ascontiguousarray(np.asarray(emission, np.float32))
        if emission.shape != density.shape:
            raise ValueError("emission grid must match density shape")
        if sigma_a <= 0.0:
            raise ValueError("emissive media need sigma_a > 0 (the "
                             "estimator weights emission by "
                             "sigma_a/sigma_t)")
        if emit_color is None:
            emit_color = (1.0, 1.0, 1.0)
    majorant = float(density.max()) * (sigma_s + sigma_a)
    coarse = coarse_ray = None
    ray_samples = 0
    if coarse_block and coarse_block > 0:
        coarse = _coarse_majorants(density, int(coarse_block)) * (
            sigma_s + sigma_a)
        cpad = np.pad(coarse, 1, mode="edge")
        coarse_ray = np.maximum.reduce([
            cpad[1 + dz:cpad.shape[0] - 1 + dz,
                 1 + dy:cpad.shape[1] - 1 + dy,
                 1 + dx:cpad.shape[2] - 1 + dx]
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
        ])
        nz_, ny_, nx_ = density.shape
        ncz, ncy, ncx = coarse.shape
        ext = bmax - bmin                        # x, y, z
        csize_axes = np.array([
            ext[0] * (-(-nx_ // ncx)) / nx_,
            ext[1] * (-(-ny_ // ncy)) / ny_,
            ext[2] * (-(-nz_ // ncz)) / nz_,
        ], np.float32)
        diag = float(np.linalg.norm(ext))
        ray_samples = int(math.ceil(diag / float(csize_axes.min()))) + 2
    if n_steps is None:
        lam = majorant * float(np.linalg.norm(bmax - bmin))
        n_steps = lam + 8.0 * math.sqrt(lam + 1.0) + 8.0
        if coarse is not None:
            # Boundary advances add at most one step per coarse cell
            # crossed.
            n_steps += float(sum(coarse.shape))
        n_steps = int(min(max(n_steps, 32.0), 512.0))

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return VolumeGrid(
        density=dev(density), sigma_s=dev(sigma_s), sigma_a=dev(sigma_a),
        g=dev(g), bbox_min=dev(bmin), bbox_max=dev(bmax),
        majorant=dev(majorant),
        emission=dev(emission) if emission is not None else None,
        emit_color=dev(emit_color) if emission is not None else None,
        coarse=dev(coarse) if coarse is not None else None,
        coarse_ray=dev(coarse_ray) if coarse_ray is not None else None,
        n_steps=int(n_steps), ray_samples=int(ray_samples),
    )


def _cell_index(u, hi: int):
    """``clip(int(u), 0, hi)`` of a floored coordinate, safe for values a
    cast cannot hold (clamped as floats first)."""
    return torch.clamp(torch.clamp(u, 0.0, float(hi)).to(torch.int64), 0,
                       hi)


def _trilinear(grid, bbox_min, bbox_max, x):
    """Trilinear lookup in a (Nz, Ny, Nx) grid at world points (R, 3), per
    axis with the JAX package's float32 operations."""
    nz, ny, nx = grid.shape
    ext = bbox_max - bbox_min
    i0, i1, f = [], [], []
    for a, n in enumerate((nx, ny, nz)):
        u = (x[:, a] - bbox_min[a]) / ext[a] * float(n) - 0.5
        i0f = torch.floor(u)
        f.append(u - i0f)
        lo = _cell_index(i0f, n - 1)
        i0.append(lo)
        i1.append(torch.clamp(lo + 1, 0, n - 1))
    flat = grid.reshape(-1)

    def fetch(ix, iy, iz):
        return flat[(iz * ny + iy) * nx + ix]

    (x0, y0, z0), (x1, y1, z1), (fx, fy, fz) = i0, i1, f
    c00 = fetch(x0, y0, z0) * (1 - fx) + fetch(x1, y0, z0) * fx
    c10 = fetch(x0, y1, z0) * (1 - fx) + fetch(x1, y1, z0) * fx
    c01 = fetch(x0, y0, z1) * (1 - fx) + fetch(x1, y0, z1) * fx
    c11 = fetch(x0, y1, z1) * (1 - fx) + fetch(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def density_at(vol: VolumeGrid, x):
    """Trilinear density at world points ``x`` (R, 3) -> (R,)."""
    return _trilinear(vol.density, vol.bbox_min, vol.bbox_max, x)


def emission_at(vol: VolumeGrid, x):
    """Emitted radiance at world points (R, 3) -> (R, 3); needs
    ``vol.emission``."""
    e = _trilinear(vol.emission, vol.bbox_min, vol.bbox_max, x)
    return e[:, None] * vol.emit_color[None, :]


def _safe_inv(d):
    safe_d = torch.where(torch.abs(d) > 1e-12, d,
                         torch.where(d >= 0.0, 1e-12, -1e-12))
    return 1.0 / safe_d


def _ray_box(o, d, bmin, bmax):
    """Slab test: per-ray (t_enter, t_exit); t_enter > t_exit is a miss."""
    inv = _safe_inv(d)
    ta = (bmin - o) * inv
    tb = (bmax - o) * inv
    t0 = torch.amax(torch.minimum(ta, tb), dim=-1)
    t1 = torch.amin(torch.maximum(ta, tb), dim=-1)
    return t0, t1


def _flight(u, inv_maj):
    """Exponential free-flight length at the majorant rate."""
    return -torch.log1p(-torch.clamp(u, max=1.0 - 1e-7)) * inv_maj


def _coarse_geom(vol: VolumeGrid):
    """Coarse-cell geometry: the per-axis world cell size ((3,) f32, x y z
    order), the per-axis top cell indices, the flat majorant table and
    the monotone-progress epsilon."""
    ncz, ncy, ncx = vol.coarse.shape
    nz, ny, nx = vol.density.shape
    scale = (np.array([-(-nx // ncx), -(-ny // ncy), -(-nz // ncz)],
                      np.float32)
             / np.array([nx, ny, nz], np.float32))
    ext = vol.bbox_max - vol.bbox_min
    csize = torch.stack([ext[a] * float(scale[a]) for a in range(3)])
    t_eps = 1e-4 * torch.amin(csize)
    return csize, (ncx - 1, ncy - 1, ncz - 1), vol.coarse.reshape(-1), t_eps


def _coarse_cells(vol, csize, hi, x):
    """(..., 3) coarse-cell indices (x, y, z) of world points ``x``."""
    return [_cell_index(torch.floor((x[..., a] - vol.bbox_min[a])
                                    / csize[a]), hi[a]) for a in range(3)]


def _coarse_step(vol, csize, hi, cflat, t_eps, o, d, t, u_flight):
    """One piecewise-constant-majorant step of the sequential walks: the
    current cell's majorant, a flight at it, clamped to the cell exit.
    Returns (t_new, advance, inv_lm): ``advance`` lanes crossed a
    boundary (no collision test there)."""
    ncz, ncy, ncx = vol.coarse.shape
    x = o + (t + t_eps)[:, None] * d
    cx, cy, cz = _coarse_cells(vol, csize, hi, x)
    lm = cflat[(cz * ncy + cy) * ncx + cx]
    ci = torch.stack([cx, cy, cz], dim=-1).to(torch.float32)
    clo = vol.bbox_min + ci * csize
    inv_d = _safe_inv(d)
    tb = torch.amin(torch.maximum((clo - o) * inv_d,
                                  (clo + csize - o) * inv_d), dim=-1)
    tb = torch.maximum(tb, t + t_eps)
    inv_lm = 1.0 / torch.clamp(lm, min=1e-20)
    t_cand = t + _flight(u_flight, inv_lm)
    advance = (lm <= 0.0) | (t_cand >= tb)
    return torch.where(advance, tb, t_cand), advance, inv_lm


def _linspace01(s: int, device):
    """``jnp.linspace(0, 1, s, float32)`` bit for bit: i · f32(1/(s-1)),
    then 1 exactly."""
    if s == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = float(np.float32(1.0 / (s - 1)))
    frac = torch.arange(s, dtype=torch.float32, device=device) * step
    return torch.where(torch.arange(s, device=device) == s - 1, 1.0, frac)


def _ray_rate(vol: VolumeGrid, o, d, t0, t1):
    """Per-ray constant majorant over the clipped segment [t0, t1]: the max
    of ``coarse_ray`` over ``ray_samples`` points at most one coarse cell
    apart. Returns (rate, inv_rate), (R,) f32; the global majorant when
    the coarse grids are disabled."""
    r = o.shape[0]
    if vol.coarse_ray is None or vol.ray_samples <= 0:
        rate = vol.majorant.expand(r)
        return rate, 1.0 / torch.clamp(rate, min=1e-20)
    ncz, ncy, ncx = vol.coarse_ray.shape
    csize, hi, _, _ = _coarse_geom(vol)
    frac = _linspace01(vol.ray_samples, o.device)
    ts = t0[:, None] + (t1 - t0)[:, None] * frac[None, :]       # (R, S)
    xs = o[:, None, :] + ts[..., None] * d[:, None, :]          # (R, S, 3)
    cx, cy, cz = _coarse_cells(vol, csize, hi, xs)
    lm = vol.coarse_ray.reshape(-1)[(cz * ncy + cy) * ncx + cx]
    rate = torch.amax(torch.where(ts <= t1[:, None], lm, 0.0), dim=1)
    return rate, 1.0 / torch.clamp(rate, min=1e-20)


def _walk_lanes(vol, o, d, t0, t1, want):
    """The lanes ``want`` & (t0 < t1) & (rate > 0) that a batched walk
    takes, with their rates: (index, inv_rate) of those lanes only."""
    idx = metrics.host_read("volume.lanes", torch.nonzero,
                            want & (t0 < t1)).squeeze(1)
    rate, inv_rate = _ray_rate(vol, o[idx], d[idx], t0[idx], t1[idx])
    keep = rate > 0.0
    return metrics.host_read("volume.lanes", metrics.masked, keep, idx,
                             inv_rate, syncs=2)


def _round(vol, k, i, o, d, t, inv_rate, n_u):
    """One batched round on the walking lanes: (u (n, K, n_u), ts (n, K),
    densities (n, K))."""
    n = o.shape[0]
    u = rng.uniform(rng.fold_in(k, i), BATCH_K * n_u).reshape(n, BATCH_K,
                                                              n_u)
    flights = _flight(u[..., 0], inv_rate[:, None])
    ts = t[:, None] + torch.cumsum(flights, dim=1)
    xs = o[:, None, :] + ts[..., None] * d[:, None, :]
    dens = density_at(vol, xs.reshape(n * BATCH_K, 3)).reshape(n, BATCH_K)
    return u, ts, dens


def sample_distance(vol: VolumeGrid, keys, depth, o, d, t_max, active):
    """Delta-tracking free-flight sampling inside the grid (batched).

    Returns (event, t_event, u_phase): a bool (R,) marking lanes whose
    next vertex is an in-medium collision before ``t_max``, the event
    distance (the clipped segment's exit where there is none), and two
    phase uniforms of the same stream at the round index past every walk
    round. ``depth``: an int or (R,) integer tensor."""
    t0, t1 = _ray_box(o, d, vol.bbox_min, vol.bbox_max)
    t0 = torch.clamp(t0, min=0.0)
    t1 = torch.minimum(t1, t_max)
    sig_scale = vol.sigma_s + vol.sigma_a
    k_vol = rng.stream_key(keys, depth, rng.STREAM_VOL)
    r = o.shape[0]
    n_rounds = -(-vol.n_steps // BATCH_K)
    event = torch.zeros(r, dtype=torch.bool, device=o.device)
    t_evt = t1.clone()
    idx, inv_rate = _walk_lanes(vol, o, d, t0, t1, active)
    k, ow, dw, t, t1w = k_vol[idx], o[idx], d[idx], t0[idx], t1[idx]
    i = 0
    while i < n_rounds and idx.numel() > 0:
        u, ts, dens = _round(vol, k, i, ow, dw, t, inv_rate, 2)
        p_real = dens * sig_scale * inv_rate[:, None]
        accept = (ts < t1w[:, None]) & (u[..., 1] < p_real)
        any_acc = torch.any(accept, dim=1)
        first = torch.argmax(accept.to(torch.int8), dim=1)      # first True
        t_hit = torch.gather(ts, 1, first[:, None])[:, 0]
        # Every round reads the walking lanes back (ROADMAP C2).
        hit_idx, t_acc = metrics.host_read(
            "volume.distance", metrics.masked, any_acc, idx, t_hit, syncs=2)
        metrics.host_read("volume.distance", event.__setitem__, hit_idx,
                          True)
        t_evt[hit_idx] = t_acc
        go = ~any_acc & (ts[:, -1] < t1w)
        idx, k, ow, dw, t1w, inv_rate = metrics.host_read(
            "volume.distance", metrics.masked, go, idx, k, ow, dw, t1w,
            inv_rate, syncs=6)
        t = metrics.host_read("volume.distance", ts.__getitem__, (go, -1))
        i += 1
    u_phase = rng.uniform(rng.fold_in(k_vol, n_rounds), 2)
    return event, torch.where(event, t_evt, t1), u_phase


def transmittance(vol: VolumeGrid, keys, depth, o, d, t_max, salt,
                  active=None):
    """Ratio-tracking transmittance along (o, d) up to ``t_max`` -> (R,).

    Exponential flights at the per-ray rate, multiplying
    ``1 - sigma_t(x)/rate`` per collision until the walk leaves the
    clipped segment, ``BATCH_K`` flights a round. ``salt`` keeps the NEE
    arms on disjoint streams. ``active`` (optional (R,) bool) restricts
    the walk to the lanes a caller reads; the others give 1."""
    t0, t1 = _ray_box(o, d, vol.bbox_min, vol.bbox_max)
    t0 = torch.clamp(t0, min=0.0)
    t1 = torch.minimum(t1, t_max)
    sig_scale = vol.sigma_s + vol.sigma_a
    r = o.shape[0]
    trans = torch.ones(r, dtype=torch.float32, device=o.device)
    want = (torch.ones(r, dtype=torch.bool, device=o.device)
            if active is None else active)
    idx, inv_rate = _walk_lanes(vol, o, d, t0, t1, want)
    if not isinstance(depth, int):
        depth = depth[idx]
    k = rng.fold_in(rng.stream_key(keys[idx], depth, rng.STREAM_VOLT), salt)
    ow, dw, t, t1w = o[idx], d[idx], t0[idx], t1[idx]
    tr = torch.ones(idx.shape[0], dtype=torch.float32, device=o.device)
    n_rounds = -(-vol.n_steps // BATCH_K)
    i = 0
    while i < n_rounds and idx.numel() > 0:
        _, ts, dens = _round(vol, k, i, ow, dw, t, inv_rate, 1)
        ratio = torch.clamp(1.0 - dens * sig_scale * inv_rate[:, None],
                            min=0.0)
        counts = ts < t1w[:, None]
        tr = tr * torch.prod(torch.where(counts, ratio, 1.0), dim=1)
        trans[idx] = tr
        go = (ts[:, -1] < t1w) & (tr > 0.0)
        idx, k, ow, dw, t1w, inv_rate, tr = metrics.host_read(
            "volume.transmittance", metrics.masked, go, idx, k, ow, dw, t1w,
            inv_rate, tr, syncs=7)
        t = metrics.host_read("volume.transmittance", ts.__getitem__,
                              (go, -1))
        i += 1
    return trans


def sample_distance_seq(vol: VolumeGrid, keys, depth, o, d, t_max,
                        active):
    """The sequential per-cell delta-tracking walk (regular tracking
    across the coarse cells, delta tracking inside each), one draw pair a
    step: the same estimator as ``sample_distance`` on another stream
    layout; the tests' cross-check."""
    t0, t1 = _ray_box(o, d, vol.bbox_min, vol.bbox_max)
    t0 = torch.clamp(t0, min=0.0)
    t1 = torch.minimum(t1, t_max)
    sig_scale = vol.sigma_s + vol.sigma_a
    inv_maj = 1.0 / torch.clamp(vol.majorant, min=1e-20)
    k_vol = rng.stream_key(keys, depth, rng.STREAM_VOL)
    r = o.shape[0]
    done = ~active | (t0 >= t1)
    event = torch.zeros(r, dtype=torch.bool, device=o.device)
    coarse = vol.coarse is not None
    if coarse:
        geom = _coarse_geom(vol)
    t = t0
    i = 0
    while i < vol.n_steps and not bool(done.all()):
        u = rng.uniform(rng.fold_in(k_vol, i), 2)
        if coarse:
            t_new, advance, inv_lm = _coarse_step(vol, *geom, o, d, t,
                                                  u[:, 0])
        else:
            t_new = t + _flight(u[:, 0], inv_maj)
            advance = torch.zeros(r, dtype=torch.bool, device=o.device)
            inv_lm = inv_maj
        esc = t_new >= t1
        p_real = density_at(vol, o + t_new[:, None] * d) * sig_scale * inv_lm
        real = ~advance & (u[:, 1] < p_real)
        event = event | (~done & ~esc & real)
        t = torch.where(done, t, t_new)
        done = done | esc | real
        i += 1
    u_phase = rng.uniform(rng.fold_in(k_vol, vol.n_steps), 2)
    return event, t, u_phase


def transmittance_seq(vol: VolumeGrid, keys, depth, o, d, t_max, salt):
    """The sequential per-cell ratio-tracking walk (see
    ``sample_distance_seq``)."""
    t0, t1 = _ray_box(o, d, vol.bbox_min, vol.bbox_max)
    t0 = torch.clamp(t0, min=0.0)
    t1 = torch.minimum(t1, t_max)
    sig_scale = vol.sigma_s + vol.sigma_a
    inv_maj = 1.0 / torch.clamp(vol.majorant, min=1e-20)
    k_t = rng.fold_in(rng.stream_key(keys, depth, rng.STREAM_VOLT), salt)
    r = o.shape[0]
    done = t0 >= t1
    trans = torch.ones(r, dtype=torch.float32, device=o.device)
    coarse = vol.coarse is not None
    if coarse:
        geom = _coarse_geom(vol)
    t = t0
    i = 0
    while i < vol.n_steps and not bool(done.all()):
        u = rng.uniform(rng.fold_in(k_t, i))
        if coarse:
            t_new, advance, inv_lm = _coarse_step(vol, *geom, o, d, t, u)
        else:
            t_new = t + _flight(u, inv_maj)
            advance = torch.zeros(r, dtype=torch.bool, device=o.device)
            inv_lm = inv_maj
        esc = t_new >= t1
        ratio = torch.clamp(
            1.0 - density_at(vol, o + t_new[:, None] * d) * sig_scale
            * inv_lm, min=0.0)
        trans = torch.where(~done & ~esc & ~advance, trans * ratio, trans)
        t = torch.where(done, t, t_new)
        done = done | esc
        i += 1
    return trans
