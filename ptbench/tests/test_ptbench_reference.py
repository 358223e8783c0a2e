"""The plain reference against the port's plain route on the CPU: a
32x32 render of the Cornell box with a small icosphere. The test imports
both; the reference itself imports nothing of the port."""

import subprocess
import sys

import numpy as np
import torch

from ptbench import check, spec
from ptbench.reference import pathtrace
from ptbench.scenes import cornell_mesh

W = H = 32
N = 3
SEED = 2**32 + 99


def _port_accum(data):
    from pathtracing_tpu_torch.models import progressive
    from pathtracing_tpu_torch.ops.camera import build_camera
    from pathtracing_tpu_torch.utils.config import CameraConfig, RenderConfig

    scene = cornell_mesh.build_port(data, "cpu")
    cam = build_camera(CameraConfig(**data["camera"]), W / H, device="cpu")
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=N, max_depth=8,
                       rr_start_depth=8, samples_per_step=1, seed=SEED)
    state = progressive.init_state(cfg, device="cpu")
    for _ in range(N):
        state = progressive.render_step(state, scene, cam, cfg)
    return state.accum.reshape(-1, 3)


def test_reference_follows_the_ports_paths():
    data = cornell_mesh.scene_data({"subdivisions": 2})
    config = {"width": W, "height": H, "max_depth": 8}
    ref = check.Reference(data, cornell_mesh.triangles(data), config, "cpu")
    prog = _port_accum(data)
    pix = np.arange(W * H)
    spp = np.full(pix.size, N)
    gaps = []
    for light in ref.orders:
        want = ref.sums(SEED, pix, spp, light)
        gaps.append(check.pixel_gaps(prog, want, torch.as_tensor(spp),
                                      0.01))
    good, other = sorted(gaps, key=lambda g: float(g.median()))
    # The program's own order: the same paths, so the sums agree to float
    # rounding on nearly every pixel.
    assert float(good.median()) <= 1e-6
    assert float((good > check.OFF_GAP).float().mean()) <= 0.01
    # The other order picks the other light triangle: most pixels differ.
    assert float((other > check.OFF_GAP).float().mean()) >= 0.3
    ref.pick_order(SEED, pix, spp, prog)
    assert ref.light is ref.orders[[float(g.median()) for g in gaps].index(
        float(good.median()))]


def test_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            "import ptbench.check, ptbench.calibrate, ptbench.reftime\n"
            "from ptbench.reference import (instanced, pathtrace, schedule,\n"
            "                               streams)\n"
            "from ptbench.scenes import cornell_mesh, instanced_field\n"
            "d = cornell_mesh.scene_data({'subdivisions': 1})\n"
            "cornell_mesh.triangles(d)\n"
            "c = {'grid': 2, 'subdivisions': 1, 'radius': 0.45,\n"
            "     'spacing': 1.5, 'placement_seed': 7, 'width': 8,\n"
            "     'height': 8, 'max_depth': 2}\n"
            "d = instanced_field.scene_data(c)\n"
            "instanced_field.reference(d, c, 'cpu').sums(1, [0, 9], [1, 1])\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'pathtracing_tpu_torch', 'pathtracing_tpu',\n"
            "                'jax', 'jaxlib', 'flax'})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_geometry_finds_the_nearest_hit():
    data = cornell_mesh.scene_data({"subdivisions": 1})
    v0, e1, e2, mat = cornell_mesh.triangles(data)
    geo = pathtrace.prepare(v0, e1, e2, mat, "cpu", group=8)
    o = torch.tensor([[0.0, -0.5, 3.0], [0.0, 0.5, 0.0], [0.0, 0.0, 3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    t, row = pathtrace.closest(geo, o, d, torch.full((3,), 1e30))
    # The icosphere's front (radius 0.5 at z >= 0.4 for a coarse mesh),
    # the ceiling light at y = 2 * 554 / 555 - 1, and nothing behind the
    # camera.
    assert 2.0 < float(t[0]) < 2.61 and mat[int(row[0])] == cornell_mesh.BODY
    assert abs(float(t[1]) - (2 * 554 / 555 - 1.5)) < 1e-5
    assert mat[int(row[1])] == cornell_mesh.LIGHT
    assert int(row[2]) == -1 and torch.isinf(t[2])
