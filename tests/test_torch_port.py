"""Port checks (g), (h) and the engine's invariants.

(g) The port imports no JAX: every module imports in a subprocess with
    ``sys.modules["jax"] = None``, and no source line of the port or of
    chip_smoke.py imports ``jax`` or ``pathtracing_tpu.``.
(h) Entry points run on the card unless the caller passes ``device="cpu"``:
    with no GPU they raise; a CUDA-route wrapper given a tensor on neither
    the CPU nor a CUDA device raises instead of falling back.
Engine invariants (exact, tolerance none): row chunking and live-first
compaction leave every pixel's result unchanged; progressive steps sum
to the single-shot render; the tonemap and PNG bytes equal the JAX
package's.
"""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracing_tpu.utils import image as jimage
from pathtracing_tpu_torch.models import megakernel, progressive, scenes
from pathtracing_tpu_torch.models import scene as scene_mod
from pathtracing_tpu_torch.models.scene import SceneBuilder
from pathtracing_tpu_torch.ops import camera as tcamera
from pathtracing_tpu_torch.ops import cluster_trace, cuda_build
from pathtracing_tpu_torch.utils import config as tconfig
from pathtracing_tpu_torch.utils import image as timage

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pathtracing_tpu_torch")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG],
                                              "pathtracing_tpu_torch.")
    )


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "pathtracing_tpu_torch.ops.cluster_trace" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pathtracing_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in "
        "sys.modules.items() if v is not None}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _sources():
    for dirpath, dirs, files in os.walk(PKG):
        # The git-ignored build directory holds compiled output only.
        dirs[:] = [d for d in dirs if d != ".build"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_jax_or_reference_imports_in_source():
    offenders = []
    for path in _sources():
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if not re.match(r"\s*(import\s+\w|from\s+[\w.]+\s+import\b)",
                                line):
                    continue
                code = line.replace("pathtracing_tpu_torch", "")
                if re.search(r"\bjax\b", code) or "pathtracing_tpu" in code:
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders


def test_cuda_sources_are_not_built_on_import():
    # Only the host BVH builder may have been built, by a scene build.
    assert set(cuda_build._LOADED) <= {"bvh_builder"}
    assert sorted(os.listdir(cuda_build.CSRC)) == [
        "bvh_builder.cpp", "cluster_common.cuh", "cluster_trace.cu",
        "cluster_trace_inst.cu", "cluster_trace_inst_tree.cu",
        "cluster_trace_paged.cu", "cluster_trace_tree.cu",
        "cluster_walk.cuh", "pgather.cu", "rng.cu"]
    assert cuda_build.sources() == ["cluster_trace", "cluster_trace_inst",
                                    "cluster_trace_inst_tree",
                                    "cluster_trace_paged",
                                    "cluster_trace_tree", "pgather", "rng"]
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "pathtracing_tpu_torch/.build/" in f.read().split()


def _cuda_functions():
    """{name: (body, is a __global__ kernel)} of every function defined in
    the port's CUDA sources (``csrc/*.cu``, ``*.cuh``), comments
    stripped."""
    code = ""
    for f in sorted(os.listdir(cuda_build.CSRC)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(cuda_build.CSRC, f)) as fh:
                code += fh.read() + "\n"
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", code, flags=re.S)

    def close(i, open_c, close_c):
        depth = 0
        for j in range(i, len(code)):
            depth += (code[j] == open_c) - (code[j] == close_c)
            if depth == 0:
                return j
        raise AssertionError("unbalanced " + open_c)

    out = {}
    for m in re.finditer(r"\b(\w+)\s*\(", code):
        if m.group(1) in ("if", "for", "while", "switch", "return",
                          "__launch_bounds__", "sizeof"):
            continue
        end = close(m.end() - 1, "(", ")")
        rest = code[end + 1:].lstrip()
        if not rest.startswith("{"):
            continue
        start = len(code) - len(rest)
        head = code[:m.start()]
        head = head[max(head.rfind(";"), head.rfind("}")) + 1:]
        out[m.group(1)] = (code[start:close(start, "{", "}") + 1],
                           "__global__" in head)
    return out


def _calls(body, names):
    """(position, name) of each call in ``body`` to a function of
    ``names``, in order."""
    return [(m.start(), m.group(1)) for m in re.finditer(
        r"\b(\w+)\s*(?:<[^;{}()]*>)?\s*\(", body) if m.group(1) in names]


def _reaching(funcs, target="warp_walk"):
    """The functions whose calls reach ``target`` (``target`` included)."""
    reach = {target}
    while True:
        more = {f for f, (body, _) in funcs.items()
                if f not in reach and _calls(body, reach)}
        if not more:
            return reach
        reach |= more


WALKER_KERNELS = {"trace_dnf_kernel", "occluded_dnf_kernel",
                  "trace_paged_dnf_kernel", "occluded_paged_dnf_kernel",
                  "trace_tree_kernel", "occluded_tree_kernel",
                  "trace_tree_paged_kernel", "trace_inst_tree_kernel",
                  "occluded_inst_tree_kernel"}


def test_one_lane_cluster_walk_is_gone():
    """No CUDA source defines or calls the one-lane walk or its one-lane
    cluster scans: every tree walk is the warp-cooperative walker."""
    funcs = _cuda_functions()
    gone = {"walk_tree", "closest_in_cluster", "any_in_cluster"}
    assert "warp_walk" in funcs
    assert not gone & set(funcs)
    assert [(f, c) for f, (body, _) in funcs.items()
            for _, c in _calls(body, gone)] == []


def test_every_tree_walking_kernel_reaches_the_warp_walker():
    funcs = _cuda_functions()
    kernels = {f for f, (_, is_global) in funcs.items() if is_global}
    assert WALKER_KERNELS <= kernels
    assert kernels & _reaching(funcs) == WALKER_KERNELS


def test_no_return_before_the_warp_walker():
    """Every lane of a warp must reach the walker's warp intrinsics: no
    kernel on it, nor any function between the kernel and the walker,
    returns before its call on the way there."""
    funcs = _cuda_functions()
    reach = _reaching(funcs)
    for kernel in WALKER_KERNELS:
        f = kernel
        while f != "warp_walk":
            body = funcs[f][0]
            calls = _calls(body, reach)
            assert calls, (kernel, f)
            pos, callee = calls[0]
            assert not re.search(r"\breturn\b", body[:pos]), (kernel, f)
            f = callee


def test_library_name_follows_source_headers_and_flags(tmp_path,
                                                       monkeypatch):
    """An edited source, shared header or flag set gives another library
    name, so a stale build is never loaded."""
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    (tmp_path / "a.cu").write_text("// a")
    (tmp_path / "b.cu").write_text("// b")
    (tmp_path / "common.cuh").write_text("// h")
    assert cuda_build.sources() == ["a", "b"]
    names = {n: cuda_build._library_path(n) for n in ("a", "b")}
    assert names["a"] != names["b"]
    assert os.path.dirname(names["a"]) == cuda_build.BUILD_DIR
    (tmp_path / "common.cuh").write_text("// h2")
    assert all(cuda_build._library_path(n) != names[n] for n in names)
    (tmp_path / "common.cuh").write_text("// h")
    assert cuda_build._library_path("a") == names["a"]
    (tmp_path / "a.cu").write_text("// a2")
    assert cuda_build._library_path("a") != names["a"]
    assert cuda_build._library_path("b") == names["b"]
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", ("-O0",))
    assert cuda_build._library_path("b") != names["b"]


def test_compiled_here_tells_a_fresh_build_from_a_cached_one(tmp_path,
                                                             monkeypatch):
    """A library this process compiled reports so; the same library found
    on disk by a later process reports a cached build, log and all."""
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_COMPILED", set())
    # A stand-in compiler that writes its output and one line of log:
    # ``sh -c 'touch "$2"; echo built' sh -o <out> <src>``.
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "sh")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        ("-c", 'touch "$2"; echo built', "sh"))
    (tmp_path / "a.cu").write_text("// a")
    assert not cuda_build.compiled_here("a")
    cuda_build.build("a")
    assert cuda_build.compiled_here("a")
    assert cuda_build.build_log("a").strip() == "built"
    monkeypatch.setattr(cuda_build, "_COMPILED", set())
    cuda_build.build("a")
    assert not cuda_build.compiled_here("a")
    assert cuda_build.build_log("a").strip() == "built"


@pytest.mark.parametrize("mangled, name", [
    ("_ZN55_GLOBAL__N__a3ed6920_22_cluster_trace_paged_cu_39034780"
     "22trace_paged_dnf_kernelEvPKfS1_i",
     "trace_paged_dnf_kernel"),
    ("_ZN54_GLOBAL__N__ecd8c24e_21_cluster_trace_inst_cu_0ec8248f"
     "21trace_dnf_inst_kernelILb1EEEvPKf",
     "trace_dnf_inst_kernel<true>"),
    ("_ZN54_GLOBAL__N__ecd8c24e_21_cluster_trace_inst_cu_0ec8248f"
     "24occluded_dnf_inst_kernelILb0EEEvPKf",
     "occluded_dnf_inst_kernel<false>"),
    ("_Z18gather_rows_kernelPKfPKiPfiii",
     "gather_rows_kernel"),
    ("_Z9walk_treeILb1EEvPKf",
     "_Z9walk_treeILb1EEvPKf"),
])
def test_ptxas_kernel_names(mangled, name):
    """chip_smoke reads each kernel's registers under its own name, with
    the bool of a templated kernel; a symbol with no ``*_kernel`` stays."""
    import chip_smoke

    assert chip_smoke.demangled_kernel(mangled) == name


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["scene", "camera", "state", "scenes",
                                   "device_cuda"])
def test_entry_points_raise_without_gpu(no_gpu, entry):
    cfg = tconfig.RenderConfig(width=8, height=8)
    calls = {
        "scene": lambda: SceneBuilder().build(),
        "camera": lambda: tcamera.build_camera(scenes.CORNELL_CAMERA, 1.0),
        "state": lambda: progressive.init_state(cfg),
        "scenes": lambda: scenes.cornell_sphere(),
        "device_cuda": lambda: tconfig.resolve_device("cuda"),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_entry_points_run_on_cpu_when_asked(no_gpu):
    assert tconfig.resolve_device("cpu") == torch.device("cpu")
    scene, cam_cfg = scenes.cornell_sphere(device="cpu")
    assert scene.tri_v0.device.type == "cpu"
    cfg = tconfig.RenderConfig(width=8, height=8)
    assert cfg.resolve_traversal(scene) == "cluster_torch"
    state = progressive.init_state(cfg, device="cpu")
    assert state.accum.device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device (here ``meta``) must
    raise: the wrappers take the plain path only for CPU tensors."""
    scene, _ = scenes.cornell_sphere(device="cpu")
    cl = scene.clusters._replace(
        **{f: getattr(scene.clusters, f).to("meta")
           for f in scene.clusters._fields})
    o = torch.zeros((4, 3), device="meta")
    t = torch.ones(4, device="meta")
    before = dict(cluster_trace.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cluster_trace.trace(cl, o, o, t)
    with pytest.raises(ValueError, match="CUDA"):
        cluster_trace.occluded(cl, o, o, t)
    assert cluster_trace.LAUNCHES == before
    assert set(before) == {"trace", "occluded", "trace_inst",
                           "occluded_inst", "trace_paged_dnf",
                           "occluded_paged_dnf", "trace_tree",
                           "occluded_tree", "trace_tree_paged",
                           "trace_inst_tree", "occluded_inst_tree"}


def test_unported_traversal_modes_raise():
    """The JAX package's interpret and plain-XLA modes have no counterpart;
    "bvh" is ported, and "auto" keeps the cluster routes."""
    scene, _ = scenes.cornell_sphere(device="cpu")
    for mode in ("cluster_interpret", "cluster_jax", "cluster_pallas"):
        with pytest.raises(ValueError, match="not ported"):
            tconfig.RenderConfig(traversal=mode).resolve_traversal(scene)
    assert tconfig.RenderConfig(traversal="bvh").resolve_traversal(
        scene) == "bvh"
    assert tconfig.RenderConfig().resolve_traversal(scene) == "cluster_torch"


@pytest.fixture(scope="module")
def mesh():
    scene, cam_cfg = scenes.cornell_mesh(2, device="cpu")
    return scene, tcamera.build_camera(cam_cfg, 1.5, device="cpu")


def _render(mesh, **kw):
    scene, cam = mesh
    cfg = tconfig.RenderConfig(width=24, height=16, max_depth=6,
                               rr_start_depth=4, **kw)
    return megakernel.render_samples(scene, cam, cfg, sample_start=2,
                                     n_samples=2, seed=3)


def test_row_chunking_is_bitwise_neutral(mesh, monkeypatch):
    ref = _render(mesh)
    for cap in (24 * 4, 24 * 5):     # divisor chunks; ceil-split + padding
        monkeypatch.setattr(megakernel, "MAX_WAVE_RAYS", cap)
        assert torch.equal(_render(mesh), ref), cap


def test_compaction_is_bitwise_neutral(mesh, monkeypatch):
    ref = _render(mesh)
    monkeypatch.setattr(megakernel, "COMPACT_DEPTHS", ())
    assert torch.equal(_render(mesh), ref)


def test_block_rows_match_full_image(mesh):
    scene, cam = mesh
    cfg = tconfig.RenderConfig(width=24, height=16, max_depth=4)
    full = megakernel.render_samples(scene, cam, cfg, 0, 1, 5)
    part = megakernel.render_samples(scene, cam, cfg, 0, 1, 5, row_start=5,
                                     block_rows=7)
    assert torch.equal(part, full[5:12])


def test_progressive_steps_sum_to_render_once(mesh):
    scene, cam = mesh
    cfg = tconfig.RenderConfig(width=24, height=16, max_depth=4,
                               samples_per_pixel=4, samples_per_step=2,
                               seed=7)
    state = progressive.init_state(cfg, device="cpu")
    accum = state.accum
    stats = {}
    for _ in range(2):
        state = progressive.render_step(state, scene, cam, cfg, stats=stats)
    assert state.accum is accum and state.spp == 4     # updated in place
    once = progressive.render_once(scene, cam, cfg)
    torch.testing.assert_close(progressive.resolve(state), once,
                               rtol=1e-6, atol=1e-6)
    assert int(stats["segments"]) >= 24 * 16 * 4
    assert 0 < int(stats["shadow_segments"]) <= int(stats["segments"])


@pytest.mark.parametrize("curve", ["clip", "aces", "reinhard", "filmic"])
def test_tonemap_and_png_match_jax(curve):
    rs = np.random.RandomState(0)
    img = (rs.rand(9, 13, 3) * 3.0).astype(np.float32)
    a = np.asarray(jimage.tonemap(jnp.asarray(img), 1.3, curve))
    b = timage.tonemap(torch.as_tensor(img), 1.3, curve).numpy()
    # The sRGB transfer's pow may round an 8-bit code differently.
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert (a == b).mean() > 0.99
    assert jimage.encode_png(b) == timage.encode_png(b)


def _open_roadmap_items():
    """The item numbers of ROADMAP.md queue A's "Still to port" list."""
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        text = f.read()
    queue_a = text.split("### A.", 1)[1].split("### B.", 1)[0]
    still = queue_a.split("Still to port", 1)[1]
    return {int(n) for n in re.findall(r"^(\d+)\. \*\*", still, re.M)}


def test_not_implemented_messages_name_an_open_item():
    """Every ``NotImplementedError`` the port raises names the ROADMAP
    queue-A item that ports it, and that item is still open. Queue A is
    empty since the app shell (21) and ``parallel/`` (19) were ported: no
    item is open, so no ``NotImplementedError`` may be left, and the
    tables of unported scene fields and scenes are gone."""
    open_items = _open_roadmap_items()
    assert open_items == set()
    assert not hasattr(scene_mod, "_UNPORTED_FIELDS")
    assert not hasattr(scenes, "UNPORTED_SCENES")
    raises = []
    for path in _sources():
        if not path.startswith(PKG):
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Raise)
                    and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", "")
                    == "NotImplementedError"):
                text = "".join(c.value for c in ast.walk(node.exc)
                               if isinstance(c, ast.Constant)
                               and isinstance(c.value, str))
                raises.append((f"{path}:{node.lineno}", text))
    assert raises == []
