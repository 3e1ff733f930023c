"""PyTorch port, the slice as a whole: two coupled frames of the port's
`coupled_step_grid_fast` against the same frames composed from the JAX
package (grid-FEM step -> Wendland weights -> Pallas deformed trace in
interpret mode) on a small additive scene; the package's import
hygiene (also of the simulation frame's modules, whose own whole-frame
test is test_torch_frame.py); its default device; and that nothing in it
falls back when a kernel, a build or a phase fails."""
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.fem import grid_fem as jax_gfm
from fembrain_tpu.mesh.polygonize import extract_tet_mesh as jax_extract
from fembrain_tpu.mesh.polygonize import grid_for_scene as jax_grid
from fembrain_tpu.mesh.samples import bottom_nodes_per_component as jax_bottom
from fembrain_tpu.render import deformed as jd
from fembrain_tpu.render.camera import Camera as JaxCamera
from fembrain_tpu.render.camera import generate_rays as jax_rays

import fembrain_tpu_torch
from fembrain_tpu_torch import convert
from fembrain_tpu_torch.blob.scene import SceneDef
from fembrain_tpu_torch.fem import grid_fem as pgfm
from fembrain_tpu_torch.fem import tetmesh as ptet
from fembrain_tpu_torch.render import deformed as pd
from fembrain_tpu_torch.render.camera import Camera
from fembrain_tpu_torch.render.deformed import coupled_step_grid_fast

from test_torch_fem import BRAIN, assert_fem_state_close
from test_torch_wendland import K_REFRESH, _k2_agree

REPO = Path(__file__).resolve().parent.parent


def test_coupled_frames_match_composed_jax_steps():
    """Brain at cellsize 0.3, 64 Wendland centers, a 16x16 image, CG at
    its default tolerance: on this mesh both frameworks' CG counts stay
    within one iteration (on smaller meshes the JAX package's f32
    reductions drift its counts by up to five)."""
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jax_grid(js, cellsize=0.3)
    jtm = jax_extract(js, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6)
    nodes = np.asarray(jtm.nodes)[: int(jtm.n_nodes)]
    tets = np.asarray(jtm.tets)[: int(jtm.n_tets)]
    jgf = jax_gfm.grid_fem_from_tetmesh(
        grid, jtm, fixed_nodes=jax_bottom(nodes, tets, frac=0.25))
    interp = jd.build_disp_interp(nodes, n_centers=64, kernel="wendland",
                                  sigma_fill=2.5)
    n2g = jax_gfm.node_to_grid_index(jtm)
    cgi = n2g[np.asarray(interp.center_nodes)]
    f_ext = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f_ext[n2g, 1] = -500.0 * np.asarray(jgf.mass).reshape(-1)[n2g]
    f_ext = jnp.asarray(f_ext.reshape(*grid.dims, 3))
    w_img, h_img = 16, 16
    ro, rd = jax_rays(JaxCamera.orbit(30.0, 20.0, 4.0), w_img, h_img)
    ro, rd = np.asarray(ro).reshape(-1, 3), np.asarray(rd).reshape(-1, 3)

    # Settle a few steps so the frames start from a sagging state.
    jax_step = jax.jit(lambda st: jax_gfm.timestep(jgf, st, f_ext))
    jst = jgf.rest_state()
    for _ in range(3):
        jst, _ = jax_step(jst)

    ps = convert.scene(convert.numpy_fields(js), device="cpu")
    pgf = convert.grid_fem(convert.numpy_fields(jgf), device="cpu")
    pinterp = convert.disp_interp(convert.numpy_fields(interp), device="cpu")
    pst = convert.fem_state(convert.numpy_fields(jst), device="cpu")
    p_fext = torch.tensor(np.asarray(f_ext))
    p_cgi = torch.tensor(cgi.astype(np.int64))
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)

    jax_trace = jax.jit(lambda w: jd.trace_deformed_rbf_fast(
        js, interp, w, ro, rd, image_hw=(h_img, w_img), interpret=True,
        need_grads=False, tile=256, k_refresh=K_REFRESH,
    ))
    hits = 0
    for frame in range(2):
        # JAX: the production frame composed by hand.
        jst, j_it = jax_step(jst)
        t_j, h_j = jax_trace(
            jd.disp_weights_centers(interp, jst.q.reshape(-1, 3)[cgi]))
        # Port: one call.
        t_p, h_p, pst, p_it = coupled_step_grid_fast(
            ps, pgf, pinterp, p_cgi, pst, p_fext, ro_t, rd_t,
            image_hw=(h_img, w_img), k_refresh=K_REFRESH,
        )
        assert abs(int(j_it) - p_it) <= 1, (frame, int(j_it), p_it)
        assert_fem_state_close(np.asarray(jst.q), np.asarray(jst.qvel),
                               pst.q.numpy(), pst.qvel.numpy())
        _k2_agree(np.asarray(h_j), np.asarray(t_j), h_p.numpy(), t_p.numpy(),
                  min_hits=20)
        hits += int(h_p.sum())
    assert hits > 40


def test_package_imports_no_jax_and_keeps_f32_matmuls():
    """Importing every port module pulls in neither jax nor the JAX
    package, and leaves TF32 off."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import fembrain_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fembrain_tpu' or m.startswith('fembrain_tpu.')]\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _sources():
    files = sorted((REPO / "fembrain_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_every_module_of_the_slice_is_there_and_imports_no_jax():
    """The simulation frame's modules exist beside their JAX counterparts,
    and no source file of the port (nor chip_smoke.py) has an import
    statement of jax or of the JAX package."""
    for rel in ("fem/corotational.py", "fem/deformable.py", "fem/tetmesh.py",
                "fem/integrator.py", "graphics/materials.py",
                "mesh/polygonize.py", "mesh/samples.py", "ops/field.py",
                "render/deformed.py", "render/sphere_trace.py"):
        assert (REPO / "fembrain_tpu_torch" / rel).is_file(), rel
        assert (REPO / "fembrain_tpu" / rel).is_file(), rel
    files = _sources()
    assert len(files) > 25
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] == ["import"] or words[:1] == ["from"]:
                mod = words[1]
                assert mod != "jax" and not mod.startswith("jax."), path
                assert mod != "fembrain_tpu" and not mod.startswith(
                    "fembrain_tpu."), (path, line)


def test_no_fallback_around_a_kernel_build_or_phase():
    """No `is_available()` branch and no try/except in the port or in
    chip_smoke.py: a failed kernel, build or phase raises. The two
    exceptions are named: chip_smoke's exit without a card, and the INI
    reader's number parsing."""
    for path in _sources():
        src = path.read_text()
        rel = path.relative_to(REPO).as_posix()
        n_avail = src.count("is_available")
        n_try = sum(1 for line in src.splitlines()
                    if line.strip() in ("try:",)
                    or line.strip().startswith("except"))
        if rel == "chip_smoke.py":
            assert n_avail == 1 and n_try == 0, rel
            assert "if not torch.cuda.is_available():" in src
        elif rel == "fembrain_tpu_torch/utils/ini.py":
            assert n_avail == 0 and n_try == 4, rel
        else:
            assert n_avail == 0 and n_try == 0, rel


def test_chip_smoke_holds_every_ported_kernel():
    """Every kernel the port counts launches of is listed by
    chip_smoke.py with its source, the TPU kernel it replaces and its
    thresholds against the plain version, and the sources exist."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from fembrain_tpu_torch.render import tile_trace as tt

    names = [k[0] for k in chip_smoke.KERNELS]
    assert sorted(names) == sorted(tt.LAUNCHES) == sorted(
        chip_smoke.THRESHOLDS)
    for _, source, replaces in chip_smoke.KERNELS:
        assert (REPO / source).is_file()
        ref, line = replaces.split(":")
        assert int(line) <= len((REPO / ref).read_text().splitlines())
    src = (REPO / "chip_smoke.py").read_text()
    for phase in ("kernel_phase", "main_path_phase", "training_phase",
                  "simulation_frame_phase"):
        assert f"def {phase}(" in src and f" {phase}(root" in src


# Each public constructor with the function that resolves its `device`.
_CONSTRUCTORS = [
    (SceneDef.pack, SceneDef.pack), (Camera.make, Camera.make),
    (Camera.orbit, Camera.make),
    (pgfm.build_grid_fem, pgfm.build_grid_fem),
    (pgfm.grid_fem_from_tetmesh, pgfm.build_grid_fem),
    (pd.build_disp_interp, pd.build_disp_interp),
    (ptet.build_fem_mesh, ptet.build_fem_mesh),
] + [(f, convert._build) for f in (
    convert.scene, convert.tet_mesh, convert.grid_fem, convert.disp_interp,
    convert.fem_state, convert.fem_mesh_from_numpy,
    convert.surface_mesh_from_numpy)]


@pytest.mark.parametrize("ctor,resolver", _CONSTRUCTORS,
                         ids=[c.__qualname__ for c, _ in _CONSTRUCTORS])
def test_constructors_default_to_the_card(ctor, resolver):
    """Every public constructor takes `device=None`, and the None is
    resolved through `default_device()`, which is the CUDA card whether
    or not one is present (no card is needed to check that)."""
    assert inspect.signature(ctor).parameters["device"].default is None
    assert "default_device() if device is None" in inspect.getsource(resolver)
    if resolver is not ctor:
        assert resolver.__name__ in inspect.getsource(ctor)
    assert fembrain_tpu_torch.default_device() == torch.device("cuda")
