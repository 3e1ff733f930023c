"""PyTorch port, the slice as a whole: two coupled frames of the port's
`coupled_step_grid_fast` against the same frames composed from the JAX
package (grid-FEM step -> Wendland weights -> Pallas deformed trace in
interpret mode) on a small additive scene; the package's import
hygiene (also of the simulation frame's modules, whose own whole-frame
test is test_torch_frame.py); its default device; that nothing in it
falls back when a kernel, a build or a phase fails; and, for the app
slice, the reference's top-level names in every module pair, its names
for renamed functions and the coupled steps' return shape."""
import ast
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
from fembrain_tpu_torch import app as papp
from fembrain_tpu_torch import convert
from fembrain_tpu_torch.blob.scene import SceneDef
from fembrain_tpu_torch.blob import sketch as psketch
from fembrain_tpu_torch.fem import cutting as pcut
from fembrain_tpu_torch.fem import grid_fem as pgfm
from fembrain_tpu_torch.fem import grid_sharded as pgsh
from fembrain_tpu_torch.fem import mass_spring as pms
from fembrain_tpu_torch.fem import partitioned as ppt
from fembrain_tpu_torch.fem import rigid as prigid
from fembrain_tpu_torch.fem import tetmesh as ptet
from fembrain_tpu_torch.ops import particles as ppart
from fembrain_tpu_torch.ops import rbf as prbf
from fembrain_tpu_torch.parallel import sharding as psh
from fembrain_tpu_torch.render import coupled_sharded as pcs
from fembrain_tpu_torch.render import deformed as pd
from fembrain_tpu_torch.render import tile_trace as ptt
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
        stats = {}
        t_p, h_p, pst = coupled_step_grid_fast(
            ps, pgf, pinterp, p_cgi, pst, p_fext, ro_t, rd_t,
            image_hw=(h_img, w_img), k_refresh=K_REFRESH, solve_stats=stats,
        )
        p_it = stats["forward_iters"]
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
                  "simulation_frame_phase", "app_phase",
                  "interaction_phase", "multi_device_phase"):
        assert f"def {phase}(" in src and f" {phase}(root" in src


def test_chip_smoke_alone_names_what_it_needs(tmp_path):
    """Run alone in an empty directory, chip_smoke.py exits non-zero
    before it imports anything, naming the files of the checkout it
    needs (the package and the model data), and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
    for need in ("fembrain_tpu_torch/__init__.py", "data/models/brain.sim",
                 "data/models/blobtree/brain.blob"):
        assert need in out.stderr, out.stderr


# Each public constructor with the function that resolves its `device`.
_CONSTRUCTORS = [
    (SceneDef.pack, SceneDef.pack), (Camera.make, Camera.make),
    (Camera.orbit, Camera.make),
    (pgfm.build_grid_fem, pgfm.build_grid_fem),
    (pgfm.grid_fem_from_tetmesh, pgfm.build_grid_fem),
    (pd.build_disp_interp, pd.build_disp_interp),
    (pd.refine_disp_interp, pd.build_disp_interp),
    (ptet.build_fem_mesh, ptet.build_fem_mesh),
    (prbf.FastRBF.__init__, prbf.FastRBF.__init__),
    (papp.SimulationApp.__init__, papp.SimulationApp.__init__),
    (pcut.CuttableMesh.__init__, pcut.CuttableMesh.__init__),
    (pcut.batched_edge_quad_hits, pcut.batched_edge_quad_hits),
    (psketch.SketchMachine.__init__, psketch.SketchMachine.__init__),
    (prigid.RigidBoxState.at_rest, prigid.RigidBoxState.at_rest),
    (prigid.RigidBody6State.at_rest, prigid.RigidBody6State.at_rest),
    (pms.make_dumbbell, pms.make_dumbbell),
    (ppart.init_particles, ppart.init_particles),
    (psh.launch, psh.launch),
    (psh.initialize_distributed, psh.initialize_distributed),
    (ppt.build_partitioned, ppt.build_partitioned),
    (pgsh.build_sharded_grid_fem, pgsh.build_sharded_grid_fem),
    (pcs.build_coupled_sharded, ppt.build_partitioned),
    (pcs.build_coupled_grid_sharded, pgsh.build_sharded_grid_fem),
] + [(f, convert._build) for f in (
    convert.scene, convert.tet_mesh, convert.grid_fem, convert.disp_interp,
    convert.fem_state, convert.fem_mesh_from_numpy,
    convert.surface_mesh_from_numpy, convert.rigid_box_state,
    convert.rigid_body6_state, convert.mass_spring, convert.particle_state)]


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


# The app slice's file pairs, and the reference's top-level names each
# leaves out on purpose: `field_jit` is jax.jit of `field`;
# `enable_compilation_cache` is XLA's cache; `_HI` is JAX's matmul
# precision (TF32 stays off package-wide instead); `timed_readback` had
# no caller in the port (stages are timed by `span` in a profile).
_APP_SLICE = ("app.py", "blob/writer.py", "graphics/scenegraph.py",
              "mesh/samples.py", "ops/field.py", "ops/field_ref.py",
              "ops/rbf.py", "render/deformed.py", "render/viewer.py",
              "utils/checkpoint.py", "utils/config.py", "utils/logging.py",
              "utils/metrics.py", "utils/plots.py", "utils/profiler.py")
_LEFT_OUT = {"ops/field.py": {"field_jit"},
             "utils/checkpoint.py": {"enable_compilation_cache"},
             "render/deformed.py": {"_HI"},
             "utils/profiler.py": {"timed_readback"}}


def _top_level_names(path):
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


@pytest.mark.parametrize("rel", _APP_SLICE)
def test_app_slice_module_has_the_reference_names(rel):
    """Each module of the app slice has every top-level name of its JAX
    counterpart, but those left out on purpose; it imports neither jax
    nor the JAX package (checked on every source by the test above), and
    has no fallback (the test below)."""
    ref = _top_level_names(REPO / "fembrain_tpu" / rel)
    got = _top_level_names(REPO / "fembrain_tpu_torch" / rel)
    assert ref - got == _LEFT_OUT.get(rel, set()), rel


# The interaction slice's file pairs (reference -> port), and the names
# each leaves out on purpose: the JAX package's core binding finds its
# source beside the JAX package and memoises a failed build (`_SRC`,
# `_SO`, `_tried`; the port builds its own copy into _build/ and raises);
# `_edge_quad_hits_jit` and its cache `_EDGE_QUAD_HITS` are jax.jit (the
# port's `edge_quad_hits` runs eagerly on the tensors' device).
_INTERACTION_SLICE = {
    "native/__init__.py": "femcore.py",
    "mesh/volmesh.py": "mesh/volmesh.py",
    "fem/cutting.py": "fem/cutting.py",
    "mesh/quality.py": "mesh/quality.py",
    "mesh/io.py": "mesh/io.py",
    "fem/avatars.py": "fem/avatars.py",
    "graphics/gizmo.py": "graphics/gizmo.py",
    "graphics/spline.py": "graphics/spline.py",
    "graphics/surface_mesh.py": "graphics/surface_mesh.py",
    "graphics/__init__.py": "graphics/__init__.py",
    "fem/collision.py": "fem/collision.py",
    "fem/rigid.py": "fem/rigid.py",
    "fem/mass_spring.py": "fem/mass_spring.py",
    "ops/particles.py": "ops/particles.py",
    "blob/kdtree.py": "blob/kdtree.py",
    "blob/sketch.py": "blob/sketch.py",
}
_INTERACTION_LEFT_OUT = {
    "native/__init__.py": {"_SRC", "_SO", "_tried"},
    "fem/cutting.py": {"_edge_quad_hits_jit", "_EDGE_QUAD_HITS"},
}


def _signatures(path):
    """{qualified name: [(parameter, default source or None)]} for the
    top-level functions and the methods of top-level classes."""
    out = {}

    def sig(fn):
        a = fn.args
        params = a.posonlyargs + a.args
        defaults = [None] * (len(params) - len(a.defaults)) + [
            ast.unparse(d) for d in a.defaults]
        rows = list(zip([p.arg for p in params], defaults))
        rows += [(p.arg, None if d is None else ast.unparse(d))
                 for p, d in zip(a.kwonlyargs, a.kw_defaults)]
        return rows

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = sig(node)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    out[f"{node.name}.{item.name}"] = sig(item)
    return out


def _dataclass_fields(path):
    return {node.name: [item.target.id for item in node.body
                        if isinstance(item, ast.AnnAssign)]
            for node in ast.parse(path.read_text()).body
            if isinstance(node, ast.ClassDef)}


@pytest.mark.parametrize("ref_rel", sorted(_INTERACTION_SLICE))
def test_interaction_slice_module_matches_the_reference(ref_rel):
    """Each module of the interaction slice has every top-level name of
    its JAX counterpart (but those left out on purpose), the same
    parameters with the same defaults, in order, where the port may add a
    trailing `device`, and the same dataclass fields in the same order."""
    ref = REPO / "fembrain_tpu" / ref_rel
    got = REPO / "fembrain_tpu_torch" / _INTERACTION_SLICE[ref_rel]
    left_out = _INTERACTION_LEFT_OUT.get(ref_rel, set())
    assert _top_level_names(ref) - _top_level_names(got) == left_out
    ref_sigs, got_sigs = _signatures(ref), _signatures(got)
    for name, params in ref_sigs.items():
        if name.split(".")[0] in left_out:
            continue
        mine = got_sigs[name]
        assert mine[: len(params)] == params, (ref_rel, name)
        assert [p for p, _ in mine[len(params):]] in ([], ["device"]), (
            ref_rel, name)
    got_fields = _dataclass_fields(got)
    for cls, fields in _dataclass_fields(ref).items():
        if cls not in left_out:
            assert got_fields[cls] == fields, (ref_rel, cls)


# The multi-device slice's file pairs and the rest of graphics/ and mesh/
# (reference -> port), the reference's names each leaves out on purpose
# (`triplanar_sample_jax` is the port's `triplanar_sample_tensor`, see
# README "Names"; `_element_spec` is a NamedSharding, where the port's
# place_sharded slices the rank's block), the parameters it leaves out on purpose (they choose
# between Pallas and XLA; the tensors' device chooses in the port), and
# the trailing parameters the port may add: where a block lands
# (`device`), which block a rank builds (`part`), the ranks a reduction
# spans (`device_mesh`) and the global ray count (`n_total`).
_MULTI_DEVICE_SLICE = {
    "parallel/__init__.py": "parallel/__init__.py",
    "parallel/sharding.py": "parallel/sharding.py",
    "fem/sharded.py": "fem/sharded.py",
    "fem/partitioned.py": "fem/partitioned.py",
    "fem/grid_sharded.py": "fem/grid_sharded.py",
    "render/coupled_sharded.py": "render/coupled_sharded.py",
    "graphics/raster.py": "graphics/raster.py",
    "graphics/materials.py": "graphics/materials.py",
    "mesh/minc.py": "mesh/minc.py",
}
_MULTI_DEVICE_LEFT_OUT = {"graphics/materials.py": {"triplanar_sample_jax"},
                          "fem/sharded.py": {"_element_spec"}}
_NOT_PORTED_PARAMS = {"interpret", "use_pallas", "tile_cond"}
_ADDED_PARAMS = {"device", "part", "device_mesh", "n_total"}


@pytest.mark.parametrize("ref_rel", sorted(_MULTI_DEVICE_SLICE))
def test_multi_device_slice_module_matches_the_reference(ref_rel):
    """Each module of the multi-device slice and of the rest of graphics/
    and mesh/ has every top-level name of its JAX counterpart (but those
    left out on purpose), the same parameters with the same defaults in
    order (but `interpret`, `use_pallas` and `tile_cond`), where the port
    may add trailing ones of a named set, and the reference's dataclass
    fields in order, where the port's may add the block a rank holds."""
    ref = REPO / "fembrain_tpu" / ref_rel
    got = REPO / "fembrain_tpu_torch" / _MULTI_DEVICE_SLICE[ref_rel]
    left_out = _MULTI_DEVICE_LEFT_OUT.get(ref_rel, set())
    assert _top_level_names(ref) - _top_level_names(got) == left_out
    ref_sigs, got_sigs = _signatures(ref), _signatures(got)
    for name, params in ref_sigs.items():
        if name.split(".")[0] in left_out:
            continue
        params = [p for p in params if p[0] not in _NOT_PORTED_PARAMS]
        mine = got_sigs[name]
        assert mine[: len(params)] == params, (ref_rel, name)
        assert {p for p, _ in mine[len(params):]} <= _ADDED_PARAMS, (
            ref_rel, name)
    got_fields = _dataclass_fields(got)
    for cls, fields in _dataclass_fields(ref).items():
        assert got_fields[cls][: len(fields)] == fields, (ref_rel, cls)
        assert got_fields[cls][len(fields):] in ([], ["part"]), (ref_rel,
                                                                 cls)


def test_sharded_trace_names_and_imports():
    """The reference's sharded trace names (and its Wendland spec class)
    resolve to the port's, the multi-device modules import no jax
    (checked on every source above), and the collectives count their
    calls."""
    from fembrain_tpu_torch.parallel import sharding as psh

    assert ptt.trace_pallas_sharded is ptt.trace_tiles_sharded
    assert ptt.trace_pallas_image_sharded is ptt.trace_tiles_image_sharded
    assert ptt.WendlandDisp is ptt.WendlandSpec
    for fn in ("trace_pallas_sharded", "trace_pallas_image_sharded"):
        ref = _signatures(REPO / "fembrain_tpu/render/pallas_trace.py")[fn]
        mine = _signatures(REPO / "fembrain_tpu_torch/render/tile_trace.py")[
            fn.replace("pallas", "tiles")]
        assert mine == [p for p in ref if p[0] not in _NOT_PORTED_PARAMS]
    assert set(psh.COUNTS) >= {"shift", "all_reduce", "all_gather",
                               "staged_bytes"}
    names = (REPO / "README.md").read_text().split("### Names")[1]
    for ref, port in (("pallas_trace.trace_pallas_sharded",
                       "tile_trace.trace_tiles_sharded"),
                      ("pallas_trace.trace_pallas_image_sharded",
                       "tile_trace.trace_tiles_image_sharded"),
                      ("materials.triplanar_sample_jax",
                       "materials.triplanar_sample_tensor"),
                      ("pallas_trace.WendlandDisp", "tile_trace.WendlandSpec"),
                      ("jax.sharding.Mesh", "DeviceMesh")):
        assert ref in names and port in names, ref


def test_reference_names_and_return_shapes():
    """The reference's names resolve in the port (README, "Names"), and
    both coupled steps return (t, hit, new_state) as the reference's do,
    with the CG counts in `solve_stats`."""
    assert pd.wendland_pallas_spec is pd.wendland_spec
    assert ptt.trace_pallas is ptt.trace_tiles
    assert ptt.trace_pallas_image is ptt.trace_tiles_image
    for fn in (pd.coupled_step_fast, pd.coupled_step_grid_fast):
        src = inspect.getsource(fn)
        assert "    return t, hit, new_state\n" in src, fn.__name__
        assert "solve_stats" in inspect.signature(fn).parameters
    sig = inspect.signature(pgfm.timestep).parameters
    assert sig["precond"].default == "mg"
    assert inspect.signature(pgfm.build_grid_fem).parameters[
        "dtype"].default == torch.float32
    names = (REPO / "README.md").read_text().split("### Names")[1]
    for ref, port in (("deformed.wendland_pallas_spec", "wendland_spec"),
                      ("pallas_trace.trace_pallas_image",
                       "tile_trace.trace_tiles_image"),
                      ("pallas_trace._image_rays_to_blocks",
                       "tile_trace.image_rays_to_blocks")):
        assert ref in names and port in names, ref


def test_app_main_runs_on_the_card_by_default():
    """`main`'s --device defaults to None, which SimulationApp resolves to
    the card; the app's modules need no card to import."""
    src = inspect.getsource(papp.main)
    assert 'ap.add_argument("--device", default=None' in src
    assert "device=args.device" in src
