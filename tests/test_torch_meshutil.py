"""PyTorch port: mesh I/O, mesh quality, the Catmull-Rom spline, the
scene-graph SurfaceMesh and the graphics package's exports against the
JAX package. Files written by the two packages are equal byte for byte
and each reads the other's; quality and spline values agree within 1e-12
(both are float64 numpy); picking and the fixed set agree exactly."""

import numpy as np
import pytest

import fembrain_tpu.graphics as jgraphics
from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.graphics.spline import CatmullRom as JaxSpline
from fembrain_tpu.graphics.surface_mesh import SurfaceMesh as JaxSurfaceMesh
from fembrain_tpu.mesh import io as jio
from fembrain_tpu.mesh import polygonize as jpoly
from fembrain_tpu.mesh import quality as jq

import fembrain_tpu_torch.graphics as pgraphics
from fembrain_tpu_torch.graphics.scenegraph import SGMesh
from fembrain_tpu_torch.graphics.spline import CatmullRom
from fembrain_tpu_torch.graphics.surface_mesh import SurfaceMesh
from fembrain_tpu_torch.mesh import io as pio
from fembrain_tpu_torch.mesh import quality as pq
from fembrain_tpu_torch.mesh import samples
from fembrain_tpu_torch.mesh.polygonize import SurfaceMesh as PolySurface

from test_torch_fixtures import BRAIN

TOL = 1e-12


@pytest.fixture(scope="module")
def brain_meshes():
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jpoly.grid_for_scene(js, 0.35)
    surf = jpoly.polygonize(js, grid, *jpoly.default_caps(grid))
    tm = jpoly.extract_tet_mesh(js, grid, ncap=grid.n_vertices,
                                tetcap=grid.n_cells * 6)
    nv, nt = int(surf.n_verts), int(surf.n_tris)
    return dict(
        verts=np.asarray(surf.verts)[:nv].astype(np.float64),
        normals=np.asarray(surf.normals)[:nv].astype(np.float64),
        tris=np.asarray(surf.tris)[:nt],
        nodes=np.asarray(tm.nodes)[: int(tm.n_nodes)].astype(np.float64),
        tets=np.asarray(tm.tets)[: int(tm.n_tets)])


@pytest.mark.parametrize("mesh", ["truth_cube", "brain"])
def test_veg_files_are_identical_and_cross_read(tmp_path, brain_meshes, mesh):
    if mesh == "brain":
        nodes, tets = brain_meshes["nodes"], brain_meshes["tets"]
    else:
        nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    p, j = tmp_path / "port.veg", tmp_path / "jax.veg"
    pio.write_veg(p, nodes, tets, density=1000, E=1e7, nu=0.45)
    jio.write_veg(j, nodes, tets, density=1000, E=1e7, nu=0.45)
    assert p.read_bytes() == j.read_bytes()
    for reader, path in ((pio.read_veg, j), (jio.read_veg, p)):
        n2, t2, mat = reader(path)
        np.testing.assert_allclose(n2, nodes, atol=1e-5 * np.abs(nodes).max())
        np.testing.assert_array_equal(t2, tets)
        assert mat == {"name": "BODY", "type": "ENU", "density": 1000.0,
                       "E": 1e7, "nu": 0.45}


@pytest.mark.parametrize("normals", [False, True])
def test_obj_files_are_identical_and_cross_read(tmp_path, brain_meshes,
                                                normals):
    v, t = brain_meshes["verts"], brain_meshes["tris"]
    n = brain_meshes["normals"] if normals else None
    p, j = tmp_path / "port.obj", tmp_path / "jax.obj"
    pio.write_obj(p, v, t, normals=n)
    jio.write_obj(j, v, t, normals=n)
    assert p.read_bytes() == j.read_bytes()
    for reader, path in ((pio.read_obj, j), (jio.read_obj, p)):
        v2, t2 = reader(path)
        np.testing.assert_allclose(v2, v, atol=1e-5)
        np.testing.assert_array_equal(t2, t)


def test_veg_reader_rejects_what_the_jax_reader_rejects(tmp_path):
    bad = tmp_path / "hex.veg"
    bad.write_text("*VERTICES\n1 3 0 0\n1 0 0 0\n*ELEMENTS\nCUBIC\n0 8 0\n")
    for reader in (pio.read_veg, jio.read_veg):
        with pytest.raises(ValueError, match="unsupported element"):
            reader(bad)
    part = tmp_path / "part.veg"
    part.write_text("*VERTICES\n1 3 0 0\n1 0 0 0\n")
    for reader in (pio.read_veg, jio.read_veg):
        with pytest.raises(ValueError, match="incomplete"):
            reader(part)


def test_quality_matches_jax(brain_meshes):
    b = brain_meshes
    for fn in ("triangle_quality",):
        got = getattr(pq, fn)(b["verts"], b["tris"])
        ref = getattr(jq, fn)(b["verts"], b["tris"])
        assert got.keys() == ref.keys()
        for k in got:
            assert abs(got[k] - ref[k]) <= TOL * max(1.0, abs(ref[k])), k
    for nodes, tets in ((b["nodes"], b["tets"]),
                        samples.truth_cube(3, 3, 3, 0.5)):
        got, ref = pq.tet_quality(nodes, tets), jq.tet_quality(nodes, tets)
        assert got.keys() == ref.keys()
        for k in got:
            assert abs(got[k] - ref[k]) <= TOL * max(1.0, abs(ref[k])), k
    cube = pq.tet_quality(*samples.truth_cube(3, 3, 3, 0.5))
    assert cube["inverted"] == 0 and cube["degenerate"] == 0
    np.testing.assert_allclose(cube["volume_total"], 1.0, rtol=1e-9)
    tri = pq.triangle_quality(b["verts"], b["tris"])
    assert 0.3 < tri["quality_mean"] <= 1.0


@pytest.mark.parametrize("closed", [False, True])
def test_spline_matches_jax(closed):
    pts = np.random.default_rng(3).normal(size=(6, 3))
    ps, js = CatmullRom(pts, closed=closed), JaxSpline(pts, closed=closed)
    assert ps.n_segments == js.n_segments == (6 if closed else 5)
    u = np.linspace(0.0, ps.n_segments, 77)
    np.testing.assert_allclose(ps.position(u), js.position(u), atol=TOL)
    np.testing.assert_allclose(ps.tangent(u), js.tangent(u), atol=TOL)
    np.testing.assert_allclose(ps.position(1.25), js.position(1.25),
                               atol=TOL)
    assert abs(ps.total_length - js.total_length) <= TOL * js.total_length
    s = np.linspace(0.0, ps.total_length, 9)
    np.testing.assert_allclose(ps.position_at_length(s),
                               js.position_at_length(s), atol=TOL)
    for i in range(len(pts) - 1):
        np.testing.assert_allclose(ps.position(float(i)), pts[i], atol=TOL)
    with pytest.raises(ValueError):
        CatmullRom([[0, 0, 0]])


def test_surface_mesh_pick_and_fixed_match_jax(tmp_path, brain_meshes):
    v, t = brain_meshes["verts"], brain_meshes["tris"]
    ps, js = SurfaceMesh("brain", v, t), JaxSurfaceMesh("brain", v, t)
    for m in (ps, js):
        m.set_translation([0.1, -0.2, 0.3])
    rng = np.random.default_rng(5)
    for _ in range(12):
        ro = rng.uniform(-4, 4, 3)
        target = v[rng.integers(len(v))] + [0.1, -0.2, 0.3]
        rd = target - ro
        assert ps.pick_vertex(ro, rd) == js.pick_vertex(ro, rd)
        c, r = rng.uniform(-1, 1, 3), rng.uniform(0.1, 0.6)
        np.testing.assert_array_equal(ps.pick_vertices_in_sphere(c, r),
                                      js.pick_vertices_in_sphere(c, r))
    assert ps.pick_vertex([50, 50, 5.0], [0, 0, -1.0]) == -1
    for i in (3, 9, 3):
        assert ps.toggle_fixed(i) == js.toggle_fixed(i)
    assert ps.fixed == js.fixed == {9}
    p, j = tmp_path / "p.obj", tmp_path / "j.obj"
    ps.save_obj(p)
    js.save_obj(j)
    assert p.read_bytes() == j.read_bytes()
    back = SurfaceMesh.from_obj(j)
    assert back.name == "j" and isinstance(back, SGMesh)
    np.testing.assert_allclose(back.verts, v + [0.1, -0.2, 0.3], atol=1e-5)


def test_graphics_exports_match_jax():
    assert pgraphics.__all__ == jgraphics.__all__
    for name in pgraphics.__all__:
        obj = getattr(pgraphics, name)
        assert obj.__module__.startswith("fembrain_tpu_torch.graphics."), name
        assert obj.__name__ == getattr(jgraphics, name).__name__
    # The scene-graph SurfaceMesh is not the polygonizer's.
    assert pgraphics.SurfaceMesh is SurfaceMesh
    assert pgraphics.SurfaceMesh is not PolySurface
    assert pgraphics.the_gizmo_manager() is pgraphics.the_gizmo_manager()
    assert isinstance(pgraphics.the_scenegraph(), pgraphics.SceneGraph)
