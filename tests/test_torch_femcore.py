"""PyTorch port: the host core (fembrain_tpu_torch/femcore.py over
csrc/femcore.cpp) against its numpy twins in the port and against the
JAX package's binding of the same source, on sample meshes and brain's
tet mesh; where the library is built; the anchors of a mesh with a node
in no tet. Every comparison is exact: the core and its twins compute the
same sums in the same order."""
from pathlib import Path

import numpy as np
import pytest

from fembrain_tpu import native as jnative
from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.fem import deformable as jdef
from fembrain_tpu.mesh import polygonize as jpoly
from fembrain_tpu.mesh.samples import bottom_nodes_per_component as jax_bottom

from fembrain_tpu_torch import femcore
from fembrain_tpu_torch.fem import deformable as pdef
from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
from fembrain_tpu_torch.mesh import samples
from fembrain_tpu_torch.mesh.volmesh import CELL_EDGES, numpy_edges

from test_torch_fixtures import BRAIN

REPO = Path(__file__).resolve().parent.parent
assert jnative.load() is not None, "the JAX package's core did not build"


def _brain_tets():
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jpoly.grid_for_scene(js, cellsize=0.35)
    tm = jpoly.extract_tet_mesh(js, grid, ncap=grid.n_vertices,
                                tetcap=grid.n_cells * 6)
    return (np.asarray(tm.nodes)[: int(tm.n_nodes)].astype(np.float64),
            np.asarray(tm.tets)[: int(tm.n_tets)])


def _two_cubes():
    """Two truth cubes side by side: two components."""
    n1, t1 = samples.truth_cube(3, 3, 3, 0.5)
    n2, t2 = samples.truth_cube(3, 2, 3, 0.5)
    return np.vstack([n1, n2 + [3.0, 0.5, 0.0]]), np.vstack([t1, t2 + len(n1)])


MESHES = {
    "one_tetra": samples.one_tetra,
    "two_tetra": samples.two_tetra,
    "truth_cube": lambda: samples.truth_cube(4, 4, 4, 0.5),
    "egg_shell": samples.egg_shell,
    "two_cubes": _two_cubes,
    "brain_0.35": _brain_tets,
}


def test_source_is_a_byte_identical_copy():
    ours = (REPO / "fembrain_tpu_torch" / "csrc" / "femcore.cpp").read_bytes()
    assert ours == (REPO / "native" / "femcore.cpp").read_bytes()
    assert femcore.SOURCE == (
        REPO / "fembrain_tpu_torch" / "csrc" / "femcore.cpp")


def test_library_is_built_under_build_and_nowhere_else(tmp_path, monkeypatch):
    """The library is named by a hash of source and flags, lands in the
    package's _build/, and a fresh build writes nothing beside the JAX
    package's copy of the source."""
    path = femcore.build()
    assert path.parent == REPO / "fembrain_tpu_torch" / "_build"
    assert path.name.startswith("femcore-") and path.suffix == ".so"
    before = sorted((REPO / "native").iterdir())
    stamps = [p.stat().st_mtime_ns for p in before]
    monkeypatch.setattr(femcore, "BUILD_DIR", tmp_path / "_build")
    fresh = femcore.build()
    assert fresh.parent == tmp_path / "_build" and fresh.name == path.name
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [path.name]
    after = sorted((REPO / "native").iterdir())
    assert after == before
    assert [p.stat().st_mtime_ns for p in after] == stamps


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "femcore.cpp"
    bad.write_text("extern \"C\" int fem_components( {\n")
    monkeypatch.setattr(femcore, "SOURCE", bad)
    monkeypatch.setattr(femcore, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        femcore.build()
    assert "error" in str(err.value)
    assert list((tmp_path / "_build").iterdir()) == []


@pytest.mark.parametrize("name", MESHES)
def test_ring_forces_match_numpy_twin_and_jax(name):
    nodes, tets = MESHES[name]()
    n = len(nodes)
    rng = np.random.default_rng(len(tets))
    contacts = rng.choice(n, size=min(n, 3), replace=False)
    forces = rng.normal(size=(len(contacts), 3)) * 100.0
    adj = pdef.node_adjacency(tets, n)
    for a, b in zip(adj, jdef.node_adjacency(tets, n)):
        np.testing.assert_array_equal(a, b)
    for radius in (1, 3, 5):
        twin = pdef.haptic_ring_forces(adj, n, contacts, forces, radius)
        got = femcore.NativeAdjacency(tets, n).ring_forces(
            contacts, forces, radius)
        ref = jnative.NativeAdjacency(tets, n).ring_forces(
            contacts, forces, radius)
        np.testing.assert_array_equal(got, twin)
        np.testing.assert_array_equal(got, ref)
        assert (got != 0).any(1).sum() >= len(contacts)


@pytest.mark.parametrize("name", MESHES)
def test_edges_match_numpy_twin_and_jax(name):
    nodes, tets = MESHES[name]()
    edges, cell_edges = femcore.build_edges(tets)
    t_edges, t_cell = numpy_edges(tets, len(nodes))
    j_edges, j_cell = jnative.build_edges(tets)
    np.testing.assert_array_equal(edges, t_edges)
    np.testing.assert_array_equal(cell_edges, t_cell)
    np.testing.assert_array_equal(edges, j_edges)
    np.testing.assert_array_equal(cell_edges, j_cell)
    for s, (a, b) in enumerate(CELL_EDGES):
        e = edges[cell_edges[:, s]]
        np.testing.assert_array_equal(np.sort(e, 1),
                                      np.sort(tets[:, [a, b]], 1))


@pytest.mark.parametrize("corrupt", ["none", "duplicate", "range", "flat"])
def test_check_cells_matches_jax(corrupt):
    nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    tets = tets.copy()
    nodes = nodes.copy()
    if corrupt == "duplicate":
        tets[0, 1] = tets[0, 0]
        tets[5, 3] = tets[5, 2]
    elif corrupt == "range":
        tets[2, 2] = len(nodes) + 4
    elif corrupt == "flat":
        nodes[tets[7, 3]] = nodes[tets[7, 0]]
    want = {"none": 0, "duplicate": 2, "range": 1}.get(corrupt)
    n = len(nodes)
    if corrupt != "range":
        got = femcore.check_cells(tets, nodes, n)
        assert got == jnative.check_cells(tets, nodes, n)
        if want is not None:
            assert got == want
        else:
            assert got >= 1
    assert femcore.check_cells(tets, None, n) == jnative.check_cells(
        tets, None, n) == (want if corrupt != "flat" else 0)


@pytest.mark.parametrize("name", MESHES)
def test_components_match_union_find_twin_and_jax(name):
    nodes, tets = MESHES[name]()
    n_comp, labels = femcore.components(tets, len(nodes))
    j_comp, j_labels = jnative.components(tets, len(nodes))
    assert n_comp == j_comp
    np.testing.assert_array_equal(labels, j_labels)
    roots = samples.union_find_components(len(nodes), tets)
    # The same partition of the cells as the twin's roots ...
    by_root = roots[tets[:, 0]]
    assert len(np.unique(by_root)) == n_comp
    assert len(set(zip(labels.tolist(), by_root.tolist()))) == n_comp
    # ... numbered in the order of each component's first cell.
    _, first = np.unique(labels, return_index=True)
    assert (np.diff(first) > 0).all() and labels[0] == 0
    if name == "two_cubes":
        assert n_comp == 2


@pytest.mark.parametrize("frac", [0.0, 0.25])
def test_anchors_skip_a_node_in_no_tet_as_the_jax_package_does(frac):
    """A cut can leave a node that no tet uses. The JAX package (with its
    core loaded) leaves such a node out of every component, and so does
    the port; a union-find over the nodes makes it a component of its own
    and anchors it."""
    nodes, tets = _two_cubes()
    orphan = np.array([[1.0, -3.0, 0.25]])
    nodes = np.vstack([nodes[:10], orphan, nodes[10:]])
    tets = np.where(tets >= 10, tets + 1, tets)
    got = samples.bottom_nodes_per_component(nodes, tets, frac=frac)
    ref = jax_bottom(nodes, tets, frac=frac)
    np.testing.assert_array_equal(got, ref)
    assert 10 not in got and len(got) > 0
    roots = samples.union_find_components(len(nodes), tets)
    assert roots[10] == 10 and (roots == 10).sum() == 1


def test_deformable_haptic_forces_come_from_the_core():
    nodes, tets = samples.truth_cube(4, 4, 4, 0.5)
    mesh = build_fem_mesh(nodes, tets, fixed=samples.bottom_nodes(nodes),
                          device="cpu")
    body = pdef.Deformable(mesh, gravity=0.0)
    assert isinstance(body._native_adj, femcore.NativeAdjacency)
    idx, force = np.array([63, 20]), np.array([[0.0, -50.0, 0.0],
                                               [3.0, 1.0, -2.0]])
    got = body.haptic_forces(idx, force)
    twin = pdef.haptic_ring_forces(pdef.node_adjacency(tets, len(nodes)),
                                   len(nodes), idx, force)
    np.testing.assert_array_equal(got, twin)
    handle = body._native_adj
    handle.__del__()
    assert handle._h is None
