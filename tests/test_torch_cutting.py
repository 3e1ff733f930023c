"""PyTorch port: VolMesh, the batched edge x swept-quad classification,
cell subdivision, scalpel cuts and the FEM rebuilt after a cut, against
the JAX package on sample meshes and brain's tet mesh at cellsize 0.35.
Topology (edges, faces, cells, cut counts, cells_array) must be equal,
but for one fault of the JAX package that the port repairs: which of a
split edge's two coincident mid nodes a cut cell takes (see
`assert_cut_as_jax`; with it a through cut parts brain in the port and
leaves it whole in the JAX package); positions agree within 1e-6; the
classification's hits are equal and its t within 1e-6 (both run in
float32); the rebuilt FEM's steps within the unstructured timestep's
tolerance (test_torch_fem.FEM_RTOL, CG iterations within 2)."""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.fem import avatars as javatars
from fembrain_tpu.fem import cutting as jcut
from fembrain_tpu.fem import integrator as jinteg
from fembrain_tpu.fem import tetmesh as jtet
from fembrain_tpu.mesh import polygonize as jpoly
from fembrain_tpu.mesh import volmesh as jvm
from fembrain_tpu.mesh.samples import bottom_nodes_per_component as jax_bottom

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.fem import avatars as pavatars
from fembrain_tpu_torch.fem import cutting as pcut
from fembrain_tpu_torch.fem import integrator as pinteg
from fembrain_tpu_torch.fem import tetmesh as ptet
from fembrain_tpu_torch.mesh import samples
from fembrain_tpu_torch.mesh import volmesh as pvm
from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component
from fembrain_tpu_torch.utils.profiler import the_profiler

from test_torch_fem import assert_fem_state_close
from test_torch_fixtures import BRAIN

CPU = "cpu"


def _res(result):
    """A CutResult of either package as a plain tuple."""
    return dataclasses.astuple(result)


def pair_cells(mesh, n_before):
    """cells_array with the two coincident mid nodes of each split edge
    (nodes n_before + 2k and + 2k + 1) named by the first of them."""
    cells = mesh.cells_array().astype(np.int64)
    mid = cells >= n_before
    cells[mid] = n_before + 2 * ((cells[mid] - n_before) // 2)
    return cells


def assert_cut_as_jax(pm, jm, n_before):
    """The port's cut mesh against the JAX package's: the same nodes,
    edges and cells, but for which of a split edge's two mid nodes a cell
    takes. The JAX package hands each cell the pair in the edge's
    orientation where subdivide_cell reads it in the cell's slot order
    (fembrain_tpu/fem/cutting.py:384); the port orients it by slot."""
    assert pm.count_nodes() == jm.count_nodes()
    assert pm.count_cells() == jm.count_cells()
    np.testing.assert_array_equal(pair_cells(pm, n_before),
                                  pair_cells(jm, n_before))
    np.testing.assert_allclose(pm.positions(), jm.positions(), rtol=0,
                               atol=1e-6)
    assert pm.check_invariants() == jm.check_invariants() == []


def assert_same_volmesh(a, b, pos_atol=0.0):
    """Two VolMeshes (one of each package) with equal topology and
    positions within pos_atol."""
    assert a.count_nodes() == b.count_nodes()
    assert a.count_edges() == b.count_edges()
    assert a.count_cells() == b.count_cells()
    assert [(e.from_, e.to) for e in a.edges] == [
        (e.from_, e.to) for e in b.edges]
    assert a.faces == b.faces
    assert a._edge_map == b._edge_map
    for ca, cb in zip(a.cells, b.cells):
        assert (ca is None) == (cb is None)
        if ca is not None:
            assert (ca.nodes, ca.edges, ca.faces) == (
                cb.nodes, cb.edges, cb.faces)
    np.testing.assert_array_equal(a.cells_array(), b.cells_array())
    np.testing.assert_allclose(a.positions(), b.positions(), rtol=0,
                               atol=pos_atol)
    np.testing.assert_allclose(a.restpositions(), b.restpositions(), rtol=0,
                               atol=pos_atol)


FIXTURES = {
    "one_tetra": samples.one_tetra,
    "two_tetra": samples.two_tetra,
    "truth_cube_3": lambda: samples.truth_cube(3, 3, 3, 0.5),
    "truth_cube_7_bulk": lambda: samples.truth_cube(7, 7, 7, 0.1),
    "egg_shell": samples.egg_shell,
}


@pytest.mark.parametrize("name", FIXTURES)
def test_volmesh_matches_jax(name):
    nodes, tets = FIXTURES[name]()
    p, j = pvm.VolMesh(nodes, tets), jvm.VolMesh(nodes, tets)
    assert_same_volmesh(p, j)
    assert p.check_invariants() == j.check_invariants() == []
    assert p.incident_cells_per_edge == j.incident_cells_per_edge
    assert p.incident_edges_per_node == j.incident_edges_per_node
    ip, ij = p.report_info(), j.report_info()
    assert ip == ij
    for i in range(min(8, len(tets))):
        assert p.cell_aspect_ratio(i) == j.cell_aspect_ratio(i)
    assert [sorted(x) for x in p.disjoint_parts()] == [
        sorted(x) for x in j.disjoint_parts()]


def test_volmesh_construction_and_invariants():
    nodes, tets = samples.truth_cube(3, 3, 3, 0.5)
    vm = pvm.VolMesh(nodes, tets)
    assert vm.count_nodes() == 27
    assert vm.count_cells() == 8 * 6
    assert vm.check_invariants() == []
    np.testing.assert_allclose(vm.report_info()["volume"], (2 * 0.5) ** 3,
                               rtol=1e-9)
    cell = vm.cells[0]
    for slot, (a, b) in enumerate(pvm.CELL_EDGES):
        e = vm.edges[cell.edges[slot]]
        assert {e.from_, e.to} == {cell.nodes[a], cell.nodes[b]}


def test_bulk_matches_loop_construction():
    """The >256-cell bulk path (edges from the host core) builds the
    database the per-cell loop builds."""
    nodes, tets = samples.truth_cube(7, 7, 7, 0.1)
    assert len(tets) > 256
    bulk = pvm.VolMesh(nodes, tets)
    loop = pvm.VolMesh()
    for p in nodes:
        loop.insert_node(p)
    for c in tets:
        loop.insert_cell(tuple(int(v) for v in c))
    assert_same_volmesh(bulk, loop)
    assert bulk.incident_edges_per_node == loop.incident_edges_per_node
    assert bulk.incident_cells_per_edge == loop.incident_cells_per_edge


def test_vectorized_invariants_catch_violations():
    nodes, tets = samples.truth_cube(3, 3, 3, 0.1)
    vm = pvm.VolMesh(nodes, tets)
    jm = jvm.VolMesh(nodes, tets)
    for m in (vm, jm):
        m.cells[0].nodes[1] = m.cells[0].nodes[0]
    assert vm.check_invariants() == jm.check_invariants()
    assert any("duplicate nodes" in e for e in vm.check_invariants())
    vm2, jm2 = pvm.VolMesh(nodes, tets), jvm.VolMesh(nodes, tets)
    for m in (vm2, jm2):
        m.cells[1].edges[0] = (m.cells[1].edges[0] + 1) % m.count_edges()
    errs = vm2.check_invariants()
    assert errs == jm2.check_invariants()
    assert any("mismatch" in e or "duplicate edges" in e for e in errs)


def test_cut_edge_splits_as_in_jax():
    nodes, tets = samples.one_tetra()
    out = []
    for mod in (pvm, jvm):
        vm = mod.VolMesh(nodes, tets)
        e0 = vm.cells[0].edges[0]
        edge = vm.edges[e0]
        to_before = edge.to
        length = np.linalg.norm(vm.nodes[edge.to].pos
                                - vm.nodes[edge.from_].pos)
        np0, np1 = vm.cut_edge(e0, 0.5 * length)
        assert vm.count_nodes() == 6
        np.testing.assert_allclose(vm.nodes[np0].pos, vm.nodes[np1].pos)
        assert vm.edges[e0].to == np0 and vm.edge_exists(np1, to_before)
        out.append(vm)
    assert_same_volmesh(*out)


def _cut_single_tet(mod_vm, mod_cut, slots):
    nodes, tets = samples.one_tetra()
    vm = mod_vm.VolMesh(nodes, tets)
    cell = vm.cells[0]
    cut_edges = {}
    for slot in slots:
        e = cell.edges[slot]
        edge = vm.edges[e]
        length = np.linalg.norm(vm.nodes[edge.to].pos
                                - vm.nodes[edge.from_].pos)
        cut_edges[slot] = vm.cut_edge(e, 0.4 * length)
    new = mod_cut.subdivide_cell(vm, 0, cut_edges)
    vm.garbage_collection()
    assert vm.check_invariants() == []
    return vm, new


@pytest.mark.parametrize("slots", [
    (3, 4, 5), (0, 2, 5), (0, 1, 3), (1, 2, 4),            # case A
    (1, 2, 3, 5), (0, 2, 3, 4), (0, 1, 4, 5),              # case B
])
def test_subdivide_cases_a_and_b_match_jax(slots):
    pm, pnew = _cut_single_tet(pvm, pcut, slots)
    jm, jnew = _cut_single_tet(jvm, jcut, slots)
    assert pnew == jnew and len(pnew) == (4 if len(slots) == 3 else 6)
    assert_same_volmesh(pm, jm)
    nodes, tets = samples.one_tetra()
    p = nodes[tets[0]]
    vol0 = abs(np.dot(p[1] - p[0], np.cross(p[2] - p[0], p[3] - p[0])) / 6)
    np.testing.assert_allclose(sum(abs(pm.cell_volume(i)) for i in pnew),
                               vol0, rtol=1e-9)
    assert len(pm.disjoint_parts()) == 2


def test_unsupported_cut_refused():
    nodes, tets = samples.one_tetra()
    vm = pvm.VolMesh(nodes, tets)
    e = vm.cells[0].edges[0]
    edge = vm.edges[e]
    length = np.linalg.norm(vm.nodes[edge.to].pos - vm.nodes[edge.from_].pos)
    cut = {0: vm.cut_edge(e, 0.5 * length)}
    with pytest.raises(pcut.CutError):
        pcut.subdivide_cell(vm, 0, cut)


def test_segment_quad_intersection():
    quad = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], float)
    for a, b in ((0.0, 0.5), (0.37, -0.81), (0.9, 0.9)):
        p0, p1 = np.array([a, -1.0, b]), np.array([a, 1.0, b])
        got = pcut.segment_quad_intersect(p0, p1, quad)
        assert got == jcut.segment_quad_intersect(p0, p1, quad)
        assert abs(got - 0.5) < 1e-9
    assert pcut.segment_quad_intersect(
        np.array([5.0, -1, 0]), np.array([5.0, 1, 0]), quad) is None


def _seeded_segments_and_quads(seed):
    """Random segments against random planar quads, plus segments that
    cross each quad exactly on its shared diagonal (q0, q2), at a corner
    of it, and just off its edges."""
    rng = np.random.default_rng(seed)
    Q, E = 6, 400
    c = rng.uniform(-1, 1, (Q, 3))
    u = rng.normal(size=(Q, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(u, rng.normal(size=(Q, 3)))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    s = rng.uniform(0.3, 0.8, (Q, 1))
    quads = np.stack([c - s * u - s * v, c + s * u - s * v,
                      c + s * u + s * v, c - s * u + s * v], 1)
    p0 = rng.uniform(-1.5, 1.5, (E, 3))
    p1 = rng.uniform(-1.5, 1.5, (E, 3))
    n = np.cross(u, v)
    extra0, extra1 = [], []
    for k in range(Q):
        for w in np.linspace(0.1, 0.9, 5):          # on the diagonal
            x = quads[k, 0] + w * (quads[k, 2] - quads[k, 0])
            extra0.append(x - 0.3 * n[k])
            extra1.append(x + 0.7 * n[k])
        for x in (quads[k, 1], 0.5 * (quads[k, 0] + quads[k, 1])):
            extra0.append(x - 0.5 * n[k])            # a corner, an edge
            extra1.append(x + 0.5 * n[k])
    return (np.vstack([p0, extra0]), np.vstack([p1, extra1]), quads)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_edge_quad_hits_match_jax(seed):
    p0, p1, quads = _seeded_segments_and_quads(seed)
    hit_j, t_j = jcut.batched_edge_quad_hits(p0, p1, quads)
    hit_p, t_p = pcut.batched_edge_quad_hits(p0, p1, quads, device=CPU)
    np.testing.assert_array_equal(hit_p, hit_j)
    np.testing.assert_allclose(t_p[hit_p], t_j[hit_j], rtol=0, atol=1e-6)
    assert hit_p.sum() > 30
    # Every segment through a quad's shared diagonal hits that quad at
    # t 0.3, in both packages.
    base = len(p0) - 7 * len(quads)
    for k in range(len(quads)):
        rows = slice(base + 7 * k, base + 7 * k + 5)
        hp, tp = pcut.batched_edge_quad_hits(p0[rows], p1[rows],
                                             quads[k:k + 1], device=CPU)
        hj, tj = jcut.batched_edge_quad_hits(p0[rows], p1[rows],
                                             quads[k:k + 1])
        assert hp.all() and hj.all()
        np.testing.assert_allclose(tp, 0.3, atol=1e-5)
        np.testing.assert_allclose(tp, tj, atol=1e-6)
    # The device function returns tensors on its inputs' device.
    hit_t, t_t = pcut.edge_quad_hits(*(torch.tensor(a, dtype=torch.float32)
                                       for a in (p0, p1, quads)))
    assert hit_t.dtype == torch.bool and t_t.dtype == torch.float32
    np.testing.assert_array_equal(hit_t.numpy(), hit_p)


def test_first_hitting_quad_in_sweep_order():
    """Two coplanar-parallel quads both crossed: t comes from the first in
    sweep order, in both packages."""
    q = np.array([[-1, 0.2, -1], [1, 0.2, -1], [1, 0.2, 1], [-1, 0.2, 1.0]])
    quads = np.stack([q, q + [0, 0.4, 0]])
    p0, p1 = np.array([[0.1, -1.0, 0.1]]), np.array([[0.1, 1.0, 0.1]])
    for order in (quads, quads[::-1]):
        hj, tj = jcut.batched_edge_quad_hits(p0, p1, order)
        hp, tp = pcut.batched_edge_quad_hits(p0, p1, order, device=CPU)
        assert hp[0] and hj[0]
        np.testing.assert_allclose(tp, tj, atol=1e-6)
    np.testing.assert_allclose(
        pcut.batched_edge_quad_hits(p0, p1, quads, device=CPU)[1], 0.6,
        atol=1e-6)


def _sweep(mod, blade_a, blade_b, moves):
    sc = mod.AvatarScalpel(blade_a=np.asarray(blade_a, float),
                           blade_b=np.asarray(blade_b, float))
    sc.grip()
    for m in moves:
        sc.move_to(m)
    return sc


def test_scalpel_cuts_single_tet_apart():
    nodes, tets = samples.one_tetra()
    moves = [[x, -1.5, 0.0] for x in np.linspace(-2.0, 2.0, 9)]
    pm = pcut.CuttableMesh(nodes, tets, device=CPU)
    jm = jcut.CuttableMesh(nodes, tets)
    pres = _sweep(pavatars, [0, 3, 1], [0, 3, -3], moves).release(pm)
    jres = _sweep(javatars, [0, 3, 1], [0, 3, -3], moves).release(jm)
    assert _res(pres) == _res(jres) and pres.n_cut_cells == 1
    assert pres.n_new_cells in (4, 6)
    assert_same_volmesh(pm.mesh, jm.mesh, pos_atol=1e-12)
    parts = pm.mesh.disjoint_parts()
    assert len(parts) == 2
    for part in parts:
        assert pm.mesh.extract_part(part).check_invariants() == []


def test_scalpel_cut_truthcube_as_jax():
    """The JAX package's test skips when this sweep meets an unsupported
    configuration; here the port must do what the JAX package does."""
    nodes, tets = samples.truth_cube(3, 2, 2, 1.0)
    moves = [[0.083, y - 5.0, 0.0] for y in np.linspace(6.0, -6.0, 25)]
    outcome = []
    for mod_a, mod_c, kw in ((pavatars, pcut, {"device": CPU}),
                             (javatars, jcut, {})):
        cm = mod_c.CuttableMesh(nodes, tets, **kw)
        vol0 = cm.mesh.total_volume()
        sc = _sweep(mod_a, [0, 5, 5], [0, 5, -5], moves)
        try:
            res = sc.release(cm)
        except mod_c.CutError as err:
            outcome.append(("refused", str(err)))
            continue
        np.testing.assert_allclose(cm.mesh.total_volume(), vol0, rtol=1e-6)
        assert cm.mesh.check_invariants() == []
        outcome.append((_res(res),
                        pair_cells(cm.mesh, len(nodes)).tolist()))
    assert outcome[0] == outcome[1]


def test_cut_node_snapping_as_jax():
    nodes, tets = samples.one_tetra()
    for mod_c, kw in ((pcut, {"device": CPU}), (jcut, {})):
        cm = mod_c.CuttableMesh(nodes, tets, **kw)
        e0, e1 = cm.mesh.cells[0].edges[0], cm.mesh.cells[0].edges[1]
        snap_from = cm.mesh.edges[e0].from_
        kept, snapped = mod_c.snap_cut_nodes(cm.mesh, {e0: 0.05, e1: 0.5},
                                             roi=0.2)
        assert snap_from in snapped
        for ei in kept:
            assert snap_from not in (cm.mesh.edges[ei].from_,
                                     cm.mesh.edges[ei].to)
        kept2, snapped2 = mod_c.snap_cut_nodes(cm.mesh, {e1: 0.5}, roi=0.2)
        assert snapped2 == set() and len(kept2) == 1
    apex_y = float(nodes[:, 1].max())
    moves = [[x, apex_y - 3.1, 0.0] for x in np.linspace(-2.0, 2.0, 9)]
    outcome = []
    for mod_a, mod_c, kw in ((pavatars, pcut, {"device": CPU}),
                             (javatars, jcut, {})):
        cm = mod_c.CuttableMesh(nodes, tets, **kw)
        quads = _sweep(mod_a, [0, 3, 1], [0, 3, -3], moves).sweep_quads
        try:
            res = cm.cut(quads, snap_nodes=True, snap_roi=0.45)
        except mod_c.CutError:
            outcome.append("refused")
            continue
        assert cm.mesh.check_invariants() == []
        outcome.append((_res(res),
                        pair_cells(cm.mesh, len(nodes)).tolist()))
    assert outcome[0] == outcome[1]


def test_a_partial_cut_raises_and_leaves_the_mesh():
    """A blade that ends inside the tissue leaves partial cuts: the cut
    raises CutError before it changes anything (CuttableMesh.cpp:381-387)."""
    nodes, tets = samples.truth_cube(4, 4, 4, 0.5)
    cm = pcut.CuttableMesh(nodes, tets, device=CPU)
    before = cm.mesh.cells_array().copy()
    sc = _sweep(pavatars, [0.13, 3.0, 0.0], [0.13, 0.61, 0.0],
                [[0.0, 0.0, z] for z in np.linspace(-2.0, 2.0, 7)])
    with pytest.raises(pcut.CutError):
        sc.release(cm)
    np.testing.assert_array_equal(cm.mesh.cells_array(), before)
    assert cm.mesh.count_nodes() == len(nodes)


@pytest.fixture(scope="module")
def brain():
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jpoly.grid_for_scene(js, cellsize=0.35)
    tm = jpoly.extract_tet_mesh(js, grid, ncap=grid.n_vertices,
                                tetcap=grid.n_cells * 6)
    nodes = np.asarray(tm.nodes)[: int(tm.n_nodes)]
    tets = np.asarray(tm.tets)[: int(tm.n_tets)]
    return grid, nodes, tets


def _plane_sweep(grid, nodes, steps=7):
    """A vertical blade past the tissue's height, swept across z on the
    mid-cell plane x = lo + (k + 1/2) cellsize nearest the middle."""
    xmid = 0.5 * (nodes[:, 0].min() + nodes[:, 0].max())
    k = round((xmid - grid.lo[0]) / grid.cellsize)
    x0 = grid.lo[0] + (k + 0.5) * grid.cellsize
    lo, hi = nodes.min(0) - 0.5, nodes.max(0) + 0.5
    blade_a, blade_b = [x0, hi[1], 0.0], [x0, lo[1], 0.0]
    moves = [[0.0, 0.0, z] for z in np.linspace(lo[2] - 0.13, hi[2] + 0.11,
                                                steps + 1)]
    return x0, blade_a, blade_b, moves


def test_brain_plane_cut_matches_jax_and_rebuilds(brain):
    """Cut brain at 0.35 with a scalpel sweep in both packages (equal
    counts and cells_array, positions within 1e-6), rebuild the FEM from
    each cut mesh and take 3 steps under gravity against JAX."""
    grid, nodes, tets = brain
    x0, a, b, moves = _plane_sweep(grid, nodes)
    prof = the_profiler()
    prof.reset()
    pm = pcut.CuttableMesh(nodes, tets, device=CPU)
    jm = jcut.CuttableMesh(nodes, tets)
    n_before = len(pm.mesh.disjoint_parts())
    t0 = time.perf_counter()
    pres = _sweep(pavatars, a, b, moves).release(pm)
    cut_s = time.perf_counter() - t0
    jres = _sweep(javatars, a, b, moves).release(jm)
    assert _res(pres) == _res(jres)
    assert pres.n_cut_edges > 50 and pres.n_new_cells > pres.n_cut_cells
    assert cut_s < 30.0
    stages = prof.stats()
    for name in ("cut_gather", "cut_classify", "cut_cells", "cut_split",
                 "cut_subdivide", "cut_check"):
        assert stages[name]["count"] == 1, name
    assert_cut_as_jax(pm.mesh, jm.mesh, len(nodes))
    # The blade parts the tissue in the port; in the JAX package the cells
    # whose slots run against their edges keep it in one piece.
    assert n_before == 1
    assert len(pm.mesh.disjoint_parts()) == 2
    assert len(jm.mesh.disjoint_parts()) == 1

    pos, cells = pm.mesh.restpositions(), pm.mesh.cells_array()
    fixed = bottom_nodes_per_component(pos, cells, frac=0.25)
    np.testing.assert_array_equal(fixed, jax_bottom(pos, cells, frac=0.25))
    pf = ptet.build_fem_mesh(pos, cells, fixed=fixed, device=CPU)
    jf = jtet.build_fem_mesh(pos, cells, fixed=fixed)
    assert pf.n_tets == len(cells) > len(tets)
    f = np.zeros((pf.n_nodes, 3), np.float32)
    f[:, 1] = -1000.0
    pst, jst = pinteg.FemState.rest(pf), jinteg.FemState.rest(jf)
    for _ in range(3):
        jst, j_it = jinteg.timestep(jf, jst, jnp.asarray(f), h=0.01)
        pst, p_it = pinteg.timestep(pf, pst, torch.tensor(f), h=0.01)
        assert abs(int(j_it) - p_it) <= 2
        assert_fem_state_close(np.asarray(jst.q), np.asarray(jst.qvel),
                               pst.q.numpy(), pst.qvel.numpy(), h=0.01)
    # Both halves hang from their own anchors and move.
    assert np.isfinite(pst.q.numpy()).all()
    assert float(pst.q.abs().max()) > 1e-6


def test_brain_cut_in_one_quad_matches_jax_and_converts(brain):
    """One quad through the whole tissue (the scale test's sweep) in both
    packages; the cut mesh rebuilt through convert.volmesh from its
    positions has the JAX package's topology when rebuilt there too."""
    grid, nodes, tets = brain
    x0 = _plane_sweep(grid, nodes)[0]
    lo, hi = nodes.min(0), nodes.max(0)
    quad = np.array([[x0, lo[1] - 0.1, lo[2] - 0.1],
                     [x0, hi[1] + 0.1, lo[2] - 0.1],
                     [x0, hi[1] + 0.1, hi[2] + 0.1],
                     [x0, lo[1] - 0.1, hi[2] + 0.1]])
    pm = pcut.CuttableMesh(nodes, tets, device=CPU)
    jm = jcut.CuttableMesh(nodes, tets)
    assert _res(pm.cut([quad], modify=False)) == _res(
        jm.cut([quad], modify=False))
    assert pm.mesh.count_cells() == len(tets)
    assert _res(pm.cut([quad])) == _res(jm.cut([quad]))
    assert_cut_as_jax(pm.mesh, jm.mesh, len(nodes))
    assert len(pm.mesh.disjoint_parts()) == 2
    rest, cells = pm.mesh.restpositions(), pm.mesh.cells_array()
    moved = rest + 0.01
    pv = convert.volmesh(moved, rest, cells)
    jv = jvm.VolMesh(rest, cells)
    jv.displace(np.full_like(rest, 0.01))
    assert_same_volmesh(pv, jv, pos_atol=1e-12)
    assert pv.check_invariants() == []
