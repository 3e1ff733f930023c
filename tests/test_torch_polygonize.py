"""PyTorch port: the surface polygonizer against the JAX package on a
one-sphere scene and on brain at cellsize 0.35. Counts, triangles and the
edge embedding must be equal; positions, edge parameters, normals and
colours agree within 1e-5 (+ 1e-5 relative: the edge parameter divides by
a field difference, which amplifies the last bit of the two packages'
prim sums); d verts / d prim_pos within rtol 1e-3."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fembrain_tpu.blob.scene as jscene
from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.mesh import polygonize as jpoly

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch import convert
from fembrain_tpu_torch.blob.types import PrimType
from fembrain_tpu_torch.mesh import polygonize as ppoly

from test_torch_fixtures import BRAIN

TOL = dict(atol=1e-5, rtol=1e-5)


def one_sphere(mod):
    sc = mod.SceneDef()
    sc.add_prim(mod.PrimDef(PrimType.POINT, pos=np.array([0.1, -0.05, 0.2]),
                            color=np.array([0.8, 0.3, 0.2, 1.0])))
    return sc


def _meshes(js, ps, cellsize):
    grid = jpoly.grid_for_scene(js, cellsize)
    pgrid = ppoly.grid_for_scene(ps, cellsize)
    assert (pgrid.lo, pgrid.dims, pgrid.cellsize) == (
        grid.lo, grid.dims, grid.cellsize)
    caps = jpoly.default_caps(grid)
    assert ppoly.default_caps(pgrid) == caps
    return (grid, pgrid, caps, jpoly.polygonize(js, grid, *caps),
            ppoly.polygonize(ps, pgrid, *caps))


@pytest.fixture(scope="module")
def sphere():
    js = one_sphere(jscene).pack()
    ps = one_sphere(pscene).pack(device="cpu")
    return (js, ps) + _meshes(js, ps, 0.12)


@pytest.fixture(scope="module")
def brain():
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    ps = convert.scene(convert.numpy_fields(js), device="cpu")
    return (js, ps) + _meshes(js, ps, 0.35)


def _edge_counts(tris):
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    uniq, counts = np.unique(np.sort(e, 1), axis=0, return_counts=True)
    return uniq, counts


@pytest.mark.parametrize("which", ["sphere", "brain"])
def test_surface_matches_jax(which, request):
    _, _, _, _, _, jm, pm = request.getfixturevalue(which)
    ppoly.check_capacity(pm)
    nv, nt = int(jm.n_verts), int(jm.n_tris)
    assert (int(pm.n_verts), int(pm.n_tris)) == (nv, nt) and nv > 0 < nt
    assert pm.tris.dtype == torch.int32 and pm.edge_nodes.dtype == torch.int32
    np.testing.assert_array_equal(pm.tris.numpy(), np.asarray(jm.tris))
    np.testing.assert_array_equal(pm.edge_nodes.numpy(),
                                  np.asarray(jm.edge_nodes))
    for name in ("verts", "edge_t", "normals", "colors"):
        np.testing.assert_allclose(
            getattr(pm, name).numpy()[:nv], np.asarray(getattr(jm, name))[:nv],
            err_msg=name, **TOL)
    # Rows beyond the count stay zero, as the reference's dropped writes.
    assert float(pm.verts[nv:].abs().max()) == 0.0
    assert int(pm.tris[nt:].abs().max()) == 0


def test_sphere_surface_is_closed(sphere):
    pm = sphere[-1]
    tris = pm.tris.numpy()[: int(pm.n_tris)]
    assert tris.min() >= 0 and tris.max() < int(pm.n_verts)
    assert set(_edge_counts(tris)[1]) == {2}
    v = pm.verts.numpy()[: int(pm.n_verts)] - np.array([0.1, -0.05, 0.2])
    r = np.linalg.norm(v, axis=1)
    assert abs(r.mean() - np.sqrt(1 - 0.5 ** (1 / 3))) < 5e-3
    n = pm.normals.numpy()[: int(pm.n_verts)]
    assert ((n * v / r[:, None]).sum(1) > 0.9).all()


def test_brain_surface_is_closed_inside_the_grid(brain):
    """brain's iso surface reaches past the scene's heuristic bounding
    box, so the grid cuts it (in both packages): every edge has two
    triangles but for a rim of one-triangle edges on the grid's box."""
    pgrid, pm = brain[3], brain[-1]
    tris = pm.tris.numpy()[: int(pm.n_tris)]
    assert tris.min() >= 0 and tris.max() < int(pm.n_verts)
    uniq, counts = _edge_counts(tris)
    assert set(counts) <= {1, 2} and (counts == 2).sum() > 3000
    lo = np.asarray(pgrid.lo)
    hi = lo + (np.asarray(pgrid.dims) - 1) * pgrid.cellsize
    v = pm.verts.numpy()[uniq[counts == 1].reshape(-1)]
    on_box = np.minimum(np.abs(v - lo), np.abs(v - hi)).min(1) < 1e-5
    assert on_box.all()


def test_embedding_reconstructs_the_vertices(brain):
    pgrid, pm = brain[3], brain[-1]
    nv = int(pm.n_verts)
    _, Y, Z = pgrid.dims
    ids = pm.edge_nodes.numpy()[:nv].astype(np.int64)

    def grid_pos(lin):
        ijk = np.stack([lin // (Y * Z), (lin // Z) % Y, lin % Z], -1)
        return np.asarray(pgrid.lo) + ijk * pgrid.cellsize

    pa, pb = grid_pos(ids[:, 0]), grid_pos(ids[:, 1])
    rec = pa + pm.edge_t.numpy()[:nv, None] * (pb - pa)
    np.testing.assert_allclose(rec, pm.verts.numpy()[:nv], atol=1e-5)


def test_over_tight_caps_raise(sphere):
    _, ps, _, pgrid, caps, _, pm = sphere
    nv, nt = int(pm.n_verts), int(pm.n_tris)
    tight = ppoly.polygonize(ps, pgrid, nv - 5, caps[1])
    assert tight.verts.shape[0] == nv - 5 and int(tight.n_verts) == nv
    with pytest.raises(ppoly.CapacityError, match="surface overflow"):
        ppoly.check_capacity(tight)
    with pytest.raises(ppoly.CapacityError, match="surface overflow"):
        ppoly.check_capacity(ppoly.polygonize(ps, pgrid, caps[0], nt - 1))
    with pytest.raises(TypeError):
        ppoly.check_capacity(object())
    ppoly.check_capacity(ppoly.extract_tet_mesh(
        ps, pgrid, ncap=pgrid.n_vertices, tetcap=pgrid.n_cells * 6))


def test_vertex_positions_differentiable_as_in_jax(sphere):
    """d (weighted vertex sum) / d prim_pos against the JAX package's
    (rtol 1e-3), and the x-sensitivity against central differences."""
    js, ps, grid, pgrid, caps, jm, _ = sphere
    nv = int(jm.n_verts)
    wgt = np.random.default_rng(3).normal(size=(caps[0], 3)).astype(np.float32)
    wgt[nv:] = 0.0

    def jloss(prim_pos):
        m = jpoly.polygonize(dataclasses.replace(js, prim_pos=prim_pos),
                             grid, *caps)
        return jnp.sum(m.verts * wgt) + jnp.sum(m.normals[:, 0] * wgt[:, 1])

    ref = np.asarray(jax.grad(jloss)(js.prim_pos))

    def ploss(prim_pos):
        m = ppoly.polygonize(dataclasses.replace(ps, prim_pos=prim_pos),
                             pgrid, *caps)
        w = torch.tensor(wgt)
        return torch.sum(m.verts * w) + torch.sum(m.normals[:, 0] * w[:, 1])

    pos = ps.prim_pos.clone().requires_grad_(True)
    ploss(pos).backward()
    g = pos.grad.numpy()
    assert np.abs(ref[0]).max() > 0.1
    np.testing.assert_allclose(g[0], ref[0], rtol=1e-3,
                               atol=1e-3 * np.abs(ref[0]).max())
    eps = 1e-3
    with torch.no_grad():
        dp, dm = ps.prim_pos.clone(), ps.prim_pos.clone()
        dp[0, 0] += eps
        dm[0, 0] -= eps
        fd = float(ploss(dp) - ploss(dm)) / (2 * eps)
    assert abs(g[0, 0] - fd) < 2e-2 * max(abs(fd), 1.0)
