"""PyTorch port: embedded tet mesh, anchors and the grid FEM against the
JAX package on the brain scene (cellsize 0.3), on identical inputs."""
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

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.fem import grid_fem as gfm
from fembrain_tpu_torch.mesh.polygonize import (
    CapacityError, extract_tet_mesh, grid_for_scene,
)
from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component

from test_torch_fixtures import BRAIN
# FEM state tolerance, relative: |dq| <= FEM_RTOL max|q| and |dqvel| <=
# FEM_RTOL max(max|qvel|, max|q| / h). The velocity's own maximum is no
# scale near equilibrium, where it decays towards 0 while its rounding
# floor stays that of q over the time step.
FEM_RTOL = 1e-4


def assert_fem_state_close(ref_q, ref_qvel, q, qvel,
                           h=jax_gfm.DEFAULT_TIMESTEP):
    q_scale = np.abs(ref_q).max()
    v_scale = max(np.abs(ref_qvel).max(), q_scale / h)
    assert q_scale > 0
    assert np.abs(ref_q - q).max() <= FEM_RTOL * q_scale, "q"
    assert np.abs(ref_qvel - qvel).max() <= FEM_RTOL * v_scale, "qvel"


@pytest.fixture(scope="module")
def brain():
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jax_grid(js, cellsize=0.3)
    jtm = jax_extract(js, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6)
    ps = convert.scene(convert.numpy_fields(js), device="cpu")
    return js, grid, jtm, ps


def test_tet_mesh_matches_jax(brain):
    js, grid, jtm, ps = brain
    pgrid = grid_for_scene(ps, cellsize=0.3)
    assert (pgrid.lo, pgrid.dims, pgrid.cellsize) == (
        grid.lo, grid.dims, grid.cellsize)
    tm = extract_tet_mesh(ps, pgrid, ncap=pgrid.n_vertices,
                          tetcap=pgrid.n_cells * 6)
    assert tm.n_nodes == int(jtm.n_nodes) and tm.n_tets == int(jtm.n_tets)
    np.testing.assert_array_equal(tm.tets.numpy(), np.asarray(jtm.tets))
    np.testing.assert_allclose(tm.nodes.numpy(), np.asarray(jtm.nodes),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.grid_to_node.numpy(),
                                  np.asarray(jtm.grid_to_node))
    np.testing.assert_array_equal(tm.cell_mask.numpy(),
                                  np.asarray(jtm.cell_mask))
    with pytest.raises(CapacityError):
        extract_tet_mesh(ps, pgrid, ncap=tm.n_nodes - 1,
                         tetcap=pgrid.n_cells * 6)


def test_component_anchors_match_jax(brain):
    _, _, jtm, _ = brain
    nodes = np.asarray(jtm.nodes)[: int(jtm.n_nodes)]
    tets = np.asarray(jtm.tets)[: int(jtm.n_tets)]
    got = bottom_nodes_per_component(nodes, tets, frac=0.25)
    ref = jax_bottom(nodes, tets, frac=0.25)
    assert len(got) > 0
    assert sorted(got.tolist()) == sorted(np.asarray(ref).tolist())


def test_grid_fem_build_matches_jax(brain):
    _, grid, jtm, ps = brain
    nodes = np.asarray(jtm.nodes)[: int(jtm.n_nodes)]
    fixed = nodes[:, 1] < nodes[:, 1].min() + 0.3
    jgf = jax_gfm.grid_fem_from_tetmesh(grid, jtm, fixed_nodes=fixed)
    tm = convert.tet_mesh(convert.numpy_fields(jtm), device="cpu")
    pgf = gfm.grid_fem_from_tetmesh(grid_for_scene(ps, cellsize=0.3), tm,
                                    fixed_nodes=fixed, device="cpu")
    cgf = convert.grid_fem(convert.numpy_fields(jgf), device="cpu")
    assert len(pgf.levels) == len(cgf.levels) >= 2
    for name in ("cellw", "free", "active", "mass", "ke", "inv_dm", "x0",
                 "kdiag", "coarse_inv"):
        np.testing.assert_array_equal(getattr(pgf, name).numpy(),
                                      getattr(cgf, name).numpy(), name)
    for lp, lc in zip(pgf.levels, cgf.levels):
        assert lp.dims == lc.dims
        for name in ("cellw", "free", "mass", "ke", "kdiag"):
            np.testing.assert_array_equal(getattr(lp, name).numpy(),
                                          getattr(lc, name).numpy(), name)
    assert pgf.coarse_coefs == cgf.coarse_coefs
    np.testing.assert_array_equal(gfm.node_to_grid_index(tm),
                                  jax_gfm.node_to_grid_index(jtm))


def test_timestep_trajectory_matches_jax(brain):
    """gfm.timestep for 1 and 5 steps from rest under gravity: q and qvel
    within FEM_RTOL, CG iteration counts within +-1."""
    _, grid, jtm, _ = brain
    nodes = np.asarray(jtm.nodes)[: int(jtm.n_nodes)]
    tets = np.asarray(jtm.tets)[: int(jtm.n_tets)]
    fixed = jax_bottom(nodes, tets, frac=0.25)
    jgf = jax_gfm.grid_fem_from_tetmesh(grid, jtm, fixed_nodes=fixed)
    pgf = convert.grid_fem(convert.numpy_fields(jgf), device="cpu")
    n2g = jax_gfm.node_to_grid_index(jtm)
    f_ext = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f_ext[n2g, 1] = -500.0 * np.asarray(jgf.mass).reshape(-1)[n2g]
    f_ext = f_ext.reshape(*grid.dims, 3)

    jax_step = jax.jit(lambda st: jax_gfm.timestep(jgf, st, jnp.asarray(f_ext)))
    jst = jgf.rest_state()
    pst = convert.fem_state(convert.numpy_fields(jst), device="cpu")
    for step in range(5):
        jst, j_it = jax_step(jst)
        pst, p_it = gfm.timestep(pgf, pst, torch.tensor(f_ext))
        assert abs(int(j_it) - p_it) <= 1, (step, int(j_it), p_it)
        if step in (0, 4):
            assert_fem_state_close(np.asarray(jst.q), np.asarray(jst.qvel),
                                   pst.q.numpy(), pst.qvel.numpy())
    assert pst.q[..., 1].min() < 0.0  # the tissue sags
