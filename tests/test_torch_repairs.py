"""PyTorch port, repairs of the grid FEM against the reference: the
`precond` switch of `grid_fem.timestep` (multigrid, or block-Jacobi for
any other value and for a GridFem without levels), the -1 it returns for
a differentiable solve, and its float64 form, which carries the
E-gradient check of tools/egrad_check.py (there a subprocess, since x64
is a process-wide flag in JAX; here every tensor has its own dtype)."""
import dataclasses

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
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.fem import grid_fem as gfm
from fembrain_tpu_torch.mesh.polygonize import extract_tet_mesh, grid_for_scene
from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component
from fembrain_tpu_torch.render import deformed as pd
from fembrain_tpu_torch.render.camera import Camera, generate_rays

from test_torch_fem import assert_fem_state_close
from test_torch_fixtures import BRAIN

# The reference's thresholds for the f64 check (tests/test_egrad_check.py).
EGRAD_MAX_REL = 1e-2
EGRAD_EPS = 1e-2


@pytest.fixture(scope="module")
def brain_grid():
    """Brain at cellsize 0.35: the JAX grid FEM with its bottom anchors
    and the same object in the port, and a gravity load of -100 mass."""
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jax_grid(js, cellsize=0.35)
    jtm = jax_extract(js, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6)
    nodes = np.asarray(jtm.nodes)[: int(jtm.n_nodes)]
    tets = np.asarray(jtm.tets)[: int(jtm.n_tets)]
    jgf = jax_gfm.grid_fem_from_tetmesh(
        grid, jtm, fixed_nodes=jax_bottom(nodes, tets, frac=0.25))
    n2g = jax_gfm.node_to_grid_index(jtm)
    f_ext = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f_ext[n2g, 1] = -100.0 * np.asarray(jgf.mass).reshape(-1)[n2g]
    return jgf, convert.grid_fem(convert.numpy_fields(jgf), device="cpu"), \
        f_ext.reshape(*grid.dims, 3)


@pytest.mark.parametrize("precond,levels", [
    ("mg", True), ("jacobi", True), ("mg", False)],
    ids=["multigrid", "block_jacobi", "no_levels"])
def test_timestep_preconditioners_match_jax(brain_grid, precond, levels):
    """Two steps from rest with each preconditioner (a GridFem without
    levels takes block-Jacobi whatever `precond` says): q and qvel within
    FEM_RTOL of the reference (f32), CG counts within one."""
    jgf, pgf, f_ext = brain_grid
    if not levels:
        jgf = dataclasses.replace(jgf, levels=())
        pgf = dataclasses.replace(pgf, levels=())
    jstep = jax.jit(lambda st: jax_gfm.timestep(
        jgf, st, jnp.asarray(f_ext), precond=precond))
    jst, pst = jgf.rest_state(), pgf.rest_state()
    for _ in range(2):
        jst, j_it = jstep(jst)
        pst, p_it = gfm.timestep(pgf, pst, torch.tensor(f_ext),
                                 precond=precond)
        assert abs(int(j_it) - p_it) <= 1, (int(j_it), p_it)
    assert_fem_state_close(np.asarray(jst.q), np.asarray(jst.qvel),
                           pst.q.numpy(), pst.qvel.numpy())
    assert float(pst.q[..., 1].min()) < 0.0
    # Multigrid needs a fraction of block-Jacobi's iterations.
    assert p_it < 40 if precond == "mg" and levels else p_it > 80, p_it


def test_differentiable_timestep_returns_minus_one(brain_grid):
    """A differentiable solve returns -1 as its count, as the reference
    does; the counts are in `solve_stats`."""
    _, pgf, f_ext = brain_grid
    stats = {}
    st, it = gfm.timestep(pgf, pgf.rest_state(), torch.tensor(f_ext),
                          differentiable=True, solve_stats=stats)
    assert it == -1 and stats["forward_iters"] > 0
    fwd, it_f = gfm.timestep(pgf, pgf.rest_state(), torch.tensor(f_ext))
    assert it_f > 0
    np.testing.assert_allclose(st.q.detach().numpy(), fwd.q.numpy(),
                               atol=5e-5)


def _to_f64(obj):
    """The dataclass `obj` with every floating tensor field in float64."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).double()
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
        and getattr(obj, f.name).is_floating_point()})


def test_grid_fem_builds_in_float64():
    """build_grid_fem's `dtype` reaches every float field, its levels and
    the rest state; the float64 build agrees with the float32 one."""
    sdef = load_blob(BRAIN)
    sdef.flatten_instances()
    scene = sdef.pack(device="cpu")
    grid = grid_for_scene(scene, cellsize=0.35)
    tm = extract_tet_mesh(scene, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    cell_mask = tm.cell_mask.numpy()
    fixed = np.zeros(grid.dims, bool)
    fixed[:, 0, :] = True
    g32 = gfm.build_grid_fem(grid, cell_mask, fixed, device="cpu")
    g64 = gfm.build_grid_fem(grid, cell_mask, fixed, dtype=torch.float64,
                             device="cpu")
    for g, dt in ((g32, torch.float32), (g64, torch.float64)):
        for name in ("cellw", "mass", "ke", "inv_dm", "x0", "kdiag",
                     "coarse_inv"):
            assert getattr(g, name).dtype == dt, name
        for lvl in g.levels:
            assert lvl.mass.dtype == lvl.ke.dtype == dt
        assert g.rest_state().q.dtype == dt
    np.testing.assert_allclose(g64.coarse_inv.numpy(), g32.coarse_inv.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_coupled_e_gradient_f64():
    """The counterpart of tools/egrad_check.py: brain at cellsize 0.35, its
    bottom quarter anchored, 64 biharmonic centers, 24x18 rays,
    f_ext = -200 mass, one differentiable grid step from rest, then the
    weights and the dense deformed trace, all in float64 on the CPU. The
    autograd d(sum of t over hits)/dE_scale matches central differences
    at eps 1e-2 with no hit flipping across the stencil."""
    sdef = load_blob(BRAIN)
    sdef.flatten_instances()
    scene32 = sdef.pack(device="cpu")
    grid = grid_for_scene(scene32, cellsize=0.35)
    tm = extract_tet_mesh(scene32, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    nodes = tm.nodes[: tm.n_nodes].numpy()
    tets = tm.tets[: tm.n_tets].numpy()
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    n2g = gfm.node_to_grid_index(tm)
    fixed_grid = np.zeros(int(np.prod(grid.dims)), bool)
    fixed_grid[n2g[fixed]] = True
    gf = gfm.build_grid_fem(grid, tm.cell_mask.numpy(),
                            fixed_grid.reshape(grid.dims),
                            dtype=torch.float64, device="cpu")
    scene = _to_f64(scene32)
    interp = _to_f64(pd.build_disp_interp(nodes, n_centers=64, fixed=fixed,
                                          device="cpu"))
    cgi = torch.as_tensor(n2g[interp.center_nodes.numpy()].astype(np.int64))
    f_ext = torch.zeros((int(np.prod(grid.dims)), 3), dtype=torch.float64)
    f_ext[n2g, 1] = -200.0 * gf.mass.reshape(-1)[n2g]
    f_ext = f_ext.reshape(*grid.dims, 3)
    ro, rd = generate_rays(Camera.orbit(30.0, 20.0, 8.0, device="cpu"),
                           24, 18)
    ro, rd = ro.reshape(-1, 3).double(), rd.reshape(-1, 3).double()

    def frame(es):
        g = dataclasses.replace(gf, ke=gf.ke * es)
        st, it = gfm.timestep(g, gf.rest_state(), f_ext, differentiable=True)
        assert it == -1 and st.q.dtype == torch.float64
        w = pd.disp_weights_centers(interp, st.q.reshape(-1, 3)[cgi])
        return pd.trace_deformed_rbf(scene, interp, w, ro, rd)

    es = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    t, h0 = frame(es)
    assert t.dtype == torch.float64 and int(h0.sum()) > 20
    torch.sum(torch.where(h0, t, 0.0)).backward()
    g = float(es.grad)

    def loss(e):
        with torch.no_grad():
            t, hit = frame(torch.tensor(e, dtype=torch.float64))
        return float(torch.sum(torch.where(hit, t, 0.0))), hit

    lp, hp = loss(1.0 + EGRAD_EPS)
    lm, hm = loss(1.0 - EGRAD_EPS)
    fd = (lp - lm) / (2.0 * EGRAD_EPS)
    flips = int((hp != h0).sum() + (hm != h0).sum())
    rel = abs(g - fd) / max(abs(fd), 1e-12)
    assert flips == 0
    assert np.isfinite(g) and abs(g) > 0.0
    assert rel < EGRAD_MAX_REL, (g, fd, rel)
