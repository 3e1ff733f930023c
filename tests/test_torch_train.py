"""PyTorch port, the training path: the adjoint-differentiable grid-FEM
step and the E-gradient of the differentiable coupled frame
(`coupled_step_grid_fast(differentiable=True)`: grid-FEM step ->
biharmonic weights -> K4's plain version -> implicit-differentiation
correction), against jax.grad of the JAX package and against central
finite differences."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fembrain_tpu.fem import grid_fem as jax_gfm
from fembrain_tpu.render import deformed as jd

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.fem import grid_fem as gfm
from fembrain_tpu_torch.render.deformed import coupled_step_grid_fast

from test_torch_biharmonic import brain_sag_setup


def train_setup():
    """Brain at cellsize 0.35 with its grid FEM, 64 biharmonic centers,
    24 x 18 rays and f_ext = -200 mass: the size of the reference's
    on-device E-gradient check (bench.py:683-718)."""
    st = brain_sag_setup(width=24, height=18)
    grid, tm, interp = st["grid"], st["tm"], st["interp"]
    jgf = jax_gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=st["fixed"])
    n2g = jax_gfm.node_to_grid_index(tm)
    f_ext = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f_ext[n2g, 1] = -200.0 * np.asarray(jgf.mass).reshape(-1)[n2g]
    st.update(
        jgf=jgf, pgf=convert.grid_fem(convert.numpy_fields(jgf), device="cpu"),
        cgi=n2g[np.asarray(interp.center_nodes)],
        f_ext=f_ext.reshape(*grid.dims, 3),
    )
    return st


@pytest.fixture(scope="module")
def setup():
    return train_setup()


def test_differentiable_timestep_matches_forward(setup):
    """Three steps of the cold adjoint-differentiable solve against the
    warm-started forward solve (tests/test_deformed_fast.py:237-259)."""
    pgf, f = setup["pgf"], torch.tensor(setup["f_ext"])
    fwd = dif = pgf.rest_state()
    stats = {}
    for _ in range(3):
        fwd, _ = gfm.timestep(pgf, fwd, f)
        dif, it = gfm.timestep(pgf, dif, f, differentiable=True,
                               solve_stats=stats)
        np.testing.assert_allclose(dif.q.numpy(), fwd.q.numpy(), atol=5e-5)
        assert it == -1 and stats["forward_iters"] > 0
    assert float(fwd.q[..., 1].min()) < -1e-3


def test_slice_E_gradient_matches_jax_and_finite_differences(setup):
    """The E-gradient of the differentiable coupled frame (one step from
    rest, loss = sum of t over hit rays) against the JAX package composed
    as the frame (FEM step -> weights -> K4 in interpret mode with its
    correction) under jax.grad, and against central differences with the
    hit mask frozen and eps above the measured noise floor
    (bench.py:712-715)."""
    js, ps = setup["js"], setup["ps"]
    interp, pinterp = setup["interp"], setup["pinterp"]
    jgf, pgf = setup["jgf"], setup["pgf"]
    ro, rd, cgi = setup["ro"], setup["rd"], setup["cgi"]
    f_j = jnp.asarray(setup["f_ext"])

    def loss_j(es):
        g = dataclasses.replace(jgf, ke=jgf.ke * es)
        st, _ = jax_gfm.timestep(g, jgf.rest_state(), f_j,
                                 differentiable=True)
        w = jd.disp_weights_centers(interp, st.q.reshape(-1, 3)[cgi])
        t, h = jd.trace_deformed_rbf_fast(js, interp, w, ro, rd,
                                          interpret=True, need_grads=True,
                                          tile=256)
        return jnp.sum(jnp.where(h, t, 0.0))

    g_j = float(jax.jit(jax.grad(loss_j))(jnp.float32(1.0)))

    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    f_t = torch.tensor(setup["f_ext"])
    cgi_t = torch.tensor(cgi.astype(np.int64))

    def frame(es, differentiable=True):
        return coupled_step_grid_fast(
            ps, pgf, pinterp, cgi_t, pgf.rest_state(), f_t, ro_t, rd_t,
            E_scale=es, differentiable=differentiable)

    es = torch.tensor(1.0, requires_grad=True)
    t, hit0, _ = frame(es)
    torch.sum(torch.where(hit0, t, 0.0)).backward()
    g = float(es.grad)
    assert np.isfinite(g) and abs(g) > 1e-3
    assert abs(g - g_j) / abs(g_j) < 1e-2, (g, g_j)

    def loss(e):
        with torch.no_grad():
            t, _, _ = frame(torch.tensor(e))
        return float(torch.sum(torch.where(hit0, t, 0.0)))

    l0 = loss(1.0)
    sigma = abs(loss(1.0 + 1e-6) - l0)
    eps = float(np.clip(100.0 * sigma / abs(g), 0.05, 0.3))
    fd = (loss(1.0 + eps) - loss(1.0 - eps)) / (2.0 * eps)
    assert abs(g - fd) / abs(fd) < 0.05, (g, fd, eps, sigma)
