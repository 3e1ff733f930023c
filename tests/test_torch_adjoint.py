"""PyTorch port: the adjoint-differentiable grid-FEM step
(`grid_fem.timestep(differentiable=True)`, a symmetric solve whose
backward runs one adjoint CG solve) against jax.grad through the JAX
package's custom_linear_solve, on brain at cellsize 0.35."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fembrain_tpu.fem import grid_fem as jax_gfm

from fembrain_tpu_torch.fem import grid_fem as gfm

from test_torch_train import train_setup


@pytest.fixture(scope="module")
def setup():
    return train_setup()


def test_timestep_E_gradient_matches_jax(setup):
    """d(sum q . c)/dE_scale over two steps from rest (the second step's
    rotations and internal forces depend on E too) against jax.grad
    through the JAX package's custom_linear_solve."""
    jgf, pgf = setup["jgf"], setup["pgf"]
    c = np.random.default_rng(7).standard_normal(
        (*jgf.dims, 3)).astype(np.float32)
    f_j = jnp.asarray(setup["f_ext"])

    def loss_j(es):
        g = dataclasses.replace(jgf, ke=jgf.ke * es)
        st = jgf.rest_state()
        for _ in range(2):
            st, _ = jax_gfm.timestep(g, st, f_j, differentiable=True)
        return jnp.sum(st.q * c)

    g_j = float(jax.jit(jax.grad(loss_j))(jnp.float32(1.0)))
    es = torch.tensor(1.0, requires_grad=True)
    g = dataclasses.replace(pgf, ke=pgf.ke * es)
    st = pgf.rest_state()
    stats = {}
    for _ in range(2):
        st, _ = gfm.timestep(g, st, torch.tensor(setup["f_ext"]),
                             differentiable=True, solve_stats=stats)
    torch.sum(st.q * torch.tensor(c)).backward()
    assert stats["adjoint_iters"] > 0
    assert abs(g_j) > 1e-4
    np.testing.assert_allclose(float(es.grad), g_j, rtol=1e-3)
