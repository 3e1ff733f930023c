"""PyTorch port: gradients of a hit-depth loss with respect to the RBF
weights w, through the dense deformed tracer (both kernels) and through
the biharmonic tile trace with its implicit-differentiation correction
(K4's plain version), against jax.grad of the JAX package's functions on
brain's tet mesh at cellsize 0.35 (tolerance of
tests/test_deformed_fast.py:229-234)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fembrain_tpu.render import deformed as jd

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.render import deformed as pd

from test_torch_biharmonic import brain_sag_setup, k4_agree
from test_torch_fixtures import graph_size


@pytest.fixture(scope="module")
def setup():
    return brain_sag_setup(width=24, height=18)


def _interp(setup, kernel):
    if kernel == "biharmonic":
        return setup["interp"], setup["pinterp"], setup["w"]
    interp = jd.build_disp_interp(setup["nodes"], n_centers=64,
                                  kernel="wendland", sigma_fill=2.5)
    w = np.asarray(jd.disp_weights(interp, jnp.asarray(setup["u"])))
    pinterp = convert.disp_interp(convert.numpy_fields(interp),
                                  device="cpu")
    return interp, pinterp, w


def _w_grads(setup, jax_trace, port_trace, w0):
    """(t, hit, dL/dw) from each package for L = sum of t over hit rays."""
    def loss(w):
        t, h = jax_trace(w)
        return jnp.sum(jnp.where(h, t, 0.0)), (t, h)

    (_, (t_j, h_j)), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(w0))
    w = torch.tensor(w0, requires_grad=True)
    t_p, h_p = port_trace(w)
    torch.sum(torch.where(h_p, t_p, 0.0)).backward()
    return ((np.asarray(t_j), np.asarray(h_j), np.asarray(g_j)),
            (t_p.detach().numpy(), h_p.numpy(), w.grad.numpy()))


def _assert_w_grads_close(g_ref, g):
    scale = float(np.abs(g_ref).max())
    assert scale > 1e-3
    np.testing.assert_allclose(g, g_ref, atol=2e-3 * max(scale, 1.0))


@pytest.mark.parametrize("kernel", ["biharmonic", "wendland"])
def test_dense_trace_gradient_matches_jax(setup, kernel):
    """The dense tracer keeps f_at differentiable, so d t / d w is the
    reference's implicit-differentiation gradient (not zero)."""
    interp, pinterp, w0 = _interp(setup, kernel)
    js, ps = setup["js"], setup["ps"]
    ro, rd = setup["ro"], setup["rd"]
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    (t_j, h_j, g_j), (t_p, h_p, g_p) = _w_grads(
        setup,
        lambda w: jd.trace_deformed_rbf(js, interp, w, ro, rd),
        lambda w: pd.trace_deformed_rbf(ps, pinterp, w, ro_t, rd_t),
        w0,
    )
    k4_agree(h_j, t_j, h_p, t_p, min_hits=20)
    _assert_w_grads_close(g_j, g_p)
    # The gradient is the correction's: the march is not in the graph.
    w = torch.tensor(w0, requires_grad=True)
    t, _ = pd.trace_deformed_rbf(ps, pinterp, w, ro_t, rd_t)
    one_eval = graph_size(pd.deformed_field_rbf(ps, pinterp, w, ro_t))
    assert graph_size(t) < one_eval + 30, (graph_size(t), one_eval)


def test_k4_trace_gradient_matches_jax(setup):
    """The biharmonic tile trace with need_grads: the kernel's roots are
    constants and the correction against the dense deformed field carries
    the gradient, in both packages."""
    js, ps = setup["js"], setup["ps"]
    interp, pinterp = setup["interp"], setup["pinterp"]
    ro, rd = setup["ro"], setup["rd"]
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    (t_j, h_j, g_j), (t_p, h_p, g_p) = _w_grads(
        setup,
        lambda w: jd.trace_deformed_rbf_fast(js, interp, w, ro, rd,
                                             interpret=True, need_grads=True,
                                             tile=256),
        lambda w: pd.trace_deformed_rbf_fast(ps, pinterp, w, ro_t, rd_t,
                                             need_grads=True, tile=256),
        setup["w"],
    )
    k4_agree(h_j, t_j, h_p, t_p, min_hits=20)
    _assert_w_grads_close(g_j, g_p)
