"""PyTorch port: the biharmonic displacement interpolant and the
biharmonic-deformed tile trace (K4's plain version) against the JAX
package, on brain's tet mesh at cellsize 0.35 with 64 centers under a sag
u = -0.15 s^2; and `build_disp_interp` against the JAX package for both
kernels."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.mesh.polygonize import extract_tet_mesh as jax_extract
from fembrain_tpu.mesh.polygonize import grid_for_scene as jax_grid
from fembrain_tpu.mesh.samples import bottom_nodes_per_component as jax_bottom
from fembrain_tpu.render import deformed as jd
from fembrain_tpu.render.camera import Camera as JaxCamera
from fembrain_tpu.render.camera import generate_rays as jax_rays

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.render import deformed as pd
from fembrain_tpu_torch.render import tile_trace as tt

from test_torch_fixtures import BRAIN

# K4 thresholds against the reference (tests/test_deformed_fast.py:178-182).
K4_AGREE, K4_MAX = 0.995, 1e-3


def brain_sag_setup(width=32, height=20, cellsize=0.35, n_centers=64):
    """Brain's tet mesh, its bottom anchors, a biharmonic interpolant built
    as the reference's E-gradient check builds it, the sag's weights and
    image rays: a dict of JAX objects, numpy arrays and the port's
    scene and interpolant."""
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jax_grid(js, cellsize=cellsize)
    tm = jax_extract(js, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6)
    nodes = np.asarray(tm.nodes)[: int(tm.n_nodes)]
    tets = np.asarray(tm.tets)[: int(tm.n_tets)]
    fixed = jax_bottom(nodes, tets, frac=0.25)
    interp = jd.build_disp_interp(nodes, n_centers=n_centers, fixed=fixed)
    y = nodes[:, 1]
    s = (y - y.min()) / max(y.max() - y.min(), 1e-6)
    u = np.zeros_like(nodes, dtype=np.float32)
    u[:, 1] = -0.15 * s**2
    w = np.asarray(jd.disp_weights(interp, jnp.asarray(u)))
    ro, rd = jax_rays(JaxCamera.orbit(30.0, 20.0, 5.0), width, height)
    return dict(
        js=js, grid=grid, tm=tm, nodes=nodes, fixed=fixed, interp=interp,
        u=u, w=w, ro=np.asarray(ro).reshape(-1, 3),
        rd=np.asarray(rd).reshape(-1, 3),
        ps=convert.scene(convert.numpy_fields(js), device="cpu"),
        pinterp=convert.disp_interp(convert.numpy_fields(interp),
                                    device="cpu"),
    )


@pytest.fixture(scope="module")
def setup():
    return brain_sag_setup()


def k4_agree(h_ref, t_ref, hit, t, min_hits=40):
    assert (h_ref == hit).mean() > K4_AGREE, (h_ref != hit).sum()
    both = h_ref & hit
    assert both.sum() > min_hits
    assert np.abs(t_ref[both] - t[both]).max() < K4_MAX


@pytest.mark.parametrize("kernel,kw", [
    ("biharmonic", {}),
    ("biharmonic", {"n_centers": None}),
    ("wendland", {"sigma_fill": 2.5}),
    ("wendland", {"extra_centers": [5, 17, 40], "sigma": 0.6}),
])
def test_build_disp_interp_matches_jax(setup, kernel, kw):
    """Identical calls build identical interpolants; the default kind is
    biharmonic in both packages."""
    nodes, fixed = setup["nodes"], setup["fixed"]
    kw = {"n_centers": 64, **kw}
    args = {} if kernel == "biharmonic" else {"kernel": kernel}
    ref = jd.build_disp_interp(nodes, fixed=fixed, **args, **kw)
    got = pd.build_disp_interp(nodes, fixed=fixed, device="cpu", **args,
                               **kw)
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(ref.centers))
    np.testing.assert_array_equal(got.center_nodes.numpy(),
                                  np.asarray(ref.center_nodes))
    np.testing.assert_allclose(got.a_inv.numpy(), np.asarray(ref.a_inv),
                               rtol=1e-6, atol=0)
    assert (got.kind, got.sigma) == (ref.kind, ref.sigma) == (kernel,
                                                              ref.sigma)
    assert float(got.fill_dist) == float(ref.fill_dist)


def test_adaptive_centers_matches_jax():
    for n in (100, 855, 8308, 14000, 110000, 900000):
        assert pd.adaptive_centers(n) == jd.adaptive_centers(n)
    assert pd.adaptive_centers(8308) == 112  # brain at cellsize 0.14


def test_disp_functions_match_jax(setup):
    interp, pinterp = setup["interp"], setup["pinterp"]
    w_j = jnp.asarray(setup["w"])
    u_t = torch.tensor(setup["u"])
    w = pd.disp_weights(pinterp, u_t)
    np.testing.assert_allclose(w.numpy(), setup["w"], rtol=1e-5,
                               atol=1e-5 * np.abs(setup["w"]).max())
    wt = torch.tensor(setup["w"])
    pts = setup["nodes"][::5].astype(np.float32)
    np.testing.assert_allclose(
        pd.sample_disp_rbf(pinterp, wt, torch.tensor(pts)).numpy(),
        np.asarray(jd.sample_disp_rbf(interp, w_j, jnp.asarray(pts))),
        rtol=1e-5, atol=1e-5)
    for name, ref, got in (
        ("lipschitz", jd.disp_lipschitz(interp, w_j),
         pd.disp_lipschitz(pinterp, wt)),
        ("slack", jd.disp_slack(interp, w_j), pd.disp_slack(pinterp, wt)),
        ("max_disp_bound", jd.max_disp_bound(interp, w_j, jnp.asarray(u_t)),
         pd.max_disp_bound(pinterp, wt, u_t)),
    ):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5,
                                   err_msg=name)
    ref = jd.disp_bounds_sampled(interp, w_j, jnp.asarray(pts))
    got = pd.disp_bounds_sampled(pinterp, wt, torch.tensor(pts))
    np.testing.assert_allclose([float(g) for g in got],
                               [float(r) for r in ref], rtol=1e-5, atol=1e-6)
    # The bound covers the interpolant's displacement at every node.
    u_nodes = pd.sample_disp_rbf(pinterp, wt, torch.tensor(setup["nodes"],
                                                           dtype=torch.float32))
    assert float(torch.linalg.norm(u_nodes, dim=-1).max()) <= float(
        pd.max_disp_bound(pinterp, wt, u_t)) + 1e-5


def test_k4_plain_matches_pallas(setup):
    """K4's plain version against the JAX kernel in interpret mode, and
    against the port's exact dense tracer."""
    t_j, h_j = jd.trace_deformed_rbf_fast(
        setup["js"], setup["interp"], jnp.asarray(setup["w"]),
        setup["ro"], setup["rd"], interpret=True, need_grads=False, tile=256,
    )
    ps, pinterp = setup["ps"], setup["pinterp"]
    w = torch.tensor(setup["w"])
    ro, rd = torch.tensor(setup["ro"]), torch.tensor(setup["rd"])
    t_p, h_p = pd.trace_deformed_rbf_fast(ps, pinterp, w, ro, rd,
                                          need_grads=False, tile=256)
    k4_agree(np.asarray(h_j), np.asarray(t_j), h_p.numpy(), t_p.numpy())
    t_d, h_d = pd.trace_deformed_rbf(ps, pinterp, w, ro, rd)
    k4_agree(h_d.numpy(), t_d.detach().numpy(), h_p.numpy(), t_p.numpy())


def test_biharmonic_inputs_on_cpu(setup):
    """The packed K4 inputs: the weights split into kernel rows and the
    affine tail, global step factors on every tile, brackets and the base
    step inflated by the static max_disp; on the CPU the wrapper runs the
    plain version and launches nothing."""
    ps, pinterp = setup["ps"], setup["pinterp"]
    w = torch.tensor(setup["w"])
    shrink, slack = pd.disp_bounds_sampled(pinterp, w,
                                           torch.tensor(setup["nodes"],
                                                        dtype=torch.float32))
    spec = pd.biharmonic_spec(pinterp, w, shrink, slack, max_disp=0.5)
    ro, rd = torch.tensor(setup["ro"]), torch.tensor(setup["rd"])
    inp = tt.prepare_tiles(ps, ro, rd, disp=spec)
    b = inp.biharmonic
    assert b.centers.shape == b.w.shape == (64, 3) and b.fp_iters == 2
    assert torch.equal(b.waff, w[64:].T)
    assert torch.all(inp.tile_rows[:, 1] == shrink)
    assert torch.all(inp.tile_rows[:, 2] == slack)
    rest = tt.prepare_tiles(ps, ro, rd)
    assert inp.base_step > rest.base_step
    assert float(inp.rays[7].max()) > float(rest.rays[7].max())
    before = dict(tt.LAUNCHES)
    t, hit = tt.run_tiles(inp)
    t2, hit2 = tt.trace_tiles_biharmonic_plain(inp)
    assert torch.equal(t, t2) and torch.equal(hit, hit2)
    assert tt.LAUNCHES == before
    with pytest.raises(ValueError):
        tt.trace_tiles_plain(inp)
    with pytest.raises(ValueError, match="CUDA"):
        tt.trace_additive_cuda(inp)
