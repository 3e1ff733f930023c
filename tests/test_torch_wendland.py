"""PyTorch port: the Wendland displacement interpolant and the deformed
tile trace (K2's plain version) against the JAX package on the brain
scene under a sag u = -0.15 s^2, and against the port's exact dense
tracer."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.mesh.polygonize import extract_tet_mesh as jax_extract
from fembrain_tpu.mesh.polygonize import grid_for_scene as jax_grid
from fembrain_tpu.render import deformed as jd
from fembrain_tpu.render.camera import Camera as JaxCamera
from fembrain_tpu.render.camera import generate_rays as jax_rays

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.render import deformed as pd
from fembrain_tpu_torch.render import tile_trace as tt

from test_torch_fixtures import BRAIN

K_REFRESH = 4


def _k2_agree(h_ref, t_ref, hit, t, min_hits=50):
    """K2 thresholds: hit agreement > 0.995, |dt| on common hits median
    < 5e-3 and max < 5e-2 (model-drift band of the refresh schedule)."""
    assert (h_ref == hit).mean() > 0.995, (h_ref != hit).sum()
    both = h_ref & hit
    assert both.sum() > min_hits
    diff = np.abs(t_ref[both] - t[both])
    assert np.median(diff) < 5e-3, np.median(diff)
    assert diff.max() < 5e-2, diff.max()


@pytest.fixture(scope="module")
def setup():
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jax_grid(js, cellsize=0.3)
    tm = jax_extract(js, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6)
    nodes = np.asarray(tm.nodes)[: int(tm.n_nodes)]
    interp = jd.build_disp_interp(nodes, n_centers=64, kernel="wendland",
                                  sigma_fill=2.5)
    y = nodes[:, 1]
    s = (y - y.min()) / max(y.max() - y.min(), 1e-6)
    u = np.zeros_like(nodes, dtype=np.float32)
    u[:, 1] = -0.15 * s**2
    w = np.asarray(jd.disp_weights(interp, jnp.asarray(u)))
    ro, rd = jax_rays(JaxCamera.orbit(30.0, 20.0, 5.0), 32, 20)
    return dict(
        js=js, nodes=nodes, interp=interp, u=u, w=w,
        ps=convert.scene(convert.numpy_fields(js), device="cpu"),
        pinterp=convert.disp_interp(convert.numpy_fields(interp),
                                    device="cpu"),
        ro=np.asarray(ro).reshape(-1, 3), rd=np.asarray(rd).reshape(-1, 3),
    )


def test_build_disp_interp_matches_jax(setup):
    ref = setup["interp"]
    got = pd.build_disp_interp(setup["nodes"], n_centers=64,
                               kernel="wendland", sigma_fill=2.5,
                               device="cpu")
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(ref.centers))
    np.testing.assert_array_equal(got.center_nodes.numpy(),
                                  np.asarray(ref.center_nodes))
    np.testing.assert_allclose(got.a_inv.numpy(), np.asarray(ref.a_inv),
                               rtol=1e-6, atol=0)
    assert got.sigma == ref.sigma and got.kind == ref.kind == "wendland"
    assert float(got.fill_dist) == float(ref.fill_dist)


def test_weights_samples_and_spec_match_jax(setup):
    interp, pinterp = setup["interp"], setup["pinterp"]
    u_c = setup["u"][np.asarray(interp.center_nodes)]
    w = pd.disp_weights_centers(pinterp, torch.tensor(u_c)).numpy()
    np.testing.assert_allclose(w, setup["w"], rtol=1e-5,
                               atol=1e-5 * np.abs(setup["w"]).max())
    wt = torch.tensor(setup["w"])
    pts = setup["nodes"][::7].astype(np.float32)
    ref_u = np.asarray(jd.sample_disp_rbf(interp, jnp.asarray(setup["w"]),
                                          jnp.asarray(pts)))
    got_u = pd.sample_disp_rbf(pinterp, wt, torch.tensor(pts)).numpy()
    np.testing.assert_allclose(got_u, ref_u, rtol=1e-5, atol=1e-6)
    ref = jd.wendland_pallas_spec(interp, jnp.asarray(setup["w"]),
                                  k_refresh=K_REFRESH)
    got = pd.wendland_spec(pinterp, wt, k_refresh=K_REFRESH)
    for name in ("centers", "w", "waff", "bu", "bg", "bfr", "max_disp"):
        a = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), a, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert (got.sigma, got.k_refresh) == (ref.sigma, ref.k_refresh)
    assert ref.fp_iters == 1  # the port's K2 refreshes with one iteration


def test_deformed_trace_matches_pallas(setup):
    """K2 plain version against the JAX kernel in interpret mode."""
    t_j, h_j = jd.trace_deformed_rbf_fast(
        setup["js"], setup["interp"], jnp.asarray(setup["w"]),
        setup["ro"], setup["rd"], interpret=True, need_grads=False,
        tile=256, k_refresh=K_REFRESH,
    )
    t_p, h_p = pd.trace_deformed_rbf_fast(
        setup["ps"], setup["pinterp"], torch.tensor(setup["w"]),
        torch.tensor(setup["ro"]), torch.tensor(setup["rd"]),
        need_grads=False, k_refresh=K_REFRESH,
    )
    _k2_agree(np.asarray(h_j), np.asarray(t_j), h_p.numpy(), t_p.numpy())


@pytest.mark.parametrize("pose", [(210.0, -20.0, 6.0), (120.0, 35.0, 8.0)])
def test_per_patch_march_matches_pallas_from_other_views(setup, pose):
    """K2 marches patch by patch and refreshes the rest-point model of
    the lanes still marching, where the JAX kernel refreshes every lane
    that started alive for as long as its 256-ray tile marches. From
    behind and from above, at the same thresholds."""
    ro, rd = jax_rays(JaxCamera.orbit(*pose), 32, 20)
    ro, rd = np.asarray(ro).reshape(-1, 3), np.asarray(rd).reshape(-1, 3)
    t_j, h_j = jd.trace_deformed_rbf_fast(
        setup["js"], setup["interp"], jnp.asarray(setup["w"]), ro, rd,
        interpret=True, need_grads=False, tile=256, k_refresh=K_REFRESH,
    )
    t_p, h_p = pd.trace_deformed_rbf_fast(
        setup["ps"], setup["pinterp"], torch.tensor(setup["w"]),
        torch.tensor(ro), torch.tensor(rd), need_grads=False,
        k_refresh=K_REFRESH,
    )
    _k2_agree(np.asarray(h_j), np.asarray(t_j), h_p.numpy(), t_p.numpy())


def test_deformed_march_of_a_ray_does_not_depend_on_its_neighbours(setup):
    """A lane refreshes only while it marches itself and the culls are
    exact, so with every other ray dead (and the tile's step rows and
    flags kept) a ray's root keeps its bits."""
    w = torch.tensor(setup["w"])
    spec = pd.wendland_spec(setup["pinterp"], w, k_refresh=K_REFRESH)
    inp = tt.prepare_tiles(setup["ps"], torch.tensor(setup["ro"]),
                           torch.tensor(setup["rd"]), disp=spec)
    t, hit = tt.trace_tiles_wendland_plain(inp)
    alive = torch.nonzero(inp.rays[8] > 0).squeeze(-1)
    chosen = alive[::5]
    assert chosen.numel() > 20 and int(hit[chosen].sum()) > 10
    keep = torch.zeros(inp.rays.shape[1], dtype=torch.bool)
    keep[chosen] = True
    rays = inp.rays.clone()
    rays[8] = torch.where(keep, rays[8], 0.0)
    t1, hit1 = tt.trace_tiles_wendland_plain(
        dataclasses.replace(inp, rays=rays))
    assert torch.equal(t1[chosen], t[chosen])
    assert torch.equal(hit1[chosen], hit[chosen])
    assert not bool(hit1[~keep].any())


def test_deformed_trace_matches_dense_tracer(setup):
    """K2 plain version against the exact dense deformed tracer."""
    ps, pinterp = setup["ps"], setup["pinterp"]
    w = torch.tensor(setup["w"])
    ro, rd = torch.tensor(setup["ro"]), torch.tensor(setup["rd"])
    t_d, h_d = pd.trace_deformed_rbf(ps, pinterp, w, ro, rd)
    t_p, h_p = pd.trace_deformed_rbf_fast(ps, pinterp, w, ro, rd,
                                          need_grads=False,
                                          k_refresh=K_REFRESH)
    _k2_agree(h_d.numpy(), t_d.numpy(), h_p.numpy(), t_p.numpy())
    # The sag moved the surface: the deformed hits differ from the rest.
    t_r, h_r = tt.trace_tiles(ps, ro, rd)
    both = h_r & h_p
    assert float(torch.abs(t_r[both] - t_p[both]).max()) > 1e-2


def test_wendland_inputs_on_cpu(setup):
    """The packed K2 inputs: centers padded to whole blocks, static
    center-block flags per tile, the Wendland plain version on the CPU."""
    w = torch.tensor(setup["w"])
    spec = pd.wendland_spec(setup["pinterp"], w, k_refresh=K_REFRESH)
    inp = tt.prepare_tiles(setup["ps"], torch.tensor(setup["ro"]),
                           torch.tensor(setup["rd"]), disp=spec)
    wi = inp.wendland
    assert wi.centers.shape == (64, 3) and wi.clive.shape == (3, 2)
    assert wi.k_refresh == K_REFRESH
    assert float(inp.tile_rows[:, 2].max()) > 0.0  # deformed slack on
    t, hit = tt.run_tiles(inp)
    t2, hit2 = tt.trace_tiles_wendland_plain(inp)
    assert torch.equal(t, t2) and torch.equal(hit, hit2)
    with pytest.raises(ValueError):
        tt.trace_tiles_plain(inp)
