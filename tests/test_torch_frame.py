"""PyTorch port, the simulation frame as a whole against the JAX package,
brain at cellsize 0.35: polygonize -> tet mesh -> unstructured FEM steps
-> coupled surface -> `coupled_step_fast`, against the JAX package's
frame with the dense tracer (`use_pallas=False`) and with the Pallas
kernel in interpret mode, at the thresholds of test_torch_wendland.py;
the certified Wendland spec; the coupling telemetry; the exact frame
`coupled_step`."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.fem import deformable as jdef
from fembrain_tpu.fem import integrator as jinteg
from fembrain_tpu.fem import tetmesh as jtet
from fembrain_tpu.mesh import polygonize as jpoly
from fembrain_tpu.mesh.samples import bottom_nodes_per_component as jax_bottom
from fembrain_tpu.render import deformed as jd
from fembrain_tpu.render.camera import Camera as JaxCamera
from fembrain_tpu.render.camera import generate_rays as jax_rays

from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.fem import deformable as pdef
from fembrain_tpu_torch.fem import integrator as pinteg
from fembrain_tpu_torch.fem import tetmesh as ptet
from fembrain_tpu_torch.mesh import polygonize as ppoly
from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component
from fembrain_tpu_torch.render import deformed as pd

from test_torch_fem import assert_fem_state_close
from test_torch_fixtures import BRAIN
from test_torch_wendland import K_REFRESH, _k2_agree

CELLSIZE = 0.35
GRAVITY = -2000.0
W_IMG, H_IMG = 24, 16


@pytest.fixture(scope="module")
def frame():
    """Each package builds its own frame from brain.blob: scene, surface,
    tet mesh, anchors, FEM mesh, 64-center Wendland interpolant."""
    jsc = jax_load_blob(BRAIN)
    jsc.flatten_instances()
    js = jsc.pack()
    grid = jpoly.grid_for_scene(js, CELLSIZE)
    caps = jpoly.default_caps(grid)
    jsurf = jpoly.polygonize(js, grid, *caps)
    jtm = jpoly.extract_tet_mesh(js, grid, ncap=grid.n_vertices,
                                 tetcap=grid.n_cells * 6)
    jnodes = np.asarray(jtm.nodes)[: int(jtm.n_nodes)]
    jtets = np.asarray(jtm.tets)[: int(jtm.n_tets)]
    jfixed = jax_bottom(jnodes, jtets, frac=0.25)
    jm = jtet.build_fem_mesh(jnodes, jtets, fixed=jfixed)
    jinterp = jd.build_disp_interp(jnodes, n_centers=64, kernel="wendland",
                                   sigma_fill=2.5)

    psc = load_blob(BRAIN)
    psc.flatten_instances()
    ps = psc.pack(device="cpu")
    pgrid = ppoly.grid_for_scene(ps, CELLSIZE)
    psurf = ppoly.polygonize(ps, pgrid, *ppoly.default_caps(pgrid))
    ppoly.check_capacity(psurf)
    ptm = ppoly.extract_tet_mesh(ps, pgrid, ncap=pgrid.n_vertices,
                                 tetcap=pgrid.n_cells * 6)
    nodes = ptm.nodes[: ptm.n_nodes].numpy()
    tets = ptm.tets[: ptm.n_tets].numpy()
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    pm = ptet.build_fem_mesh(nodes, tets, fixed=fixed, device="cpu")
    # The two tet meshes' node coordinates differ in the last bit, and the
    # farthest-point pick of the centers has ties on a regular grid that
    # such a bit decides: the port's build_disp_interp takes the JAX mesh's
    # nodes.
    np.testing.assert_allclose(nodes, jnodes, atol=1e-6)
    pinterp = pd.build_disp_interp(jnodes, n_centers=64, kernel="wendland",
                                   sigma_fill=2.5, device="cpu")
    np.testing.assert_array_equal(np.sort(fixed), np.sort(jfixed))
    np.testing.assert_array_equal(pinterp.center_nodes.numpy(),
                                  np.asarray(jinterp.center_nodes))

    f = np.zeros_like(nodes)
    f[:, 1] = GRAVITY
    ro, rd = jax_rays(JaxCamera.orbit(30.0, 20.0, 8.0), W_IMG, H_IMG)
    return dict(js=js, grid=grid, jsurf=jsurf, jtm=jtm, jm=jm,
                jinterp=jinterp, ps=ps, pgrid=pgrid, psurf=psurf, ptm=ptm,
                pm=pm, pinterp=pinterp, f=f,
                ro=np.asarray(ro).reshape(-1, 3),
                rd=np.asarray(rd).reshape(-1, 3))


@pytest.fixture(scope="module")
def settled(frame):
    """Three warm-started steps under gravity in both packages."""
    jm, pm, f = frame["jm"], frame["pm"], frame["f"]
    jstep = jax.jit(lambda st: jinteg.timestep(jm, st, jnp.asarray(f)))
    jst, pst = jinteg.FemState.rest(jm), pinteg.FemState.rest(pm)
    for _ in range(3):
        jst, j_it = jstep(jst)
        pst, p_it = pinteg.timestep(pm, pst, torch.tensor(f))
        assert abs(int(j_it) - p_it) <= 2
    return jst, pst


def test_frame_setup_and_surface_coupling_match_jax(frame, settled):
    jst, pst = settled
    assert_fem_state_close(np.asarray(jst.q), np.asarray(jst.qvel),
                           pst.q.numpy(), pst.qvel.numpy())
    jsurf, psurf = frame["jsurf"], frame["psurf"]
    nv = int(jsurf.n_verts)
    assert int(psurf.n_verts) == nv and int(psurf.n_tris) == int(jsurf.n_tris)
    ref = np.asarray(jsurf.verts + jdef.couple_surface_displacements(
        jsurf.edge_nodes, jsurf.edge_t, frame["jtm"].grid_to_node, jst.q))
    disp = pdef.couple_surface_displacements(
        psurf.edge_nodes, psurf.edge_t, frame["ptm"].grid_to_node, pst.q)
    got = (psurf.verts + disp).numpy()
    np.testing.assert_allclose(got[:nv], ref[:nv], atol=2e-5)
    moved = np.abs(disp.numpy()[:nv]).max()
    assert 1e-3 < moved <= float(pst.q.abs().max()) + 1e-6


@pytest.mark.parametrize("tracer", ["dense", "interpret"])
def test_coupled_step_fast_matches_jax(frame, settled, tracer):
    """Two frames from the settled state. The port's frame runs its tile
    trace (the kernel's plain version on the CPU); the JAX frame runs its
    dense tracer, or its Pallas kernel in interpret mode, composed by hand
    as `coupled_step_fast` composes it (the function itself has no
    interpret switch)."""
    js, ps, jm, pm = (frame[k] for k in ("js", "ps", "jm", "pm"))
    jinterp, pinterp, f = frame["jinterp"], frame["pinterp"], frame["f"]
    ro, rd = frame["ro"], frame["rd"]
    jst, pst = settled

    if tracer == "dense":
        jframe = jax.jit(lambda st: jd.coupled_step_fast(
            js, jm, jinterp, st, jnp.asarray(f), jnp.asarray(ro),
            jnp.asarray(rd), use_pallas=False, bound_pts=jm.rest))
    else:
        def composed(st):
            new, _ = jinteg.timestep(jm, st, jnp.asarray(f), h=0.0333)
            t, hit = jd.trace_deformed_rbf_fast(
                js, jinterp, jd.disp_weights(jinterp, new.q),
                jnp.asarray(ro), jnp.asarray(rd), image_hw=(H_IMG, W_IMG),
                interpret=True, need_grads=False, tile=256,
                k_refresh=K_REFRESH)
            return t, hit, new

        jframe = jax.jit(composed)
    hits = 0
    for _ in range(2):
        t_j, h_j, jst = jframe(jst)
        stats = {}
        t_p, h_p, pst, p_it = pd.coupled_step_fast(
            ps, pm, pinterp, pst, torch.tensor(f), torch.tensor(ro),
            torch.tensor(rd), image_hw=(H_IMG, W_IMG), k_refresh=K_REFRESH,
            solve_stats=stats)
        assert p_it == stats["forward_iters"] > 20
        assert_fem_state_close(np.asarray(jst.q), np.asarray(jst.qvel),
                               pst.q.numpy(), pst.qvel.numpy())
        _k2_agree(np.asarray(h_j), np.asarray(t_j), h_p.numpy(), t_p.numpy(),
                  min_hits=40)
        assert bool(torch.isfinite(t_p).all())
        hits += int(h_p.sum())
    assert hits > 80


def test_coupled_step_fast_gradient_to_young_modulus(frame):
    """The training form (biharmonic interpolant, cold adjoint solve, the
    tile trace's correction): d sum(t) / d E_scale against central
    differences of the same frame, within 5%."""
    ps, pm, f = frame["ps"], frame["pm"], torch.tensor(frame["f"])
    nodes = pm.rest.numpy()
    interp = pd.build_disp_interp(nodes, n_centers=48, device="cpu")
    ro, rd = torch.tensor(frame["ro"]), torch.tensor(frame["rd"])
    st0 = pinteg.FemState.rest(pm)

    def run(e):
        return pd.coupled_step_fast(ps, pm, interp, st0, f, ro, rd,
                                    E_scale=e, differentiable=True)

    e = torch.tensor(1.0, requires_grad=True)
    stats = {}
    t, hit0, new, it = pd.coupled_step_fast(
        ps, pm, interp, st0, f, ro, rd, E_scale=e, differentiable=True,
        solve_stats=stats)
    assert it == -1 and stats["forward_iters"] > 20
    torch.sum(torch.where(hit0, t, 0.0)).backward()
    assert stats["adjoint_iters"] > 20
    g = float(e.grad)

    def loss(v):
        with torch.no_grad():
            t, _, _, _ = run(torch.tensor(v))
        return float(torch.sum(torch.where(hit0, t, 0.0)))

    eps = 0.05
    fd = (loss(1.0 + eps) - loss(1.0 - eps)) / (2 * eps)
    assert int(hit0.sum()) > 40 and abs(fd) > 1e-4
    assert abs(g - fd) <= 0.05 * abs(fd), (g, fd)


def test_coupled_step_exact_frame_matches_jax(frame):
    """`coupled_step` (adjoint solve + trilinear dense trace) against the
    JAX package's on a 12x8 image: the state, the hits (> 0.999, |dt| <
    1e-4) and d sum(t) / d E_scale (rtol 1e-2)."""
    js, ps, jm, pm = (frame[k] for k in ("js", "ps", "jm", "pm"))
    grid, pgrid, f = frame["grid"], frame["pgrid"], frame["f"]
    ro, rd = jax_rays(JaxCamera.orbit(30.0, 20.0, 8.0), 12, 8)
    ro = np.asarray(ro).reshape(-1, 3)
    rd = np.asarray(rd).reshape(-1, 3)
    g2n = frame["jtm"].grid_to_node

    def jloss(e):
        t, hit, new = jd.coupled_step(
            js, jm, grid, g2n, jinteg.FemState.rest(jm), jnp.asarray(f),
            jnp.asarray(ro), jnp.asarray(rd), E_scale=e)
        return jnp.sum(jnp.where(hit, t, 0.0)), (t, hit, new)

    (_, (t_j, h_j, jnew)), ref = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jnp.float32(1.0))
    e = torch.tensor(1.0, requires_grad=True)
    t, hit, new = pd.coupled_step(
        ps, pm, pgrid, frame["ptm"].grid_to_node, pinteg.FemState.rest(pm),
        torch.tensor(f), torch.tensor(ro), torch.tensor(rd), E_scale=e)
    torch.sum(torch.where(hit, t, 0.0)).backward()
    assert_fem_state_close(np.asarray(jnew.q), np.asarray(jnew.qvel),
                           new.q.detach().numpy(), new.qvel.detach().numpy())
    h_j = np.asarray(h_j)
    assert (h_j == hit.numpy()).mean() > 0.999 and h_j.sum() > 8
    both = h_j & hit.numpy()
    assert np.abs(np.asarray(t_j) - t.detach().numpy())[both].max() < 1e-4
    assert abs(float(ref)) > 1e-5
    assert abs(float(e.grad) - float(ref)) <= 1e-2 * abs(float(ref))


@pytest.mark.parametrize("certified", [True, False])
def test_wendland_spec_matches_jax(frame, settled, certified):
    """Every row of the per-frame Wendland spec, sampled and certified,
    against `wendland_pallas_spec` (1e-5 relative to each row's scale)."""
    jst, pst = settled
    jinterp, pinterp = frame["jinterp"], frame["pinterp"]
    jw = jd.disp_weights(jinterp, jst.q)
    pw = torch.tensor(np.asarray(jw))
    ref = jd.wendland_pallas_spec(jinterp, jw, certified=certified,
                                  k_refresh=K_REFRESH)
    got = pd.wendland_spec(pinterp, pw, k_refresh=K_REFRESH,
                           certified=certified)
    for name in ("centers", "w", "waff", "bu", "bg", "bfr", "max_disp"):
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0, err_msg=name,
                                   atol=1e-5 * max(np.abs(a).max(), 1e-3))
    assert (got.sigma, got.k_refresh) == (ref.sigma, ref.k_refresh)
    if certified:
        # Rigorous bounds dominate the sampled ones, block by block.
        sampled = pd.wendland_spec(pinterp, pw)
        assert bool((got.bu >= sampled.bu).all())
        assert bool((got.bg >= sampled.bg).all())
        assert float(got.max_disp) == float(got.bu.max())
    with pytest.raises(ValueError):
        pd.wendland_spec(dataclasses.replace(pinterp, kind="biharmonic"), pw)


def test_coupling_telemetry_matches_jax(frame, settled):
    jst, pst = settled
    jinterp, pinterp = frame["jinterp"], frame["pinterp"]
    jw = jd.disp_weights(jinterp, jst.q)
    pw = pd.disp_weights(pinterp, pst.q)
    ref = jd.coupling_telemetry(jinterp, jw, jst.q)
    got = pd.coupling_telemetry(pinterp, pw, pst.q)
    assert set(got) == set(ref) == {"disp_lipschitz", "march_shrink",
                                    "max_disp_bound"}
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    # Center rows in place of the nodal state give the same record.
    rows = pd.coupling_telemetry(pinterp, pw,
                                 pst.q[pinterp.center_nodes.long()])
    assert all(float(rows[k]) == float(got[k]) for k in got)
    assert float(got["max_disp_bound"]) == pytest.approx(
        float(pd.max_disp_bound(pinterp, pw, pst.q)))
