"""PyTorch port, the headless app (`fembrain_tpu_torch.app`) on the repo's
one user configuration, data/models/brain.sim (brain.blob, no fixed
vertices, no gravity, FORCECOEFF 5000), at cellsize 0.35 on the CPU,
against the JAX package's SimulationApp (tests/test_app.py and
tests/test_rbf_coupling.py are the models; they load a scene this repo
does not hold)."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from fembrain_tpu.app import SimulationApp as JaxApp
from fembrain_tpu.fem.integrator import FemState as JaxFemState

from fembrain_tpu_torch import app as papp
from fembrain_tpu_torch.app import SimulationApp
from fembrain_tpu_torch.fem.deformable import couple_surface_displacements
from fembrain_tpu_torch.fem.integrator import FemState
from fembrain_tpu_torch.utils.checkpoint import load_pytree
from fembrain_tpu_torch.utils.config import SimConfig

from test_torch_fem import assert_fem_state_close

REPO = Path(__file__).resolve().parent.parent
BRAIN_SIM = REPO / "data" / "models" / "brain.sim"
CELLSIZE = 0.35
HAPTIC_STEPS = 3


def _top_node(app, to_np):
    """The tet node under the top surface vertex (where chip_smoke.py
    pushes), from an app of either package."""
    nv = int(app.surface.n_verts)
    verts = to_np(app.surface.verts)[:nv]
    top = int(np.argmax(verts[:, 1]))
    edge = to_np(app.surface.edge_nodes)[top, 0]
    return int(to_np(app._grid_to_node)[edge])


@pytest.fixture(scope="module")
def apps():
    japp = JaxApp(BRAIN_SIM, cellsize=CELLSIZE)
    papp_ = SimulationApp(BRAIN_SIM, cellsize=CELLSIZE, device="cpu")
    yield japp, papp_
    japp.close()
    papp_.close()


def test_app_builds_the_same_meshes_as_jax(apps):
    """The same surface, tet mesh and FEM sizes in both packages; the
    config's camera, no fixed vertices, no gravity; the scene graph holds
    the tissue and the physics node."""
    japp, app = apps
    assert dataclasses.asdict(app.cfg) == dataclasses.asdict(japp.cfg)
    assert int(app.surface.n_verts) == int(japp.surface.n_verts) > 0
    assert int(app.surface.n_tris) == int(japp.surface.n_tris) > 0
    assert app.fem.n_nodes == japp.fem.n_nodes > 0
    assert app.fem.n_tets == japp.fem.n_tets > 0
    assert not bool(app.fem.fixed.any())
    np.testing.assert_allclose(app.camera.eye.numpy(),
                               np.asarray(japp.camera.eye), atol=1e-5)
    assert len(app.scenegraph) == 2
    assert app.scenegraph.get("tissue") is not None
    # brain.sim has GRAVITY=0: no gravity and no ground.
    kw = app.deformable._kw
    assert kw["gravity"] == 0.0 and kw["ground_y"] is None
    assert papp.APP_GRAVITY == -10000.0


def test_haptic_steps_match_jax(apps):
    """Three steps with a push of (0, -FORCECOEFF, 0) at the top surface
    node: q and qvel within the FEM tolerance of the reference (each
    package on its own tet mesh, whose nodes differ in the last bit)."""
    japp, app = apps
    node = _top_node(app, lambda t: t.numpy())
    assert node == _top_node(japp, np.asarray)
    force = np.array([[0.0, -app.cfg.force_coeff, 0.0]])
    for _ in range(HAPTIC_STEPS):
        jd = japp.timestep(haptic=(np.array([node]), force))
        pdisp = app.timestep(haptic=(np.array([node]), force))
    jst, pst = japp.deformable.state, app.deformable.state
    assert_fem_state_close(np.asarray(jst.q), np.asarray(jst.qvel),
                           pst.q.numpy(), pst.qvel.numpy())
    assert float(pst.q[node, 1]) < 0.0
    nv = int(app.surface.n_verts)
    np.testing.assert_allclose(pdisp[:nv].numpy(), np.asarray(jd)[:nv],
                               atol=1e-4 * float(pst.q.abs().max()))
    assert app.frame == japp.frame == HAPTIC_STEPS
    rec = app.metrics.last
    assert rec.cg_iters > 0 and rec.fps > 0 and rec.ct_vertices == \
        app.fem.n_nodes


def test_scenegraph_timestep_and_draw_follow_the_fem(apps):
    """The physics node's timestep advances the FEM and captures the
    coupling; the tissue's draw batch is the rest surface plus that
    displacement."""
    _, app = apps
    frame0 = app.frame
    q0 = app.deformable.state.q.clone()
    app.scenegraph.timestep()
    assert app.frame == frame0 + 1 and app._last_disp is not None
    assert not torch.equal(app.deformable.state.q, q0)
    batches = app.scenegraph.draw()
    tissue = batches[[b.name for b in batches].index("tissue")]
    nv = int(app.surface.n_verts)
    assert tissue.verts.shape == (nv, 3) and tissue.faces.shape[1] == 3
    want = app.deformed_vertices(app._last_disp)[:nv].numpy()
    np.testing.assert_allclose(tissue.verts, want, atol=1e-6)
    moved = np.abs(tissue.verts - app.surface.verts[:nv].numpy()).max()
    assert moved > 1e-4


def test_hud_overlay_changes_pixels(apps):
    """render_frame of the deformed tissue (the trilinear dense path)
    with and without the HUD rows: same shape, finite, and the HUD's
    corner differs."""
    _, app = apps
    plain = app.render_frame(width=56, height=40)
    hud = app.render_frame(width=56, height=40, hud=True)
    assert plain.shape == hud.shape == (40, 56, 3)
    assert np.isfinite(plain).all() and (plain < 1.0).any()
    assert not np.allclose(hud[:20], plain[:20])


def test_refit_rbf_tracks_the_deformed_surface(apps):
    """A uniform sag of 0.15 (no fixed nodes): the refit RBF's zero level
    sits on the deformed surface (mean |f| 0.029 there in both packages
    on brain, against 0.18 on the vacated band above the rest top, which
    reads as outside); points 0.1 outside and inside the deformed surface
    read outside and inside (tests/test_rbf_coupling.py probes one point
    each on a sphere); the port's RBF takes as many centers as the
    reference's and evaluates within 1e-4 of it on the deformed
    surface."""
    japp, app = apps
    saved = app.deformable.state
    dq = torch.zeros((app.fem.n_nodes, 3))
    dq[:, 1] = -0.15
    app.deformable.state = FemState(q=dq, qvel=torch.zeros_like(dq),
                                    dv=torch.zeros_like(dq))
    jq = jnp.asarray(dq.numpy())
    japp.deformable.state = JaxFemState(q=jq, qvel=jnp.zeros_like(jq),
                                        dv=jnp.zeros_like(jq))
    rbf = app.refit_rbf(max_points=200)
    jrbf = japp.refit_rbf(max_points=200)
    assert rbf.centers.shape == jrbf.centers.shape
    assert rbf.device == torch.device("cpu")
    disp = couple_surface_displacements(
        app.surface.edge_nodes, app.surface.edge_t, app._grid_to_node, dq)
    nv = int(app.surface.n_verts)
    deformed = (app.surface.verts + disp)[:nv].numpy()
    rest = app.surface.verts[:nv].numpy()
    on = rbf.evaluate(deformed)
    np.testing.assert_allclose(on, np.asarray(jrbf.evaluate(deformed)),
                               atol=1e-4)
    top = rest[:, 1] > rest[:, 1].max() - 0.05
    vacated = rbf.evaluate(rest[top]).mean()
    assert np.abs(on).mean() < 0.03 and vacated < -0.1
    # A uniform sag moves the surface without turning it: the rest
    # normals are the deformed ones.
    n = app.surface.normals[:nv].numpy()
    assert (rbf.evaluate(deformed + 0.1 * n) < 0).mean() > 0.9
    assert (rbf.evaluate(deformed - 0.1 * n) > 0).mean() > 0.9
    app.deformable.state = saved


def test_refit_rbf_loses_the_surface_under_a_large_drift_as_jax_does(apps):
    """A reference fault, copied: the deformed field pulls points back by
    two fixed-point steps through a displacement clamped to the grid, so
    a drift of 1.35 (what brain.sim's unanchored tissue reaches under
    five pushes at cellsize 0.14) leaves the refit RBF far off the
    surface in both packages (mean |f| over 10, against 0.029 at 0.15)."""
    japp, app = apps
    saved, jsaved = app.deformable.state, japp.deformable.state
    dq = torch.zeros((app.fem.n_nodes, 3))
    dq[:, 1] = -1.35
    app.deformable.state = FemState(q=dq, qvel=dq * 0, dv=dq * 0)
    jq = jnp.asarray(dq.numpy())
    japp.deformable.state = JaxFemState(q=jq, qvel=jq * 0, dv=jq * 0)
    nv = int(app.surface.n_verts)
    disp = couple_surface_displacements(
        app.surface.edge_nodes, app.surface.edge_t, app._grid_to_node, dq)
    deformed = (app.surface.verts + disp)[:nv].numpy()
    for rbf in (app.refit_rbf(max_points=100),
                japp.refit_rbf(max_points=100)):
        assert np.abs(np.asarray(rbf.evaluate(deformed))).mean() > 10.0
    app.deformable.state, japp.deformable.state = saved, jsaved


def _falling_sim(tmp_path):
    """brain.sim with GRAVITY=1, so that the CLI's steps (which push
    nothing) move the tissue: the reference's -10,000 a node, ground at
    the config's level."""
    cfg = SimConfig.load(BRAIN_SIM)
    cfg = dataclasses.replace(
        cfg, gravity=True, relative_path=False,
        input_file=str(cfg.resolve_input(BRAIN_SIM).resolve()))
    path = tmp_path / "falling.sim"
    cfg.save(path)
    return path


def test_cli_checkpoint_resume_matches_an_unbroken_run(tmp_path,
                                                     monkeypatch):
    """`main` with --checkpoint-every: 4 frames in one run against 2
    frames, then 2 more with --resume, under gravity; the two final
    checkpoints hold the same state. The runs also write their PNGs (at
    32x24 here: the app's 400x300 dense frame takes minutes on the CPU)
    and the metrics JSONL (one record a frame)."""
    render = SimulationApp.render_frame
    monkeypatch.setattr(SimulationApp, "render_frame",
                        lambda self, hud=False: render(self, 32, 24, hud))
    sim = _falling_sim(tmp_path)
    base = ["--file", str(sim), "--device", "cpu", "--cellsize",
            str(CELLSIZE), "--checkpoint-every", "2"]
    ck_a, ck_b = tmp_path / "a.npz", tmp_path / "b.npz"
    assert papp.main(base + ["--frames", "4", "--checkpoint", str(ck_a),
                             "--metrics", str(tmp_path / "m.jsonl")]) == 0
    assert papp.main(base + ["--frames", "2", "--checkpoint",
                             str(ck_b)]) == 0
    assert papp.main(base + ["--frames", "2", "--checkpoint", str(ck_b),
                             "--resume", "--render-every", "2", "--hud",
                             "--out", str(tmp_path / "png")]) == 0
    like = FemState(q=torch.zeros(1), qvel=torch.zeros(1),
                    dv=torch.zeros(1))
    a, b = load_pytree(ck_a, like), load_pytree(ck_b, like)
    assert float(a.q.abs().max()) > 1e-3
    for x, y in ((a.q, b.q), (a.qvel, b.qvel), (a.dv, b.dv)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0,
                                   atol=1e-6 * float(x.abs().max()))
    rows = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    # Free fall: every later step's warm start is already the solution.
    assert len(rows) == 4 and rows[0]["cg_iters"] > 0
    pngs = sorted((tmp_path / "png").glob("frame_*.png"))
    assert [p.name for p in pngs] == ["frame_0000.png"]
    img = np.asarray(Image.open(pngs[0]))
    assert img.shape == (24, 32, 3) and img.min() < 255


def test_cli_debug_nans_raises_on_a_nan_state(tmp_path, monkeypatch):
    """--debug-nans checks the FEM state after each step and raises
    FloatingPointError on a NaN."""
    def nan_step(self, haptic=None):
        q = torch.full((self.fem.n_nodes, 3), float("nan"))
        self.deformable.state = FemState(q=q, qvel=q, dv=q)
        return q

    monkeypatch.setattr(SimulationApp, "timestep", nan_step)
    with pytest.raises(FloatingPointError):
        papp.main(["--file", str(BRAIN_SIM), "--device", "cpu",
                   "--cellsize", str(CELLSIZE), "--frames", "1",
                   "--debug-nans"])
