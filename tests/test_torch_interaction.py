"""PyTorch port: the interaction stack against the JAX package — the probe
and ring avatars, gizmo routing, collision, the rigid box (3 and 6 DOF,
alone and on tissue), the haptic scenario driven through the gizmo on
brain's tet mesh (cellsize 0.35), the mass-spring and particle steps.

Tolerances: the avatars, gizmo and collision are float64 numpy in both
packages and must agree exactly; rigid forces and steps (float32 in both)
within 1e-5 of each quantity's scale; FEM states within the unstructured
timestep's tolerance (test_torch_fem.FEM_RTOL) and CG iterations within
2, but under the falling box, where the contact follows the box's float32
position and the tissue is held to 1e-3 of its scale; mass-spring and
particle states within 1e-5 of their scale."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.fem import avatars as javatars
from fembrain_tpu.fem import collision as jcol
from fembrain_tpu.fem import deformable as jdef
from fembrain_tpu.fem import integrator as jinteg
from fembrain_tpu.fem import mass_spring as jms
from fembrain_tpu.fem import rigid as jrigid
from fembrain_tpu.fem import tetmesh as jtet
from fembrain_tpu.graphics import gizmo as jgizmo
from fembrain_tpu.mesh import polygonize as jpoly
from fembrain_tpu.ops import particles as jpart

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.fem import avatars as pavatars
from fembrain_tpu_torch.fem import collision as pcol
from fembrain_tpu_torch.fem import deformable as pdef
from fembrain_tpu_torch.fem import integrator as pinteg
from fembrain_tpu_torch.fem import mass_spring as pms
from fembrain_tpu_torch.fem import rigid as prigid
from fembrain_tpu_torch.fem import tetmesh as ptet
from fembrain_tpu_torch.graphics import gizmo as pgizmo
from fembrain_tpu_torch.mesh import samples
from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component
from fembrain_tpu_torch.ops import particles as ppart

from test_torch_fem import assert_fem_state_close
from test_torch_fixtures import BRAIN

CPU = "cpu"
RIGID_RTOL = 1e-5
TISSUE_UNDER_BOX_RTOL = 1e-3
HE = np.array([0.2, 0.2, 0.2])


def assert_close_scaled(ref, got, rtol, what=""):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0, what
    assert np.abs(ref - got).max() <= rtol * scale, (
        what, np.abs(ref - got).max(), scale)


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t))


# ------------------------------------------------------------------ avatars
def _probe_descent(mod, nodes):
    probe = mod.AvatarProbe(half_extents=np.array([0.3, 0.3, 0.3]),
                            force_coeff=1000.0)
    probe.pos = np.array([0.0, 1.5, 0.0])
    out = []
    for y in (1.3, 1.2, 1.1, 1.05, 0.95):
        out.append(probe.move_to([0.0, y, 0.0], nodes))
    return probe, out


def test_probe_forces_over_a_descent_are_exact():
    nodes, _ = samples.truth_cube(3, 3, 3, 0.5)
    pp, pout = _probe_descent(pavatars, nodes)
    jp, jout = _probe_descent(javatars, nodes)
    assert pp.contact_face == jp.contact_face == 2
    for (pi, pf), (ji, jf) in zip(pout, jout):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pf, jf)
    idx, forces = pout[-1]
    assert idx.size > 0 and (forces[:, 1] < 0).all()
    assert np.abs(forces[:, [0, 2]]).max() == 0.0
    assert list(pp._contacts) == list(jp._contacts)
    pp.clear_contact()
    assert pp.contact_face == -1 and not pp._contacts


def test_probe_face_from_contact_geometry_and_pick_mode():
    yy, zz = np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 9))
    wall = np.stack([np.zeros(yy.size), yy.ravel(), zz.ravel()], 1)
    res = []
    for mod in (pavatars, javatars):
        probe = mod.AvatarProbe(half_extents=np.array([0.3, 0.3, 0.3]),
                                force_coeff=1000.0,
                                pos=np.array([0.7, 0.0, 0.0]))
        steps = [probe.move_to(probe.pos + [-0.08, -0.02, 0.0], wall)
                 for _ in range(9)]
        res.append((probe.contact_face, steps))
        pick = mod.AvatarProbe(pos=np.zeros(3))
        pick.pick_mode, pick.picked_node = True, 7
        idx, f = pick.move_to(np.array([0.01, -0.02, 0.0]), np.zeros((10, 3)))
        assert list(idx) == [7]
        np.testing.assert_allclose(f[0], [100.0, -200.0, 0.0], rtol=1e-12)
    assert res[0][0] == res[1][0] == 0
    for (pi, pf), (ji, jf) in zip(res[0][1], res[1][1]):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pf, jf)
    assert np.abs(res[0][1][-1][1][:, 1:]).max() == 0.0


@pytest.mark.parametrize("axis", [(0.0, 1.0, 0.0), (1.0, 0.0, 1.0)])
def test_ring_sweep_quads_are_exact(axis):
    quads = []
    for mod in (pavatars, javatars):
        ring = mod.AvatarRing(radius=0.4, segments=12,
                              axis=np.asarray(axis))
        for c in ([0, 1.0, 0], [0, 0.6, 0.1], [0.05, 0.2, 0.1]):
            ring.move_to(c)
        quads.append(np.stack(ring.sweep_quads))
    np.testing.assert_array_equal(quads[0], quads[1])
    assert quads[0].shape == (24, 4, 3)


def test_ring_cut_matches_jax():
    """A ring swept down through a truth cube: the same outcome (a cut or
    the same refusal) in both packages."""
    nodes, tets = samples.truth_cube(4, 4, 4, 0.5)
    out = []
    for mod_a, mod_c, kw in ((pavatars, None, {"device": CPU}),
                             (javatars, None, {})):
        from fembrain_tpu.fem import cutting as jcut
        from fembrain_tpu_torch.fem import cutting as pcut
        cut_mod = pcut if mod_a is pavatars else jcut
        cm = cut_mod.CuttableMesh(nodes, tets, **kw)
        ring = mod_a.AvatarRing(center=np.zeros(3), radius=0.41,
                                segments=16)
        for y in (2.2, 1.1, -0.7):
            ring.move_to([0.13, y, 0.07])
        try:
            out.append(dataclasses.astuple(ring.release(cm)))
        except cut_mod.CutError:
            out.append("refused")
        assert not ring.sweep_quads
    assert out[0] == out[1]


# -------------------------------------------------------------------- gizmo
class _Recorder:
    def __init__(self):
        self.seen = []

    def on_translate(self, delta, pos):
        self.seen.append(("t", delta.copy(), pos.copy()))

    def on_rotate(self, quat):
        self.seen.append(("r", np.asarray(quat).copy()))

    def on_scale(self, scale):
        self.seen.append(("s", np.asarray(scale).copy()))


class _Node:
    def __init__(self):
        self.t = np.array([0.5, 0.0, -1.0])

    def translation(self):
        return self.t

    def set_translation(self, t):
        self.t = np.asarray(t, np.float64)


def _drive_gizmo(mod):
    gm = mod.GizmoManager()
    node = _Node()
    gm.set_focused(node)
    rec = _Recorder()
    gm.register(rec)
    out = []
    for gtype, axis, delta in (
            ("TRANSLATE", "X", [1.0, 2.0, 3.0]),
            ("AVATAR", "FREE", [0.0, -0.05, 0.1]),
            ("TRANSLATE", "Z", [0.2, 0.2, 0.2]),
            ("ROTATE", "FREE", [0.0, 0.0, np.pi / 2]),
            ("ROTATE", "Y", [0.3, 0.0, 0.0]),
            ("SCALE", "FREE", [0.5, 0.0, -0.25])):
        gm.gizmo_type = mod.GizmoType[gtype]
        gm.axis = mod.GizmoAxis[axis]
        out.append(gm.apply(delta))
    return out, rec.seen, node.t


def test_gizmo_translate_rotate_scale_are_exact():
    pout, pseen, pt = _drive_gizmo(pgizmo)
    jout, jseen, jt = _drive_gizmo(jgizmo)
    for a, b in zip(pout, jout):
        np.testing.assert_array_equal(a, b)
    assert len(pseen) == len(jseen) == 6
    for a, b in zip(pseen, jseen):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(pout[0], [1.5, 0.0, -1.0])
    q = pseen[3][1]
    np.testing.assert_allclose(np.linalg.norm(q), 1.0, atol=1e-12)
    np.testing.assert_allclose(q[2], np.sin(np.pi / 4), atol=1e-12)
    assert pgizmo.the_gizmo_manager() is pgizmo.the_gizmo_manager()
    assert [t.name for t in pgizmo.GizmoType] == [
        t.name for t in jgizmo.GizmoType]


# ---------------------------------------------------------------- collision
def test_collision_matches_jax():
    rng = np.random.default_rng(4)
    bodies = {k: rng.uniform(-1, 1, (20, 3)) + off for k, off in
              (("a", 0.0), ("b", 0.8), ("c", 5.0), ("d", -1.5))}
    pts = rng.uniform(-2, 2, (200, 3))
    out = []
    for mod in (pcol, jcol):
        cd = mod.CollisionDetection()
        for k, v in bodies.items():
            cd.update(k, v, pad=0.05)
        box = mod.AABB.of_points(pts[:5], pad=0.1)
        out.append((cd.overlaps(), [cd.vertices_inside(k, pts).tolist()
                                    for k in bodies],
                    box.contains(pts).tolist(),
                    box.expanded(0.3).intersects(cd.bodies["a"])))
    assert out[0] == out[1]
    assert ("a", "b") in out[0][0] and all("c" not in p for p in out[0][0])


# -------------------------------------------------------------------- rigid
def _nodes_around(center, n, spread, seed):
    rng = np.random.default_rng(seed)
    return (np.asarray(center) + rng.uniform(-spread, spread, (n, 3))
            ).astype(np.float32)


@pytest.mark.parametrize("damped", [False, True])
def test_box_tissue_forces_match_jax(damped):
    nodes = _nodes_around([0.1, 0.0, -0.05], 300, 0.3, 1)
    rng = np.random.default_rng(2)
    nvel = rng.normal(size=nodes.shape).astype(np.float32)
    bpos = np.array([0.0, 0.05, 0.0], np.float32)
    bvel = np.array([0.1, -0.5, 0.0], np.float32)
    kw = dict(stiffness=2e4, damping=30.0 if damped else 0.0)
    fj, bj = jrigid.box_tissue_forces(
        jnp.asarray(bpos), HE, jnp.asarray(nodes), box_vel=jnp.asarray(bvel),
        node_vel=jnp.asarray(nvel), **kw)
    fp, bp = prigid.box_tissue_forces(
        torch.tensor(bpos), HE, torch.tensor(nodes),
        box_vel=torch.tensor(bvel), node_vel=torch.tensor(nvel), **kw)
    assert_close_scaled(fj, np_(fp), RIGID_RTOL, "f_nodes")
    assert_close_scaled(bj, np_(bp), RIGID_RTOL, "f_box")
    assert (np_(fp) != 0).any(1).sum() > 20


@pytest.mark.parametrize("damped", [False, True])
def test_box_tissue_forces_6dof_match_jax(damped):
    nodes = _nodes_around([0.1, 0.0, -0.05], 300, 0.35, 3)
    nvel = np.random.default_rng(4).normal(size=nodes.shape).astype(
        np.float32)
    q = np.array([np.cos(0.2), 0.3 * np.sin(0.2), np.sin(0.2) * 0.9, 0.0])
    q /= np.linalg.norm(q)
    kw = dict(quat=q, omega=(0.5, -1.0, 0.2))
    js = jrigid.RigidBody6State.at_rest((0.02, 0.03, 0.0), **kw)
    js = dataclasses.replace(js, vel=jnp.asarray([0.1, -0.4, 0.2]))
    ps = convert.rigid_body6_state(convert.numpy_fields(js), device=CPU)
    he = (0.25, 0.15, 0.2)
    dkw = dict(damping=25.0, node_vel=nvel) if damped else {}
    fj, bj, tj = jrigid.box_tissue_forces_6dof(
        js, he, jnp.asarray(nodes),
        **{k: (jnp.asarray(v) if k == "node_vel" else v)
           for k, v in dkw.items()})
    fp, bp, tp = prigid.box_tissue_forces_6dof(
        ps, he, torch.tensor(nodes),
        **{k: (torch.tensor(v) if k == "node_vel" else v)
           for k, v in dkw.items()})
    for ref, got, what in ((fj, fp, "f_nodes"), (bj, bp, "f_box"),
                           (tj, tp, "tau")):
        assert_close_scaled(ref, np_(got), RIGID_RTOL, what)


def test_rigid_steps_match_jax_over_20_steps():
    jb = jrigid.RigidBoxState.at_rest([0.0, 0.35, 0.0])
    pb = prigid.RigidBoxState.at_rest([0.0, 0.35, 0.0], device=CPU)
    f = np.array([0.3, -2.0, 0.1], np.float32)
    lowest = 1.0
    for _ in range(20):
        jb = jrigid.rigid_step(jb, HE, 2.0, 0.01, f_ext=jnp.asarray(f),
                               ground_y=0.0)
        pb = prigid.rigid_step(pb, HE, 2.0, 0.01, f_ext=torch.tensor(f),
                               ground_y=0.0)
        assert_close_scaled(jb.pos, np_(pb.pos), RIGID_RTOL, "pos")
        assert_close_scaled(jb.vel, np_(pb.vel), RIGID_RTOL, "vel")
        lowest = min(lowest, float(pb.pos[1]))
    assert lowest == pytest.approx(0.2, abs=1e-6)   # it landed and bounced

    q0 = np.asarray([np.cos(0.15), 0.0, 0.0, np.sin(0.15)])
    j6 = jrigid.RigidBody6State.at_rest((0.0, 0.32, 0.0), quat=q0,
                                        omega=(0.0, 1.0, 0.5))
    p6 = prigid.RigidBody6State.at_rest((0.0, 0.32, 0.0), quat=q0,
                                        omega=(0.0, 1.0, 0.5), device=CPU)
    he = (0.3, 0.2, 0.25)
    for _ in range(20):
        j6 = jrigid.rigid_step_6dof(j6, he, 1.0, 0.002, ground_y=0.0,
                                    ground_stiffness=5e3)
        p6 = prigid.rigid_step_6dof(p6, he, 1.0, 0.002, ground_y=0.0,
                                    ground_stiffness=5e3)
        for f_ in ("pos", "vel", "quat", "omega"):
            assert_close_scaled(getattr(j6, f_), np_(getattr(p6, f_)),
                                RIGID_RTOL, f_)
    # The ground touched: a corner penetrates at the start.
    assert float(p6.vel[1]) > -0.02 * 20 * 10


@pytest.fixture(scope="module")
def cube():
    n = 5
    nodes, tets = samples.truth_cube(n, n, n, 0.1)
    fixed = samples.bottom_nodes(nodes)
    return dict(nodes=nodes, tets=tets,
                jm=jtet.build_fem_mesh(nodes, tets, fixed=fixed),
                pm=ptet.build_fem_mesh(nodes, tets, fixed=fixed, device=CPU))


@pytest.mark.parametrize("dof", [3, 6])
def test_coupled_box_tissue_steps_match_jax(cube, dof):
    """20 frames of the box falling onto the tissue: the box within 1e-5
    of its scale, the tissue within the timestep tolerance."""
    jm, pm = cube["jm"], cube["pm"]
    top = float(cube["nodes"][:, 1].max())
    start = [0.03, top + HE[1] + 0.02, -0.02]
    if dof == 3:
        jb = jrigid.RigidBoxState.at_rest(start)
        jb = dataclasses.replace(jb, vel=jnp.asarray([0.0, -2.0, 0.0]))
        jstep, pstep = (jrigid.coupled_box_tissue_step,
                        prigid.coupled_box_tissue_step)
        build = convert.rigid_box_state
    else:
        jb = jrigid.RigidBody6State.at_rest(
            start, quat=(np.cos(0.1), 0.0, 0.0, np.sin(0.1)))
        jb = dataclasses.replace(jb, vel=jnp.asarray([0.0, -2.0, 0.0]))
        jstep, pstep = (jrigid.coupled_box_tissue_step_6dof,
                        prigid.coupled_box_tissue_step_6dof)
        build = convert.rigid_body6_state
    pb = build(convert.numpy_fields(jb), device=CPU)
    jst, pst = jinteg.FemState.rest(jm), pinteg.FemState.rest(pm)
    jfn = jax.jit(lambda b, s: jstep(b, HE, 20.0, jm, s, h=0.005,
                                     ground_y=-1.0, tissue_gravity=-1.0))
    touched = False
    for _ in range(20):
        jb, jst, j_it = jfn(jb, jst)
        pb, pst, p_it = pstep(pb, HE, 20.0, pm, pst, h=0.005, ground_y=-1.0,
                              tissue_gravity=-1.0)
        assert abs(int(j_it) - p_it) <= 2
        for f_ in ("pos", "vel") + (("quat", "omega") if dof == 6 else ()):
            assert_close_scaled(getattr(jb, f_), np_(getattr(pb, f_)),
                                RIGID_RTOL, f_)
        touched = touched or float(pst.q[:, 1].min()) < -1e-7
    assert touched
    # The contact force follows the box's float32 position (held above to
    # 1e-5 of its scale, about 2e-6) against penetrations of 1e-5 to
    # 1e-4, so the tissue is held to 1e-3 of its scale, on the scales of
    # test_torch_fem.assert_fem_state_close.
    q_scale = float(np.abs(np.asarray(jst.q)).max())
    assert_close_scaled(jst.q, np_(pst.q), TISSUE_UNDER_BOX_RTOL, "q")
    v_scale = max(float(np.abs(np.asarray(jst.qvel)).max()), q_scale / 0.005)
    assert np.abs(np.asarray(jst.qvel) - np_(pst.qvel)).max() <= (
        TISSUE_UNDER_BOX_RTOL * v_scale)


# ---------------------------------------- the behaviours of test_rigid.py
def test_box_falls_and_rests_on_floor():
    st = prigid.RigidBoxState.at_rest([0.0, 2.0, 0.0], device=CPU)
    for _ in range(400):
        st = prigid.rigid_step(st, HE, mass=1.0, h=0.01, ground_y=0.0)
    assert abs(float(st.pos[1]) - 0.2) < 1e-3
    assert abs(float(st.vel[1])) < 0.05


def test_box_deforms_tissue_and_gets_supported(cube):
    """The box starts resting on the tissue's top rather than 0.3 above
    it: while it falls freely the tissue's right side is rounding noise,
    and CG (whose threshold is relative to that side) runs all its 10,000
    iterations a frame in both packages, which eagerly on the CPU takes
    seconds a frame."""
    mesh = cube["pm"]
    rest = np_(mesh.rest)
    top = float(rest[:, 1].max())
    box = prigid.RigidBoxState.at_rest(
        [float(rest[:, 0].mean()), top + HE[1] - 1e-4,
         float(rest[:, 2].mean())], device=CPU)
    st = pinteg.FemState.rest(mesh)
    min_bottom = 1e9
    for _ in range(300):
        box, st, _ = prigid.coupled_box_tissue_step(
            box, HE, 20.0, mesh, st, h=0.005, ground_y=-1.0)
        min_bottom = min(min_bottom, float(box.pos[1]) - HE[1])
    q = np_(st.q)
    assert np.isfinite(q).all()
    assert q[:, 1].min() < -2e-5
    assert min_bottom > -0.9
    assert top - 0.2 < float(box.pos[1]) - HE[1] < top + 0.05


def test_free_rotation_preserves_angular_velocity():
    st = prigid.RigidBody6State.at_rest((0.0, 5.0, 0.0),
                                        omega=(0.0, 2.0, 0.0), device=CPU)
    for _ in range(50):
        st = prigid.rigid_step_6dof(st, (0.3, 0.2, 0.1), 1.0, 0.01,
                                    ground_y=None)
    assert abs(float(torch.linalg.norm(st.quat)) - 1.0) < 1e-5
    assert abs(float(st.omega[1]) - 2.0) < 1e-4
    assert float(st.vel[1]) < -4.0


def test_tumbling_box_settles_on_floor():
    q0 = np.asarray([np.cos(0.15), 0.0, 0.0, np.sin(0.15)])
    st = prigid.RigidBody6State.at_rest((0.0, 1.0, 0.0), quat=q0, device=CPU)
    he = (0.3, 0.2, 0.25)
    for _ in range(5000):
        st = prigid.rigid_step_6dof(st, he, 1.0, 0.002, ground_y=0.0,
                                    ground_stiffness=5e3)
    assert abs(float(torch.linalg.norm(st.quat)) - 1.0) < 1e-4
    assert float(torch.linalg.norm(st.omega)) < 0.5
    assert 0.1 < float(st.pos[1]) < 0.4
    R = np_(prigid.quat_to_mat(st.quat))
    assert np.abs(R[1]).max() > 0.95, R[1]


def test_offcenter_tissue_contact_spins_box():
    st = prigid.RigidBody6State.at_rest((0.0, 0.0, 0.0), device=CPU)
    nodes = torch.tensor([[0.25, 0.15, 0.0]])
    f_n, f_b, tau = prigid.box_tissue_forces_6dof(st, (0.3, 0.3, 0.3), nodes)
    assert float(torch.linalg.norm(f_n)) > 0
    np.testing.assert_allclose(np_(f_b), -np_(f_n[0]), atol=1e-6)
    assert float(torch.linalg.norm(tau)) > 0


def test_rigid_helpers_match_jax():
    q = np.array([0.8, 0.2, -0.4, 0.4])
    q /= np.linalg.norm(q)
    r = np.array([0.1, 0.7, 0.7, 0.1])
    np.testing.assert_allclose(
        np_(prigid.quat_mul(torch.tensor(q), torch.tensor(r))),
        np.asarray(jrigid.quat_mul(jnp.asarray(q), jnp.asarray(r))),
        rtol=1e-6)
    np.testing.assert_allclose(
        np_(prigid.quat_to_mat(torch.tensor(q, dtype=torch.float32))),
        np.asarray(jrigid.quat_to_mat(jnp.asarray(q, jnp.float32))),
        atol=1e-6)
    np.testing.assert_allclose(np_(prigid.box_inertia(3.0, (0.3, 0.2, 0.1))),
                               np.asarray(jrigid.box_inertia(3.0,
                                                             (0.3, 0.2, 0.1))),
                               rtol=1e-6)
    np.testing.assert_array_equal(np_(prigid._CORNER_SIGNS),
                                  np.asarray(jrigid._CORNER_SIGNS))


# ------------------------------------------------------- haptic scenario
class _ProbeListener:
    """Gizmo listener wiring the probe to the deformable (the reference's
    AvatarProbe::onTranslate role), for either package."""

    def __init__(self, probe, deformable, rest):
        self.probe, self.deformable, self.rest = probe, deformable, rest
        self.contacts = []

    def on_translate(self, delta, pos):
        positions = self.rest + np_(self.deformable.state.q)
        idx, forces = self.probe.move_to(pos, positions)
        self.contacts.append(len(idx))
        f = self.deformable.haptic_forces(idx, forces) if len(idx) else None
        self.deformable.timestep(f_haptic=f)

    def on_rotate(self, quat):
        pass

    def on_scale(self, scale):
        pass


def test_haptic_scenario_on_brain_matches_jax():
    """The scripted probe push of tests/test_haptic_scenario.py on brain's
    tet mesh (cellsize 0.35), in both packages from one gizmo script."""
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jpoly.grid_for_scene(js, 0.35)
    tm = jpoly.extract_tet_mesh(js, grid, ncap=grid.n_vertices,
                                tetcap=grid.n_cells * 6)
    nodes = np.asarray(tm.nodes)[: int(tm.n_nodes)].astype(np.float64)
    tets = np.asarray(tm.tets)[: int(tm.n_tets)]
    # Every lobe anchored at its own bottom slab, as the simulation frame
    # anchors brain (the lowest plane alone leaves lobes free to drift).
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    top = nodes[:, 1].max()
    cx, cz = nodes[:, 0].mean(), nodes[:, 2].mean()
    runs = []
    for mods in ((javatars, jgizmo, jdef, jtet, {}),
                 (pavatars, pgizmo, pdef, ptet, {"device": CPU})):
        av, gz, dm, tm_, kw = mods
        fem = tm_.build_fem_mesh(nodes, tets, fixed=fixed, **kw)
        body = dm.Deformable(fem, gravity=0.0, ground_y=None)
        probe = av.AvatarProbe(half_extents=np.array([0.4, 0.4, 0.4]),
                               force_coeff=5000.0,
                               pos=np.array([cx, top + 0.3, cz]))
        gm = gz.GizmoManager()
        gm.gizmo_type = gz.GizmoType.AVATAR
        gm.pos = probe.pos.copy()
        listener = _ProbeListener(probe, body, nodes)
        gm.register(listener)
        states = []
        for _ in range(12):
            gm.apply(np.array([0.0, -0.05, 0.0]))
            states.append((np_(body.state.q), np_(body.state.qvel),
                           body.stats()["cg_iters"]))
        runs.append((listener.contacts, states, probe.contact_face))
    (jc, jstates, jface), (pc, pstates, pface) = runs
    assert jc == pc and jface == pface >= 0
    assert sum(1 for c in pc if c) >= 3
    for (jq, jv, ji), (pq, pv, pi) in zip(jstates[-6:], pstates[-6:]):
        assert abs(ji - pi) <= 2
        assert_fem_state_close(jq, jv, pq, pv)
    q = pstates[-1][0]
    assert np.abs(q[fixed]).max() == 0.0
    assert 1e-3 < np.abs(q).max() < 0.5


# -------------------------------------------------- mass-spring, particles
def test_mass_spring_matches_jax_and_damps():
    jm = jms.make_dumbbell(separation=2.0, k=50.0)
    jm = dataclasses.replace(jm, pos=jm.pos.at[1, 0].set(1.5))
    pm = convert.mass_spring(convert.numpy_fields(jm), device=CPU)
    fresh = pms.make_dumbbell(separation=2.0, k=50.0, device=CPU)
    for f in dataclasses.fields(fresh):
        ref = np.asarray(getattr(jms.make_dumbbell(2.0, 50.0), f.name))
        got = np_(getattr(fresh, f.name))
        assert got.dtype == ref.dtype, f.name
        np.testing.assert_array_equal(got, ref)
    for i in range(120):
        jm = jms.step_mass_spring(jm, dt=1 / 120, gravity=-1.0,
                                  damping=0.005)
        pm = pms.step_mass_spring(pm, dt=1 / 120, gravity=-1.0,
                                  damping=0.005)
    assert_close_scaled(jm.pos, np_(pm.pos), 1e-5, "pos")
    assert_close_scaled(jm.vel, np_(pm.vel), 1e-5, "vel")
    e0 = None
    ms = dataclasses.replace(fresh, pos=fresh.pos.clone().index_fill_(
        0, torch.tensor([1]), 0.0))
    ms.pos[1, 0] = 1.5
    for i in range(600):
        ms = pms.step_mass_spring(ms, dt=1 / 120, damping=0.005)
        if i == 0:
            e0 = float(torch.sum(ms.vel ** 2))
    sep = float(torch.linalg.norm(ms.pos[1] - ms.pos[0]))
    assert abs(sep - 2.0) < 0.2
    assert float(torch.sum(ms.vel ** 2)) < max(e0, 1.0)


def test_mass_spring_shared_endpoints_add_up():
    """Three springs on one node: index_add_ sums repeated indices as the
    JAX package's .at[].add does."""
    pos = np.array([[0, 0, 0], [1.2, 0, 0], [0, 1.3, 0], [0, 0, 0.7]],
                   np.float32)
    kw = dict(pos=pos, vel=np.zeros_like(pos),
              mass=np.ones(4, np.float32),
              springs=np.array([[0, 1], [0, 2], [3, 0]], np.int32),
              rest_len=np.ones(3, np.float32),
              k=np.array([10.0, 20.0, 30.0], np.float32),
              fixed=np.array([False, False, True, False]))
    jm = jms.MassSpring(**{k: jnp.asarray(v) for k, v in kw.items()})
    pm = convert.mass_spring(kw, device=CPU)
    for _ in range(5):
        jm = jms.step_mass_spring(jm, dt=0.01)
        pm = pms.step_mass_spring(pm, dt=0.01)
    assert_close_scaled(jm.pos, np_(pm.pos), 1e-5, "pos")
    assert_close_scaled(jm.vel, np_(pm.vel), 1e-5, "vel")
    assert (np_(pm.vel)[2] == 0).all()


def test_particles_step_matches_jax_from_one_state():
    js = jpart.init_particles(512, seed=3, box=1.0)
    ps = convert.particle_state(convert.numpy_fields(js), device=CPU)
    for _ in range(120):
        js = jpart.step_particles(js, dt=1 / 60, box=1.0)
        ps = ppart.step_particles(ps, dt=1 / 60, box=1.0)
    assert_close_scaled(js.pos, np_(ps.pos), 1e-5, "pos")
    assert_close_scaled(js.vel, np_(ps.vel), 1e-5, "vel")
    np.testing.assert_allclose(np_(ps.age), np.asarray(js.age), rtol=1e-6)


def test_particles_seeded_init_bounce_and_stay_in_box():
    a = ppart.init_particles(256, seed=5, box=1.0, device=CPU)
    b = ppart.init_particles(256, seed=5, box=1.0, device=CPU)
    c = ppart.init_particles(256, seed=6, box=1.0, device=CPU)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)
    assert not torch.equal(a.pos, c.pos)
    assert float(a.pos.abs().max()) <= 1.0 and float(a.vel.std()) < 0.2
    st = a
    for _ in range(120):
        st = ppart.step_particles(st, dt=1 / 60, box=1.0)
    pos = np_(st.pos)
    assert (pos >= -1.0 - 1e-5).all() and (pos <= 1.0 + 1e-5).all()
    assert float(st.age[0]) == pytest.approx(2.0, rel=1e-4)
