"""PyTorch port: the unstructured corotational FEM (FemMesh, the
corotational element code, the block-Jacobi PCG timestep, Deformable and
the surface coupling) against the JAX package on brain's tet mesh at
cellsize 0.35 (855 nodes, 3,480 tets), on identical numpy inputs."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.fem import corotational as jco
from fembrain_tpu.fem import deformable as jdef
from fembrain_tpu.fem import integrator as jinteg
from fembrain_tpu.fem import tetmesh as jtet
from fembrain_tpu.mesh import polygonize as jpoly
from fembrain_tpu.mesh.samples import bottom_nodes as jax_bottom_nodes
from fembrain_tpu.mesh.samples import bottom_nodes_per_component as jax_bottom

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.fem import corotational as pco
from fembrain_tpu_torch.fem import deformable as pdef
from fembrain_tpu_torch.fem import integrator as pinteg
from fembrain_tpu_torch.fem import tetmesh as ptet
from fembrain_tpu_torch.mesh.samples import bottom_nodes

from test_torch_fem import assert_fem_state_close
from test_torch_fixtures import BRAIN

GRAVITY = -2000.0   # per-node force on y


@pytest.fixture(scope="module")
def mesh():
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = jpoly.grid_for_scene(js, cellsize=0.35)
    jtm = jpoly.extract_tet_mesh(js, grid, ncap=grid.n_vertices,
                                 tetcap=grid.n_cells * 6)
    nodes = np.asarray(jtm.nodes)[: int(jtm.n_nodes)]
    tets = np.asarray(jtm.tets)[: int(jtm.n_tets)]
    fixed = jax_bottom(nodes, tets, frac=0.25)
    jm = jtet.build_fem_mesh(nodes, tets, fixed=fixed)
    pm = ptet.build_fem_mesh(nodes, tets, fixed=fixed, device="cpu")
    return dict(js=js, grid=grid, jtm=jtm, nodes=nodes, tets=tets,
                fixed=fixed, jm=jm, pm=pm)


def _displacement(mesh, seed, scale=0.05):
    u = np.random.default_rng(seed).normal(size=mesh["nodes"].shape)
    return (scale * u).astype(np.float32)


def test_build_fem_mesh_arrays_equal(mesh):
    jm, pm = mesh["jm"], mesh["pm"]
    for f in dataclasses.fields(pm):
        a, b = getattr(jm, f.name), getattr(pm, f.name)
        if isinstance(b, torch.Tensor):
            assert b.numpy().dtype == np.asarray(a).dtype, f.name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), f.name)
        else:
            assert a == b, f.name
    assert pm.dof == 3 * pm.n_nodes == jm.dof
    # convert.fem_mesh_from_numpy gives the same mesh from the JAX one's
    # arrays.
    cm = convert.fem_mesh_from_numpy(convert.numpy_fields(jm), device="cpu")
    for f in dataclasses.fields(pm):
        a, b = getattr(cm, f.name), getattr(pm, f.name)
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b


def test_fixed_masks_and_inverted_tets(mesh):
    nodes, tets = mesh["nodes"], mesh["tets"]
    mask = np.zeros(len(nodes), bool)
    mask[mesh["fixed"]] = True
    pm = ptet.build_fem_mesh(nodes, tets, fixed=mask, device="cpu")
    assert torch.equal(pm.fixed, mesh["pm"].fixed)
    assert int(pm.fixed.sum()) == len(mesh["fixed"]) > 2
    free = ptet.build_fem_mesh(nodes, tets, device="cpu")
    assert not bool(free.fixed.any())
    flipped = tets.copy()
    flipped[0, [1, 2]] = flipped[0, [2, 1]]
    with pytest.raises(ValueError, match="1 inverted"):
        ptet.build_fem_mesh(nodes, flipped, device="cpu")
    np.testing.assert_array_equal(bottom_nodes(nodes),
                                  jax_bottom_nodes(nodes))


def test_polar_rotation_matches_jax():
    """Random 3x3 matrices, some reflected: R orthogonal with det +1 for
    det F > 0 and equal to the JAX package's within 1e-5."""
    F = np.random.default_rng(0).normal(size=(200, 3, 3)).astype(np.float32)
    F += 2.0 * np.eye(3, dtype=np.float32)
    F[::7, 0] *= -1.0
    R = pco.polar_rotation(torch.tensor(F)).numpy()
    np.testing.assert_allclose(R, np.asarray(jco.polar_rotation(
        jnp.asarray(F))), atol=1e-5)
    np.testing.assert_allclose(np.abs(np.linalg.det(R)), 1.0, atol=1e-4)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-4)
    np.testing.assert_allclose(
        pco._inv3(torch.tensor(F)).numpy(), np.linalg.inv(F), rtol=1e-3,
        atol=1e-4)


def test_forces_and_stiffness_products(mesh):
    """internal_forces and the matvec forms against the JAX package
    (relative 1e-5 of the largest entry), and stiffness_apply =
    stiffness_apply_pre = the densely assembled rotated stiffness."""
    jm, pm = mesh["jm"], mesh["pm"]
    u = _displacement(mesh, 1)
    v = _displacement(mesh, 2, 1.0)
    _, jR = jco.element_kinematics(jm, jnp.asarray(u))
    p, R = pco.element_kinematics(pm, torch.tensor(u))
    assert p.shape == (pm.n_tets, 4, 3)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())

    close(pco.internal_forces(pm, torch.tensor(u), R),
          jco.internal_forces(jm, jnp.asarray(u), jR))
    kv = pco.stiffness_apply(pm, R, torch.tensor(v))
    close(kv, jco.stiffness_apply(jm, jR, jnp.asarray(v)))
    krot = pco.rotated_stiffness(pm, R)
    jkrot = jco.rotated_stiffness(jm, jR)
    close(krot, jkrot)
    close(pco.stiffness_apply_pre(pm, krot, torch.tensor(v)), kv.numpy())
    close(pco.stiffness_blocks(pm, krot), jco.stiffness_blocks(jm, jkrot))
    close(pco.stiffness_diag(pm, R), jco.stiffness_diag(jm, jR))
    # Dense assembly in float64.
    n = pm.n_nodes
    K = np.zeros((3 * n, 3 * n))
    dof = (3 * mesh["tets"][:, :, None] + np.arange(3)).reshape(-1, 12)
    for t, k in enumerate(krot.numpy().astype(np.float64)):
        K[np.ix_(dof[t], dof[t])] += k
    dense = (K @ v.reshape(-1).astype(np.float64)).reshape(n, 3)
    close(kv, dense)
    np.testing.assert_allclose(
        pco.stiffness_diag(pm, R).numpy().reshape(-1), np.diag(K),
        rtol=1e-4)
    # The scatter branch (no gather map) assembles the same sums.
    scat = dataclasses.replace(pm, node_gather=None)
    close(pco.stiffness_apply_pre(scat, krot, torch.tensor(v)), kv.numpy())


def test_timestep_matches_jax_over_warm_started_steps(mesh):
    """Five warm-started steps under gravity: q, qvel and dv within
    rtol 1e-4 of the state's scale, CG iterations within 2."""
    jm, pm = mesh["jm"], mesh["pm"]
    f = np.zeros_like(mesh["nodes"], dtype=np.float32)
    f[:, 1] = GRAVITY
    jstep = jax.jit(lambda st: jinteg.timestep(jm, st, jnp.asarray(f)))
    jst, pst = jinteg.FemState.rest(jm), pinteg.FemState.rest(pm)
    assert pst.dv is not None and float(pst.q.abs().max()) == 0.0
    for step in range(5):
        jst, j_it = jstep(jst)
        stats = {}
        pst, p_it = pinteg.timestep(pm, pst, torch.tensor(f),
                                    solve_stats=stats)
        assert abs(int(j_it) - p_it) <= 2, (step, int(j_it), p_it)
        assert stats["forward_iters"] == p_it > 50
        assert_fem_state_close(np.asarray(jst.q), np.asarray(jst.qvel),
                               pst.q.numpy(), pst.qvel.numpy())
        dv = np.asarray(jst.dv)
        assert np.abs(dv - pst.dv.numpy()).max() <= 1e-4 * max(
            np.abs(dv).max(), np.abs(np.asarray(jst.q)).max() / 0.0333)
    assert float(pst.q[pm.fixed].abs().max()) == 0.0
    assert float(pst.q[:, 1].min()) < -1e-3


def test_differentiable_timestep_gradient_to_ke_scale(mesh):
    """d sum(w * q) / d (ke scale) through the adjoint solve: against the
    JAX package's custom_linear_solve (rtol 1e-3) and against central
    differences (rtol 2e-2); the count is reported as -1 as the reference
    reports it, the real counts go to solve_stats."""
    jm, pm = mesh["jm"], mesh["pm"]
    f = np.zeros_like(mesh["nodes"], dtype=np.float32)
    f[:, 1] = GRAVITY
    wgt = np.random.default_rng(4).normal(size=f.shape).astype(np.float32)
    u0 = _displacement(mesh, 5, 0.01)
    u0[mesh["fixed"]] = 0.0

    def jloss(s):
        st = jinteg.FemState(q=jnp.asarray(u0), qvel=jnp.zeros_like(u0),
                             dv=None)
        new, it = jinteg.timestep(dataclasses.replace(jm, ke=jm.ke * s), st,
                                  jnp.asarray(f), differentiable=True)
        return jnp.sum(new.q * wgt)

    ref = float(jax.grad(jloss)(jnp.float32(1.0)))

    def ploss(s, stats=None):
        st = pinteg.FemState(q=torch.tensor(u0),
                             qvel=torch.zeros(u0.shape), dv=None)
        new, it = pinteg.timestep(dataclasses.replace(pm, ke=pm.ke * s), st,
                                  torch.tensor(f), differentiable=True,
                                  solve_stats=stats)
        assert it == -1
        return torch.sum(new.q * torch.tensor(wgt))

    s = torch.tensor(1.0, requires_grad=True)
    stats = {}
    ploss(s, stats).backward()
    g = float(s.grad)
    assert stats["forward_iters"] > 50 and stats["adjoint_iters"] > 50
    assert abs(ref) > 1e-4
    assert abs(g - ref) <= 1e-3 * abs(ref), (g, ref)
    eps = 0.05
    with torch.no_grad():
        fd = float(ploss(torch.tensor(1.0 + eps))
                   - ploss(torch.tensor(1.0 - eps))) / (2 * eps)
    assert abs(g - fd) <= 2e-2 * abs(fd), (g, fd)


def test_deformable_with_ground_haptics_and_reset(mesh):
    """Deformable against the JAX package's: three steps under gravity
    with a ground plane and a haptic ring push; the ring forces and the
    adjacency are equal."""
    jm, pm = mesh["jm"], mesh["pm"]
    ground = float(mesh["nodes"][:, 1].min()) + 0.6
    kw = dict(gravity=GRAVITY, ground_y=ground)
    jbody = jdef.Deformable(jm, **kw)
    jbody._native_adj = None
    jbody.adjacency = jdef.node_adjacency(mesh["tets"], jm.n_nodes)
    pbody = pdef.Deformable(pm, **kw)
    assert pbody.stats() == {}
    for a, b in zip(jbody.adjacency, pbody.adjacency):
        np.testing.assert_array_equal(a, b)
    top = int(np.argmax(mesh["nodes"][:, 1]))
    idx, force = np.array([top, 3]), np.array([[0.0, -4000.0, 500.0],
                                               [100.0, 0.0, 0.0]])
    fj = jbody.haptic_forces(idx, force)
    fp = pbody.haptic_forces(idx, force)
    np.testing.assert_array_equal(fp, fj)
    assert (fp != 0).any(1).sum() > 20
    np.testing.assert_allclose(fp[top], force[0])
    for step in range(3):
        jst = jbody.timestep(fj)
        pst = pbody.timestep(fp)
        assert_fem_state_close(np.asarray(jst.q), np.asarray(jst.qvel),
                               pst.q.numpy(), pst.qvel.numpy())
        js_, ps_ = jbody.stats(), pbody.stats()
        assert abs(js_["cg_iters"] - ps_["cg_iters"]) <= 2
        assert js_["n_collided"] == ps_["n_collided"]
    assert ps_["n_collided"] > 0
    pos_y = pbody.positions[:, 1]
    assert float(pos_y.min()) >= ground - 1e-6
    pbody.reset()
    assert float(pbody.state.q.abs().max()) == 0.0
    assert torch.equal(pbody.positions, pm.rest)


def test_couple_surface_displacements_matches_jax(mesh):
    js, grid, jtm = mesh["js"], mesh["grid"], mesh["jtm"]
    caps = jpoly.default_caps(grid)
    jsurf = jpoly.polygonize(js, grid, *caps)
    psurf = convert.surface_mesh_from_numpy(convert.numpy_fields(jsurf),
                                            device="cpu")
    assert int(psurf.n_verts) == int(jsurf.n_verts)
    u = _displacement(mesh, 6)
    ref = np.asarray(jdef.couple_surface_displacements(
        jsurf.edge_nodes, jsurf.edge_t, jtm.grid_to_node, jnp.asarray(u)))
    got = pdef.couple_surface_displacements(
        psurf.edge_nodes, psurf.edge_t,
        torch.tensor(np.asarray(jtm.grid_to_node)), torch.tensor(u)).numpy()
    nv = int(jsurf.n_verts)
    np.testing.assert_allclose(got[:nv], ref[:nv], atol=1e-7)
    assert np.abs(got[:nv]).max() > 0.01
    # A vertex at t = 0 takes its first node's displacement.
    g2n = np.asarray(jtm.grid_to_node)
    en = np.asarray(jsurf.edge_nodes)[:nv]
    t = np.asarray(jsurf.edge_t)[:nv, None]
    np.testing.assert_allclose(
        got[:nv], (1 - t) * u[g2n[en[:, 0]]] + t * u[g2n[en[:, 1]]],
        atol=1e-6)
