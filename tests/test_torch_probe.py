"""PyTorch port, the probe deployment on the unstructured FEM against the
benchmark's plain reference (benchmark/reference/, which imports nothing
of the port), on brain at cellsize 0.35 (855 nodes) on the CPU:

* `integrator.timestep` (corotational, block-Jacobi PCG) against the
  reference's float64 step, in A's energy norm, below the `cg_tol` the
  port ran with;
* `Deformable.probe_forces` against the reference probe and rings over a
  scripted push and slide: the same contacts, the same sticky face, the
  same load to float32's rounding;
* the host core's ring forces against the reference's breadth-first
  rings, and the fault that drops the outermost ring caught by the
  cell's limit;
* the probe stage's counters and spans;
* the polar factor of the nearly flat tetrahedra a deep push makes."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fembrain_tpu_torch import femcore
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.fem import corotational as co
from fembrain_tpu_torch.fem import integrator as integ
from fembrain_tpu_torch.fem.avatars import AvatarProbe
from fembrain_tpu_torch.fem.deformable import Deformable
from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
from fembrain_tpu_torch.mesh.polygonize import extract_tet_mesh, grid_for_scene
from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmark"))

from reference import probe as rprobe  # noqa: E402
from reference.field import Precision  # noqa: E402
from reference.tetfem import TetStep, judge_step  # noqa: E402

BRAIN = REPO / "data/models/blobtree/brain.blob"
CONFIG = json.loads((REPO / "benchmark/configs/brain-sim.json").read_text())
LIMITS = json.loads(
    (REPO / "benchmark/checks/brain-sim.probe.json").read_text())
COEFF, RADIUS = CONFIG["force_coeff"], CONFIG["haptic_radius"]


@pytest.fixture(scope="module")
def brain():
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    scene = sc.pack(device="cpu")
    grid = grid_for_scene(scene, cellsize=0.35)
    tm = extract_tet_mesh(scene, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    nodes = tm.nodes[: tm.n_nodes].numpy()
    tets = tm.tets[: tm.n_tets].numpy()
    fixed = np.zeros(len(nodes), bool)
    fixed[bottom_nodes_per_component(nodes, tets, frac=0.25)] = True
    return nodes, tets, fixed


def ref_step(brain):
    nodes, tets, fixed = brain
    c = CONFIG
    return TetStep(nodes, tets, fixed, c["E"], c["nu"], c["rho"], c["h"],
                   c["damping_mass"], c["damping_stiffness"], "cpu",
                   Precision(dtype=torch.float64))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-6),
                                       (torch.float64, 1e-4),
                                       (torch.float32, 1e-2)])
def test_unstructured_step_matches_reference(brain, dtype, tol):
    """Three warm-started steps under a ring-spread push at the top: each
    step's solve stands from the reference's by less than the tol the
    port's PCG ran with, in A's energy norm over |dv*|_A, and its update
    follows the rule (float32's rounding floors the energy error near
    5e-4 at this size, so it runs at 1e-2)."""
    nodes, tets, fixed = brain
    mesh = build_fem_mesh(nodes, tets, fixed=fixed, device="cpu",
                          dtype=dtype)
    body = Deformable(mesh, gravity=0.0)
    top = int(np.argmax(np.where(fixed, -np.inf, nodes[:, 1])))
    f = torch.as_tensor(body.haptic_forces(np.array([top]),
                                           np.array([[0.0, -2000.0, 0.0]])),
                        dtype=dtype)
    step = ref_step(brain)
    st = integ.FemState.rest(mesh)
    for _ in range(3):
        st2, iters = integ.timestep(mesh, st, f, cg_tol=tol)
        r = judge_step(step, *(x.double() for x in (st.q, st.qvel, st2.q,
                                                    st2.qvel, f)))
        assert iters > 0
        assert r["fem_energy_err"] < tol, r
        assert r["fem_update_err"] < 1e-6, r
        st = st2


def test_probe_forces_match_reference(brain):
    """A box pushed 0.06 a frame onto the top of the tissue, then slid
    along x: the port's contacts and contact face are the reference's,
    its load the reference's to 1e-6 of the largest force, frame by
    frame, the tissue stepping under the load in between."""
    nodes, tets, fixed = brain
    mesh = build_fem_mesh(nodes, tets, fixed=fixed, device="cpu")
    body = Deformable(mesh, gravity=0.0)
    free_top = np.where(fixed, -np.inf, nodes[:, 1])
    site = nodes[int(np.argmax(free_top))].astype(np.float64)
    half = CONFIG["probe_half_extent"]
    start = site + [0.0, 0.05 + half, 0.0]
    path = [start - [0.0, 0.06 * k, 0.0] for k in range(1, 6)]
    path += [path[-1] + [0.06 * k, 0.0, 0.0] for k in range(1, 6)]
    probe = AvatarProbe(half_extents=np.full(3, half), force_coeff=COEFF,
                        pos=start)
    ref = rprobe.Probe(np.full(3, half), COEFF)
    graph = rprobe.node_graph(tets, len(nodes))
    touched = 0
    for centre in path:
        positions = (mesh.rest + body.state.q).double().numpy()
        stats = {}
        f = body.probe_forces(probe, centre, stats)
        ids, fc = ref.move(centre, positions)
        f_ref = rprobe.ring_forces(graph, ids, fc, RADIUS)
        assert probe.contact_nodes.tolist() == ids.tolist()
        assert probe.contact_face == ref.face
        assert f.dtype == mesh.rest.dtype and f.shape == mesh.rest.shape
        scale = max(float(np.abs(f_ref).max()), 1e-30)
        assert float(np.abs(f.double().numpy() - f_ref).max()) <= (
            1e-6 * scale)
        assert stats["contacts"] == len(ids)
        assert stats["ring_nodes"] == int(np.any(f_ref != 0.0, 1).sum())
        assert stats["host_ms"] > 0.0
        touched = max(touched, len(ids))
        body.timestep(f)
    assert touched > 1 and probe.contact_face == 2


def test_femcore_rings_match_reference_bfs(brain):
    """The host core's ring forces are the reference's breadth-first rings
    with falloff 1 - ring / 5, for seeded contacts and forces."""
    nodes, tets, _ = brain
    rng = np.random.default_rng(15)
    idx = rng.choice(len(nodes), 40, replace=False)
    forces = rng.normal(size=(40, 3)) * COEFF
    core = femcore.NativeAdjacency(tets, len(nodes))
    got = core.ring_forces(idx, forces, RADIUS)
    want = rprobe.ring_forces(rprobe.node_graph(tets, len(nodes)), idx,
                              forces, RADIUS)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_dropped_outer_ring_fails_the_cell_limit(brain):
    """The load without its outermost ring departs from the reference's by
    a fifth of a contact's force: far beyond `probe_force_gap`'s limit."""
    nodes, tets, _ = brain
    graph = rprobe.node_graph(tets, len(nodes))
    idx = np.array([int(np.argmax(nodes[:, 1]))])
    force = np.array([[0.0, -COEFF * 0.1, 0.0]])
    full = rprobe.ring_forces(graph, idx, force, RADIUS)
    drop = rprobe.ring_forces(graph, idx, force, RADIUS, rings=RADIUS - 1)
    gap = np.abs(drop - full).max() / np.abs(full).max()
    assert gap == pytest.approx(1.0 / RADIUS)
    assert gap > LIMITS["probe_force_gap"]


def test_probe_stage_spans(brain):
    """Under the profiler the probe stage opens `probe.contact` (the read
    of positions and the contact query) and `probe.rings` (the ring
    forces and the copy back), once each a call."""
    nodes, tets, fixed = brain
    mesh = build_fem_mesh(nodes, tets, fixed=fixed, device="cpu")
    body = Deformable(mesh, gravity=0.0)
    top = nodes[int(np.argmax(nodes[:, 1]))].astype(np.float64)
    probe = AvatarProbe(half_extents=np.full(3, 0.2), force_coeff=COEFF)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body.probe_forces(probe, top)
        body.probe_forces(probe, top - [0.0, 0.05, 0.0])
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("probe.contact") == 2
    assert names.count("probe.rings") == 2


@pytest.mark.parametrize("smallest", [1e-1, 1e-3, 1e-5, 1e-6])
def test_polar_rotation_of_nearly_flat_tets(smallest):
    """Deformation gradients with one singular value down to 1e-6 of the
    others, some reflected (a push that flattens or turns a tetrahedron
    over, as the probe traffic does): the float32 polar factor is the
    SVD's, sign-fixed, to 1e-5."""
    rng = np.random.default_rng(7)
    U = np.linalg.qr(rng.normal(size=(500, 3, 3)))[0]
    V = np.linalg.qr(rng.normal(size=(500, 3, 3)))[0]
    S = np.stack([rng.uniform(0.5, 3.0, 500), rng.uniform(0.1, 2.0, 500),
                  np.full(500, smallest)], 1)
    F = torch.tensor((U * S[:, None, :]) @ V.transpose(0, 2, 1))
    W, _, Vh = torch.linalg.svd(F)
    want = (W @ Vh) * torch.where(torch.linalg.det(F) < 0, -1.0,
                                  1.0)[:, None, None]
    got = co.polar_rotation(F.float()).double()
    assert float((got - want).abs().max()) < 1e-5


def test_polar_rotation_of_padding_tets_is_zero():
    """A padding tetrahedron (all corners node 0, as the sharded and
    partitioned meshes pad) has F = 0: its factor stays zero, as the
    unscaled iteration left it, and nothing turns NaN."""
    F = torch.zeros((4, 3, 3))
    F[1] = torch.eye(3)
    R = co.polar_rotation(F)
    assert bool(torch.isfinite(R).all())
    assert torch.equal(R[0], torch.zeros(3, 3))
    assert torch.allclose(R[1], torch.eye(3))
