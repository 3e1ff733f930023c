"""PyTorch port, the unstructured step's graphed PCG
(fem.tet_cg_graph.GraphedTetCg): its prologue and iteration bodies, run
eagerly on the CPU, give `integrator.pcg`'s solution and iteration count
bit for bit on the step's own system, warm and cold; the graphed solve
stops at the iteration cap as pcg does; the cache key survives a frame's
stiffness scale and changes with what the graphs bake in; and on the CPU
`integrator.timestep` keeps the eager loop. The brain at cellsize 0.35
(855 nodes) under a push at its top; the port alone, no JAX.

The card test (marked `cuda`, skips without a card) holds the captured
graphs to the eager loop on the card, on the brain at the benchmark's
cellsize 0.14 (8,308 nodes):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tet_cg_graph.py
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.fem import grid_fem as gfm
from fembrain_tpu_torch.fem import integrator as integ
from fembrain_tpu_torch.fem import tet_cg_graph as tcg
from fembrain_tpu_torch.fem.deformable import Deformable
from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
from fembrain_tpu_torch.mesh.polygonize import extract_tet_mesh, grid_for_scene
from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component

BRAIN = (Path(__file__).resolve().parent.parent
         / "data/models/blobtree/brain.blob")
H = integ.DEFAULT_TIMESTEP
DM, DS = integ.DEFAULT_DAMPING_MASS, integ.DEFAULT_DAMPING_STIFFNESS


def brain_mesh(cellsize, device):
    """(mesh, f): the brain's tet mesh, its bottom quarter anchored, and
    a push of 2,000 down at its highest free node spread over the
    haptic rings."""
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    scene = sc.pack(device=device)
    grid = grid_for_scene(scene, cellsize=cellsize)
    tm = extract_tet_mesh(scene, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    nodes = tm.nodes[: tm.n_nodes].cpu().numpy()
    tets = tm.tets[: tm.n_tets].cpu().numpy()
    fixed = np.zeros(len(nodes), bool)
    fixed[bottom_nodes_per_component(nodes, tets, frac=0.25)] = True
    mesh = build_fem_mesh(nodes, tets, fixed=fixed, device=device)
    body = Deformable(mesh, gravity=0.0)
    top = int(np.argmax(np.where(fixed, -np.inf, nodes[:, 1])))
    f = body.haptic_forces(np.array([top]), np.array([[0.0, -2000.0, 0.0]]))
    return mesh, torch.as_tensor(f, dtype=mesh.rest.dtype, device=device)


@pytest.fixture(scope="module")
def brain():
    mesh, f = brain_mesh(0.35, "cpu")
    st = integ.FemState.rest(mesh)
    for _ in range(2):            # a pushed state: R is no identity
        st, _ = integ.timestep(mesh, st, f, cg_tol=1e-4)
    return mesh, f, st


def step_system(mesh, st, f):
    """The step's system as `timestep` builds it: (long-index mesh,
    free, m, b, krot, inv_blocks, mass_coef, stiff_coef)."""
    lm = integ.with_long_indices(mesh)
    return (lm, *integ._system(lm, st, f, H, DM, DS))


def eager_solve(mesh, st, f, tol, warm, max_iters=integ.CG_MAX_ITERS):
    """(x, iterations) of `pcg` on the step's operator, as the CPU's
    `timestep` solves it, and the solve's inputs."""
    lm, free, m, b, krot, inv_blocks, mc, sc = step_system(mesh, st, f)
    op = integ._operator(lm, free, mc, sc)
    x0 = torch.where(free, st.dv, 0.0) if warm else None
    x, it = integ.pcg(lambda v: op(v, krot, m), b,
                      integ._block_jacobi(inv_blocks), tol, max_iters,
                      x0=x0)
    return x, it, (b, krot, inv_blocks, x0, mc, sc)


@pytest.mark.parametrize("warm, tol", [(True, 1e-6), (False, 1e-6),
                                       (True, 1e-2)],
                         ids=["warm-1e-6", "cold-1e-6", "warm-1e-2"])
def test_graphed_bodies_give_pcg_bit_for_bit(brain, warm, tol):
    """The graphed solve's bodies, run eagerly, on the step's own
    system: pcg's solution bit for bit and its iteration count, and no
    graph where there is no card."""
    mesh, f, st = brain
    x_ref, it_ref, (b, krot, inv_blocks, x0, mc, sc) = eager_solve(
        mesh, st, f, tol, warm)
    cg = tcg.GraphedTetCg(mesh, mc, sc, b, krot, inv_blocks, warm)
    assert cg.graphs is None
    stats = {}
    x, it = cg.solve(b, krot, inv_blocks, x0, tol, integ.CG_MAX_ITERS,
                     stats)
    assert it == it_ref > 0
    assert torch.equal(x, x_ref)
    assert "graphed_iters" not in stats
    # A second solve on the same buffers repeats the first.
    x2, it2 = cg.solve(b, krot, inv_blocks, x0, tol, integ.CG_MAX_ITERS)
    assert it2 == it and torch.equal(x2, x)


def test_graphed_solve_stops_at_max_iters(brain):
    """With a cap below what the tolerance needs, the graphed solve
    stops where pcg stops, at the same iterate."""
    mesh, f, st = brain
    x_ref, it_ref, (b, krot, inv_blocks, x0, mc, sc) = eager_solve(
        mesh, st, f, 1e-8, False, max_iters=7)
    cg = tcg.GraphedTetCg(mesh, mc, sc, b, krot, inv_blocks, False)
    x, it = cg.solve(b, krot, inv_blocks, x0, 1e-8, 7)
    assert it == it_ref == 7 and torch.equal(x, x_ref)


def test_tet_cg_key_and_cache(brain):
    """A frame that scales the stiffness (`replace(mesh, ke=...)`, as the
    coupled frame builds its mesh) and a new state keep the key and get
    the solve of the frame before; the coefficients, warm or cold, the
    anchors and the right side's layout change it; the cache keeps at
    most its size."""
    mesh, f, st = brain
    _, _, _, b, krot, inv_blocks, mc, sc = step_system(mesh, st, f)
    key = tcg.tet_cg_key(mesh, mc, sc, b, krot, inv_blocks, True)
    scaled = dataclasses.replace(mesh, ke=mesh.ke * 0.7)
    assert tcg.tet_cg_key(scaled, mc, sc, b.clone(), krot * 2.0,
                          inv_blocks, True) == key
    others = [
        tcg.tet_cg_key(mesh, mc, sc * 2.0, b, krot, inv_blocks, True),
        tcg.tet_cg_key(mesh, mc * 2.0, sc, b, krot, inv_blocks, True),
        tcg.tet_cg_key(mesh, mc, sc, b, krot, inv_blocks, False),
        tcg.tet_cg_key(dataclasses.replace(mesh, fixed=mesh.fixed.clone()),
                       mc, sc, b, krot, inv_blocks, True),
        tcg.tet_cg_key(mesh, mc, sc, b.t().contiguous().t(), krot,
                       inv_blocks, True),
    ]
    assert len({key, *others}) == 1 + len(others)
    first = tcg.graphed_tet_cg(mesh, mc, sc, b, krot, inv_blocks, True)
    assert tcg.graphed_tet_cg(scaled, mc, sc, b.clone(), krot, inv_blocks,
                              True) is first
    for k in range(tcg._CACHE_SIZE + 2):
        tcg.graphed_tet_cg(mesh, mc, sc * (2.0 + k), b, krot, inv_blocks,
                           True)
    assert len(tcg._CACHE) == tcg._CACHE_SIZE
    assert first not in tcg._CACHE.values()


def test_cpu_timestep_keeps_the_eager_loop(brain):
    """On the CPU `timestep` runs pcg's eager loop: no solve is looked up
    or captured, no graph replayed, and no `graphed_iters` is reported;
    its step is the eager solve's."""
    mesh, f, st = brain
    before = dict(gfm.CG_GRAPH)
    n_cached = len(tcg._CACHE)
    x_ref, it_ref, _ = eager_solve(mesh, st, f, 1e-6, True)
    stats = {}
    st2, it = integ.timestep(mesh, st, f, solve_stats=stats)
    assert stats == {"forward_iters": it} and it == it_ref > 0
    assert torch.equal(st2.dv, x_ref)
    assert gfm.CG_GRAPH == before and len(tcg._CACHE) == n_cached


# ----------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(
        min=1e-30))


@pytest.mark.cuda
def test_graphed_tet_solve_matches_the_eager_loop_on_the_card(cuda):
    """Two 6-frame episodes from rest under the push at cg_tol 1e-6, each
    frame's mesh built as the coupled frame builds it
    (`replace(mesh, ke=mesh.ke * 1.0)`): the graphed `timestep` against
    pcg's eager loop on the card from the same state, on the same
    system: equal iteration counts, dv equal to 1e-6 relative (expected:
    0), one capture and a replay a graphed iteration."""
    mesh, f = brain_mesh(0.14, cuda)
    gfm.reset_cg_graph_counts()
    total, worst = 0, 0.0
    for _ in range(2):
        st = integ.FemState.rest(mesh)
        for _ in range(6):
            m2 = dataclasses.replace(mesh, ke=mesh.ke * 1.0)
            x_ref, it_ref, _ = eager_solve(m2, st, f, 1e-6, True)
            stats = {}
            st, it = integ.timestep(m2, st, f, solve_stats=stats)
            assert it == it_ref > 0
            assert stats["graphed_iters"] == it == stats["forward_iters"]
            worst = max(worst, rel(st.dv, x_ref))
            total += it
    torch.cuda.synchronize()
    assert worst <= 1e-6, worst
    assert gfm.CG_GRAPH == {"captures": 1, "replays": total}
