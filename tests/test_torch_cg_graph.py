"""PyTorch port, the grid solve's graphed PCG (fem.grid_fem.GraphedCg):
its prologue and iteration bodies, run eagerly on the CPU, give
`integrator.pcg`'s solution and iteration count bit for bit, warm and
cold, with either preconditioner; the E-gradient through
`symmetric_solve` is the same through either solver; the graphs' cache
key survives a frame's stiffness scale and a new rest state and changes
with what the graphs bake in; and on the CPU `grid_fem.timestep` keeps
the eager loop. The brain at cellsize 0.35 (855 nodes); the port alone,
no JAX.

The card test (marked `cuda`, skips without a card) holds the captured
graphs to the eager loop on the card, on the brain at the benchmark's
cellsize 0.14 (8,308 nodes):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cg_graph.py
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.fem import grid_fem as gfm
from fembrain_tpu_torch.fem import integrator as integ
from fembrain_tpu_torch.mesh.polygonize import (
    extract_tet_mesh, grid_for_scene,
)
from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component

BRAIN = (Path(__file__).resolve().parent.parent
         / "data/models/blobtree/brain.blob")
H = integ.DEFAULT_TIMESTEP
DM, DS = integ.DEFAULT_DAMPING_MASS, integ.DEFAULT_DAMPING_STIFFNESS
MC, SC = 1.0 + H * DM, H * DS + H * H


def brain_fem(cellsize, device):
    """(gf, f_ext): the brain's grid FEM, its bottom quarter anchored,
    under gravity of -500 times the nodal mass."""
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    scene = sc.pack(device=device)
    grid = grid_for_scene(scene, cellsize=cellsize)
    tm = extract_tet_mesh(scene, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    nodes = tm.nodes[: tm.n_nodes].cpu().numpy()
    tets = tm.tets[: tm.n_tets].cpu().numpy()
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    gf = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed,
                                   device=device)
    f_ext = torch.zeros((*gf.dims, 3), device=device)
    f_ext[..., 1] = -500.0 * gf.mass
    return gf, f_ext


@pytest.fixture(scope="module")
def brain():
    gf, f_ext = brain_fem(0.35, "cpu")
    st = gf.rest_state()
    for _ in range(2):            # a sagging state: R is no identity
        st, _ = gfm.timestep(gf, st, f_ext, cg_tol=1e-2)
    return gf, f_ext, st


def eager_solve(gf, st, f_ext, precond, tol, warm):
    """(x, iterations) of `pcg` on the step's operator, as the CPU's
    `timestep` solves it, and the solve's inputs."""
    R, b = gfm._forces(gf, st, f_ext, H, DM, DS)
    op = gfm._operator(gf, MC, SC)
    prec = gfm._preconditioner(gf, precond, MC, SC)
    x0 = torch.where(gf.free[..., None], st.dv, 0.0) if warm else None
    x, it = integ.pcg(lambda v: op(v, gf.ke, R), b, prec, tol, x0=x0)
    return x, it, (b, R, x0)


@pytest.mark.parametrize("precond", ["mg", "jacobi"])
@pytest.mark.parametrize("warm, tol", [(True, 1e-2), (False, 1e-6)],
                         ids=["warm-1e-2", "cold-1e-6"])
def test_graphed_bodies_give_pcg_bit_for_bit(brain, precond, warm, tol):
    """The prologue and the iteration, as the card captures them and here
    run eagerly, give pcg's x and iteration count bit for bit: the warm
    forward solve at the gravity frame's 1e-2 and the cold solve of the
    differentiable step at 1e-6."""
    gf, f_ext, st = brain
    x_ref, it_ref, (b, R, x0) = eager_solve(gf, st, f_ext, precond, tol,
                                            warm)
    cg = gfm.GraphedCg(gf, MC, SC, precond, b, warm)
    assert cg.graphs is None
    stats = {}
    for _ in range(2):            # a second solve starts from fresh statics
        x, it = cg.solve(b, gf.ke, R, x0, tol, integ.CG_MAX_ITERS, stats)
        assert it == it_ref > 0
        assert torch.equal(x, x_ref)
    assert x.data_ptr() != cg.x.data_ptr()
    assert stats == {}            # no graph was replayed


def test_graphed_solve_stops_at_max_iters(brain):
    """The iteration cap holds as in pcg."""
    gf, f_ext, st = brain
    R, b = gfm._forces(gf, st, f_ext, H, DM, DS)
    op = gfm._operator(gf, MC, SC)
    prec = gfm._preconditioner(gf, "mg", MC, SC)
    x_ref, it_ref = integ.pcg(lambda v: op(v, gf.ke, R), b, prec, 1e-6, 3)
    cg = gfm.GraphedCg(gf, MC, SC, "mg", b, False)
    x, it = cg.solve(b, gf.ke, R, None, 1e-6, 3)
    assert it == it_ref == 3 and torch.equal(x, x_ref)


def test_e_gradient_through_the_graphed_solve(brain):
    """d(loss)/dE through `symmetric_solve` is the same, bit for bit,
    with the graphed bodies as forward and adjoint solver as with pcg,
    and pcg's is what the CPU's differentiable `timestep` gives."""
    gf, f_ext, _ = brain
    rest = gf.rest_state()
    w = torch.as_tensor(np.random.default_rng(5).random((*gf.dims, 3)),
                        dtype=torch.float32)

    def grad(solver):
        scale = torch.tensor(1.0, requires_grad=True)
        g2 = dataclasses.replace(gf, ke=gf.ke * scale)
        stats = {}
        if solver == "timestep":
            st, it = gfm.timestep(g2, rest, f_ext, differentiable=True,
                                  solve_stats=stats)
            assert it == -1
        else:
            R, b = gfm._forces(g2, rest, f_ext, H, DM, DS)
            prec = gfm._preconditioner(g2, "mg", MC, SC)
            if solver == "pcg":
                def solve(mv, rhs):
                    return integ.pcg(mv, rhs, prec, integ.CG_TOL)
            else:
                # The adjoint's right side is laid out otherwise than
                # the forward's: each solve takes its own statics.
                def solve(mv, rhs):
                    cg = gfm.GraphedCg(g2, MC, SC, "mg", rhs, False)
                    return cg.solve(rhs, g2.ke, R, None, integ.CG_TOL,
                                    integ.CG_MAX_ITERS)
            dv = integ.symmetric_solve(gfm._operator(g2, MC, SC), b,
                                       (g2.ke, R), solve, stats)
            st = gfm._advance(g2, rest, dv, H)
        torch.sum(w * st.q).backward()
        assert stats["forward_iters"] > 0 and stats["adjoint_iters"] > 0
        return scale.grad, stats

    g_step, s_step = grad("timestep")
    g_pcg, s_pcg = grad("pcg")
    g_graph, s_graph = grad("graphed")
    assert torch.equal(g_pcg, g_step) and torch.equal(g_graph, g_pcg)
    assert g_graph != 0
    for key in ("forward_iters", "adjoint_iters"):
        assert s_step[key] == s_pcg[key] == s_graph[key]
    assert s_step["graphed_iters"] == 0


def test_cache_key(brain):
    """The key is equal across a frame's `replace(gf, ke=gf.ke * s)` and
    across a new rest state (a warm start, a channel-major right side),
    and differs for other coefficients, another preconditioner, a cold
    start, another layout of the right side and another mesh's levels."""
    gf, f_ext, st = brain
    _, b = gfm._forces(gf, st, f_ext, H, DM, DS)
    key = gfm.cg_graph_key(gf, MC, SC, "mg", b, True)
    scaled = dataclasses.replace(gf, ke=gf.ke * 1.3)
    assert gfm.cg_graph_key(scaled, MC, SC, "mg", b, True) == key
    rest = gf.rest_state()
    _, b_rest = gfm._forces(scaled, rest, f_ext, H, DM, DS)
    assert gfm.cg_graph_key(scaled, MC, SC, "mg", b_rest,
                            rest.dv is not None) == key
    others = [
        gfm.cg_graph_key(gf, MC, 2.0 * SC, "mg", b, True),
        gfm.cg_graph_key(gf, 1.5, SC, "mg", b, True),
        gfm.cg_graph_key(gf, MC, SC, "jacobi", b, True),
        gfm.cg_graph_key(gf, MC, SC, "mg", b, False),
        gfm.cg_graph_key(gf, MC, SC, "mg", b.contiguous(), True),
        gfm.cg_graph_key(dataclasses.replace(gf, levels=gf.levels[:2]),
                         MC, SC, "mg", b, True),
        gfm.cg_graph_key(dataclasses.replace(gf, levels=()), MC, SC, "mg",
                         b, True),
    ]
    assert len({key, *others}) == 1 + len(others)
    # Every preconditioner kind other than the V-cycle is block-Jacobi.
    assert (gfm.cg_graph_key(gf, MC, SC, "jacobi", b, True)
            == gfm.cg_graph_key(gf, MC, SC, "block", b, True))


def test_graphed_cg_cache_reuses_and_stays_bounded(brain):
    """`graphed_cg` hands a frame with scaled stiffness the solve of the
    frame before, and keeps at most its cache's size."""
    gf, f_ext, st = brain
    _, b = gfm._forces(gf, st, f_ext, H, DM, DS)
    first = gfm.graphed_cg(gf, MC, SC, "mg", b, True)
    scaled = dataclasses.replace(gf, ke=gf.ke * 0.7)
    assert gfm.graphed_cg(scaled, MC, SC, "mg", b.clone(), True) is first
    for k in range(gfm._CG_CACHE_SIZE + 2):
        gfm.graphed_cg(gf, MC, SC * (2.0 + k), "mg", b, True)
    assert len(gfm._CG_CACHE) == gfm._CG_CACHE_SIZE
    assert first not in gfm._CG_CACHE.values()


def test_cpu_timestep_keeps_the_eager_loop(brain):
    """On the CPU `timestep` runs pcg's eager loop: no solve is looked up
    or captured, no graph replayed, and `graphed_iters` is 0."""
    gf, f_ext, st = brain
    before = dict(gfm.CG_GRAPH)
    n_cached = len(gfm._CG_CACHE)
    stats = {}
    _, it = gfm.timestep(gf, st, f_ext, cg_tol=1e-2, solve_stats=stats)
    assert stats == {"graphed_iters": 0, "forward_iters": it} and it > 0
    assert gfm.CG_GRAPH == before and len(gfm._CG_CACHE) == n_cached


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
def test_graphed_solve_matches_the_eager_loop_on_the_card(cuda):
    """Two 6-frame gravity episodes from rest at cg_tol 1e-2, each frame
    built as the coupled frame builds it (`replace(gf, ke=gf.ke * 1.0)`):
    the graphed `timestep` against pcg's eager loop on the card from the
    same state, with the same operator and preconditioner: equal
    iteration counts, dv equal to 1e-6 relative (expected: 0), one
    capture and a replay a graphed iteration. Then the E-gradient of a
    differentiable step through the graphed forward and adjoint solves
    against the eager one, to 1e-5 relative."""
    gf, f_ext = brain_fem(0.14, cuda)
    gfm.reset_cg_graph_counts()
    total, worst = 0, 0.0
    for _ in range(2):
        st = gf.rest_state()
        for _ in range(6):
            g2 = dataclasses.replace(gf, ke=gf.ke * 1.0)
            x_ref, it_ref, _ = eager_solve(g2, st, f_ext, "mg", 1e-2, True)
            stats = {}
            st, it = gfm.timestep(g2, st, f_ext, cg_tol=1e-2,
                                  solve_stats=stats)
            assert it == it_ref > 0
            assert stats["graphed_iters"] == it
            worst = max(worst, rel(st.dv, x_ref))
            total += it
    torch.cuda.synchronize()
    assert worst <= 1e-6, worst
    assert gfm.CG_GRAPH == {"captures": 1, "replays": total}

    gfm.reset_cg_graph_counts()
    rest = gf.rest_state()
    w = torch.as_tensor(np.random.default_rng(5).random((*gf.dims, 3)),
                        dtype=torch.float32, device=cuda)

    def grad(graphed):
        scale = torch.tensor(1.0, requires_grad=True, device=cuda)
        g2 = dataclasses.replace(gf, ke=gf.ke * scale)
        stats = {}
        if graphed:
            st, _ = gfm.timestep(g2, rest, f_ext, differentiable=True,
                                 solve_stats=stats)
        else:
            R, b = gfm._forces(g2, rest, f_ext, H, DM, DS)
            prec = gfm._preconditioner(g2, "mg", MC, SC)
            dv = integ.symmetric_solve(
                gfm._operator(g2, MC, SC), b, (g2.ke, R),
                lambda mv, rhs: integ.pcg(mv, rhs, prec, integ.CG_TOL),
                stats)
            st = gfm._advance(g2, rest, dv, H)
        torch.sum(w * st.q).backward()
        return scale.grad, stats

    g_eager, s_eager = grad(False)
    g_graph, s_graph = grad(True)
    n = s_graph["forward_iters"] + s_graph["adjoint_iters"]
    assert s_graph["graphed_iters"] == n > 0
    assert abs(s_graph["forward_iters"] - s_eager["forward_iters"]) <= 1
    assert abs(s_graph["adjoint_iters"] - s_eager["adjoint_iters"]) <= 1
    # The forward's right side is channel-major, the adjoint's (this
    # loss's gradient) row-major: a key each, captured once.
    assert gfm.CG_GRAPH == {"captures": 2, "replays": n}
    g_again, _ = grad(True)
    assert gfm.CG_GRAPH == {"captures": 2, "replays": 2 * n}
    assert torch.equal(g_again, g_graph)
    assert abs(float(g_graph - g_eager)) <= 1e-5 * abs(float(g_eager)), (
        float(g_graph), float(g_eager))
