"""PyTorch port, the X-slab grid FEM (fem.grid_sharded) at two and four
gloo ranks on the CPU, on brain's tet mesh at cellsize 0.35 (855 nodes,
an 11 x 9 x 12 vertex grid): its three preconditioners against the JAX
package's sharded step on the 8-device CPU mesh, the layout round trip,
a 3-step warm-started trajectory against the port's single-device
grid_fem.timestep, and the collectives of a CG iteration counted per
preconditioner (the pattern tests/test_comm_volume.py pins in the JAX
package's compiled HLO).

Each group of ranks starts once (`ranks` fixture, in the background while
the JAX reference compiles here) and runs every rank-side check of this
file; the rank processes import this module to find `_rank_checks`, so
JAX is imported only where the reference runs."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.fem import grid_fem as pgfm
from fembrain_tpu_torch.fem import grid_sharded as pgs
from fembrain_tpu_torch.mesh.polygonize import GridSpec
from fembrain_tpu_torch.parallel import sharding as sh

from test_torch_fixtures import BRAIN

PRECONDS = ("hybrid", "global_mg", "schwarz")
STEPS = 3


@pytest.fixture(scope="module")
def brain():
    """Brain's tet mesh from the JAX package (numpy), its bottom quarter
    anchored, and the gravity load -300 * mass of the JAX tests."""
    from fembrain_tpu.blob.reader import load_blob
    from fembrain_tpu.fem import grid_fem as jgfm
    from fembrain_tpu.mesh.polygonize import extract_tet_mesh, grid_for_scene
    from fembrain_tpu.mesh.samples import bottom_nodes_per_component

    sc = load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    grid = grid_for_scene(js, cellsize=0.35)
    jtm = extract_tet_mesh(js, grid, ncap=grid.n_vertices,
                           tetcap=grid.n_cells * 6)
    nodes = np.asarray(jtm.nodes)[: int(jtm.n_nodes)]
    tets = np.asarray(jtm.tets)[: int(jtm.n_tets)]
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    jgf = jgfm.grid_fem_from_tetmesh(grid, jtm, fixed_nodes=fixed)
    n2g = jgfm.node_to_grid_index(jtm)
    f = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f[n2g, 1] = -300.0 * np.asarray(jgf.mass).reshape(-1)[n2g]
    return dict(grid=(tuple(grid.lo), tuple(grid.dims), grid.cellsize),
                tm=convert.numpy_fields(jtm), fixed=fixed,
                f=f.reshape(*grid.dims, 3), jgrid=grid, jtm=jtm)


def _port_mesh(b, dev):
    return GridSpec(*b["grid"]), convert.tet_mesh(b["tm"], device=dev)


def _rank_checks(dev, b, n_parts):
    """One rank's slab: a step from rest under each preconditioner, with
    the collectives of each step, and at four ranks a warm-started hybrid
    trajectory."""
    grid, tm = _port_mesh(b, dev)
    sgf = pgs.build_sharded_grid_fem(grid, tm, n_parts,
                                     fixed_nodes=b["fixed"], device=dev)
    mesh = pgs.make_grid_mesh()
    fs = pgs.to_shard_layout(sgf, torch.tensor(b["f"], device=dev))
    fs = fs[sgf.part]
    out = dict(part=sgf.part, xl=sgf.xl,
               lvl1=tuple(sgf.gfull.levels[1].dims))
    for p in PRECONDS:
        q, v, dv = sgf.rest_state()
        sh.reset_counts()
        q, _, _, it = pgs.sharded_timestep(sgf, mesh, q, v, fs, dv=dv,
                                           precond=p)
        out[p] = dict(q=q.cpu(), iters=it, counts=dict(sh.COUNTS))
    q, v, dv = sgf.rest_state()
    traj = []
    for _ in range(STEPS if n_parts == 4 else 0):
        q, v, dv, it = pgs.sharded_timestep(sgf, mesh, q, v, fs, dv=dv)
        traj.append((q.cpu(), it))
    out["traj"] = traj
    return out


@pytest.fixture(scope="module")
def ranks(brain):
    """{D: the ranks' results} for D = 2 and 4, both groups launched at
    once; a test reads them with .result()."""
    with ThreadPoolExecutor(2) as pool:
        yield {d: pool.submit(sh.launch, _rank_checks, d, brain, d,
                              device="cpu") for d in (2, 4)}


def _global(ranks, d, key):
    """The ranks' blocks stacked [D, Xl, Y, Z, 3] and their global view."""
    rs = ranks[d].result()
    assert [r["part"] for r in rs] == list(range(d))
    blocks = np.stack([r[key]["q"].numpy() for r in rs])
    xl = rs[0]["xl"]
    return blocks, blocks.reshape(d * xl, *blocks.shape[2:])


def _jax_step(brain, d, precond):
    import jax
    import jax.numpy as jnp

    from fembrain_tpu.fem import grid_sharded as jgs

    sgf = jgs.build_sharded_grid_fem(brain["jgrid"], brain["jtm"], d,
                                     fixed_nodes=brain["fixed"])
    mesh = jgs.make_grid_mesh(d)
    q, v, dv = sgf.rest_state()
    fs = jgs.to_shard_layout(sgf, jnp.asarray(brain["f"]))
    q2, _, _, it = jax.jit(lambda q, v, dv: jgs.sharded_timestep(
        sgf, mesh, q, v, fs, dv=dv, precond=precond))(q, v, dv)
    return np.asarray(q2), int(it)


@pytest.fixture(scope="module")
def single(brain):
    """The port's single-device grid_fem.timestep trajectory: (q, CG
    iterations) of STEPS warm-started steps from rest."""
    grid, tm = _port_mesh(brain, "cpu")
    gf = pgfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=brain["fixed"],
                                    device="cpu")
    st = gf.rest_state()
    out = []
    for _ in range(STEPS):
        st, it = pgfm.timestep(gf, st, torch.tensor(brain["f"]))
        out.append((st.q.numpy(), it))
    return out


@pytest.mark.parametrize("d,precond", [(2, "hybrid"), (4, "schwarz")])
def test_preconditioner_matches_jax_sharded_step(brain, ranks, d, precond):
    """The stacked slabs equal the JAX package's [D, Xl, Y, Z, 3] after one
    step from rest, with its CG count within one iteration."""
    jq, jit = _jax_step(brain, d, precond)
    blocks, _ = _global(ranks, d, precond)
    scale = np.abs(jq).max()
    assert scale > 0
    assert np.abs(blocks - jq).max() / scale < 1e-4
    it = ranks[d].result()[0][precond]["iters"]
    assert abs(it - jit) <= 1, (it, jit)


@pytest.mark.parametrize("d", [2, 4])
def test_all_preconditioners_solve_the_single_device_step(single, ranks, d):
    """All three preconditioners reach the single-device solution; hybrid
    and global_mg take the single-device V-cycle's count (within two),
    the communication-free Schwarz cycles more; every rank agrees on the
    count."""
    q_ref, it_ref = single[0]
    X = q_ref.shape[0]
    scale = np.abs(q_ref).max()
    for p in PRECONDS:
        _, flat = _global(ranks, d, p)
        assert np.abs(flat[:X] - q_ref).max() / scale < 1e-4, p
        assert not flat[X:].any()
        assert len({r[p]["iters"] for r in ranks[d].result()}) == 1
    its = {p: ranks[d].result()[0][p]["iters"] for p in PRECONDS}
    assert abs(its["global_mg"] - it_ref) <= 2, (its, it_ref)
    assert its["hybrid"] <= its["global_mg"] + 2, its
    assert its["schwarz"] > its["hybrid"], its


def test_trajectory_matches_single_device(single, ranks):
    """Three warm-started hybrid steps over four slabs track
    grid_fem.timestep: max |dq| / max |q| < 1e-4 and CG counts within 5
    (tests/test_grid_sharded.py)."""
    rs = ranks[4].result()
    xl = rs[0]["xl"]
    for i, (q_ref, it_ref) in enumerate(single):
        blocks = np.stack([r["traj"][i][0].numpy() for r in rs])
        flat = blocks.reshape(4 * xl, *blocks.shape[2:])[: q_ref.shape[0]]
        scale = np.abs(q_ref).max()
        assert scale > 0
        assert np.abs(flat - q_ref).max() / scale < 1e-4, i
        assert abs(rs[0]["traj"][i][1] - it_ref) <= 5


def test_layout_round_trip(brain):
    grid, tm = _port_mesh(brain, "cpu")
    for d in (2, 4, 8):
        sgf = pgs.build_sharded_grid_fem(grid, tm, d,
                                         fixed_nodes=brain["fixed"],
                                         part=d - 1, device="cpu")
        f = torch.tensor(brain["f"])
        lay = pgs.to_shard_layout(sgf, f)
        assert lay.shape[:2] == (d, sgf.xl) and sgf.xl % 2 == 0
        assert torch.equal(pgs.from_shard_layout(sgf, lay), f)


# Collectives of one CG iteration by preconditioner: the matvec's halo
# exchange and return (2 one-plane shifts) and the two dots; hybrid adds
# two level-0 operator applies (4 shifts), the restriction's left plane
# (1 shift) and the level-1 gather; global_mg the fine gather; schwarz
# nothing. Set-up: the step's 4 shifts, the warm start's matvec (2), the
# preconditioner twice (the threshold's and the first z), two dots.
PER_ITER = {"hybrid": (7, 1, 2), "global_mg": (2, 1, 2),
            "schwarz": (2, 0, 2)}
SETUP = {"hybrid": (16, 2, 2), "global_mg": (6, 2, 2),
         "schwarz": (6, 0, 2)}


@pytest.mark.parametrize("d", [2, 4])
def test_collectives_per_cg_iteration(brain, ranks, d):
    """Calls and sizes: every shift moves one vertex plane, every dot one
    float; hybrid's gather moves the restricted (level-1) residual of a
    slab, global_mg's the whole fine slab (about 8 times as much)."""
    _, (X, Y, Z), _ = brain["grid"]
    plane = Y * Z * 3 * 4
    rs = ranks[d].result()
    xl = rs[0]["xl"]
    _, yc, zc = rs[0]["lvl1"]
    for r in rs:
        for p in PRECONDS:
            c, it = r[p]["counts"], r[p]["iters"]
            want = [s + it * n for s, n in zip(SETUP[p], PER_ITER[p])]
            assert [c["shift"], c["all_gather"], c["all_reduce"]] == want, (
                p, c, it)
            assert c["shift_bytes"] == c["shift"] * plane
            assert c["all_reduce_bytes"] == c["all_reduce"] * 4
            gathered = {"hybrid": 3 * (xl // 2) * yc * zc * 4,
                        "global_mg": xl * Y * Z * 3 * 4, "schwarz": 0}[p]
            assert c["all_gather_bytes"] == c["all_gather"] * gathered
            assert c["staged_bytes"] == 0
