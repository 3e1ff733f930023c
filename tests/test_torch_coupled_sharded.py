"""PyTorch port, the coupled frame over ranks (render.coupled_sharded) at
two gloo ranks on the CPU, on brain at cellsize 0.35 (855 nodes) with 64
RBF centers and 1,920 rays: the grid-backed frame (X-slab grid FEM,
Wendland weights, K2's plain version on each rank's rays) and the
node-partitioned one (partitioned FEM, biharmonic weights, K4's plain
version), each against the JAX package's sharded frame on the 8-device
CPU mesh and against the port's single-device frame
(coupled_step_grid_fast, coupled_step_fast).

Both packages' interpolants are built from ONE node array (the JAX
package's tet mesh; the two meshes' nodes differ in the last bit, which
decides ties of the farthest-point center pick). The ranks start once
(`ranks` fixture, in the background while the JAX reference compiles
here); the rank processes import this module to find `_rank_checks`, so
JAX is imported only where the reference runs."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.fem import grid_fem as pgfm
from fembrain_tpu_torch.fem import grid_sharded as pgs
from fembrain_tpu_torch.fem import integrator as pinteg
from fembrain_tpu_torch.fem import partitioned as ppt
from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
from fembrain_tpu_torch.mesh.polygonize import GridSpec
from fembrain_tpu_torch.parallel import sharding as sh
from fembrain_tpu_torch.render import coupled_sharded as pcs
from fembrain_tpu_torch.render import deformed as pd

from test_torch_fixtures import BRAIN

D = 2
N_CENTERS = 64
RAYS = (48, 40)
POSE = (30.0, 20.0, 4.5)
FORCE = -500.0


@pytest.fixture(scope="module")
def brain():
    """The JAX package's brain tet mesh at 0.35, its interpolants, loads
    and rays, as numpy (what the ranks are given)."""
    from fembrain_tpu.blob.reader import load_blob as jload
    from fembrain_tpu.fem import grid_fem as jgfm
    from fembrain_tpu.fem.tetmesh import build_fem_mesh as jbuild
    from fembrain_tpu.mesh.polygonize import extract_tet_mesh, grid_for_scene
    from fembrain_tpu.mesh.samples import bottom_nodes_per_component
    from fembrain_tpu.render import deformed as jd
    from fembrain_tpu.render.camera import Camera, generate_rays

    sc = jload(BRAIN)
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
    f_grid = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f_grid[n2g, 1] = FORCE * np.asarray(jgf.mass).reshape(-1)[n2g]
    mass = np.asarray(jbuild(nodes, tets, fixed=fixed).mass)
    f_nodes = np.zeros((len(nodes), 3), np.float32)
    f_nodes[:, 1] = FORCE * mass
    ro, rd = generate_rays(Camera.orbit(*POSE), *RAYS)
    wend = jd.build_disp_interp(nodes, n_centers=N_CENTERS, fixed=fixed,
                                kernel="wendland")
    bih = jd.build_disp_interp(nodes, n_centers=N_CENTERS, fixed=fixed)
    return dict(
        grid=(tuple(grid.lo), tuple(grid.dims), grid.cellsize),
        tm=convert.numpy_fields(jtm), nodes=nodes, tets=tets, fixed=fixed,
        n2g=n2g, f_grid=f_grid.reshape(*grid.dims, 3), f_nodes=f_nodes,
        ro=np.asarray(ro).reshape(-1, 3), rd=np.asarray(rd).reshape(-1, 3),
        wend=convert.numpy_fields(wend), bih=convert.numpy_fields(bih),
        js=js, jgrid=grid, jtm=jtm, jwend=wend, jbih=bih)


def port_setup(b, dev):
    """The port's scene, tet mesh, rays and the two interpolants given."""
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    return dict(
        scene=sc.pack(device=dev), grid=GridSpec(*b["grid"]),
        tm=convert.tet_mesh(b["tm"], device=dev),
        ro=torch.tensor(b["ro"], device=dev),
        rd=torch.tensor(b["rd"], device=dev),
        wend=convert.disp_interp(b["wend"], device=dev),
        bih=convert.disp_interp(b["bih"], device=dev))


def grid_coupled(b, p, n_parts, dev, part=None):
    """build_coupled_grid_sharded with the given Wendland interpolant."""
    cgs = pcs.build_coupled_grid_sharded(
        p["grid"], p["tm"], n_parts, fixed_nodes=b["fixed"],
        n_centers=N_CENTERS, part=part, device=dev)
    flat = b["n2g"][p["wend"].center_nodes.cpu().numpy()]
    return dataclasses.replace(cgs, interp=p["wend"], center_flat=torch.tensor(
        flat.astype(np.int32), device=dev))


def part_coupled(b, p, n_parts, dev, part=None):
    """build_coupled_sharded with the given biharmonic interpolant."""
    cs = pcs.build_coupled_sharded(b["nodes"], b["tets"], n_parts,
                                   fixed=b["fixed"], n_centers=N_CENTERS,
                                   part=part, device=dev)
    slot_of = np.empty(cs.pm.n_nodes, np.int64)
    slot_of[cs.pm.perm.cpu().numpy()] = np.arange(cs.pm.n_nodes)
    slots = slot_of[p["bih"].center_nodes.cpu().numpy()]
    return dataclasses.replace(cs, interp=p["bih"], center_slot=torch.tensor(
        slots.astype(np.int32), device=dev))


def _rank_checks(dev, b):
    """One frame from rest of each sharded coupled step on this rank; rank
    0 also runs the single-device frames they are held to."""
    p = port_setup(b, dev)
    cgs = grid_coupled(b, p, D, dev)
    mesh = pgs.make_grid_mesh()
    fs = pgs.to_shard_layout(cgs.sgf, torch.tensor(b["f_grid"]))[cgs.sgf.part]
    q, v, dv = cgs.sgf.rest_state()
    t, hit, (q2, _, _), it = pcs.coupled_step_grid_sharded(
        p["scene"], cgs, mesh, q, v, dv, fs, p["ro"], p["rd"])
    out = dict(grid=dict(t=t, hit=hit, q=q2, iters=it, part=cgs.sgf.part))

    cs = part_coupled(b, p, D, dev)
    nmesh = sh.make_mesh(axis=ppt.NODE_AXIS)
    fp = ppt.to_partition_order(cs.pm, torch.tensor(b["f_nodes"]))[cs.pm.part]
    z = torch.zeros_like(fp)
    t, hit, (q2, _, _), it = pcs.coupled_step_sharded(
        p["scene"], cs, nmesh, z, z, z, fp, p["ro"], p["rd"])
    out["part"] = dict(t=t, hit=hit, q=q2, iters=it, part=cs.pm.part)

    if cs.pm.part == 0:
        gf = pgfm.grid_fem_from_tetmesh(p["grid"], p["tm"],
                                        fixed_nodes=b["fixed"], device=dev)
        cgi = torch.tensor(b["n2g"][p["wend"].center_nodes.numpy()])
        t, hit, st = pd.coupled_step_grid_fast(
            p["scene"], gf, p["wend"], cgi, gf.rest_state(),
            torch.tensor(b["f_grid"]), p["ro"], p["rd"], E_scale=None)
        out["grid_single"] = dict(t=t, hit=hit, q=st.q)
        fem = build_fem_mesh(b["nodes"], b["tets"], fixed=b["fixed"],
                             device=dev)
        t, hit, st = pd.coupled_step_fast(
            p["scene"], fem, p["bih"], pinteg.FemState.rest(fem),
            torch.tensor(b["f_nodes"]), p["ro"], p["rd"], E_scale=None)
        out["part_single"] = dict(t=t, hit=hit, q=st.q)
    return out


@pytest.fixture(scope="module")
def ranks(brain):
    """The ranks' results, launched in the background: a test reads them
    with .result()."""
    small = {k: v for k, v in brain.items() if not k.startswith("j")}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(sh.launch, _rank_checks, D, small,
                          device="cpu")


def _joined(rs, key):
    t = torch.cat([r[key]["t"] for r in rs]).numpy()
    hit = torch.cat([r[key]["hit"] for r in rs]).numpy()
    return t, hit


def _agree(h_ref, t_ref, hit, t, max_dt, median_dt=None, agree=0.999,
           over=0):
    """Hit agreement, and |dt| on the common hits under max_dt on all but
    `over` rays (and a median under median_dt)."""
    assert (h_ref == hit).mean() > agree, (h_ref != hit).sum()
    both = h_ref & hit
    assert both.sum() > 100
    dt = np.abs(t_ref[both] - t[both])
    assert (dt >= max_dt).sum() <= over, np.sort(dt)[-over - 1:]
    if median_dt is not None:
        assert np.median(dt) < median_dt


def test_grid_coupled_frame_matches_jax_and_single_device(brain, ranks):
    """Grid FEM blocks within 1e-4 of the JAX package's shard layout and
    of the single-device step; hits agree with K2's thresholds (PERF.md
    section 2) against the JAX package's sharded frame (its dense XLA
    deformed trace), and on > 0.999 of the rays against the single-device
    frame."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fembrain_tpu.fem import grid_sharded as jgs
    from fembrain_tpu.render.coupled_sharded import (
        build_coupled_grid_sharded, coupled_step_grid_sharded)

    cgs = build_coupled_grid_sharded(brain["jgrid"], brain["jtm"], D,
                                     fixed_nodes=brain["fixed"],
                                     n_centers=N_CENTERS, kernel="wendland")
    cgs = dataclasses.replace(
        cgs, interp=brain["jwend"], center_flat=jnp.asarray(
            brain["n2g"][np.asarray(brain["jwend"].center_nodes)]))
    mesh = Mesh(np.array(jax.devices()[:D]), (jgs.GRID_AXIS,))
    q, v, dv = cgs.sgf.rest_state()
    fs = jgs.to_shard_layout(cgs.sgf, brain["f_grid"])
    tj, hj, (qj, _, _), itj = jax.jit(
        lambda q, v, dv: coupled_step_grid_sharded(
            brain["js"], cgs, mesh, q, v, dv, fs, brain["ro"], brain["rd"],
            use_pallas=False))(q, v, dv)
    rs = ranks.result()
    assert [r["grid"]["part"] for r in rs] == list(range(D))
    blocks = np.stack([r["grid"]["q"].numpy() for r in rs])
    qj = np.asarray(qj)
    assert np.abs(blocks - qj).max() / np.abs(qj).max() < 1e-4
    assert abs(rs[0]["grid"]["iters"] - int(itj)) <= 1
    t, hit = _joined(rs, "grid")
    # Against the dense tracer, K2 is held to its own thresholds, with
    # one ray pinned: the reference's K2 (Pallas, interpret mode) leaves
    # the dense tracer on the same 3 of these 1,920 rays and lands one
    # ray on a crossing 1.066 further, as the port's does (ROADMAP
    # queue 3); the JAX interpret run takes 70 s, too long to repeat here.
    _agree(np.asarray(hj), np.asarray(tj), hit, t, 5e-2, 5e-3, agree=0.995,
           over=1)
    single = rs[0]["grid_single"]
    flat = blocks.reshape(-1, *blocks.shape[2:])[: single["q"].shape[0]]
    assert np.abs(flat - single["q"].numpy()).max() / np.abs(qj).max() < 1e-4
    _agree(single["hit"].numpy(), single["t"].numpy(), hit, t, 5e-2, 5e-3)


def test_partitioned_coupled_frame_matches_jax_and_single_device(brain,
                                                                 ranks):
    """Partitioned FEM blocks within rtol 1e-4 / atol 1e-7 of the JAX
    package's; hits agree on > 0.999 with K4's |dt| threshold against
    its sharded frame (dense XLA trace) and the single-device frame."""
    import jax
    from jax.sharding import Mesh

    from fembrain_tpu.fem.partitioned import NODE_AXIS, to_partition_order
    from fembrain_tpu.render.coupled_sharded import (
        build_coupled_sharded, coupled_step_sharded)

    cs = build_coupled_sharded(brain["nodes"], brain["tets"], D,
                               fixed=brain["fixed"], n_centers=N_CENTERS)
    slot_of = np.empty(cs.pm.n_nodes, np.int64)
    slot_of[np.asarray(cs.pm.perm)] = np.arange(cs.pm.n_nodes)
    cs = dataclasses.replace(cs, interp=brain["jbih"], center_slot=np.asarray(
        slot_of[np.asarray(brain["jbih"].center_nodes)], np.int32))
    mesh = Mesh(np.array(jax.devices()[:D]), (NODE_AXIS,))
    z = to_partition_order(cs.pm, np.zeros_like(brain["f_nodes"]))
    fp = to_partition_order(cs.pm, brain["f_nodes"])
    tj, hj, (qj, _, _), itj = jax.jit(
        lambda q, v, dv, f: coupled_step_sharded(
            brain["js"], cs, mesh, q, v, dv, f, brain["ro"], brain["rd"],
            use_pallas=False))(z, z, z, fp)
    rs = ranks.result()
    assert [r["part"]["part"] for r in rs] == list(range(D))
    blocks = np.stack([r["part"]["q"].numpy() for r in rs])
    np.testing.assert_allclose(blocks, np.asarray(qj), rtol=1e-4, atol=1e-7)
    assert abs(rs[0]["part"]["iters"] - int(itj)) <= 1
    t, hit = _joined(rs, "part")
    _agree(np.asarray(hj), np.asarray(tj), hit, t, 1e-3)
    single = rs[0]["part_single"]
    pm = ppt.build_partitioned(brain["nodes"], brain["tets"], D,
                               fixed=brain["fixed"], device="cpu")
    q = ppt.from_partition_order(pm, torch.tensor(blocks)).numpy()
    np.testing.assert_allclose(q, single["q"].numpy(), rtol=1e-3, atol=1e-6)
    _agree(single["hit"].numpy(), single["t"].numpy(), hit, t, 1e-3)
