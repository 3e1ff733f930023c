"""PyTorch port, the training step over ranks: the gradient of the summed
hit depth of one differentiable grid-backed coupled frame
(coupled_step_grid_sharded, biharmonic interpolant: K4's plain version)
with respect to Young's modulus, at two gloo ranks on the CPU, on brain
at cellsize 0.35. Young's modulus is held whole on every rank and enters
each rank's slab of the residual and of the matvec; its gradient, summed
over the ranks, must equal the JAX package's sharded gradient (the
transpose of its psum) and the port's single-device differentiable frame
within 1e-3; and the node-partitioned differentiable frame's gradient
with respect to the load equals the single-device coupled_step_fast's.

The ranks start once (`ranks` fixture, in the background while the JAX
reference compiles here); the rank processes import this module to find
`_rank_checks`, so JAX is imported only where the reference runs."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fembrain_tpu_torch.fem import grid_fem as pgfm
from fembrain_tpu_torch.fem import grid_sharded as pgs
from fembrain_tpu_torch.fem import integrator as pinteg
from fembrain_tpu_torch.fem import partitioned as ppt
from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
from fembrain_tpu_torch.parallel import sharding as sh
from fembrain_tpu_torch.render import coupled_sharded as pcs
from fembrain_tpu_torch.render import deformed as pd

from test_torch_coupled_sharded import (
    D,
    brain,  # noqa: F401  (the module fixture)
    part_coupled,
    port_setup,
)


def _grid_loss_grad(step, rays):
    """(loss, dloss/dE, hit) of sum(where(hit, t, 0)) for step(E)."""
    e = torch.tensor(1.0, requires_grad=True)
    t, hit = step(e)
    loss = torch.sum(torch.where(hit, t, 0.0))
    loss.backward()
    return float(loss.detach()), float(e.grad), hit


def _rank_checks(dev, b):
    p = port_setup(b, dev)
    cgs = pcs.build_coupled_grid_sharded(
        p["grid"], p["tm"], D, fixed_nodes=b["fixed"], kernel="biharmonic",
        device=dev)
    flat = b["n2g"][p["bih"].center_nodes.cpu().numpy()]
    cgs = dataclasses.replace(cgs, interp=p["bih"], center_flat=torch.tensor(
        flat.astype(np.int32), device=dev))
    mesh = pgs.make_grid_mesh()
    fs = pgs.to_shard_layout(cgs.sgf, torch.tensor(b["f_grid"]))[cgs.sgf.part]
    q, v, dv = cgs.sgf.rest_state()

    def sharded(e):
        t, hit, _, it = pcs.coupled_step_grid_sharded(
            p["scene"], cgs, mesh, q, v, dv, fs, p["ro"], p["rd"],
            E_scale=e, differentiable=True)
        assert it == -1
        return t, hit

    loss, g, hit = _grid_loss_grad(sharded, p)
    out = dict(loss=loss, g=g, hit=hit)

    # The node-partitioned frame: d sum(t) / d(load scale).
    cs = part_coupled(b, p, D, dev)
    nmesh = sh.make_mesh(axis=ppt.NODE_AXIS)
    fp = ppt.to_partition_order(cs.pm, torch.tensor(b["f_nodes"]))[cs.pm.part]
    z = torch.zeros_like(fp)
    s = torch.tensor(1.0, requires_grad=True)
    t, hit, _, _ = pcs.coupled_step_sharded(
        p["scene"], cs, nmesh, z, z, z, fp * sh.replicated(s), p["ro"],
        p["rd"], differentiable=True)
    torch.sum(torch.where(hit, t, 0.0)).backward()
    out["part_g"] = float(s.grad)
    out["part_hit"] = hit

    if cs.pm.part == 0:
        gf = pgfm.grid_fem_from_tetmesh(p["grid"], p["tm"],
                                        fixed_nodes=b["fixed"], device=dev)
        cgi = torch.tensor(flat)

        def single(e):
            t, hit, _ = pd.coupled_step_grid_fast(
                p["scene"], gf, p["bih"], cgi, gf.rest_state(),
                torch.tensor(b["f_grid"]), p["ro"], p["rd"], E_scale=e,
                differentiable=True)
            return t, hit

        out["single"] = _grid_loss_grad(single, p)
        fem = build_fem_mesh(b["nodes"], b["tets"], fixed=b["fixed"],
                             device=dev)
        s = torch.tensor(1.0, requires_grad=True)
        t, hit, _ = pd.coupled_step_fast(
            p["scene"], fem, p["bih"], pinteg.FemState.rest(fem),
            torch.tensor(b["f_nodes"]) * s, p["ro"], p["rd"], E_scale=None,
            differentiable=True)
        torch.sum(torch.where(hit, t, 0.0)).backward()
        out["part_single"] = (float(s.grad), hit)
    return out


@pytest.fixture(scope="module")
def ranks(brain):  # noqa: F811
    small = {k: v for k, v in brain.items() if not k.startswith("j")}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(sh.launch, _rank_checks, D, small,
                          device="cpu")


def test_e_gradient_through_sharded_solve(brain, ranks):  # noqa: F811
    """Every rank holds the whole E-gradient; it is the JAX package's
    sharded one (dense XLA deformed trace over the same hits, its
    derivative by forward mode) and the single-device differentiable
    frame's within 1e-3."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fembrain_tpu.fem import grid_sharded as jgs
    from fembrain_tpu.render.coupled_sharded import (
        build_coupled_grid_sharded, coupled_step_grid_sharded)

    cgs = build_coupled_grid_sharded(brain["jgrid"], brain["jtm"], D,
                                     fixed_nodes=brain["fixed"],
                                     kernel="biharmonic")
    cgs = dataclasses.replace(
        cgs, interp=brain["jbih"], center_flat=jnp.asarray(
            brain["n2g"][np.asarray(brain["jbih"].center_nodes)]))
    mesh = Mesh(np.array(jax.devices()[:D]), (jgs.GRID_AXIS,))
    q, v, dv = cgs.sgf.rest_state()
    fs = jgs.to_shard_layout(cgs.sgf, brain["f_grid"])

    def loss(es):
        t, hit, _, _ = coupled_step_grid_sharded(
            brain["js"], cgs, mesh, q, v, dv, fs, brain["ro"], brain["rd"],
            E_scale=es, differentiable=True, use_pallas=False)
        return jnp.sum(jnp.where(hit, t, 0.0)), hit

    # Forward mode gives the same scalar derivative through the
    # reference's custom_linear_solve, and compiles in 24 s against
    # reverse mode's 30 s here.
    lj, gj, hj = jax.jit(lambda e: jax.jvp(
        loss, (e,), (jnp.float32(1.0),), has_aux=True))(jnp.float32(1.0))
    gj = float(gj)
    rs = ranks.result()
    g = [r["g"] for r in rs]
    assert g[0] == g[1] and np.isfinite(g[0]) and abs(g[0]) > 0
    hit = torch.cat([r["hit"] for r in rs]).numpy()
    np.testing.assert_array_equal(hit, np.asarray(hj))
    assert abs(sum(r["loss"] for r in rs) - float(lj)) <= 1e-4 * abs(
        float(lj))
    assert abs(g[0] - gj) <= 1e-3 * abs(gj), (g[0], gj)
    l1, g1, h1 = rs[0]["single"]
    np.testing.assert_array_equal(hit, h1.numpy())
    assert abs(g[0] - g1) <= 1e-3 * abs(g1), (g[0], g1)


def test_partitioned_frame_gradient_matches_single_device(ranks):
    """The load scale, held whole, reaches every rank's block; its
    gradient through the node-partitioned adjoint solve and the center
    gather is the single-device frame's."""
    rs = ranks.result()
    g = [r["part_g"] for r in rs]
    g1, h1 = rs[0]["part_single"]
    hit = torch.cat([r["part_hit"] for r in rs]).numpy()
    np.testing.assert_array_equal(hit, h1.numpy())
    assert g[0] == g[1] and np.isfinite(g[0]) and abs(g[0]) > 0
    assert abs(g[0] - g1) <= 1e-3 * abs(g1), (g[0], g1)
