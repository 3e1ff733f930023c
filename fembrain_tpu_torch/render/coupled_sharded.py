"""The coupled frame over several ranks:

    force -> FEM solve split over the ranks (halo exchange)
          -> RBF displacement weights (the M center rows gathered,
             the [M+4, 3] product replicated)
          -> deformed tile trace with the rays split over the same ranks

PyTorch counterpart of fembrain_tpu/render/coupled_sharded.py. The
FEM stage splits NODES (fem.partitioned, the unstructured solver) or
X-slabs (fem.grid_sharded, the grid solver) over the ranks; the glue
gathers the M center-node displacement rows (one all_reduce of each
rank's own rows: KBs), every rank solves the weights whole; the trace
stage splits RAYS over the same ranks (render.tile_trace.
trace_tiles_sharded: tiles are independent, no collective) and runs the
single-device kernels on its share: K4 for the biharmonic interpolant,
K2 for the Wendland one. Semantics of coupled_step_fast /
coupled_step_grid_fast (tested). State is this rank's block of the
partition or slab layout; rays are the whole batch on every rank, and
(t, hit) come back as this rank's rows (parallel.sharding.row_share).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..blob.scene import Scene
from ..fem import grid_fem as gfm
from ..fem import grid_sharded as gsh
from ..fem.partitioned import (
    PartFemMesh,
    build_partitioned,
    partitioned_timestep,
)
from ..parallel import sharding as sh
from .deformed import (
    FIXED_POINT_ITERS,
    DispInterp,
    biharmonic_spec,
    build_disp_interp,
    deformed_field_rbf,
    disp_lipschitz,
    disp_slack,
    disp_weights_centers,
    wendland_spec,
)
from .sphere_trace import TraceParams, newton_nudge
from .tile_trace import TILE, trace_tiles_image_sharded, trace_tiles_sharded


@dataclasses.dataclass(frozen=True)
class CoupledSharded:
    """Static setup of the node-partitioned coupled step: this rank's
    block of the partitioned mesh, the interpolant (whole)."""
    pm: PartFemMesh
    interp: DispInterp
    center_slot: torch.Tensor  # [M] partition-order row of each RBF center


def build_coupled_sharded(nodes, tets, n_parts: int,
                          fixed=None, n_centers: int | None = None, *,
                          part: int | None = None, device=None,
                          **material) -> CoupledSharded:
    """Partition the mesh (block `part` for this rank, see
    fem.partitioned.build_partitioned) and map the RBF centers of the
    biharmonic interpolant into partition order (host-side, once per
    mesh topology); tensors on `device` (the card when None)."""
    pm = build_partitioned(nodes, tets, n_parts, fixed=fixed, part=part,
                           device=device, **material)
    fixed_idx = None if fixed is None else np.asarray(fixed)
    interp = build_disp_interp(nodes, n_centers=n_centers, fixed=fixed_idx,
                               device=device)
    perm = pm.perm.cpu().numpy()          # partition slot -> original id
    slot_of = np.empty(pm.n_nodes, np.int64)
    slot_of[perm] = np.arange(pm.n_nodes)
    center_slot = slot_of[interp.center_nodes.cpu().numpy()]
    return CoupledSharded(
        pm=pm, interp=interp,
        center_slot=torch.as_tensor(center_slot.astype(np.int32),
                                    device=pm.ke.device),
    )


def _own_rows(local: torch.Tensor, flat_idx: torch.Tensor, part: int,
              group) -> torch.Tensor:
    """Rows flat_idx [M] of the layout the ranks' [n, 3] blocks stack
    into, on every rank: each rank puts in the rows it owns and one
    all_reduce sums the disjoint parts (exact; its backward sums the
    ranks' gradients back onto the owners' rows)."""
    flat = local.reshape(-1, 3)
    n = flat.shape[0]
    idx = flat_idx.long() - part * n
    mine = (idx >= 0) & (idx < n)
    rows = flat[torch.clamp(idx, 0, n - 1)]
    return sh.all_reduce(torch.where(mine[:, None], rows, 0.0), group)


def disp_weights_from_partition(cs: CoupledSharded, q_p: torch.Tensor,
                                device_mesh=None):
    """RBF weights [M+4, 3] from this rank's partition-layout block
    q_p [Nl, 3]: the M center rows gathered across the ranks of
    `device_mesh` (the world without one), then the replicated factored
    solve."""
    group = None if device_mesh is None else device_mesh.get_group()
    u_c = _own_rows(q_p, cs.center_slot, cs.pm.part, group)
    return disp_weights_centers(cs.interp, u_c)


def _trace(scene, ro, rd, device_mesh, params, image_hw, disp):
    with torch.no_grad():
        if image_hw is not None:
            return trace_tiles_image_sharded(
                scene, ro, rd, image_hw[0], image_hw[1], device_mesh,
                params=params, disp=disp)
        return trace_tiles_sharded(scene, ro, rd, device_mesh,
                                   params=params, disp=disp)


def _correct(scene, interp, w, ro, rd, device_mesh, t, hit, params, md,
             fp_iters):
    """The implicit hit correction on this rank's rows against the dense
    deformed field (the kernel is forward-only), tied to w so that every
    rank's backward reaches the center gather and the solve behind it,
    also a rank whose rays all miss."""
    nd, idx = sh.shard_index(device_mesh)
    rows = sh.row_share(ro.shape[0], nd, idx, TILE)
    lo = scene.bbox_lo - 0.05 - md
    hi = scene.bbox_hi + 0.05 + md
    base_step = torch.linalg.norm(hi - lo) * params.step_frac
    t = newton_nudge(
        lambda p: deformed_field_rbf(scene, interp, w, p, fp_iters)
        - params.iso, ro[rows], rd[rows], t, hit, 0.5 * base_step)
    return sh.tie(t, w)


def coupled_step_sharded(scene: Scene, cs: CoupledSharded, device_mesh,
                         q_p: torch.Tensor, qvel_p: torch.Tensor,
                         dv_p: torch.Tensor, f_ext_p: torch.Tensor,
                         ro: torch.Tensor, rd: torch.Tensor,
                         h: float = 0.0333,
                         params: TraceParams = TraceParams(),
                         image_hw: tuple[int, int] | None = None,
                         max_disp: float = 0.5,
                         fp_iters: int = FIXED_POINT_ITERS,
                         cg_tol: float | None = None,
                         differentiable: bool = False):
    """One node-partitioned coupled frame. State arrays are this rank's
    block [Nl, 3] of the partition layout
    (fem.partitioned.to_partition_order); rays are the whole batch and
    split internally. Returns (t, hit, (q', qvel', dv'), cg_iters), t and
    hit this rank's rows. The trace is K4 (biharmonic interpolant,
    global march bounds, brackets inflated by `max_disp`).

    device_mesh is 1-D with axis NODE_AXIS ('nodes'): the same ranks hold
    node blocks in the FEM stage and ray blocks in the trace stage.
    differentiable=True solves cold and adjoint-differentiably and
    applies the implicit hit correction, so a loss on t (the sum of the
    ranks' local losses) reaches the forces and material across ranks."""
    kw = {} if cg_tol is None else {"cg_tol": cg_tol}
    q2, v2, dv2, iters = partitioned_timestep(
        cs.pm, device_mesh, q_p, qvel_p, f_ext_p, h=h, dv=dv_p,
        differentiable=differentiable, **kw,
    )
    w = disp_weights_from_partition(cs, q2, device_mesh)
    wd = w.detach()
    shrink = torch.clamp(1.0 - disp_lipschitz(cs.interp, wd), 0.0, 1.0)
    disp = biharmonic_spec(cs.interp, wd, shrink, disp_slack(cs.interp, wd),
                           max_disp, fp_iters)
    t, hit = _trace(scene, ro, rd, device_mesh, params, image_hw, disp)
    if differentiable:
        t = _correct(scene, cs.interp, w, ro, rd, device_mesh, t, hit,
                     params, max_disp, fp_iters)
    return t, hit, (q2, v2, dv2), iters


@dataclasses.dataclass(frozen=True)
class CoupledGridSharded:
    """Static setup of the grid-backed sharded coupled step: this rank's
    slab, the interpolant (whole)."""
    sgf: gsh.ShardedGridFem
    interp: DispInterp
    center_flat: torch.Tensor  # [M] each RBF center's grid vertex in the
                               #   flattened [D*Xl, Y, Z] shard layout


def build_coupled_grid_sharded(grid, tm, n_parts: int, fixed_nodes=None,
                               n_centers: int | None = None,
                               kernel: str = "wendland", *,
                               part: int | None = None, device=None,
                               **material) -> CoupledGridSharded:
    """Host-side: build slab `part` of the X-slab grid FEM
    (fem.grid_sharded.build_sharded_grid_fem) plus the displacement
    interpolant over the tet mesh's nodes, and map the RBF centers into
    the shard layout; tensors on `device` (the card when None)."""
    sgf = gsh.build_sharded_grid_fem(
        grid, tm, n_parts, fixed_nodes=fixed_nodes, part=part,
        device=device, **material
    )
    nodes = tm.nodes[: int(tm.n_nodes)].detach().cpu().numpy()
    interp = build_disp_interp(
        nodes, n_centers=n_centers, fixed=fixed_nodes, kernel=kernel,
        device=device,
    )
    # The shard layout [D, Xl, Y, Z] flattens to [D*Xl, Y, Z] with the
    # padding planes appended: the global flat vertex index carries over.
    g = gfm.node_to_grid_index(tm)[interp.center_nodes.cpu().numpy()]
    return CoupledGridSharded(
        sgf=sgf, interp=interp,
        center_flat=torch.as_tensor(g.astype(np.int32),
                                    device=sgf.mass.device),
    )


def scale_grid_E(sgf, e_scale):
    """Scale the slab's Young's modulus (element stiffness is linear in E
    for fixed nu). Only the solve operator (local.ke) is scaled; the
    multigrid preconditioner stays at E=1, which changes CG convergence
    slightly, never the solution."""
    return dataclasses.replace(
        sgf,
        local=dataclasses.replace(sgf.local, ke=sgf.local.ke * e_scale),
    )


def coupled_step_grid_sharded(scene: Scene, cgs: CoupledGridSharded,
                              device_mesh,
                              q, qvel, dv, f_ext,
                              ro: torch.Tensor, rd: torch.Tensor,
                              h: float = 0.0333,
                              E_scale=None,
                              params: TraceParams = TraceParams(),
                              image_hw: tuple[int, int] | None = None,
                              cg_tol: float | None = None,
                              differentiable: bool = False,
                              max_disp=None,
                              fp_iters: int = FIXED_POINT_ITERS):
    """One grid-backed sharded coupled frame: X-slab grid FEM step ->
    replicated RBF weights (the M center rows gathered) -> deformed tile
    trace with the rays split over the SAME ranks: K2 for a Wendland
    interpolant (its per-tile bounds and bracket inflation from this
    frame's weights), K4 for a biharmonic one (global bounds, brackets
    inflated by `max_disp`, 0.5 when None). State arrays are this rank's
    block [Xl, Y, Z, 3] of the shard layout
    (fem.grid_sharded.to_shard_layout). Returns
    (t, hit, (q', qvel', dv'), cg_iters), t and hit this rank's rows.

    E_scale (held whole on every rank) scales Young's modulus; with
    differentiable=True the solve runs cold and adjoint-differentiably
    and the trace applies its implicit correction, so a loss on t (the
    sum of the ranks' local losses) gives every rank the whole
    d(loss)/d(E_scale)."""
    group = device_mesh.get_group()
    sgf = cgs.sgf if E_scale is None else scale_grid_E(
        cgs.sgf, sh.replicated(E_scale, group))
    kw = {} if cg_tol is None else {"cg_tol": cg_tol}
    q2, v2, dv2, iters = gsh.sharded_timestep(
        sgf, device_mesh, q, qvel, f_ext, h=h, dv=dv,
        differentiable=differentiable, **kw,
    )
    u_c = _own_rows(q2, cgs.center_flat, sgf.part, group)
    w = disp_weights_centers(cgs.interp, u_c)
    interp = cgs.interp
    wd = w.detach()
    if interp.kind == "wendland":
        disp = wendland_spec(interp, wd)
        md = disp.max_disp
    else:
        md = 0.5 if max_disp is None else max_disp
        shrink = torch.clamp(1.0 - disp_lipschitz(interp, wd), 0.0, 1.0)
        disp = biharmonic_spec(interp, wd, shrink, disp_slack(interp, wd),
                               md, fp_iters)
    t, hit = _trace(scene, ro, rd, device_mesh, params, image_hw, disp)
    if differentiable:
        t = _correct(scene, interp, w, ro, rd, device_mesh, t, hit, params,
                     md, fp_iters)
    return t, hit, (q2, v2, dv2), iters
