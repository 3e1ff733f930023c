"""Sharded grid FEM: X-slab decomposition of the dense voxel solver
(fem.grid_fem) over a 1-D device mesh.

PyTorch counterpart of fembrain_tpu/fem/grid_sharded.py. Vertex planes
are split into contiguous X-slabs, one a rank. The stencil matvec needs
exactly ONE vertex plane from the right neighbour (cells span two
adjacent planes), so a CG iteration's matvec communicates two one-plane
shifts (gather the halo, return the boundary contributions) and its dots
two scalar all_reduces, plus the preconditioner's traffic:

  precond="hybrid"    (default) the global multigrid V-cycle with its
                      fine level computed slab-wise (block-Jacobi
                      smoothing, plane-halo stencil applies, a sharded
                      full-weighting restriction) and the hierarchy from
                      level 1 down replicated on the all_gathered
                      restricted residual (1/8 of the fine grid): two
                      more halo exchanges and returns for the two level-0
                      operator applies, one shift for the restriction and
                      one all_gather an iteration. Falls back to
                      global_mg when the hierarchy has one level, slabs
                      are odd, or the sharded restriction would miss a
                      coarse plane.
  precond="global_mg" all_gather the full fine residual every iteration
                      for a replicated global V-cycle: iteration counts of
                      the single-device solver.
  precond="schwarz"   communication-free local V-cycles with Dirichlet
                      slab walls: no preconditioner traffic, more
                      iterations.

Each rank keeps its block of the reference's stacked [D, ...] layout: the
state [Xl, Y, Z, 3] of the padded global [D*Xl, Y, Z, 3].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh.polygonize import GridSpec, TetMesh
from ..parallel import sharding as sh
from . import grid_fem as gfm
from .grid_fem import GridFem, build_grid_fem
from .integrator import (
    CG_MAX_ITERS,
    CG_TOL,
    DEFAULT_DAMPING_MASS,
    DEFAULT_DAMPING_STIFFNESS,
    DEFAULT_TIMESTEP,
    symmetric_solve,
)
from .tetmesh import DEFAULT_E, DEFAULT_NU, DEFAULT_RHO

GRID_AXIS = "x"


@dataclasses.dataclass(frozen=True)
class ShardedGridFem:
    """One rank's slab of the X-slab grid FEM (the reference stacks the
    slabs [D, ...]).

    local: a GridFem whose dims are the EXTENDED slab (Xl owned vertex
    planes + 1 halo plane); its cellw covers exactly this slab's cells,
    its levels form the local Schwarz hierarchy (halo plane Dirichlet).
    mass/free cover the OWNED planes with globally-assembled values."""

    local: GridFem
    mass: torch.Tensor       # [Xl, Y, Z] global lumped mass, sliced
    free: torch.Tensor       # [Xl, Y, Z] bool
    kdiag: torch.Tensor      # [3, 3, Xl*Y*Z] GLOBAL linear diag blocks
    bnd: torch.Tensor        # [Xl, Y, Z] owned planes Dirichlet-clamped in
                             # the local Schwarz solve (block-Jacobi there)
    # The whole-domain grid FEM, on every rank: its multigrid hierarchy
    # drives the hybrid and global_mg preconditioners.
    gfull: GridFem | None = None
    n_parts: int = 1
    xl: int = 0
    dims_pad: tuple[int, int, int] = (0, 0, 0)
    dims: tuple[int, int, int] = (0, 0, 0)
    part: int = 0            # the slab this rank holds

    def rest_state(self):
        z = torch.zeros((self.xl, *self.dims_pad[1:], 3),
                        dtype=self.mass.dtype, device=self.mass.device)
        return z, z, z  # q, qvel, dv: this rank's block of the layout


def make_grid_mesh(n_devices: int | None = None):
    return sh.make_mesh(n_devices, GRID_AXIS)


def to_shard_layout(sgf: ShardedGridFem, v: torch.Tensor) -> torch.Tensor:
    """Global [X, Y, Z, 3] grid array -> [D, Xl, Y, Z, 3] shard layout
    (pads X; rank r holds [r])."""
    X = sgf.dims[0]
    xpad = sgf.n_parts * sgf.xl
    v = torch.cat([v, v.new_zeros((xpad - X, *v.shape[1:]))], 0)
    return v.reshape(sgf.n_parts, sgf.xl, *v.shape[1:])


def from_shard_layout(sgf: ShardedGridFem, v: torch.Tensor) -> torch.Tensor:
    """[D, Xl, Y, Z, 3] (the ranks' blocks stacked) -> global [X, Y, Z, 3]."""
    flat = v.reshape(sgf.n_parts * sgf.xl, *v.shape[2:])
    return flat[: sgf.dims[0]]


def build_sharded_grid_fem(
    grid: GridSpec,
    tm: TetMesh,
    n_parts: int,
    fixed_nodes: np.ndarray | None = None,
    E: float = DEFAULT_E,
    nu: float = DEFAULT_NU,
    rho: float = DEFAULT_RHO,
    n_levels: int = 3,
    part: int | None = None,
    device=None,
) -> ShardedGridFem:
    """Host-side: build the global grid FEM, pad X so every slab gets Xl
    cells with at least one inactive padding layer at the top, slice the
    global assembled quantities for slab `part` (default: this process's
    rank, 0 without a process group) and build its local Schwarz
    multigrid hierarchy; tensors land on `device` (the card when None)."""
    from .. import default_device

    device = default_device() if device is None else device
    if part is None:
        part = torch.distributed.get_rank() if (
            torch.distributed.is_initialized()) else 0
    g = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed_nodes,
                                  E=E, nu=nu, rho=rho, n_levels=4,
                                  device=device)
    X, Y, Z = g.dims
    CX = X - 1
    # >= 1 padding cell layer so the final vertex plane is nobody's child.
    xl = -(-(CX + 1) // n_parts)
    xl += xl % 2  # even slabs: coarse multigrid planes align with shards
    cxp = n_parts * xl
    xp = cxp + 1

    def host(t):
        return t.detach().cpu().numpy()

    cellw = host(g.cellw).reshape(CX, Y - 1, Z - 1)
    cellw = np.pad(cellw, [(0, cxp - CX), (0, 0), (0, 0)])
    free = np.pad(host(g.free), [(0, xp - X), (0, 0), (0, 0)])
    mass = np.pad(host(g.mass), [(0, xp - X), (0, 0), (0, 0)])
    kdiag = host(g.kdiag).reshape(3, 3, X, Y, Z)
    kdiag = np.pad(kdiag, [(0, 0), (0, 0), (0, xp - X), (0, 0), (0, 0)])

    d = part
    cm = cellw[d * xl : (d + 1) * xl] > 0.5                # [xl, CY, CZ]
    # Local Schwarz domain: owned planes + halo plane, Dirichlet at BOTH
    # slab walls (an interior wall vertex lacks its neighbour's stiffness:
    # solving it locally overshoots and AMPLIFIES the residual) and at
    # globally-fixed/inactive vertices.
    fr = free[d * xl : (d + 1) * xl + 1].copy()            # [xl+1, Y, Z]
    fr[-1] = False                                         # halo Dirichlet
    bnd = np.zeros((xl, Y, Z), bool)
    if d > 0:
        fr[0] = False                                      # left wall
        bnd[0] = free[d * xl]                              # jacobi-covered
    lg = build_grid_fem(
        GridSpec(tuple(float(v) for v in grid.lo), (xl + 1, Y, Z),
                 grid.cellsize),
        cm, ~fr, E=E, nu=nu, rho=rho, n_levels=n_levels, device=device,
    )

    def real(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ShardedGridFem(
        local=lg,
        mass=real(mass[d * xl : (d + 1) * xl]),
        free=torch.as_tensor(free[d * xl : (d + 1) * xl], device=device),
        kdiag=real(kdiag[:, :, d * xl : (d + 1) * xl].reshape(3, 3, -1)),
        bnd=torch.as_tensor(bnd, device=device),
        gfull=g,
        n_parts=n_parts,
        xl=xl,
        dims_pad=(xp, Y, Z),
        dims=(X, Y, Z),
        part=d,
    )


def _coarse_inv(g: GridFem, mass_coef, stiff_coef):
    """The host-precomputed coarse inverse when the step's coefficients
    are the default ones it was built for, else None (rebuilt)."""
    if (g.coarse_inv is not None
            and abs(mass_coef - g.coarse_coefs[0]) < 1e-12
            and abs(stiff_coef - g.coarse_coefs[1]) < 1e-12):
        return g.coarse_inv
    return None


def sharded_timestep(
    sgf: ShardedGridFem,
    device_mesh,
    q: torch.Tensor,            # [Xl, Y, Z, 3] this rank's block
    qvel: torch.Tensor,
    f_ext: torch.Tensor,
    h: float = DEFAULT_TIMESTEP,
    damping_mass: float = DEFAULT_DAMPING_MASS,
    damping_stiffness: float = DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = CG_TOL,
    cg_max_iters: int = CG_MAX_ITERS,
    dv: torch.Tensor | None = None,
    differentiable: bool = False,
    precond: str = "hybrid",
):
    """One implicit Newmark step on this rank's slab; semantics of
    fem.grid_fem.timestep (tested equal). Returns (q', qvel', dv', iters),
    this rank's blocks and the CG count (-1 with differentiable=True,
    which solves cold through integrator.symmetric_solve with the
    distributed operator, so gradients reach the slab's element stiffness
    local.ke; see the module docstring for `precond`)."""
    group = device_mesh.get_group()
    D, Xl = sgf.n_parts, sgf.xl
    d_idx = sh.shard_index(device_mesh)[1]
    if d_idx != sgf.part:
        raise ValueError(f"rank holds slab {sgf.part}, mesh says {d_idx}")
    X = sgf.dims[0]
    Y, Z = sgf.dims[1], sgf.dims[2]
    mass_coef = 1.0 + h * damping_mass
    stiff_coef = h * damping_stiffness + h * h
    if dv is None:
        dv = torch.zeros_like(q)

    lgf = sgf.local
    free = sgf.free[..., None]
    m = sgf.mass[..., None]

    def exchange(v):
        """Owned [Xl,Y,Z,3] -> extended [Xl+1,Y,Z,3]: the halo plane is
        the right neighbour's first owned plane (zeros past the end)."""
        return torch.cat([v, sh.shift(v[0:1], -1, group)], 0)

    def collect(ext):
        """Extended contributions -> owned: the halo plane's rows belong
        to the right neighbour; send them there, add at its first plane."""
        recv = sh.shift(ext[Xl : Xl + 1], 1, group)
        return torch.cat([ext[0:1] + recv, ext[1:Xl]], 0)

    q_ext = exchange(torch.where(free, q, 0.0))
    qvel_ext = exchange(torch.where(free, qvel, 0.0))
    R = gfm.kinematics(lgf, q_ext)
    f_int = collect(gfm.internal_forces(lgf, q_ext, R))
    kq = collect(gfm.stiffness_apply_rot(lgf, R, qvel_ext))

    residual = -h * (
        (h + damping_stiffness) * kq
        + damping_mass * m * qvel
        + f_int
        - f_ext
    )
    residual = torch.where(free, residual, 0.0)

    def operator(v, ke, rot):
        g = lgf if ke is lgf.ke else dataclasses.replace(lgf, ke=ke)
        vf = torch.where(free, v, 0.0)
        out = mass_coef * m * vf + stiff_coef * collect(
            gfm.stiffness_apply_rot(g, rot, exchange(vf))
        )
        return torch.where(free, out, v)

    gfull = sgf.gfull
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device)[..., None]
    mflat = sgf.mass.reshape(-1)
    if (precond == "hybrid" and gfull is not None
            and len(gfull.levels) > 1 and Xl % 2 == 0
            # The sharded restriction makes D*(Xl/2) coarse X planes; a
            # hierarchy with MORE (odd-X grids) would zero-fill the top
            # coarse plane on restriction but prolong it, so restriction
            # and prolongation would stop being adjoints and PCG would
            # lose its SPD operator: global_mg then.
            and D * (Xl // 2) >= gfull.levels[1].dims[0]):
        sub_levels = gfull.levels[1:]
        setup_sub = gfm.mg_setup(sub_levels, mass_coef, stiff_coef,
                                 _coarse_inv(gfull, mass_coef, stiff_coef))
        Xc, Yc, Zc = gfull.levels[1].dims
        Xlc = Xl // 2
        # Fine-level smoother: globally-assembled diagonal blocks of the
        # linear operator on the owned planes.
        blk0 = (mass_coef * mflat) * eye3 + stiff_coef * sgf.kdiag
        freef0 = sgf.free.reshape(-1)[None, None]
        inv_b0 = gfm._inv3_cm(torch.where(freef0, blk0, eye3))

        def lin_mv(v):
            """The fine-level LINEAR (rest) operator on the owned planes
            (level 0 of the global hierarchy), one halo exchange."""
            vf = torch.where(free, v, 0.0)
            out = mass_coef * m * vf + stiff_coef * collect(
                gfm._un_cm(gfm._stiffness_apply_linear(
                    (Xl + 1, Y, Z), lgf.cellw, lgf.ke, gfm._cm(exchange(vf)),
                ))
            )
            return torch.where(free, out, 0.0)

        def jac(r):
            return gfm._OMEGA * torch.where(free, gfm._un_cm(
                gfm._block_apply(inv_b0, gfm._cm(r))), 0.0)

        def prec(r):
            r = torch.where(free, r, 0.0)
            z1 = jac(r)                                   # pre-smooth
            res1 = torch.where(free, r - lin_mv(z1), 0.0)
            # Sharded full-weighting restriction along X: coarse plane
            # gi = d*Xlc + i sits at owned fine plane 2i; f[2i-1] for
            # i = 0 is the LEFT neighbour's last plane.
            left = sh.shift(res1[Xl - 1 : Xl], 1, group)
            ext = torch.cat([left, res1], 0)              # planes -1..Xl-1
            even = ext[1::2][:Xlc]                        # f[2i]
            fm1 = ext[0::2][:Xlc]                         # f[2i-1]
            fp1 = ext[2::2][:Xlc]                         # f[2i+1]
            rc = gfm._cm(even + 0.5 * (fm1 + fp1))        # [3, Xlc, Y, Z]
            rc = gfm._restrict_axis(rc, Yc, 2)
            rc = gfm._restrict_axis(rc, Zc, 3)
            rcg = sh.all_gather(rc, group, 1)             # [3,D*Xlc,Yc,Zc]
            pad_c = max(0, Xc - D * Xlc)
            if pad_c:
                rcg = torch.cat([rcg, rcg.new_zeros((3, pad_c, Yc, Zc))], 1)
            rcg = rcg[:, :Xc]
            # Replicated sub-V-cycle on levels 1..end.
            zcg = gfm.vcycle(sub_levels, mass_coef, stiff_coef,
                             gfm._un_cm(rcg), setup_sub)
            zg3 = gfm._cm(zcg)                            # [3, Xc, Yc, Zc]
            pad_t = D * Xlc + 1 - Xc
            if pad_t > 0:
                zg3 = torch.cat([zg3, zg3.new_zeros((3, pad_t, Yc, Zc))], 1)
            c_own = zg3[:, d_idx * Xlc : d_idx * Xlc + Xlc + 1]
            c_own = gfm._prolong_axis(c_own, Y, 2)
            c_own = gfm._prolong_axis(c_own, Z, 3)
            ev = c_own[:, :Xlc]
            od = 0.5 * (c_own[:, :Xlc] + c_own[:, 1 : Xlc + 1])
            zp = torch.stack([ev, od], 2).reshape(3, Xl, Y, Z)
            z2 = z1 + torch.where(free, gfm._un_cm(zp), 0.0)
            # post-smooth (symmetric V(1,1))
            z3 = z2 + jac(r - lin_mv(z2))
            return torch.where(free, z3, 0.0)
    elif precond in ("global_mg", "hybrid") and gfull is not None:
        # (a hybrid request that failed its exactness gate lands here,
        # not in schwarz: the same iterations, more all_gather traffic)
        setup_g = gfm.mg_setup(gfull.levels, mass_coef, stiff_coef,
                               _coarse_inv(gfull, mass_coef, stiff_coef))

        def prec(r):
            rg = sh.all_gather(r, group, 0)               # [D*Xl, Y, Z, 3]
            z = gfm.vcycle(gfull.levels, mass_coef, stiff_coef, rg[:X],
                           setup_g)
            z = torch.cat([z, z.new_zeros((D * Xl - X, Y, Z, 3))], 0)
            return torch.where(free, z[d_idx * Xl : (d_idx + 1) * Xl], 0.0)
    else:
        # Additive Schwarz: a local V-cycle on the slab INTERIOR (both
        # walls Dirichlet) plus a block-Jacobi sweep on the wall-clamped
        # owned plane (keeps the preconditioner PD there). No traffic.
        setup = gfm.mg_setup(lgf.levels, mass_coef, stiff_coef,
                             _coarse_inv(lgf, mass_coef, stiff_coef))
        bnd = sgf.bnd[..., None]                          # [Xl, Y, Z, 1]
        blocks = (mass_coef * mflat) * eye3 + stiff_coef * sgf.kdiag
        freef = (sgf.free & sgf.bnd).reshape(-1)[None, None]
        inv_blocks = gfm._inv3_cm(torch.where(freef, blocks, eye3))

        def prec(r):
            r_ext = torch.cat([r, torch.zeros_like(r[0:1])], 0)
            z = gfm.vcycle(lgf.levels, mass_coef, stiff_coef, r_ext, setup)
            zj = gfm._un_cm(gfm._block_apply(inv_blocks, gfm._cm(r)))
            z = torch.where(bnd, zj, z[:Xl])
            return torch.where(free, z, 0.0)

    def pdot(a, b):
        return sh.all_reduce(torch.sum(a * b), group)

    def pcg(mv, b, x0=None):
        """PCG with distributed dots; the loop test reads the all-reduced
        r.z on the host once an iteration, the same on every rank."""
        with torch.no_grad():
            thresh = float((cg_tol * cg_tol) * pdot(b, prec(b)))
            x = torch.zeros_like(b) if x0 is None else x0
            r = b - mv(x)
            z = prec(r)
            p = z
            rz = pdot(r, z)
            it = 0
            while it < cg_max_iters and float(rz) > thresh:
                ap = mv(p)
                alpha = rz / torch.clamp(pdot(p, ap), min=1e-30)
                x = x + alpha * p
                r = r - alpha * ap
                z = prec(r)
                rz_new = pdot(r, z)
                beta = rz_new / torch.clamp(rz, min=1e-30)
                p = z + beta * p
                rz = rz_new
                it += 1
        return x, it

    if differentiable:
        dvn = symmetric_solve(operator, residual, (lgf.ke, R), pcg)
        iters = -1
    else:
        dvn, iters = pcg(lambda v: operator(v, lgf.ke, R), residual,
                         torch.where(free, dv, 0.0))

    qvel2 = torch.where(free, qvel + dvn, 0.0)
    q2 = torch.where(free, q + h * qvel2, 0.0)
    return q2, qvel2, dvn, iters
