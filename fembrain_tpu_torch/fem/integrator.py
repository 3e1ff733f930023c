"""Implicit integrator on an unstructured tet mesh, preconditioned
conjugate gradients and the adjoint-differentiable symmetric solve.

PyTorch counterpart of fembrain_tpu/fem/integrator.py (the reference's
solver stack, src/deformable/PS_VolumeConservingIntegrator.cpp:46-240
with the PCG branch, vegafem sparseSolver/CGSolver): per step

    K_eff = M + h (alpha M + beta K_rot) + h^2 K_rot
    residual = -h ((h + beta) K_rot qdot + alpha M qdot + f_int - f_ext)
    solve K_eff dv = residual   (block-Jacobi PCG, tol 1e-6, <= 10k iters)
    qdot += dv;  q += h qdot;   fixed DOFs zeroed

Constrained DOFs are handled by projection (identity rows) instead of the
reference's RemoveRows/InsertRows repacking. Everything is matrix-free:
K_rot v is the batched per-tet product of fem.corotational. `FemState`,
`pcg` and `symmetric_solve` also serve the grid solver (fem.grid_fem).
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.profiler import span
from . import corotational as co
from .tetmesh import FemMesh

# Reference integrator defaults (Deformable.cpp:208-216,
# PS_VolumeConservingIntegrator.cpp:17-28).
DEFAULT_TIMESTEP = 0.0333
DEFAULT_DAMPING_MASS = 0.0
DEFAULT_DAMPING_STIFFNESS = 0.01
CG_TOL = 1e-6
CG_MAX_ITERS = 10_000


@dataclasses.dataclass(frozen=True)
class FemState:
    q: torch.Tensor     # displacements
    qvel: torch.Tensor  # velocities
    # Previous step's velocity delta: the CG warm start (None = cold).
    dv: torch.Tensor | None = None

    @classmethod
    def rest(cls, mesh: FemMesh) -> "FemState":
        z = torch.zeros_like(mesh.rest)
        return cls(q=z, qvel=z, dv=z)


def _vdot(a, b):
    return torch.sum(a * b)


def pcg(matvec, b, prec, tol=CG_TOL, max_iters=CG_MAX_ITERS, x0=None):
    """Preconditioned conjugate gradients: (x, iterations).

    `prec` is a callable r -> M^-1 r. Stopping rule: the M^-1-weighted
    residual z.r against tol^2 times that of b, the cold-start initial
    residual, so a warm start x0 saves iterations. The loop test reads
    z.r on the host once per iteration (span `fem.cg_sync`), at the end
    of each iteration's span `fem.cg_iter`. The arithmetic is
    `pcg_start` and one `pcg_update` an iteration, which the grid
    solver's CUDA graphs replay (fem.grid_fem.GraphedCg)."""
    b_zb, x, r, p, rz = pcg_start(matvec, b, prec, x0)
    b_zb = (tol * tol) * b_zb
    with span("fem.cg_sync"):
        thresh = float(b_zb)
    it = 0
    go = it < max_iters and _above(rz, thresh)
    while go:
        with span("fem.cg_iter"):
            x, r, p, rz = pcg_update(matvec, prec, x, r, p, rz)
            it += 1
            go = it < max_iters and _above(rz, thresh)
    return x, it


def pcg_start(matvec, b, prec, x0=None):
    """PCG's prologue: (b.M^-1 b, x, r, p, z.r) of the start from x0
    (zero when None)."""
    b_zb = _vdot(b, prec(b))
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = prec(r)
    return b_zb, x, r, z, _vdot(r, z)


def pcg_update(matvec, prec, x, r, p, rz):
    """One PCG iteration from (x, r, p, z.r): the next (x, r, p, z.r)."""
    with span("fem.matvec"):
        ap = matvec(p)
    alpha = rz / torch.clamp(_vdot(p, ap), min=1e-30)
    x = x + alpha * p
    r = r - alpha * ap
    with span("fem.precond"):
        z = prec(r)
    rz_new = _vdot(r, z)
    beta = rz_new / torch.clamp(rz, min=1e-30)
    p = z + beta * p
    return x, r, p, rz_new


def _above(rz, thresh) -> bool:
    """The loop test's host read of z.r."""
    with span("fem.cg_sync"):
        return float(rz) > thresh


class _SymmetricSolve(torch.autograd.Function):
    """x = A(theta)^-1 b for a symmetric operator A given by
    matvec(v, *theta). Backward solves the adjoint system A lam = g with
    the same solver and returns lam for b and -lam . (dA/dtheta) x for
    theta, by autograd through one re-run of matvec(x): the counterpart
    of jax.lax.custom_linear_solve(symmetric=True)."""

    @staticmethod
    def forward(ctx, solve, matvec, stats, b, *theta):
        x, it = solve(lambda v: matvec(v, *theta), b)
        ctx.solve, ctx.matvec, ctx.stats = solve, matvec, stats
        ctx.save_for_backward(x, *theta)
        if stats is not None:
            stats["forward_iters"] = it
        return x

    @staticmethod
    def backward(ctx, g):
        with span("fem.adjoint"):
            x, *theta = ctx.saved_tensors
            lam, it = ctx.solve(lambda v: ctx.matvec(v, *theta), g)
            if ctx.stats is not None:
                ctx.stats["adjoint_iters"] = it
            need = [i for i in range(len(theta))
                    if ctx.needs_input_grad[4 + i]]
            grads = [None] * len(theta)
            if need:
                with torch.enable_grad():
                    th = [t.detach().requires_grad_(i in need)
                          for i, t in enumerate(theta)]
                    out = ctx.matvec(x, *th)
                    gs = torch.autograd.grad(out, [th[i] for i in need],
                                             grad_outputs=lam,
                                             allow_unused=True)
                for i, gi in zip(need, gs):
                    grads[i] = None if gi is None else -gi
        return (None, None, None, lam, *grads)


def symmetric_solve(matvec, b, theta, solve, stats: dict | None = None):
    """Differentiable solve of matvec(x, *theta) = b for a symmetric
    operator. solve(mv, rhs) -> (x, iterations) runs with no warm start,
    forward and adjoint alike; `stats`, if given, receives
    "forward_iters" and, after backward, "adjoint_iters"."""
    return _SymmetricSolve.apply(solve, matvec, stats, b, *theta)


def _operator(mesh: FemMesh, free, mass_coef, stiff_coef):
    """K_eff v on `mesh` (int64 indices), with identity rows on the fixed
    DOFs: (v, krot, m) -> [N, 3], krot the step's rotated element
    stiffness and m the nodal masses [N, 1]."""

    def operator(v, krot_, m_):
        vf = torch.where(free, v, 0.0)
        out = mass_coef * m_ * vf + stiff_coef * co.stiffness_apply_pre(
            mesh, krot_, vf
        )
        return torch.where(free, out, v)

    return operator


def _block_jacobi(inv_blocks):
    """The 3x3 block-Jacobi preconditioner r -> inv_blocks r."""

    def prec(r):
        return (inv_blocks @ r[..., None])[..., 0]

    return prec


def _system(mesh: FemMesh, state: FemState, f_ext, h, damping_mass,
            damping_stiffness):
    """The step's system K_eff dv = residual on `mesh` (int64 indices):
    (free [N,1], m [N,1], residual, krot, inv_blocks, mass_coef,
    stiff_coef), inv_blocks the inverted 3x3 diagonal blocks of K_eff."""
    free = ~mesh.fixed[:, None]  # [N,1] broadcast over xyz
    m = mesh.mass[:, None]

    with span("fem.forces"):
        _, R = co.element_kinematics(mesh, state.q)
        f_int = co.internal_forces(mesh, state.q, R)

        # R is constant across the CG solve: materialize R Ke R^T once
        # so the per-iteration matvec is a single batched 12x12 product.
        krot = co.rotated_stiffness(mesh, R)

        kq = co.stiffness_apply_pre(mesh, krot, state.qvel)
        residual = -h * (
            (h + damping_stiffness) * kq
            + damping_mass * m * state.qvel
            + f_int
            - f_ext
        )
        residual = torch.where(free, residual, 0.0)

    mass_coef = 1.0 + h * damping_mass
    stiff_coef = h * damping_stiffness + h * h

    # 3x3 block-Jacobi preconditioner: per-node diagonal blocks of
    # K_eff, inverted once per step (identity on fixed nodes, matching
    # the operator's identity rows there). Not differentiated.
    with span("fem.precond_setup"), torch.no_grad():
        eye = torch.eye(3, dtype=residual.dtype, device=residual.device)
        blocks = (mass_coef * m)[..., None] * eye + stiff_coef * (
            co.stiffness_blocks(mesh, krot)
        )
        inv_blocks = co._inv3(torch.where(free[..., None], blocks, eye))
    return free, m, residual, krot, inv_blocks, mass_coef, stiff_coef


def with_long_indices(mesh: FemMesh) -> FemMesh:
    """`mesh` with its index tensors as int64, as the step indexes."""
    return dataclasses.replace(
        mesh, tets=mesh.tets.long(),
        node_gather=None if mesh.node_gather is None
        else mesh.node_gather.long())


def timestep(
    mesh: FemMesh,
    state: FemState,
    f_ext: torch.Tensor,
    h: float = DEFAULT_TIMESTEP,
    damping_mass: float = DEFAULT_DAMPING_MASS,
    damping_stiffness: float = DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = CG_TOL,
    cg_max_iters: int = CG_MAX_ITERS,
    differentiable: bool = False,
    solve_stats: dict | None = None,
) -> tuple[FemState, int]:
    """One implicit step on the unstructured mesh; returns (new_state,
    cg_iterations). The forward default warm-starts CG from state.dv.

    With differentiable=True the solve runs cold through
    `symmetric_solve`, so reverse-mode gradients reach the element
    stiffness mesh.ke, the mass and the state through one adjoint solve
    instead of through the CG iterations; the iteration count is then
    reported as -1, and `solve_stats`, if given, receives
    "forward_iters" and, after backward, "adjoint_iters".

    On a CUDA device the forward default's solve replays the cached CUDA
    graphs of `fem.tet_cg_graph.graphed_tet_cg` (pcg's arithmetic, one
    launch an iteration) and returns a detached copy of the solution;
    `solve_stats["graphed_iters"]` then counts its iterations. Elsewhere,
    and for the differentiable solve, pcg runs its eager loop."""
    with span("fem.step"):
        # Index tensors as int64 once, not once per matvec.
        key_mesh, mesh = mesh, with_long_indices(mesh)
        free, m, residual, krot, inv_blocks, mass_coef, stiff_coef = (
            _system(mesh, state, f_ext, h, damping_mass, damping_stiffness))
        operator = _operator(mesh, free, mass_coef, stiff_coef)
        prec = _block_jacobi(inv_blocks)

        with span("fem.solve"):
            if differentiable:
                # No warm start: the adjoint system reuses the solver,
                # where the primal guess would be wrong.
                dv = symmetric_solve(
                    operator, residual, (krot, m),
                    lambda mv, b: pcg(mv, b, prec, cg_tol, cg_max_iters),
                    solve_stats,
                )
                iters = -1
            else:
                x0 = (None if state.dv is None
                      else torch.where(free, state.dv, 0.0))
                if residual.is_cuda:
                    from .tet_cg_graph import graphed_tet_cg
                    cg = graphed_tet_cg(key_mesh, mass_coef, stiff_coef,
                                        residual, krot, inv_blocks,
                                        warm=x0 is not None)
                    dv, iters = cg.solve(residual, krot, inv_blocks, x0,
                                         cg_tol, cg_max_iters, solve_stats)
                else:
                    dv, iters = pcg(lambda v: operator(v, krot, m),
                                    residual, prec, cg_tol, cg_max_iters,
                                    x0=x0)
                if solve_stats is not None:
                    solve_stats["forward_iters"] = iters
        qvel = torch.where(free, state.qvel + dv, 0.0)
        q = torch.where(free, state.q + h * qvel, 0.0)
    return FemState(q=q, qvel=qvel, dv=dv), iters
