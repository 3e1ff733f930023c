"""Implicit-integrator state, preconditioned conjugate gradients and the
adjoint-differentiable symmetric solve.

PyTorch counterpart of `FemState`, `pcg` and the custom_linear_solve use
in fembrain_tpu/fem/integrator.py (the reference's solver stack,
src/deformable/PS_VolumeConservingIntegrator.cpp:46-240 with the PCG
branch, vegafem sparseSolver/CGSolver).
"""
from __future__ import annotations

import dataclasses

import torch

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


def _vdot(a, b):
    return torch.sum(a * b)


def pcg(matvec, b, prec, tol=CG_TOL, max_iters=CG_MAX_ITERS, x0=None):
    """Preconditioned conjugate gradients: (x, iterations).

    `prec` is a callable r -> M^-1 r. Stopping rule: the M^-1-weighted
    residual z.r against tol^2 times that of b, the cold-start initial
    residual, so a warm start x0 saves iterations. The loop test reads
    z.r on the host once per iteration."""
    thresh = float((tol * tol) * _vdot(b, prec(b)))
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    z = prec(r)
    p = z
    rz = _vdot(r, z)
    it = 0
    while it < max_iters and float(rz) > thresh:
        ap = matvec(p)
        alpha = rz / torch.clamp(_vdot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = _vdot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it


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
        x, *theta = ctx.saved_tensors
        lam, it = ctx.solve(lambda v: ctx.matvec(v, *theta), g)
        if ctx.stats is not None:
            ctx.stats["adjoint_iters"] = it
        need = [i for i in range(len(theta)) if ctx.needs_input_grad[4 + i]]
        grads = [None] * len(theta)
        if need:
            with torch.enable_grad():
                th = [t.detach().requires_grad_(i in need)
                      for i, t in enumerate(theta)]
                out = ctx.matvec(x, *th)
                gs = torch.autograd.grad(out, [th[i] for i in need],
                                         grad_outputs=lam, allow_unused=True)
            for i, gi in zip(need, gs):
                grads[i] = None if gi is None else -gi
        return (None, None, None, lam, *grads)


def symmetric_solve(matvec, b, theta, solve, stats: dict | None = None):
    """Differentiable solve of matvec(x, *theta) = b for a symmetric
    operator. solve(mv, rhs) -> (x, iterations) runs with no warm start,
    forward and adjoint alike; `stats`, if given, receives
    "forward_iters" and, after backward, "adjoint_iters"."""
    return _SymmetricSolve.apply(solve, matvec, stats, b, *theta)
