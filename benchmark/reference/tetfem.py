"""The plain corotational FEM step on an unstructured tet mesh (the
upstream's Vega stack: TetMesh, CorotationalLinearFEM with warp, lumped
mass, the implicit integrator), and the check of a step against it.

The mesh is data: node positions [N, 3] and tetrahedra [T, 4]. Each
tetrahedron is linear and isotropic (E, nu): Ke = B^T C B vol from its
own rest corners; its mass rho vol / 4 goes to each corner. The step is
the one `fem.py` writes down for the voxel grid, with the mesh's own
tetrahedra in place of the cell's six Kuhn ones:

    A = (1 + h alpha) M + (h beta + h^2) K_R,   K_R = sum R Ke R^T
    b = -h ((h + beta) K_R v + alpha M v + f_int - f_ext)
    A dv = b on the free nodes;  v' = v + dv;  q' = q + h v'

R is the polar factor of each tetrahedron's deformation gradient at q
(by SVD, flipped where det F < 0, as the upstream flips it). The solve is
block-Jacobi preconditioned CG in the reference's own precision.

Departures from the upstream: the upstream's PCG preconditions with the
diagonal of A (Jacobi) and the program with its 3 x 3 node blocks; the
two reach the same solution in other iteration counts, and the check
reads the solution, not the count. Fixed nodes are held by zero rows
here, by removed rows upstream: the same free-node system.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fem as rfem
from .field import Precision


def element_stiffness(x: np.ndarray, E: float, nu: float):
    """Per tetrahedron of the rest corners x [T, 4, 3] (float64): Ke
    [T, 12, 12], volume [T], inverse edge matrix [T, 3, 3] (columns the
    edges from corner 0)."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[range(3), range(3)] += 2 * mu
    C[3:, 3:] = mu * np.eye(3)
    dm = np.swapaxes(x[:, 1:] - x[:, :1], 1, 2)
    inv_dm = np.linalg.inv(dm)
    vol = np.abs(np.linalg.det(dm)) / 6.0
    g = np.concatenate([-inv_dm.sum(1, keepdims=True), inv_dm], 1)  # [T,4,3]
    B = np.zeros((len(x), 6, 12))
    for j in range(4):
        gx, gy, gz = g[:, j, 0], g[:, j, 1], g[:, j, 2]
        B[:, 0, 3 * j], B[:, 1, 3 * j + 1], B[:, 2, 3 * j + 2] = gx, gy, gz
        B[:, 3, 3 * j], B[:, 3, 3 * j + 1] = gy, gx
        B[:, 4, 3 * j + 1], B[:, 4, 3 * j + 2] = gz, gy
        B[:, 5, 3 * j], B[:, 5, 3 * j + 2] = gz, gx
    ke = np.einsum("tia,ij,tjb->tab", B, C, B) * vol[:, None, None]
    return ke, vol, inv_dm


class TetStep(rfem.Step):
    """The step on an unstructured mesh. It keeps the grid step's layout
    with one "cell" that holds every tetrahedron, so the grid step's
    operator, right side, rotations and solve run on it unchanged. `tol`
    and `max_iters` are the solve's stopping rule."""

    def __init__(self, nodes, tets, fixed, E: float, nu: float, rho: float,
                 h: float, damping_mass: float, damping_stiffness: float,
                 device, prec: Precision, tol: float = 1e-10,
                 max_iters: int = 10_000):
        self.prec, self.h = prec, h
        self.alpha, self.beta = damping_mass, damping_stiffness
        self.tol, self.max_iters = tol, max_iters
        dt = prec.dtype
        nodes = np.asarray(nodes, np.float64)
        tets = np.asarray(tets, np.int64)
        x0 = nodes[tets]                                        # [T, 4, 3]
        ke, vol, inv_dm = element_stiffness(x0, E, nu)
        self.ke = torch.as_tensor(ke, dtype=dt, device=device)
        self.x0 = torch.as_tensor(x0.reshape(-1, 12), dtype=dt,
                                  device=device)
        self.inv_dm = torch.as_tensor(inv_dm, dtype=dt, device=device)
        self.nodes = torch.as_tensor(tets[None], device=device)  # [1, T, 4]
        self.n = len(nodes)
        mass = np.zeros(self.n)
        np.add.at(mass, tets.reshape(-1), np.repeat(rho * vol / 4.0, 4))
        self.mass = torch.as_tensor(mass, dtype=dt, device=device)
        self.free = torch.as_tensor(~np.asarray(fixed, bool), device=device)
        self.mass_coef = 1.0 + h * damping_mass
        self.stiff_coef = h * damping_stiffness + h * h

    def _rot_ke(self, R, v12, rotate_in: bool):
        """sum over tetrahedra of R Ke (R^T v) -> [n, 3]."""
        shape = self.nodes.shape[:2]
        v = v12.reshape(*shape, 4, 3)
        if rotate_in:
            v = torch.einsum("ctba,ctjb->ctja", R, v)           # R^T v
        kv = self.prec.mm(v.reshape(*shape, 1, 12),
                          self.ke.transpose(1, 2)[None]).reshape(*shape, 4, 3)
        return self.scatter(torch.einsum("ctab,ctjb->ctja", R, kv))

    def solve(self, A, b, R, tol=None, max_iters=None):
        return super().solve(A, b, R, self.tol if tol is None else tol,
                             self.max_iters if max_iters is None
                             else max_iters)


def judge_step(step: TetStep, q0, v0, q1, v1, f_ext) -> dict:
    """Readings of one program step (q0, v0) -> (q1, v1) under f_ext,
    [N, 3] float64.

    Under a load, the scale is the larger of the step's own solution dv*
    and the load impulse x (A x = h f_ext), in A's energy norm (the load
    comes and goes with the probe's contact, and the tissue moves on
    where it is gone): `fem_energy_err` |dv - dv*|_A over that scale;
    `fem_update_err` how far q1 and v1 stand from the update rule applied
    to the program's own dv, max |gap| over max |h dv*|, |h x|.

    Under no load both read 0 and `fem_unloaded_gap` reads how far the
    program's q1 stands from the reference's q0 + h (v0 + dv*), max over
    the nodes, in length units (0 under a load). A tissue at rest under
    no load has no scale of its own: in float32 the program's rest
    forces are rounding, and the first steps move the nodes by that
    rounding, a relative error of about 1 of a motion of 1e-7."""
    R = step.rotations(q0)
    A = step.operator(R)
    free = step.free[:, None]
    dv_star = step.solve(A, step.rhs(R, q0, v0, f_ext), R)
    if not bool(torch.any(f_ext != 0.0)):
        q_star = torch.where(free, q0 + step.h * (v0 + dv_star), 0.0)
        return {"fem_energy_err": 0.0, "fem_update_err": 0.0,
                "fem_unloaded_gap": float(torch.amax(torch.abs(q1 - q_star)))}
    x = step.solve(A, torch.where(free, step.h * f_ext, 0.0), R)
    dv = torch.where(free, v1 - v0, 0.0)

    def energy(u):
        return float(torch.sqrt(torch.clamp(torch.sum(u * A(u)), min=0.0)))

    q_rule = torch.where(free, q0 + step.h * torch.where(free, v1, 0.0), 0.0)
    gap = float(torch.amax(torch.abs(q1 - q_rule)) + torch.amax(
        torch.abs(torch.where(free, 0.0, v1))))
    move = step.h * max(float(torch.amax(torch.abs(dv_star))),
                        float(torch.amax(torch.abs(x))))
    return {"fem_energy_err": energy(dv - dv_star)
            / max(energy(dv_star), energy(x)),
            "fem_update_err": gap / move, "fem_unloaded_gap": 0.0}
