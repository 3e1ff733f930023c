"""Multi-device FEM: tetrahedra split across the ranks.

PyTorch counterpart of fembrain_tpu/fem/sharded.py. Element work (the
corotational force and stiffness products, the FLOPs) is split along a
`tets` mesh axis; nodal state (q, qdot, small) is replicated, and each
rank's partial nodal assembly is summed with one all_reduce: forces,
every K v of the CG loop and the diagonal each take one, and nothing
else travels. The CG loop runs replicated on every rank, with the split
matvec inside, and its point-Jacobi preconditioner as in the reference's
sharded step.
"""
from __future__ import annotations

import dataclasses

import torch

from ..parallel import sharding as sh
from . import corotational as co
from . import integrator as integ
from .integrator import FemState
from .tetmesh import FemMesh

TET_AXIS = "tets"


def make_tet_mesh_axis(n_devices: int | None = None):
    return sh.make_mesh(n_devices, TET_AXIS)


def pad_mesh_for_sharding(mesh: FemMesh, n_shards: int) -> FemMesh:
    """Pad element arrays so the tet count divides the mesh axis; padding
    tets are degenerate no-ops (zero stiffness/volume, node 0 corners)."""
    t = mesh.n_tets
    rem = (-t) % n_shards
    if rem == 0:
        return mesh
    eye = torch.eye(3, dtype=mesh.inv_dm.dtype, device=mesh.inv_dm.device)
    return dataclasses.replace(
        mesh,
        tets=torch.cat([mesh.tets, mesh.tets.new_zeros((rem, 4))]),
        inv_dm=torch.cat([mesh.inv_dm, eye.expand(rem, 3, 3)]),
        volume=torch.cat([mesh.volume, mesh.volume.new_zeros(rem)]),
        ke=torch.cat([mesh.ke, mesh.ke.new_zeros((rem, 12, 12))]),
        n_tets=t + rem,
    )


def place_sharded(mesh: FemMesh, device_mesh, device=None) -> FemMesh:
    """This rank's mesh: its equal block of the element arrays (the tet
    count must divide the axis: pad_mesh_for_sharding) and the nodal
    arrays whole, on `device` (default: where they are). Shard-local
    assembly scatters by index (no global gather map)."""
    n, idx = sh.shard_index(device_mesh)
    if mesh.n_tets % n:
        raise ValueError(f"{mesh.n_tets} tets do not split over {n} ranks: "
                         f"pad_mesh_for_sharding first")
    per = mesh.n_tets // n
    sl = slice(idx * per, (idx + 1) * per)
    dev = mesh.rest.device if device is None else device
    return dataclasses.replace(
        mesh,
        tets=mesh.tets[sl].to(dev), inv_dm=mesh.inv_dm[sl].to(dev),
        volume=mesh.volume[sl].to(dev), ke=mesh.ke[sl].to(dev),
        rest=mesh.rest.to(dev), mass=mesh.mass.to(dev),
        fixed=mesh.fixed.to(dev), node_gather=None, n_tets=per,
    )


def _shard_fns(mesh: FemMesh, device_mesh):
    """This rank's element kinematics, and the force, K v and diagonal
    assemblies each summed over the ranks by one all_reduce."""
    group = device_mesh.get_group()
    mesh = dataclasses.replace(mesh, tets=mesh.tets.long())

    def rotations(u):
        return co.element_kinematics(mesh, u)[1]

    def forces(R, u):
        return sh.all_reduce(co.internal_forces(mesh, u, R), group)

    def k_apply(R, v):
        return sh.all_reduce(co.stiffness_apply(mesh, R, v), group)

    def k_diag(R):
        return sh.all_reduce(co.stiffness_diag(mesh, R), group)

    return rotations, forces, k_apply, k_diag


def sharded_timestep(
    mesh: FemMesh,
    device_mesh,
    state: FemState,
    f_ext: torch.Tensor,
    h: float = integ.DEFAULT_TIMESTEP,
    damping_mass: float = integ.DEFAULT_DAMPING_MASS,
    damping_stiffness: float = integ.DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = integ.CG_TOL,
    cg_max_iters: int = integ.CG_MAX_ITERS,
) -> tuple[FemState, int]:
    """One implicit step with this rank's element block (place_sharded)
    and the replicated state and f_ext [N, 3]; returns the replicated
    (FemState(q, qvel), cg_iterations). Semantics of integrator.timestep
    (tested equal), with the reference's point-Jacobi preconditioner."""
    rotations, forces, k_apply, k_diag = _shard_fns(mesh, device_mesh)
    free = ~mesh.fixed[:, None]

    R = rotations(state.q)
    f_int = forces(R, state.q)
    m = mesh.mass[:, None]

    kq = k_apply(R, state.qvel)
    residual = -h * (
        (h + damping_stiffness) * kq
        + damping_mass * m * state.qvel
        + f_int
        - f_ext
    )
    residual = torch.where(free, residual, 0.0)

    mass_coef = 1.0 + h * damping_mass
    stiff_coef = h * damping_stiffness + h * h

    def matvec(v):
        vf = torch.where(free, v, 0.0)
        out = mass_coef * m * vf + stiff_coef * k_apply(R, vf)
        return torch.where(free, out, v)

    diag = mass_coef * torch.broadcast_to(m, residual.shape) + (
        stiff_coef * k_diag(R)
    )
    diag = torch.where(free, diag, 1.0)
    inv_diag = 1.0 / torch.where(torch.abs(diag) < 1e-30, 1.0, diag)

    dv, iters = integ.pcg(matvec, residual, lambda r: r * inv_diag, cg_tol,
                          cg_max_iters)
    qvel = torch.where(free, state.qvel + dv, 0.0)
    q = torch.where(free, state.q + h * qvel, 0.0)
    return FemState(q=q, qvel=qvel), iters
