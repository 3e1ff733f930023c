"""Corotational linear FEM: batched per-tet force/stiffness (Mueller 2004
warp, the reference default, vegafem corotationalLinearFEM.cpp:219-296
with warp=1) as batched tensor code.

PyTorch counterpart of fembrain_tpu/fem/corotational.py. Per tet:
deformation gradient F = Ds * inv(Dm), rotation R by polar decomposition
(Higham's scaled Newton iteration, differentiable, sign-fixed like the
reference's det<0 flip), internal force f_e = R Ke (R^T p - x0), and the
warped stiffness applied matrix-free: K_rot v = R Ke R^T v. Nodal
assembly is a gather and a sum in a fixed order (no atomics), so a CG
solve repeats bit for bit.

Every product that feeds the CG operator must run in full float32: with
low-precision multiplies (TF32, which the package turns off at import)
K_eff is perturbed by a fraction of a percent, which breaks the
operator's effective symmetry and definiteness and lets CG diverge at
production mesh sizes.
"""
from __future__ import annotations

import torch

from .tetmesh import FemMesh


def _det3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _inv3(m):
    """Batched 3x3 inverse via adjugate (differentiable, no LU)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def polar_rotation(F: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Rotation factor of batched 3x3 matrices via Higham's scaled Newton
    iteration R <- (g R + R^{-T} / g) / 2, g = sqrt(|R^{-1}|_F / |R|_F),
    with determinant sign fix (reference flips R when det < 0,
    corotationalLinearFEM.cpp:263-268). The scaling keeps the count of
    iterations small for a nearly flat tetrahedron (singular value 1e-6
    of the others): there the unscaled iteration needs about 30 and after
    12 leaves entries in the tens; the scaled one reaches float32's
    rounding in 8. On a well-shaped tetrahedron g is 1 to rounding and
    the two agree."""
    sign = torch.where(_det3(F) < 0, -1.0, 1.0)[..., None, None]
    # Normalize scale for fast convergence.
    scale = torch.sqrt(torch.clamp(torch.sum(F * F, (-2, -1)) / 3.0,
                                   min=1e-12))
    R = F / scale[..., None, None]
    for _ in range(iters):
        rit = _inv3(R).transpose(-1, -2)
        # Clamped both ways: a padding tetrahedron's F is zero (its
        # corners all node 0), and there g is 1 and R stays zero.
        g = torch.sqrt(torch.sqrt(
            torch.clamp(torch.sum(rit * rit, (-2, -1)), min=1e-30)
            / torch.clamp(torch.sum(R * R, (-2, -1)), min=1e-30)))
        g = g[..., None, None]
        R = 0.5 * (g * R + rit / g)
    return R * sign


def element_kinematics(mesh: FemMesh, u: torch.Tensor):
    """u: [N, 3] displacements -> (p [T,4,3] deformed corners, R [T,3,3])."""
    x = mesh.rest + u
    p = x[mesh.tets.long()]                           # [T,4,3]
    ds = (p[:, 1:] - p[:, :1]).transpose(1, 2)        # [T,3,3]
    return p, polar_rotation(ds @ mesh.inv_dm)


def internal_forces(mesh: FemMesh, u: torch.Tensor,
                    R: torch.Tensor) -> torch.Tensor:
    """Nodal internal forces [N, 3]: f_e = R Ke (R^T p - x0) per element,
    summed to nodes."""
    tets = mesh.tets.long()
    p = (mesh.rest + u)[tets].reshape(-1, 12)         # [T, 12]
    x0 = mesh.rest[tets].reshape(-1, 12)
    rp = _blockT_apply(R, p)                          # R^T p
    fe = _block_apply(R, _ke_apply(mesh.ke, rp - x0))  # R Ke (R^T p - x0)
    return _scatter_nodes(mesh, fe)


def stiffness_apply(mesh: FemMesh, R: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Matrix-free K_rot v for v [N,3]: per-element R Ke R^T, assembled."""
    ve = v[mesh.tets.long()].reshape(-1, 12)
    we = _block_apply(R, _ke_apply(mesh.ke, _blockT_apply(R, ve)))
    return _scatter_nodes(mesh, we)


def rotated_stiffness(mesh: FemMesh, R: torch.Tensor) -> torch.Tensor:
    """Warped element stiffness K_rot = blockdiag(R) Ke blockdiag(R)^T,
    materialized [T,12,12]. R is constant across a CG solve, so computing
    this once per timestep turns the per-iteration matvec into a single
    batched 12x12 product (vs 3 products in stiffness_apply)."""
    keb = mesh.ke.reshape(-1, 4, 3, 4, 3)
    tmp = torch.einsum("tap,tjpkq->tjakq", R, keb)
    krot = torch.einsum("tjakq,tbq->tjakb", tmp, R)
    return krot.reshape(-1, 12, 12)


def stiffness_apply_pre(mesh: FemMesh, krot: torch.Tensor, v: torch.Tensor):
    """K_rot v using the precomputed per-element rotated stiffness."""
    ve = v[mesh.tets.long()].reshape(-1, 12)
    return _scatter_nodes(mesh, _ke_apply(krot, ve))


def stiffness_blocks(mesh: FemMesh, krot: torch.Tensor) -> torch.Tensor:
    """Per-node 3x3 diagonal blocks of the assembled K_rot: [N,3,3].
    Feeds the block-Jacobi preconditioner (a strict upgrade over the
    reference's scalar Jacobi, vegafem sparseSolver/CGSolver.cpp)."""
    kb = krot.reshape(-1, 4, 3, 4, 3)
    corner = torch.stack([kb[:, j, :, j, :] for j in range(4)], 1)  # [T,4,3,3]
    out = _scatter_nodes(mesh, corner.reshape(-1, 4, 9))
    return out.reshape(-1, 3, 3)


def stiffness_diag(mesh: FemMesh, R: torch.Tensor) -> torch.Tensor:
    """diag(K_rot) [N,3] for the Jacobi preconditioner:
    (R Ke R^T)[3j+a, 3j+a] = sum_bc R[a,b] Ke[3j+b, 3j+c] R[a,c]."""
    keb = mesh.ke.reshape(-1, 4, 3, 4, 3)
    # only the j==j' corner blocks contribute to the diagonal
    kjj = torch.stack([keb[:, j, :, j, :] for j in range(4)], 1)  # [T,4,3,3]
    d = torch.einsum("tab,tjbc,tac->tja", R, kjj, R)              # [T,4,3]
    return _scatter_nodes(mesh, d)


def _ke_apply(ke, v12):
    return (ke @ v12[..., None])[..., 0]


def _block_apply(R, v12):
    """Apply blockdiag(R,R,R,R) to [T,12]."""
    v = v12.reshape(-1, 4, 3)
    return torch.einsum("tab,tjb->tja", R, v).reshape(-1, 12)


def _blockT_apply(R, v12):
    v = v12.reshape(-1, 4, 3)
    return torch.einsum("tba,tjb->tja", R, v).reshape(-1, 12)


def _scatter_nodes(mesh: FemMesh, fe) -> torch.Tensor:
    """Element -> node assembly in gather form: pad the [T*4, W] slot
    array with one zero row, gather each node's incident slots
    (mesh.node_gather) and sum. Equal to an index-add scatter, but the
    order of the sum is fixed: index_add_ on a CUDA tensor sums with
    atomics in an order that changes from run to run, and CG iteration
    counts then wander. Meshes without a gather map (shard-local tet
    partitions) scatter. fe may carry any trailing payload width W (3 for
    forces, 9 for the 3x3 preconditioner blocks)."""
    slots = fe.reshape(mesh.tets.shape[0] * 4, -1)
    w = slots.shape[1]
    if mesh.node_gather is None:
        out = slots.new_zeros((mesh.n_nodes, w))
        return out.index_add(0, mesh.tets.reshape(-1).long(), slots)
    slots = torch.cat([slots, slots.new_zeros((1, w))], 0)
    return torch.sum(slots[mesh.node_gather.long()], 1)
