"""FEM tetrahedral mesh: precomputed element matrices + lumped mass.

PyTorch counterpart of fembrain_tpu/fem/tetmesh.py (the reference's Vega
`TetMesh` with its element stiffness precomputation and lumped mass
assembly): host float64 numpy, then tensors on the device. Default
material matches the reference: E = 1e7 Pa, nu = 0.46, rho = 1000
(src/deformable/Deformable.cpp:178).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device

DEFAULT_E = 1e7
DEFAULT_NU = 0.46
DEFAULT_RHO = 1000.0


@dataclasses.dataclass(frozen=True)
class FemMesh:
    """Static-topology FEM mesh; the float tensors are differentiable
    (material and rest-shape gradients flow through the simulation)."""

    rest: torch.Tensor        # [N, 3] rest positions
    tets: torch.Tensor        # [T, 4] int32 node indices
    inv_dm: torch.Tensor      # [T, 3, 3] inverse rest edge matrices
    volume: torch.Tensor      # [T] rest volumes
    ke: torch.Tensor          # [T, 12, 12] undeformed element stiffness
    mass: torch.Tensor        # [N] lumped nodal mass
    fixed: torch.Tensor       # [N] bool, fixed vertices (all 3 DOFs)
    # Transposed assembly: per node, the (tet*4 + corner) slots that
    # scatter into it, padded with T*4 (a zero slot). Assembly is then a
    # gather and a sum over the incidence axis, in one fixed order. None
    # (shard-local meshes, whose slot spaces differ) falls back to
    # index-add assembly.
    node_gather: torch.Tensor | None = None
    n_nodes: int = 0
    n_tets: int = 0

    @property
    def dof(self) -> int:
        return 3 * self.n_nodes


def _element_stiffness(verts: np.ndarray, E: float, nu: float):
    """Linear isotropic tet stiffness Ke [12,12], volume, inv(Dm).

    Standard B^T C B formulation (what Vega's StVKTetABCD/corotational
    setup computes for linear tets)."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] += 2 * mu
    C[3:, 3:] = mu * np.eye(3)

    p0 = verts[:, 0]
    dm = verts[:, 1:] - p0[:, None, :]          # [T,3,3] columns? rows=edges
    dm = np.swapaxes(dm, 1, 2)                   # [T,3(coord),3(edge)]
    det = np.linalg.det(dm)
    vol = det / 6.0
    inv_dm = np.linalg.inv(dm)

    # Shape-function gradients: N_j(x) = (inv(Dm) (x - p0))_j for j=1..3,
    # so grad N_j is ROW j of inv(Dm); grad N_0 = -sum.
    g = inv_dm                                    # [T, 3(node j), 3(coord)]
    g0 = -g.sum(1, keepdims=True)
    grads = np.concatenate([g0, g], 1)           # [T, 4, 3]

    T_ = verts.shape[0]
    B = np.zeros((T_, 6, 12))
    for j in range(4):
        gx, gy, gz = grads[:, j, 0], grads[:, j, 1], grads[:, j, 2]
        B[:, 0, 3 * j + 0] = gx
        B[:, 1, 3 * j + 1] = gy
        B[:, 2, 3 * j + 2] = gz
        B[:, 3, 3 * j + 0] = gy
        B[:, 3, 3 * j + 1] = gx
        B[:, 4, 3 * j + 1] = gz
        B[:, 4, 3 * j + 2] = gy
        B[:, 5, 3 * j + 0] = gz
        B[:, 5, 3 * j + 2] = gx

    ke = np.einsum("tia,ij,tjb->tab", B, C, B) * vol[:, None, None]
    return ke, vol, inv_dm, grads


def build_fem_mesh(
    nodes: np.ndarray,
    tets: np.ndarray,
    fixed: np.ndarray | None = None,
    E: float = DEFAULT_E,
    nu: float = DEFAULT_NU,
    rho: float = DEFAULT_RHO,
    dtype=torch.float32,
    device: torch.device | str | None = None,
) -> FemMesh:
    """FemMesh from host arrays: nodes [N, 3], tets [T, 4], `fixed` a bool
    mask over the nodes or an array of node indices. Tensors land on
    `device` (the card when None). Raises ValueError on inverted tets."""
    device = default_device() if device is None else device
    nodes = np.asarray(nodes, np.float64)
    tets = np.asarray(tets, np.int32)
    ke, vol, inv_dm, _ = _element_stiffness(nodes[tets], E, nu)
    if np.any(vol <= 0):
        raise ValueError(f"{int((vol <= 0).sum())} inverted/degenerate tets")

    # Lumped mass: rho * V / 4 to each corner
    # (vegafem/volumetricMesh/generateMassMatrix.cpp lumped path).
    mass = np.zeros(len(nodes))
    np.add.at(mass, tets.reshape(-1), np.repeat(rho * vol / 4.0, 4))

    fixed_mask = np.zeros(len(nodes), bool)
    if fixed is not None:
        fixed = np.asarray(fixed)
        if fixed.dtype == bool:
            # A bool mask is a mask, not the indices {0, 1}.
            fixed_mask[: len(fixed)] = fixed[: len(nodes)]
        else:
            fixed_mask[fixed.astype(np.int64)] = True

    # Transposed (gather-form) assembly map: slots sorted by node.
    flat_nodes = tets.reshape(-1)                 # slot s touches node
    order = np.argsort(flat_nodes, kind="stable")
    counts = np.bincount(flat_nodes, minlength=len(nodes))
    K = int(counts.max()) if len(counts) else 1
    node_gather = np.full((len(nodes), K), len(flat_nodes), np.int32)
    col = np.concatenate([np.arange(c) for c in counts]) if K else None
    node_gather[flat_nodes[order], col] = order.astype(np.int32)

    def dev(a, dt=None):
        return torch.tensor(a, dtype=dt, device=device)

    return FemMesh(
        rest=dev(nodes, dtype),
        tets=dev(tets),
        inv_dm=dev(inv_dm, dtype),
        volume=dev(vol, dtype),
        ke=dev(ke, dtype),
        mass=dev(mass, dtype),
        fixed=dev(fixed_mask),
        node_gather=dev(node_gather),
        n_nodes=int(len(nodes)),
        n_tets=int(len(tets)),
    )
