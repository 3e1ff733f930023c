"""Grid-structured corotational FEM: the production solver of the
coupled frame.

PyTorch counterpart of fembrain_tpu/fem/grid_fem.py. The
embedded tet mesh is 6 Kuhn tets per active voxel of a regular grid, so
displacements live dense on the grid, corner access is 8 static slices,
assembly is 8 padded adds, and the six shared element stiffnesses apply
as one [72,72] block-diagonal product over all cells. Hot arrays are
channel-major with the flattened cell axis last ([12, C], [3, 3, C]). A
geometric multigrid V-cycle preconditions CG.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .. import default_device
from ..mesh import tables as T
from ..mesh.polygonize import GridSpec, TetMesh
from ..utils.profiler import span
from .integrator import (
    CG_MAX_ITERS,
    CG_TOL,
    DEFAULT_DAMPING_MASS,
    DEFAULT_DAMPING_STIFFNESS,
    DEFAULT_TIMESTEP,
    FemState,
    pcg,
    pcg_start,
    pcg_update,
    symmetric_solve,
)
from .tetmesh import DEFAULT_E, DEFAULT_NU, DEFAULT_RHO, _element_stiffness

# Per-corner lumped-mass weights: corner b of a cell receives
# (#tets containing b) / 24 of the cell's mass.
_CORNER_MASS_W = np.zeros(8)
for _k in range(6):
    for _j in range(4):
        _CORNER_MASS_W[T.TET_CORNERS[_k, _j]] += 1.0 / 24.0

# Damped block-Jacobi smoother inside the V-cycle.
_OMEGA = 0.6
_NU_SMOOTH = 1

_POLAR_ITERS = 6


def _kuhn_elements(cellsize: float, E: float, nu: float):
    """Shared element data for the 6 Kuhn tets of an s-cube (float64):
    ke [6,12,12], inv_dm [6,3,3], rest corner positions x0 [6,4,3]."""
    corners = T.CORNER_OFFSET.astype(np.float64) * cellsize  # [8,3]
    verts = corners[T.TET_CORNERS]                           # [6,4,3]
    ke, vol, inv_dm, _ = _element_stiffness(verts, E, nu)
    assert np.all(vol > 0)
    return ke, inv_dm, verts


def _linear_diag_blocks_table(ke: np.ndarray) -> np.ndarray:
    """[8,3,3] per-cube-corner diagonal stiffness blocks."""
    out = np.zeros((8, 3, 3))
    for k in range(6):
        for j in range(4):
            b = T.TET_CORNERS[k, j]
            out[b] += ke[k, 3 * j : 3 * j + 3, 3 * j : 3 * j + 3]
    return out


@dataclasses.dataclass(frozen=True)
class GridLevel:
    """One multigrid level: the linear (rest, R = I) elasticity operator
    on its own vertex grid, rediscretized at this level's cell size."""

    cellw: torch.Tensor   # [CX*CY*CZ] cell weights (1 = active)
    free: torch.Tensor    # [X,Y,Z] bool — active node and not fixed
    mass: torch.Tensor    # [X,Y,Z] lumped mass
    ke: torch.Tensor      # [6,12,12] shared element stiffness
    kdiag: torch.Tensor   # [3,3,X*Y*Z] assembled linear diag blocks of K
    # Coarsest level only: dense K [D,D] with fixed rows/cols zeroed and
    # the free mask [D] for a direct coarse solve.
    k_dense: torch.Tensor | None = None
    free_dense: torch.Tensor | None = None
    dims: tuple[int, int, int] = (0, 0, 0)


@dataclasses.dataclass(frozen=True)
class GridFem:
    """Grid FEM mesh: fine level + coarser multigrid levels."""

    cellw: torch.Tensor   # [CX*CY*CZ] active-cell weights
    free: torch.Tensor    # [X,Y,Z] bool
    active: torch.Tensor  # [X,Y,Z] bool (tet nodes)
    mass: torch.Tensor    # [X,Y,Z]
    ke: torch.Tensor      # [6,12,12]
    inv_dm: torch.Tensor  # [6,3,3]
    x0: torch.Tensor      # [6,12] rest corner positions within a cell
    kdiag: torch.Tensor   # [3,3,X*Y*Z] linear diag blocks
    levels: tuple[GridLevel, ...]
    # Coarse-level operator inverse precomputed on the host for the
    # default (mass_coef, stiff_coef); rebuilt per step otherwise.
    coarse_inv: torch.Tensor | None = None
    coarse_coefs: tuple[float, float] = (0.0, 0.0)
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    dims: tuple[int, int, int] = (0, 0, 0)
    cellsize: float = 0.0

    def rest_state(self) -> FemState:
        z = torch.zeros((*self.dims, 3), dtype=self.mass.dtype,
                        device=self.mass.device)
        return FemState(q=z, qvel=z, dv=z)


# ----------------------------------------------------- channel-major core
#
# Vectors over cells are [12, C] (corner-coord channels leading, flattened
# cells last); 3x3 matrix fields are [3, 3, C]; grid vectors [3, X, Y, Z].

def _cm(u):
    """[X,Y,Z,3] -> [3,X,Y,Z]."""
    return torch.movedim(u, -1, 0)


def _un_cm(u3):
    return torch.movedim(u3, 0, -1)


def _corner_rows(dims, u3):
    """u3 [3,X,Y,Z] -> list of 8 [3, C] corner-value blocks."""
    X, Y, Z = dims
    out = []
    for b in range(8):
        ox, oy, oz = (int(t) for t in T.CORNER_OFFSET[b])
        sl = u3[:, ox : ox + X - 1, oy : oy + Y - 1, oz : oz + Z - 1]
        out.append(sl.reshape(3, -1))
    return out


def _scatter_rows(dims, acc):
    """acc: list of 8 [3, C] corner contributions -> [3,X,Y,Z] nodal
    sums (adjoint of _corner_rows: 8 padded adds, no scatter)."""
    X, Y, Z = dims
    out = None
    for b in range(8):
        if acc[b] is None:
            continue
        ox, oy, oz = (int(t) for t in T.CORNER_OFFSET[b])
        p = torch.nn.functional.pad(
            acc[b].reshape(3, X - 1, Y - 1, Z - 1),
            (oz, 1 - oz, oy, 1 - oy, ox, 1 - ox),
        )
        out = p if out is None else out + p
    return out


def _ke_blockdiag(ke):
    """[6,12,12] per-tet element stiffness -> [72,72] block diagonal, so
    all six tets' stiffness applies run as one [72,72]x[72,C] product."""
    return torch.block_diag(*ke.unbind(0))


def _tet_rows(corners, k):
    """[12, C] displacement/position rows of tet k (static corner picks)."""
    return torch.cat(
        [corners[int(T.TET_CORNERS[k, j])] for j in range(4)], dim=0
    )


def _rot_rows(R, v12, transpose=False):
    """Apply blockdiag(R) (or R^T) to [12, C] given R [3, 3, C]."""
    outs = []
    for j in range(4):
        for a in range(3):
            s = None
            for b in range(3):
                r = R[b, a] if transpose else R[a, b]
                t = r * v12[3 * j + b]
                s = t if s is None else s + t
            outs.append(s)
    return torch.stack(outs, 0)


def _inv3_cm(m):
    """Inverse of a [3,3,C] matrix field via adjugate."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    rows = [
        [A, -(b * i - c * h), b * f - c * e],
        [B, a * i - c * g, -(a * f - c * d)],
        [C, -(a * h - b * g), a * e - b * d],
    ]
    return torch.stack(
        [torch.stack([rows[r][s] / det for s in range(3)], 0)
         for r in range(3)],
        0,
    )


def _det3_cm(m):
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _polar_cm(F, iters=_POLAR_ITERS):
    """Rotation factor of a [3,3,C] matrix field (Higham iteration with
    det-sign fix)."""
    sign = torch.where(_det3_cm(F) < 0, -1.0, 1.0)
    scale = torch.sqrt(torch.clamp(torch.sum(F * F, (0, 1)) / 3.0, min=1e-12))
    R = F / scale
    for _ in range(iters):
        R = 0.5 * (R + torch.transpose(_inv3_cm(R), 0, 1))
    return R * sign


def kinematics(gf: GridFem, q: torch.Tensor) -> torch.Tensor:
    """Corotational rotations [6, 3, 3, C] from grid displacements q
    [X,Y,Z,3] (F = I + Du per Kuhn tet, polar decomposition)."""
    corners = _corner_rows(gf.dims, _cm(q))
    Fs = []
    for k in range(6):
        du = _tet_rows(corners, k)                    # [12, C]
        rows = []
        for a in range(3):
            row = []
            for b in range(3):
                s = None
                for e in range(3):
                    t = (du[3 * (e + 1) + a] - du[a]) * gf.inv_dm[k, e, b]
                    s = t if s is None else s + t
                row.append(s + (1.0 if a == b else 0.0))
            rows.append(torch.stack(row, 0))
        Fs.append(torch.stack(rows, 0))               # [3,3,C]
    R6 = _polar_cm(torch.cat(Fs, dim=-1))             # [3,3,6C]
    C = Fs[0].shape[-1]
    return torch.stack([R6[..., k * C : (k + 1) * C] for k in range(6)], 0)


def _apply_tets(gf, R, corners, with_x0):
    """Shared per-tet channel-major pipeline:
      with_x0=True : f_e = R Ke (R^T (u + x0) - x0)   (internal forces)
      with_x0=False: f_e = R Ke R^T u                 (stiffness apply)
    corners: list of 8 [3, C]; returns [3,X,Y,Z]."""
    acc = [None] * 8
    rvs = []
    for k in range(6):
        v = _tet_rows(corners, k)                     # [12, C]
        if with_x0:
            v = v + gf.x0[k][:, None]
        rv = _rot_rows(R[k], v, transpose=True)
        if with_x0:
            rv = rv - gf.x0[k][:, None]
        rvs.append(rv)
    w72 = torch.matmul(_ke_blockdiag(gf.ke), torch.cat(rvs, 0))
    for k in range(6):
        fw = _rot_rows(R[k], w72[12 * k : 12 * k + 12]) * gf.cellw
        for j in range(4):
            b = int(T.TET_CORNERS[k, j])
            c = fw[3 * j : 3 * j + 3]
            acc[b] = c if acc[b] is None else acc[b] + c
    return _scatter_rows(gf.dims, acc)


def internal_forces(gf: GridFem, q: torch.Tensor, R: torch.Tensor):
    """Nodal internal forces [X,Y,Z,3]: f_e = R Ke (R^T p - x0) per tet."""
    corners = _corner_rows(gf.dims, _cm(q))
    return _un_cm(_apply_tets(gf, R, corners, with_x0=True))


def stiffness_apply_rot(gf: GridFem, R: torch.Tensor, v: torch.Tensor):
    """Matrix-free K_rot v on the grid — the CG matvec. v [X,Y,Z,3]."""
    corners = _corner_rows(gf.dims, _cm(v))
    return _un_cm(_apply_tets(gf, R, corners, with_x0=False))


def _stiffness_apply_linear(dims, cellw, ke, v3):
    """Rest (R = I) stiffness apply — the multigrid level operator.
    v3 [3,X,Y,Z] -> [3,X,Y,Z]."""
    corners = _corner_rows(dims, v3)
    acc = [None] * 8
    v72 = torch.cat([_tet_rows(corners, k) for k in range(6)], 0)
    w72 = torch.matmul(_ke_blockdiag(ke), v72)
    for k in range(6):
        w = w72[12 * k : 12 * k + 12] * cellw
        for j in range(4):
            b = int(T.TET_CORNERS[k, j])
            c = w[3 * j : 3 * j + 3]
            acc[b] = c if acc[b] is None else acc[b] + c
    return _scatter_rows(dims, acc)


# ------------------------------------------------ multigrid transfer ops

def _prolong_axis(a: torch.Tensor, fine_n: int, axis: int) -> torch.Tensor:
    """Linear interpolation along one axis: coarse size nc -> fine size
    fine_n, fine 2i <- c[i], fine 2i+1 <- (c[i] + c[i+1]) / 2."""
    a = torch.movedim(a, axis, 0)
    ne = (fine_n + 1) // 2
    no = fine_n // 2
    even = a[:ne]
    odd = 0.5 * (a[:no] + a[1 : no + 1])
    if no < ne:
        odd = torch.cat([odd, torch.zeros_like(a[:1])], 0)
    out = torch.stack([even, odd], dim=1).reshape(2 * ne, *a.shape[1:])
    return torch.movedim(out[:fine_n], 0, axis)


def _restrict_axis(r: torch.Tensor, coarse_n: int, axis: int) -> torch.Tensor:
    """Adjoint of _prolong_axis (full weighting)."""
    r = torch.movedim(r, axis, 0)
    even = r[0::2]
    odd = r[1::2]
    zero = torch.zeros_like(r[:1])

    def fit(x, n):
        if x.shape[0] < n:
            reps = zero.expand(n - x.shape[0], *x.shape[1:])
            return torch.cat([x, reps], 0)
        return x[:n]

    out = fit(even, coarse_n)
    out = out + 0.5 * fit(odd, coarse_n)
    out = out + 0.5 * fit(torch.cat([zero, odd], 0), coarse_n)
    return torch.movedim(out, 0, axis)


def prolong(z: torch.Tensor, fine_dims) -> torch.Tensor:
    """[3, Xc, Yc, Zc] -> [3, X, Y, Z] trilinear prolongation."""
    for ax, n in enumerate(fine_dims):
        z = _prolong_axis(z, n, ax + 1)
    return z


def restrict(r: torch.Tensor, coarse_dims) -> torch.Tensor:
    """[3, X, Y, Z] -> [3, Xc, Yc, Zc], exact adjoint of prolong."""
    for ax, n in enumerate(coarse_dims):
        r = _restrict_axis(r, n, ax + 1)
    return r


# ------------------------------------------------------------ V-cycle

def _level_matvec(lvl: GridLevel, mc, sc, v3):
    free = lvl.free[None]
    vf = torch.where(free, v3, 0.0)
    out = mc * lvl.mass[None] * vf + sc * _stiffness_apply_linear(
        lvl.dims, lvl.cellw, lvl.ke, vf
    )
    return torch.where(free, out, v3)


def _level_inv_blocks(lvl: GridLevel, mc, sc):
    """[3,3,N] inverse diagonal blocks of the level operator."""
    mflat = lvl.mass.reshape(-1)
    eye = torch.eye(3, dtype=mflat.dtype, device=mflat.device)[..., None]
    blocks = (mc * mflat) * eye + sc * lvl.kdiag
    freef = lvl.free.reshape(-1)[None, None]
    return _inv3_cm(torch.where(freef, blocks, eye))


def _block_apply(inv_b, r3):
    """inv_b [3,3,N] applied to r3 [3,X,Y,Z]."""
    r = r3.reshape(3, -1)
    out = torch.stack(
        [inv_b[a, 0] * r[0] + inv_b[a, 1] * r[1] + inv_b[a, 2] * r[2]
         for a in range(3)],
        0,
    )
    return out.reshape(r3.shape)


def _smooth(lvl, mc, sc, inv_b, r, z, sweeps):
    """Damped block-Jacobi iterations toward A z = r."""
    for _ in range(sweeps):
        resid = r - _level_matvec(lvl, mc, sc, z)
        z = z + _OMEGA * _block_apply(inv_b, resid)
    return z


def mg_setup(levels: tuple[GridLevel, ...], mc, sc, coarse_inv=None):
    """Per-solve preconditioner setup: smoother inverse blocks per level
    and the dense inverse of the coarsest-level operator (pass the host-
    precomputed GridFem.coarse_inv for the default coefficients)."""
    inv_bs = [_level_inv_blocks(lvl, mc, sc) for lvl in levels]
    coarse = levels[-1]
    if coarse_inv is None and coarse.k_dense is not None:
        mass3 = coarse.mass.reshape(-1).repeat(3)
        fr = coarse.free_dense
        a = sc * coarse.k_dense + torch.diag(mc * mass3 * fr + (1.0 - fr))
        coarse_inv = torch.linalg.inv(a)
    return inv_bs, coarse_inv


def vcycle(levels: tuple[GridLevel, ...], mc, sc, r: torch.Tensor,
           setup=None):
    """One symmetric V(1,1) multigrid cycle on the linear rest operator —
    the CG preconditioner — with a direct dense solve on the coarsest
    level. Operates on [X,Y,Z,3] residuals."""
    if setup is None:
        setup = mg_setup(levels, mc, sc)
    inv_bs, coarse_inv = setup

    def cycle(i, r3):
        lvl = levels[i]
        free = lvl.free[None]
        r3 = torch.where(free, r3, 0.0)
        if i == len(levels) - 1:
            if coarse_inv is not None:
                z = (coarse_inv @ r3.reshape(-1)).reshape(r3.shape)
                return torch.where(free, z, 0.0)
            return _smooth(lvl, mc, sc, inv_bs[i], r3, torch.zeros_like(r3), 8)
        z = _smooth(lvl, mc, sc, inv_bs[i], r3, torch.zeros_like(r3),
                    _NU_SMOOTH)
        resid = r3 - _level_matvec(lvl, mc, sc, z)
        rc = restrict(torch.where(free, resid, 0.0), levels[i + 1].dims)
        zc = cycle(i + 1, rc)
        z = z + torch.where(free, prolong(zc, lvl.dims), 0.0)
        return _smooth(lvl, mc, sc, inv_bs[i], r3, z, _NU_SMOOTH)

    return _un_cm(cycle(0, _cm(r)))


# ------------------------------------------------------------- builders

def _coarsen_masks(cell_mask: np.ndarray, fixed: np.ndarray):
    """(coarse cell mask, coarse fixed) from fine masks. Coarse cells
    cover 2x2x2 fine cells (any active -> active); coarse fixed is the
    coincident (even-index) fine vertex's flag."""
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    Xc, Yc, Zc = X // 2 + 1, Y // 2 + 1, Z // 2 + 1
    cm = np.zeros((Xc - 1, Yc - 1, Zc - 1), bool)
    for ox in range(2):
        for oy in range(2):
            for oz in range(2):
                sub = cell_mask[ox::2, oy::2, oz::2]
                cm[: sub.shape[0], : sub.shape[1], : sub.shape[2]] |= sub
    fx = np.zeros((Xc, Yc, Zc), bool)
    sub = fixed[::2, ::2, ::2]
    fx[: sub.shape[0], : sub.shape[1], : sub.shape[2]] = sub
    return cm, fx


def _active_from_cells(cell_mask: np.ndarray) -> np.ndarray:
    """Vertex active mask: any incident active cell (extract_tet_mesh's
    node rule)."""
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    pad = np.pad(cell_mask, 1)
    act = np.zeros((X, Y, Z), bool)
    for b in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
        act |= pad[1 - ox : 1 - ox + X, 1 - oy : 1 - oy + Y,
                   1 - oz : 1 - oz + Z]
    return act


def _mass_grid(cell_mask: np.ndarray, cellsize: float, rho: float):
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    cellm = cell_mask.astype(np.float64) * (rho * cellsize**3)
    pad = np.pad(cellm, 1)
    mass = np.zeros((X, Y, Z))
    for b in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
        mass += _CORNER_MASS_W[b] * pad[
            1 - ox : 1 - ox + X, 1 - oy : 1 - oy + Y, 1 - oz : 1 - oz + Z
        ]
    return mass


def _kdiag_grid(cell_mask: np.ndarray, ke: np.ndarray):
    """[3,3,X*Y*Z] assembled linear diagonal blocks."""
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    tab = _linear_diag_blocks_table(ke)                # [8,3,3]
    pad = np.pad(cell_mask.astype(np.float64), 1)
    out = np.zeros((X, Y, Z, 3, 3))
    for b in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
        w = pad[1 - ox : 1 - ox + X, 1 - oy : 1 - oy + Y,
                1 - oz : 1 - oz + Z]
        out += w[..., None, None] * tab[b]
    return np.moveaxis(out.reshape(-1, 3, 3), 0, -1)


_DENSE_COARSE_MAX_DOF = 2048


def _assemble_dense(cell_mask: np.ndarray, ke: np.ndarray,
                    free: np.ndarray):
    """Dense assembled linear stiffness of one (small) level, fixed
    rows/cols zeroed. DOF ordering matches the channel-major flatten of
    [3, X, Y, Z]: dof = coord * n_verts + flat_vertex."""
    X, Y, Z = (d + 1 for d in cell_mask.shape)
    n = X * Y * Z
    K = np.zeros((3 * n, 3 * n))
    for ci, cj, ck in zip(*np.nonzero(cell_mask)):
        vids = []
        for b in range(8):
            ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
            vids.append((ci + ox) * Y * Z + (cj + oy) * Z + (ck + oz))
        for k in range(6):
            gdof = []
            for j in range(4):
                v = vids[T.TET_CORNERS[k, j]]
                gdof.extend(a * n + v for a in range(3))
            # local ke ordering is [corner j * 3 + coord a]
            K[np.ix_(gdof, gdof)] += ke[k]
    fr = free.reshape(-1)
    fd = np.concatenate([fr, fr, fr]).astype(np.float64)
    K = K * fd[:, None] * fd[None, :]
    return K, fd


def build_grid_fem(
    grid: GridSpec,
    cell_mask: np.ndarray,
    fixed: np.ndarray,
    E: float = DEFAULT_E,
    nu: float = DEFAULT_NU,
    rho: float = DEFAULT_RHO,
    n_levels: int = 4,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> GridFem:
    """Host-side constructor. cell_mask [CX,CY,CZ] bool (TetMesh.cell_mask),
    fixed [X,Y,Z] bool grid-vertex anchors; float tensors are `dtype` and
    land on `device` (the card when None)."""
    device = default_device() if device is None else device
    cell_mask = np.asarray(cell_mask, bool)
    fixed = np.asarray(fixed, bool)
    dims = tuple(d + 1 for d in cell_mask.shape)
    assert fixed.shape == dims, (fixed.shape, dims)

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def real(a):
        return torch.as_tensor(np.asarray(a, np_dtype), device=device)

    def flag(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    ke, inv_dm, x0 = _kuhn_elements(grid.cellsize, E, nu)
    active = _active_from_cells(cell_mask)

    levels = []
    cm, fx, cs = cell_mask, fixed, grid.cellsize
    for li in range(n_levels):
        if li > 0:
            if min(d + 1 for d in cm.shape) <= 3:
                break
            cm, fx = _coarsen_masks(cm, fx)
            cs = cs * 2.0
        ke_l, _, _ = _kuhn_elements(cs, E, nu)
        levels.append(dict(
            cm=cm, free=_active_from_cells(cm) & ~fx,
            mass=_mass_grid(cm, cs, rho), ke=ke_l,
            kdiag=_kdiag_grid(cm, ke_l), dims=tuple(d + 1 for d in cm.shape),
        ))

    # Direct dense solve on the coarsest level, with its inverse for the
    # default step coefficients precomputed here (float64, then `dtype`).
    coarse = levels[-1]
    coarse_inv = k_dense = free_dense = None
    mc0 = 1.0 + DEFAULT_TIMESTEP * DEFAULT_DAMPING_MASS
    sc0 = (DEFAULT_TIMESTEP * DEFAULT_DAMPING_STIFFNESS
           + DEFAULT_TIMESTEP * DEFAULT_TIMESTEP)
    if 3 * int(np.prod(coarse["dims"])) <= _DENSE_COARSE_MAX_DOF:
        # The round trip through `dtype` keeps the assembly identical to
        # assembling from the level's stored stiffness.
        kd, fd = _assemble_dense(
            coarse["cm"], coarse["ke"].astype(np_dtype).astype(np.float64),
            coarse["free"],
        )
        k_dense, free_dense = kd, fd
        mass3 = np.tile(
            coarse["mass"].astype(np_dtype).astype(np.float64).reshape(-1), 3
        )
        a = sc0 * kd + np.diag(mc0 * mass3 * fd + (1.0 - fd))
        coarse_inv = real(np.linalg.inv(a))

    grid_levels = []
    for i, lv in enumerate(levels):
        last = i == len(levels) - 1
        grid_levels.append(GridLevel(
            cellw=real(lv["cm"].reshape(-1)),
            free=flag(lv["free"]),
            mass=real(lv["mass"]),
            ke=real(lv["ke"]),
            kdiag=real(lv["kdiag"]),
            k_dense=real(k_dense) if last and k_dense is not None else None,
            free_dense=(real(free_dense) if last and free_dense is not None
                        else None),
            dims=lv["dims"],
        ))

    return GridFem(
        cellw=real(cell_mask.reshape(-1)),
        free=flag(active & ~fixed),
        active=flag(active),
        mass=real(_mass_grid(cell_mask, grid.cellsize, rho)),
        ke=real(ke),
        inv_dm=real(inv_dm),
        x0=real(x0.reshape(6, 12)),
        kdiag=real(_kdiag_grid(cell_mask, ke)),
        levels=tuple(grid_levels),
        coarse_inv=coarse_inv,
        coarse_coefs=(float(mc0), float(sc0)),
        origin=tuple(float(v) for v in grid.lo),
        dims=dims,
        cellsize=float(grid.cellsize),
    )


def node_to_grid_index(tm: TetMesh) -> np.ndarray:
    """[n_nodes] flat grid-vertex index per tet-mesh node id."""
    g2n = tm.grid_to_node.detach().cpu().numpy()
    return np.flatnonzero(g2n >= 0).astype(np.int32)


def grid_fem_from_tetmesh(
    grid: GridSpec,
    tm: TetMesh,
    fixed_nodes: np.ndarray | None = None,
    E: float = DEFAULT_E,
    nu: float = DEFAULT_NU,
    rho: float = DEFAULT_RHO,
    n_levels: int = 4,
    device: torch.device | str | None = None,
) -> GridFem:
    """Build from an extracted TetMesh; fixed_nodes are tet-node ids (or a
    bool mask over nodes), translated onto the grid."""
    if tm.cell_mask is None:
        raise ValueError("TetMesh.cell_mask missing (re-extract the mesh)")
    cell_mask = tm.cell_mask.detach().cpu().numpy()
    dims = tuple(d + 1 for d in cell_mask.shape)
    fixed = np.zeros(int(np.prod(dims)), bool)
    if fixed_nodes is not None:
        n2g = node_to_grid_index(tm)
        fixed_nodes = np.asarray(fixed_nodes)
        if fixed_nodes.dtype == bool:
            fixed_nodes = np.flatnonzero(fixed_nodes[: len(n2g)])
        fixed[n2g[fixed_nodes]] = True
    return build_grid_fem(grid, cell_mask, fixed.reshape(dims), E, nu, rho,
                          n_levels, device=device)


# ------------------------------------------------------------- timestep

def _forces(gf: GridFem, state: FemState, f_ext, h, damping_mass,
            damping_stiffness):
    """The step's rotations R [6,3,3,C] and the solve's right side."""
    free = gf.free[..., None]
    R = kinematics(gf, state.q)
    f_int = internal_forces(gf, state.q, R)
    kq = stiffness_apply_rot(gf, R, state.qvel)
    residual = -h * (
        (h + damping_stiffness) * kq
        + damping_mass * gf.mass[..., None] * state.qvel
        + f_int
        - f_ext
    )
    return R, torch.where(free, residual, 0.0)


def _operator(gf: GridFem, mass_coef, stiff_coef):
    """The step's operator (v, ke, R) -> (mass_coef M + stiff_coef K_rot) v,
    identity on fixed nodes."""
    free = gf.free[..., None]
    m = gf.mass[..., None]

    def operator(v, ke, rot):
        g = gf if ke is gf.ke else dataclasses.replace(gf, ke=ke)
        vf = torch.where(free, v, 0.0)
        out = mass_coef * m * vf + stiff_coef * stiffness_apply_rot(g, rot, vf)
        return torch.where(free, out, v)

    return operator


def _preconditioner(gf: GridFem, precond, mass_coef, stiff_coef):
    """r -> M^-1 r: the multigrid V-cycle (precond "mg" with levels) or
    block-Jacobi on the 3x3 diagonal blocks of the linear stiffness, with
    its set-up computed here."""
    if precond == "mg" and gf.levels:
        pre_inv = None
        if (
            gf.coarse_inv is not None
            and abs(mass_coef - gf.coarse_coefs[0]) < 1e-12
            and abs(stiff_coef - gf.coarse_coefs[1]) < 1e-12
        ):
            pre_inv = gf.coarse_inv
        setup = mg_setup(gf.levels, mass_coef, stiff_coef, pre_inv)

        def prec(r):
            return vcycle(gf.levels, mass_coef, stiff_coef, r, setup)
    else:
        mflat = gf.mass.reshape(-1)
        eye = torch.eye(3, dtype=mflat.dtype, device=mflat.device)[..., None]
        blocks = (mass_coef * mflat) * eye + stiff_coef * gf.kdiag
        freef = gf.free.reshape(-1)[None, None]
        inv_blocks = _inv3_cm(torch.where(freef, blocks, eye))

        def prec(r):
            return _un_cm(_block_apply(inv_blocks, _cm(r)))
    return prec


def _advance(gf: GridFem, state: FemState, dv, h) -> FemState:
    free = gf.free[..., None]
    qvel = torch.where(free, state.qvel + dv, 0.0)
    q = torch.where(free, state.q + h * qvel, 0.0)
    return FemState(q=q, qvel=qvel, dv=dv)


# ------------------------------------------------- the graphed grid solve

# Captures of a graphed solve (one a cache key: its prologue and its
# iteration) and replays of its iteration graph, in this process.
CG_GRAPH = {"captures": 0, "replays": 0}

# The graphed solves by cg_graph_key, least recently used first.
_CG_CACHE: collections.OrderedDict = collections.OrderedDict()
_CG_CACHE_SIZE = 4


def reset_cg_graph_counts() -> None:
    for k in CG_GRAPH:
        CG_GRAPH[k] = 0


def cg_graph_key(gf: GridFem, mass_coef, stiff_coef, precond, b,
                 warm) -> tuple:
    """What a graphed solve is captured for: the mesh by the identity of
    its multigrid levels and of the fine-level arrays the operator and
    the preconditioner read (built together by `build_grid_fem`), its
    dims, dtype and device, the step's coefficients, the preconditioner,
    whether CG starts warm, and the memory layout (strides) of the right
    side b, which fixes the order in which pcg's dots sum. Not the
    GridFem: a frame that scales its stiffness
    (`dataclasses.replace(gf, ke=...)`) keeps all of these, and the solve
    copies ke, R, b and x0 in."""
    kind = "mg" if precond == "mg" and gf.levels else "block_jacobi"
    arrays = (gf.cellw, gf.free, gf.mass, gf.kdiag, gf.coarse_inv)
    return (id(gf.levels), tuple(id(a) for a in arrays), gf.dims,
            gf.mass.dtype, gf.mass.device, float(mass_coef),
            float(stiff_coef), kind, bool(warm), b.stride())


def graphed_cg(gf: GridFem, mass_coef, stiff_coef, precond, b,
               warm) -> "GraphedCg":
    """The cached graphed solve of `cg_graph_key`, built and, on a CUDA
    device, captured at first use."""
    key = cg_graph_key(gf, mass_coef, stiff_coef, precond, b, warm)
    cg = _CG_CACHE.get(key)
    if cg is None:
        with span("fem.cg_capture"):
            cg = GraphedCg(gf, mass_coef, stiff_coef, precond, b, warm)
        _CG_CACHE[key] = cg
        if len(_CG_CACHE) > _CG_CACHE_SIZE:
            _CG_CACHE.popitem(last=False)
    _CG_CACHE.move_to_end(key)
    return cg


class GraphedCg:
    """The grid step's PCG as two CUDA graphs over static buffers: the
    prologue (`pcg_start` and the threshold) and one iteration
    (`pcg_update`), both on the operator `_operator(gf, ...)` applied with
    the ke and R copied in and the preconditioner set up once here. A
    solve copies b, ke, R and x0 in, replays the prologue, reads the
    threshold and z.r in one read, then replays the iteration and reads
    z.r until `pcg`'s stopping rule holds: `pcg`'s kernels, iterates and
    iteration count, with one launch an iteration from the host. The
    graphs are captured when the buffers lie on a CUDA device; elsewhere
    (the CPU tests) the same bodies run eagerly.

    The static vectors take the memory layouts that pcg's own vectors
    take for a right side laid out as `b` (b's strides are part of the
    cache key), so that its dots sum in the same order."""

    def __init__(self, gf: GridFem, mass_coef, stiff_coef, precond, b, warm):
        like = gf.mass

        def zeros(*shape):
            return torch.zeros(shape, dtype=like.dtype, device=like.device)

        self.b = torch.zeros_like(b)
        self.x0 = torch.zeros_like(b) if warm else None
        self.ke = torch.zeros_like(gf.ke)
        self.R = zeros(6, 3, 3, gf.cellw.shape[0])
        self.tol2 = zeros()
        self.head = zeros(2)          # threshold and z.r after the prologue
        self.rz = self.head[1]
        # The bodies read the mesh through a GridFem whose ke is the
        # static one, and hold no frame's own stiffness.
        gs = dataclasses.replace(gf, ke=self.ke)
        operator = _operator(gs, mass_coef, stiff_coef)
        self.matvec = lambda v: operator(v, self.ke, self.R)
        self.prec = _preconditioner(gs, precond, mass_coef, stiff_coef)
        _, x, r, p, _ = pcg_start(self.matvec, self.b, self.prec, self.x0)
        self.x, self.r, self.p = (torch.zeros_like(t) for t in (x, r, p))
        self.bodies = (self._prologue, self._iteration)
        self.graphs = self._capture() if like.is_cuda else None

    def _prologue(self):
        b_zb, x, r, p, rz = pcg_start(self.matvec, self.b, self.prec,
                                      self.x0)
        self.head.copy_(torch.stack([self.tol2 * b_zb, rz]))
        self.x.copy_(x)
        self.r.copy_(r)
        self.p.copy_(p)

    def _iteration(self):
        x, r, p, rz = pcg_update(self.matvec, self.prec, self.x, self.r,
                                 self.p, self.rz)
        self.x.copy_(x)
        self.r.copy_(r)
        self.p.copy_(p)
        self.rz.copy_(rz)

    def _capture(self):
        """Warm the bodies up on a side stream, then capture each into a
        graph (one memory pool)."""
        side = torch.cuda.Stream(self.b.device)
        side.wait_stream(torch.cuda.current_stream(self.b.device))
        with torch.cuda.stream(side):
            for body in self.bodies:
                body()
        torch.cuda.current_stream(self.b.device).wait_stream(side)
        graphs = []
        for body in self.bodies:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=graphs[0].pool() if graphs
                                  else None, stream=side):
                body()
            graphs.append(g)
        CG_GRAPH["captures"] += 1
        return tuple(graphs)

    def _run(self, i):
        """Body i (0 the prologue, 1 the iteration): its graph's replay,
        or the body itself where none was captured."""
        if self.graphs is None:
            self.bodies[i]()
        else:
            self.graphs[i].replay()

    def solve(self, b, ke, R, x0, tol, max_iters, stats=None):
        """(x, iterations) of `pcg` on this step's operator from x0 (None
        when cold); `stats["graphed_iters"]`, if given, grows by the
        iterations replayed. x is a copy, not the static buffer."""
        with torch.no_grad():
            self.b.copy_(b)
            self.ke.copy_(ke)
            self.R.copy_(R)
            if self.x0 is not None:
                self.x0.copy_(x0)
            self.tol2.fill_(tol * tol)
        self._run(0)
        with span("fem.cg_sync"):
            thresh, rz = self.head.tolist()
        it = 0
        go = it < max_iters and rz > thresh
        while go:
            with span("fem.cg_iter"):
                self._run(1)
                it += 1
                with span("fem.cg_sync"):
                    rz = float(self.rz)
                go = it < max_iters and rz > thresh
        if self.graphs is not None:
            CG_GRAPH["replays"] += it
            if stats is not None:
                stats["graphed_iters"] = stats.get("graphed_iters", 0) + it
        return self.x.clone(), it


def timestep(
    gf: GridFem,
    state: FemState,
    f_ext: torch.Tensor,
    h: float = DEFAULT_TIMESTEP,
    damping_mass: float = DEFAULT_DAMPING_MASS,
    damping_stiffness: float = DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = CG_TOL,
    cg_max_iters: int = CG_MAX_ITERS,
    differentiable: bool = False,
    precond: str = "mg",
    solve_stats: dict | None = None,
) -> tuple[FemState, int]:
    """One implicit Newmark step on the grid; returns (new_state,
    cg_iterations). f_ext is [X,Y,Z,3]. precond="mg" (with levels)
    preconditions CG by the multigrid V-cycle; any other value, or a
    GridFem without levels, by block-Jacobi on the 3x3 diagonal blocks of
    the linear stiffness. The forward default warm-starts from state.dv.
    differentiable=True solves cold through `symmetric_solve`, so
    gradients reach the element stiffness gf.ke (Young's modulus) and the
    state through one adjoint CG solve; the returned count is then -1, as
    in the reference, and `solve_stats` receives the forward and adjoint
    iteration counts. The preconditioner is not differentiated.

    On a CUDA device the solves (forward and adjoint) replay the cached
    CUDA graphs of `graphed_cg`, with the preconditioner set up once a
    cache key, and return a detached copy of the solution;
    `solve_stats["graphed_iters"]` counts their iterations. Elsewhere
    `pcg` runs its loop eagerly."""
    with span("fem.step"):
        free = gf.free[..., None]
        with span("fem.forces"):
            R, residual = _forces(gf, state, f_ext, h, damping_mass,
                                  damping_stiffness)

        mass_coef = 1.0 + h * damping_mass
        stiff_coef = h * damping_stiffness + h * h
        operator = _operator(gf, mass_coef, stiff_coef)
        if solve_stats is not None:
            solve_stats["graphed_iters"] = 0

        if residual.is_cuda:
            # The operator's parameters, forward and adjoint alike, are
            # this step's gf.ke and R (symmetric_solve's theta).
            def solve(mv, b, x0=None):
                cg = graphed_cg(gf, mass_coef, stiff_coef, precond, b,
                                warm=x0 is not None)
                return cg.solve(b, gf.ke, R, x0, cg_tol, cg_max_iters,
                                solve_stats)
        else:
            with span("fem.precond_setup"):
                prec = _preconditioner(gf, precond, mass_coef, stiff_coef)

            def solve(mv, b, x0=None):
                return pcg(mv, b, prec, cg_tol, cg_max_iters, x0=x0)

        with span("fem.solve"):
            if differentiable:
                dv = symmetric_solve(operator, residual, (gf.ke, R), solve,
                                     solve_stats)
                iters = -1
            else:
                x0 = (None if state.dv is None
                      else torch.where(free, state.dv, 0.0))
                dv, iters = solve(lambda v: operator(v, gf.ke, R), residual,
                                  x0)
                if solve_stats is not None:
                    solve_stats["forward_iters"] = iters
        new_state = _advance(gf, state, dv, h)
    return new_state, iters
