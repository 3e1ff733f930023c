"""The plain corotational FEM step on the voxel grid, and the check of a
step against it.

The tissue is every grid cell with a corner inside the surface (field >=
0.5 at the vertex), each cell split into the 6 Kuhn tetrahedra of the
cube; nodes are the vertices of those cells, in the grid's row-major
order. A linear isotropic tetrahedron (E, nu) has the stiffness
B^T C B vol; a cell's mass rho s^3 goes to its corners by the number of
its tetrahedra that hold each corner, over 24. The bottom share `frac`
of each connected part's height is anchored.

One implicit step from (q, v) under f_ext, with the rotation R of each
tetrahedron the polar factor of its deformation gradient at q:

    A = (1 + h alpha) M + (h beta + h^2) K_R,   K_R = sum R Ke R^T
    b = -h ((h + beta) K_R v + alpha M v + f_int - f_ext),
    f_int = sum R Ke (R^T (x0 + u) - x0)
    A dv = b on the free nodes;  v' = v + dv;  q' = q + h v'

The step's linear solve is judged by its error in A's energy norm,
relative to the step's load impulse (`judge_step`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components
import torch

from .field import Field, Precision
from .scene import ISO, RefScene

# Corner b of a cell is at offset (b >> 2 & 1, b >> 1 & 1, b & 1); the
# Kuhn split of the cube along its main diagonal 0 -> 7.
CORNERS = np.array([[(b >> 2) & 1, (b >> 1) & 1, b & 1] for b in range(8)])
KUHN = np.array([[0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7],
                 [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]])


@dataclasses.dataclass
class Grid:
    lo: np.ndarray          # [3] float32 origin
    dims: tuple             # vertices per axis
    cellsize: float
    cells: np.ndarray       # [C, 3] used cells
    active: np.ndarray      # [X, Y, Z] bool nodes
    fixed: np.ndarray       # [X, Y, Z] bool anchors
    points: np.ndarray      # [X, Y, Z, 3] float32 vertex positions
    mass: np.ndarray        # [X, Y, Z] float64

    @property
    def free(self) -> np.ndarray:
        return self.active & ~self.fixed


def make_grid(scene: RefScene, cellsize: float, frac: float, rho: float,
              device) -> Grid:
    lo = scene.bbox_lo - np.float32(0.1)
    hi = scene.bbox_hi + np.float32(0.1)
    dims = tuple(int(d) for d in np.maximum(
        np.ceil((hi - lo) / np.float32(cellsize)) + 1, 2))
    idx = torch.stack(torch.meshgrid(
        *(torch.arange(d, dtype=torch.float32) for d in dims), indexing="ij"),
        -1)
    pts = (torch.as_tensor(lo) + idx * cellsize).numpy()
    f = Field(scene, device, Precision())
    inside = (f(torch.as_tensor(pts.reshape(-1, 3), device=device))
              >= ISO).cpu().numpy().reshape(dims)
    X, Y, Z = dims
    used = np.zeros((X - 1, Y - 1, Z - 1), bool)
    for ox, oy, oz in CORNERS:
        used |= inside[ox:ox + X - 1, oy:oy + Y - 1, oz:oz + Z - 1]
    cells = np.argwhere(used)
    active = np.zeros(dims, bool)
    mass = np.zeros(dims)
    w = np.zeros(8)
    for tet in KUHN:
        w[tet] += 1.0 / 24.0
    for b, (ox, oy, oz) in enumerate(CORNERS):
        active[cells[:, 0] + ox, cells[:, 1] + oy, cells[:, 2] + oz] = True
        np.add.at(mass, (cells[:, 0] + ox, cells[:, 1] + oy, cells[:, 2] + oz),
                  w[b] * rho * cellsize ** 3)
    # Connected parts: nodes of one cell are joined.
    flat = np.ravel_multi_index(
        tuple((cells[:, None, :] + CORNERS[None]).transpose(2, 0, 1)), dims)
    rows = np.repeat(flat[:, :1], 8, 1).ravel()
    n = X * Y * Z
    g = sp.coo_matrix((np.ones(rows.size), (rows, flat.ravel())), (n, n))
    _, label = connected_components(g, directed=False)
    node_y = pts[..., 1]
    fixed = np.zeros(dims, bool)
    for c in np.unique(label[active.ravel()]):
        part = active & (label.reshape(dims) == c)
        ys = node_y[part]
        ymin, ymax = ys.min(), ys.max()
        cut = ymin + max(1e-3, frac * (ymax - ymin))
        fixed |= part & (node_y <= cut)
    return Grid(lo=lo, dims=dims, cellsize=float(cellsize), cells=cells,
                active=active, fixed=fixed, points=pts, mass=mass)


def element_stiffness(cellsize: float, E: float, nu: float):
    """[6, 12, 12] Kuhn tetrahedra stiffness and [6, 4, 3] rest corners,
    [6, 3, 3] inverse edge matrices (float64)."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[range(3), range(3)] += 2 * mu
    C[3:, 3:] = mu * np.eye(3)
    x0 = CORNERS[KUHN].astype(np.float64) * cellsize          # [6, 4, 3]
    dm = np.swapaxes(x0[:, 1:] - x0[:, :1], 1, 2)             # columns edges
    inv_dm = np.linalg.inv(dm)
    vol = np.abs(np.linalg.det(dm)) / 6.0
    g = np.concatenate([-inv_dm.sum(1, keepdims=True), inv_dm], 1)  # [6,4,3]
    B = np.zeros((6, 6, 12))
    for j in range(4):
        gx, gy, gz = g[:, j, 0], g[:, j, 1], g[:, j, 2]
        B[:, 0, 3 * j], B[:, 1, 3 * j + 1], B[:, 2, 3 * j + 2] = gx, gy, gz
        B[:, 3, 3 * j], B[:, 3, 3 * j + 1] = gy, gx
        B[:, 4, 3 * j + 1], B[:, 4, 3 * j + 2] = gz, gy
        B[:, 5, 3 * j], B[:, 5, 3 * j + 2] = gz, gx
    ke = np.einsum("tia,ij,tjb->tab", B, C, B) * vol[:, None, None]
    return ke, x0, inv_dm


class Step:
    """The step's operator and right-hand side on one grid, in `dtype`
    on `device`; products go through `prec` (the TF32 control)."""

    def __init__(self, grid: Grid, E: float, nu: float, h: float,
                 damping_mass: float, damping_stiffness: float, device,
                 prec: Precision):
        self.prec, self.h = prec, h
        self.alpha, self.beta = damping_mass, damping_stiffness
        dt = prec.dtype
        ke, x0, inv_dm = element_stiffness(grid.cellsize, E, nu)
        self.ke = torch.as_tensor(ke, dtype=dt, device=device)
        self.x0 = torch.as_tensor(x0.reshape(6, 12), dtype=dt, device=device)
        self.inv_dm = torch.as_tensor(inv_dm, dtype=dt, device=device)
        corner = grid.cells[:, None, :] + CORNERS[None]          # [C, 8, 3]
        flat = np.ravel_multi_index(tuple(corner.transpose(2, 0, 1)),
                                    grid.dims)                  # [C, 8]
        self.nodes = torch.as_tensor(flat[:, KUHN], device=device)  # [C,6,4]
        self.n = int(np.prod(grid.dims))
        self.free = torch.as_tensor(grid.free.reshape(-1), device=device)
        self.mass = torch.as_tensor(grid.mass.reshape(-1), dtype=dt,
                                    device=device)
        self.mass_coef = 1.0 + h * damping_mass
        self.stiff_coef = h * damping_stiffness + h * h

    def gather(self, u):
        """[n, 3] -> [C, 6, 12] per tetrahedron corner values."""
        return u[self.nodes].reshape(*self.nodes.shape[:2], 12)

    def scatter(self, fe):
        out = torch.zeros((self.n, 3), dtype=fe.dtype, device=fe.device)
        out.index_add_(0, self.nodes.reshape(-1), fe.reshape(-1, 3))
        return out

    def rotations(self, q):
        """[C, 6, 3, 3] polar factors of F = I + Du per tetrahedron."""
        u = self.gather(q).reshape(*self.nodes.shape[:2], 4, 3)
        du = (u[:, :, 1:] - u[:, :, :1]).transpose(-1, -2)      # [C,6,3,3]
        F = torch.eye(3, dtype=q.dtype, device=q.device) + du @ self.inv_dm
        W, _, Vh = torch.linalg.svd(F.double())
        R = W @ Vh
        sign = torch.where(torch.linalg.det(F.double()) < 0, -1.0, 1.0)
        return (R * sign[..., None, None]).to(q.dtype)

    def _rot_ke(self, R, v12, rotate_in: bool):
        """sum over tetrahedra of R Ke (R^T v) -> [n, 3]."""
        C = v12.shape[0]
        v = v12.reshape(C, 6, 4, 3)
        if rotate_in:
            v = torch.einsum("ctba,ctjb->ctja", R, v)           # R^T v
        kv = self.prec.mm(v.reshape(C, 6, 1, 12),
                          self.ke.transpose(1, 2)[None]).reshape(C, 6, 4, 3)
        return self.scatter(torch.einsum("ctab,ctjb->ctja", R, kv))

    def apply(self, R, v):
        """K_R v for [n, 3] v."""
        return self._rot_ke(R, self.gather(v), True)

    def f_int(self, R, q):
        p = self.gather(q) + self.x0[None]
        rp = torch.einsum("ctba,ctjb->ctja", R,
                          p.reshape(*p.shape[:2], 4, 3)).reshape(p.shape)
        return self._rot_ke(R, rp - self.x0[None], False)

    def operator(self, R):
        free = self.free[:, None]

        def A(v):
            vf = torch.where(free, v, 0.0)
            out = (self.mass_coef * self.mass[:, None] * vf
                   + self.stiff_coef * self.apply(R, vf))
            return torch.where(free, out, 0.0)

        return A

    def rhs(self, R, q, v, f_ext):
        h = self.h
        b = -h * ((h + self.beta) * self.apply(R, v)
                  + self.alpha * self.mass[:, None] * v
                  + self.f_int(R, q) - f_ext)
        return torch.where(self.free[:, None], b, 0.0)

    def block_inverse(self, R):
        """[n, 3, 3] inverses of A's 3 x 3 diagonal blocks (identity off
        the free nodes): CG's preconditioner."""
        kb = torch.stack([self.ke[:, 3 * j:3 * j + 3, 3 * j:3 * j + 3]
                          for j in range(4)], 1)                 # [6,4,3,3]
        blk = R[:, :, None] @ kb[None] @ R[:, :, None].transpose(-1, -2)
        out = torch.zeros((self.n, 3, 3), dtype=blk.dtype, device=blk.device)
        out.index_add_(0, self.nodes.reshape(-1), blk.reshape(-1, 3, 3))
        eye = torch.eye(3, dtype=blk.dtype, device=blk.device)
        out = self.mass_coef * self.mass[:, None, None] * eye \
            + self.stiff_coef * out
        out = torch.where(self.free[:, None, None], out, eye)
        return torch.linalg.inv(out)

    def solve(self, A, b, R, tol=1e-10, max_iters=4000):
        """Block-Jacobi preconditioned CG to a relative residual `tol` in
        the preconditioner's norm, or `max_iters` iterations."""
        inv = self.block_inverse(R)
        free = self.free[:, None]

        def pre(r):
            return torch.where(free, (inv @ r[:, :, None])[:, :, 0], 0.0)

        x = torch.zeros_like(b)
        r = b.clone()
        z = pre(r)
        p = z
        rz = torch.sum(r * z)
        stop = float(tol * tol * rz)
        self.iters = max_iters
        for it in range(max_iters):
            if float(rz) <= stop:
                self.iters = it
                break
            ap = A(p)
            alpha = rz / torch.sum(p * ap)
            x = x + alpha * p
            r = r - alpha * ap
            z = pre(r)
            rz_new = torch.sum(r * z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        return x

    def step(self, q, v, f_ext):
        """(q', v', dv) of one step from [n, 3] q, v."""
        R = self.rotations(q)
        A = self.operator(R)
        dv = self.solve(A, self.rhs(R, q, v, f_ext), R)
        v2 = torch.where(self.free[:, None], v + dv, 0.0)
        q2 = torch.where(self.free[:, None], q + self.h * v2, 0.0)
        return q2, v2, dv


def judge_step(step: Step, q0, v0, q1, v1, f_ext) -> dict:
    """Readings of one program step (q0, v0) -> (q1, v1), [n, 3] float64,
    each against the step's load impulse x, the solution of A x = h f_ext
    (the velocity change the load alone makes in one step, which does not
    vanish as the tissue settles, unlike the step's own solution):
    `fem_energy_err` the solve's error |dv - dv*|_A / |x|_A, and
    `fem_update_err` how far q1 and v1 stand from the update rule applied
    to that solve, max |gap| / max |h x|."""
    R = step.rotations(q0)
    A = step.operator(R)
    free = step.free[:, None]
    dv_star = step.solve(A, step.rhs(R, q0, v0, f_ext), R)
    x = step.solve(A, torch.where(free, step.h * f_ext, 0.0), R)
    dv = torch.where(free, v1 - v0, 0.0)
    e = dv - dv_star
    energy = torch.sqrt(torch.sum(e * A(e)) / torch.sum(x * A(x)))
    q_rule = torch.where(free, q0 + step.h * torch.where(free, v1, 0.0), 0.0)
    upd = torch.amax(torch.abs(q1 - q_rule)) + torch.amax(
        torch.abs(torch.where(free, 0.0, v1)))
    return {"fem_energy_err": float(energy),
            "fem_update_err": float(upd / torch.amax(torch.abs(step.h * x)))}
