"""Coupled render+deform: sphere-trace the FEM-deformed implicit field.

PyTorch counterpart of fembrain_tpu/render/deformed.py. The coupling is in
FIELD space: the deformation map phi(x) = x + u(x) turns the rest field f
into the deformed field F(y) = f(phi^{-1}(y)), whose iso surface is the
deformed tissue surface; phi^{-1} is the fixed point x <- y - u(x), a
contraction at soft-tissue strains, unrolled a few steps so it is plainly
differentiable.

The exact path takes u as the FEM nodal displacement, trilinearly
interpolated on the polygonizer's voxel grid (`displacement_grid`,
`sample_displacement`, `trace_deformed`, `render_deformed`,
`coupled_step`): 8 gathers per sample, a dense fixed-step march.

On the fast path the FEM displacement is interpolated by an RBF u(x) over M centers picked
among the mesh nodes: the biharmonic kernel |x - c| with an affine tail
(the default, global support) or the compact-support Wendland C2 kernel.
The deformed field F(y) = f(x) with x = y - u(x) is traced by the tile
tracer (`trace_deformed_rbf_fast`: K4 for the biharmonic kind, K2 for the
Wendland kind) or densely by `trace_deformed_rbf`, the exact plain tracer
they are checked against. Either way the hit parameter's gradient comes
from implicit differentiation at the root against the dense deformed
field (sphere_trace.newton_nudge), so image losses reach the RBF weights
and through them the FEM state. `coupled_step_grid_fast` is the coupled
frame on the grid solver (grid-FEM step -> RBF weights -> trace) and
`coupled_step_fast` the same frame on the unstructured solver; both are
differentiable in Young's modulus with `differentiable=True`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device
from ..blob.scene import Scene
from ..graphics.materials import PHONG, Material
from ..mesh.polygonize import GridSpec
from ..ops.field import field, supports_rows_fast_path, vertex_attributes
from .camera import generate_rays
from .sphere_trace import (
    TraceParams, _ray_box, march_all, newton_nudge, prim_interval,
    shade_hits, support_radius_bound,
)
from .tile_trace import (
    CEN_BLOCK, TILE, BiharmonicSpec, WendlandSpec, is_additive_path,
    trace_tiles, trace_tiles_image,
)

# Pull-back fixed-point iterations of the dense tracer and of K4.
FIXED_POINT_ITERS = 2

# Wendland support radius as a multiple of the center fill distance.
WENDLAND_SIGMA_FILL = 3.0
# max_t |d/dt (1-t)^4 (4t+1)| = 20 t (1-t)^3 at t = 1/4.
WENDLAND_DPHI_MAX = 2.109375


def displacement_grid(grid: GridSpec, grid_to_node: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Scatter FEM nodal displacements onto the voxel grid: [X, Y, Z, 3].

    Grid vertices that are not tet nodes get zero displacement; every
    cell the iso surface passes through has all 8 corners as tet nodes
    (extract_tet_mesh marks inside+crossed cells), so interpolation near
    the surface uses real nodal values only."""
    safe = torch.clamp(grid_to_node, min=0).long()
    ug = torch.where((grid_to_node >= 0)[:, None], u[safe], 0.0)
    X, Y, Z = grid.dims
    return ug.reshape(X, Y, Z, 3)


def sample_displacement(grid: GridSpec, u_grid: torch.Tensor,
                        pts: torch.Tensor) -> torch.Tensor:
    """Trilinear displacement sample at world points [N, 3] -> [N, 3].
    Clamps to the grid (zero-displacement padding outside the mesh)."""
    X, Y, Z = grid.dims
    origin = torch.tensor(grid.lo, dtype=pts.dtype, device=pts.device)
    rel = (pts - origin) / grid.cellsize
    dims = torch.tensor([X, Y, Z], dtype=pts.dtype, device=pts.device)
    rel = torch.minimum(torch.clamp(rel, min=0.0), dims - 1.0 - 1e-6)
    i0 = torch.minimum(
        torch.floor(rel).long(),
        torch.tensor([X - 2, Y - 2, Z - 2], device=pts.device))
    fr = rel - i0
    # One flat gather per corner of the cell.
    flat = u_grid.reshape(-1, 3)
    base = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]

    def corner(dx, dy, dz):
        return flat[base + ((dx * Y + dy) * Z + dz)]

    wx = fr[:, 0:1]
    wy = fr[:, 1:2]
    wz = fr[:, 2:3]
    c00 = corner(0, 0, 0) * (1 - wz) + corner(0, 0, 1) * wz
    c01 = corner(0, 1, 0) * (1 - wz) + corner(0, 1, 1) * wz
    c10 = corner(1, 0, 0) * (1 - wz) + corner(1, 0, 1) * wz
    c11 = corner(1, 1, 0) * (1 - wz) + corner(1, 1, 1) * wz
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wx) + c1 * wx


def pull_back(grid: GridSpec, u_grid: torch.Tensor, y: torch.Tensor,
              iters: int = FIXED_POINT_ITERS) -> torch.Tensor:
    """Invert phi(x) = x + u(x): fixed-point x <- y - u(x), unrolled so
    the inverse map is differentiable through plain autograd."""
    x = y
    for _ in range(iters):
        x = y - sample_displacement(grid, u_grid, x)
    return x


def deformed_field(scene: Scene, grid: GridSpec, u_grid: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """F(y) = f(phi^{-1}(y)): the implicit field of the deformed tissue."""
    return field(scene, pull_back(grid, u_grid, y))


def trace_deformed(scene: Scene, grid: GridSpec, u_grid: torch.Tensor,
                   ro: torch.Tensor, rd: torch.Tensor,
                   params: TraceParams = TraceParams(),
                   max_disp: float = 0.5):
    """Sphere-trace the trilinearly deformed field, densely. Fixed-step
    march (the Wyvill support bound does not survive an arbitrary warp),
    slab bracket expanded by `max_disp` so the deformed surface stays
    inside. Returns (t_hit, hit_mask); t_hit is differentiable in u_grid
    and the scene by implicit differentiation at the root (the march and
    the root's slope are constants)."""
    iso = params.iso
    lo = scene.bbox_lo - 0.05 - max_disp
    hi = scene.bbox_hi + 0.05 + max_disp
    t_enter, t_exit = _ray_box(ro, rd, lo[None], hi[None])
    alive0 = t_exit > t_enter
    t_enter = torch.where(alive0, t_enter, 0.0)
    t_exit = torch.where(alive0, t_exit, 0.0)
    base_step = torch.linalg.norm(hi - lo) * params.step_frac

    def f_minus_iso(p):
        return deformed_field(scene, grid, u_grid, p) - iso

    with torch.no_grad():
        t_root, found = march_all(
            lambda t: f_minus_iso(ro + t[:, None] * rd),
            lambda fv: base_step, t_enter, t_exit, alive0, params)
    return newton_nudge(f_minus_iso, ro, rd, t_root, found,
                        0.5 * base_step), found


def shade_deformed(scene: Scene, grid: GridSpec, u_grid: torch.Tensor,
                   ro, rd, t_hit, hit_mask,
                   light_dir=(0.577, 0.577, 0.577),
                   background=(1.0, 1.0, 1.0),
                   material: Material = PHONG, texture=None,
                   texture_scale: float = 1.0):
    """Blinn-Phong shading of the deformed surface: normals from the
    deformed field's gradient (exact normals of the warped surface),
    material color sampled at the pulled-back rest point. `texture`
    ([H, W, 3] tensor) modulates the albedo by triplanar sampling at the
    REST point, so the pattern sticks to the deforming tissue."""
    def warp(p):
        return pull_back(grid, u_grid, p)

    def attrs(x):
        _, g, col = vertex_attributes(scene, x, warp, (u_grid,))
        return g, col, (warp(x) if texture is not None else x)

    return shade_hits(attrs, ro, rd, t_hit, hit_mask, light_dir, background,
                      material, texture, texture_scale)


def render_deformed(scene: Scene, grid: GridSpec, grid_to_node: torch.Tensor,
                    u: torch.Tensor, cam, width: int, height: int,
                    params: TraceParams = TraceParams()) -> torch.Tensor:
    """[H, W, 3] image of the tissue displaced by FEM state u [N, 3]."""
    ro, rd = generate_rays(cam, width, height)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    u_grid = displacement_grid(grid, grid_to_node, u)
    t, hit = trace_deformed(scene, grid, u_grid, ro, rd, params)
    rgb = shade_deformed(scene, grid, u_grid, ro, rd, t, hit)
    return rgb.reshape(height, width, 3)


@dataclasses.dataclass(frozen=True)
class DispInterp:
    """Static displacement-interpolation operator for one mesh:
    u = sum_k w_k phi(|x - c_k|) + a + B x with

    * kind "biharmonic": phi(r) = r, global support, the affine tail
      required by the saddle system;
    * kind "wendland": phi(r) = (1-t)^4 (4t+1), t = r / sigma clamped to 1,
      compact support and no affine tail (its weight rows are zero)."""

    centers: torch.Tensor       # [M, 3] world positions of the chosen nodes
    center_nodes: torch.Tensor  # [M] int32 FEM node ids
    a_inv: torch.Tensor         # [M+4, M+4] inverse of the kernel system
    fill_dist: torch.Tensor     # [] farthest node-to-nearest-center distance
    kind: str = "biharmonic"
    sigma: float = 0.0


def _phi_dist(interp: DispInterp, d: torch.Tensor) -> torch.Tensor:
    """Kernel value from distance(s) d (any shape)."""
    if interp.kind == "biharmonic":
        return d
    t = torch.clamp(d * (1.0 / interp.sigma), max=1.0)
    omt = 1.0 - t
    o2 = omt * omt
    return o2 * o2 * (4.0 * t + 1.0)


def _dphi_over_d(interp: DispInterp, d: torch.Tensor) -> torch.Tensor:
    """(d phi / d r) / r at distance d: grad_x phi(|x-c|) = this * (x-c)."""
    if interp.kind == "biharmonic":
        return 1.0 / torch.clamp(d, min=1e-12)
    s = 1.0 / interp.sigma
    t = torch.clamp(d * s, max=1.0)
    omt = 1.0 - t
    return -20.0 * omt * omt * omt * (s * s)


def _kernel_lipschitz_coef(interp: DispInterp) -> float:
    """max_r |d phi / d r|: 1 for biharmonic, 2.109/sigma for Wendland."""
    if interp.kind == "biharmonic":
        return 1.0
    return WENDLAND_DPHI_MAX / interp.sigma


def adaptive_centers(n_nodes: int) -> int:
    """Center count scaled to mesh size: ~cbrt growth, clamped to
    [64, 512] and rounded up to a multiple of 8 (112 for brain's 8,308
    nodes)."""
    m = int(16 * round(n_nodes ** (1.0 / 3.0) / 3.0))
    return max(64, min(512, (m + 7) // 8 * 8))


def _morton_order(pts) -> np.ndarray:
    """Permutation sorting points by the Morton code of their positions."""
    pts = np.asarray(pts, np.float64)
    lo = pts.min(0)
    span = np.maximum(pts.max(0) - lo, 1e-9)
    q = np.clip((pts - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return np.argsort(code, kind="stable")


def _factor_interp(c, kind: str, sigma: float) -> np.ndarray:
    """Inverse of the interpolation system for centers c [M, 3] (float64,
    host) in the [M+4, M+4] layout. Biharmonic: the saddle system
    [[phi, P], [P^T, 0]], P = [1, x] (|x-c| is only conditionally positive
    definite, so the tail is required). Wendland: the kernel is positive
    definite, so the tail is dropped and u is exactly zero beyond sigma of
    every center; the affine rows of the inverse stay zero."""
    m = len(c)
    d = np.linalg.norm(c[:, None] - c[None], axis=-1)
    a = np.zeros((m + 4, m + 4))
    if kind == "biharmonic":
        p = np.concatenate([np.ones((m, 1)), c], 1)
        a[:m, :m] = d + 1e-9 * np.eye(m)
        a[:m, m:] = p
        a[m:, :m] = p.T
        return np.linalg.inv(a)
    t = np.minimum(d / sigma, 1.0)
    phi = (1.0 - t) ** 4 * (4.0 * t + 1.0)
    a[:m, :m] = np.linalg.inv(phi + 1e-9 * np.eye(m))
    return a


def build_disp_interp(nodes, n_centers: int | None = None, fixed=None,
                      kernel: str = "biharmonic",
                      sigma_fill: float = WENDLAND_SIGMA_FILL,
                      extra_centers=None, sigma: float | None = None,
                      device: torch.device | str | None = None) -> DispInterp:
    """Farthest-point-sample `n_centers` FEM nodes (None: adaptive_centers)
    and factor the kernel system (float64 host math, once per mesh
    topology). `fixed` is accepted as in the reference and not read:
    anchored nodes are pinned by their zero displacement rows.
    extra_centers are node ids appended after the pick. Wendland centers
    are Morton-ordered so the tracer's center blocks are spatially tight;
    the support is sigma = sigma_fill * max(fill distance, median center
    spacing) unless `sigma` is given. Tensors land on `device` (the card
    when None)."""
    del fixed
    device = default_device() if device is None else device
    nodes = np.asarray(nodes, np.float64)
    if n_centers is None:
        n_centers = adaptive_centers(len(nodes))
    m = min(n_centers, len(nodes))
    sel = [0]
    d = np.linalg.norm(nodes - nodes[0], axis=-1)
    for _ in range(m - 1):
        i = int(np.argmax(d))
        sel.append(i)
        d = np.minimum(d, np.linalg.norm(nodes - nodes[i], axis=-1))
    if extra_centers is not None:
        for i in np.asarray(extra_centers).tolist():
            if i not in sel:
                sel.append(int(i))
                d = np.minimum(d, np.linalg.norm(nodes - nodes[int(i)],
                                                 axis=-1))
    idx = np.asarray(sel, np.int64)
    fill = float(np.max(d))
    if kernel != "biharmonic":
        idx = idx[_morton_order(nodes[idx])]
    c = nodes[idx]
    if sigma is None:
        pair = np.linalg.norm(c[:, None] - c[None], axis=-1)
        np.fill_diagonal(pair, np.inf)
        spacing = float(np.median(pair.min(1))) if len(c) > 1 else 1.0
        sigma = sigma_fill * max(fill, spacing, 1e-6)
    return DispInterp(
        centers=torch.as_tensor(c.astype(np.float32), device=device),
        center_nodes=torch.as_tensor(idx.astype(np.int32), device=device),
        a_inv=torch.as_tensor(
            _factor_interp(c, kernel, sigma).astype(np.float32),
            device=device),
        fill_dist=torch.tensor(fill, dtype=torch.float32, device=device),
        kind=kernel,
        sigma=float(sigma),
    )


def disp_weights_centers(interp: DispInterp, u_c: torch.Tensor):
    """RBF weights from displacements at the centers: [M+4, 3], linear in
    u_c, so gradients flow through."""
    rhs = torch.cat([u_c, u_c.new_zeros((4, 3))], 0)
    return interp.a_inv @ rhs


def disp_weights(interp: DispInterp, q: torch.Tensor):
    """RBF weights from the nodal FEM state q [N, 3]: [M+4, 3]."""
    return disp_weights_centers(interp, q[interp.center_nodes.long()])


def sample_disp_rbf(interp: DispInterp, w: torch.Tensor,
                    pts: torch.Tensor) -> torch.Tensor:
    """u(x) at [N, 3] points (dense over all centers)."""
    m = interp.centers.shape[0]
    d = torch.sqrt(torch.clamp(
        torch.sum((pts[:, None] - interp.centers[None]) ** 2, -1), min=1e-24
    ))
    u = _phi_dist(interp, d) @ w[:m]
    return u + w[m] + pts @ w[m + 1:]


def disp_lipschitz(interp: DispInterp, w: torch.Tensor) -> torch.Tensor:
    """Certified bound on |grad u|: coef * sum_k |w_k| + |B|_F."""
    m = interp.centers.shape[0]
    return (_kernel_lipschitz_coef(interp)
            * torch.sum(torch.sqrt(torch.sum(w[:m] ** 2, -1)))
            + torch.sqrt(torch.sum(w[m + 1:] ** 2)))


def disp_slack(interp: DispInterp, w: torch.Tensor) -> torch.Tensor:
    """2 * (bound on max |u| over the tissue): u interpolates its center
    values, so max|u| <= max_j |u(c_j)| + L * fill_dist."""
    u_c = sample_disp_rbf(interp, w, interp.centers)
    return 2.0 * (torch.amax(torch.sqrt(torch.sum(u_c ** 2, -1)))
                  + disp_lipschitz(interp, w) * interp.fill_dist)


def disp_bounds_sampled(interp: DispInterp, w: torch.Tensor,
                        pts: torch.Tensor, l_safety: float = 1.25,
                        u_safety: float = 1.15):
    """(shrink, slack) march-step factors from |grad u| and |u| sampled at
    `pts` (mesh nodes), extended between samples by the safety factors.
    Constants: they steer the march and carry no gradient."""
    with torch.no_grad():
        m = interp.centers.shape[0]
        diff = pts[:, None] - interp.centers[None]                  # [N, M, 3]
        d = torch.sqrt(torch.clamp(torch.sum(diff ** 2, -1), min=1e-24))
        u = _phi_dist(interp, d) @ w[:m] + w[m] + pts @ w[m + 1:]
        g = torch.einsum("nka,kb->nab", diff * _dphi_over_d(interp, d)[..., None],
                         w[:m]) + w[m + 1:]
        l_max = torch.sqrt(torch.amax(torch.sum(g ** 2, (-2, -1))))
        u_max = torch.sqrt(torch.amax(torch.sum(u ** 2, -1)))
        return (torch.clamp(1.0 - l_safety * l_max, 0.0, 1.0),
                2.0 * u_safety * u_max)


def wendland_spec(interp: DispInterp, w: torch.Tensor,
                  k_refresh: int = 0,
                  certified: bool = False) -> WendlandSpec:
    """Per-frame spec for the Wendland tile trace (K2): centers padded to
    a CEN_BLOCK multiple (pad rows at 1e6 with zero weights never test
    live), plus the per-block march-bound inputs. Each eval of the trace
    refreshes with one fixed-point pull-back iteration.

    certified=False: bu/bg are |u| and |grad u| SAMPLED at the centers
    (exact there) and extended between samples by the march's 1.15 / 1.25
    safety factors: tight, but a heuristic, since |u| between centers can
    in principle exceed the factored sample maxima, and then the march
    oversteps silently. certified=True: bu/bg are rigorous per-block
    bounds: every point within reach of block b's support satisfies
    |u(x)| <= sum of |w_k| over the blocks whose boxes lie within 2 sigma
    of b's (phi <= 1), and |grad u| likewise with the kernel's slope
    bound. Loose (no cancellation), so marches slow down, but the step
    bounds then hold unconditionally. The bracket inflation `max_disp` is
    this frame's |u| bound from bu/bg."""
    if interp.kind != "wendland":
        raise ValueError(f"wendland_spec needs a Wendland interpolant, got "
                         f"{interp.kind!r}")
    m = interp.centers.shape[0]
    mp = -(-m // CEN_BLOCK) * CEN_BLOCK
    dev = interp.centers.device
    wk = w[:m].float()
    cen, wr = interp.centers, wk
    if mp > m:
        cen = torch.cat([cen, torch.full((mp - m, 3), 1e6, device=dev)], 0)
        wr = torch.cat([wk, wk.new_zeros((mp - m, 3))], 0)
    waff = w[m:].T.float()
    c = interp.centers

    def pad(v):
        return torch.cat([v, v.new_zeros(mp - m)], 0) if mp > m else v

    if certified:
        blk_sum = pad(torch.sqrt(torch.sum(wk * wk, -1))).reshape(
            -1, CEN_BLOCK).sum(1)                            # [NBc]
        cb = cen.reshape(-1, CEN_BLOCK, 3)
        b_lo, b_hi = cb.amin(1), cb.amax(1)
        reach = 2.0 * interp.sigma
        near = torch.all((b_lo[:, None] <= b_hi[None] + reach)
                         & (b_hi[:, None] >= b_lo[None] - reach), -1)
        bu = near.to(blk_sum.dtype) @ blk_sum
        bg = (WENDLAND_DPHI_MAX / interp.sigma) * bu
    else:
        diff = c[:, None] - c[None]                          # [M, M, 3]
        d = torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=1e-24))
        u_c = _phi_dist(interp, d) @ wk + w[m] + c @ w[m + 1:]
        g_c = torch.einsum(
            "jka,kb->jab", diff * _dphi_over_d(interp, d)[..., None], wk
        ) + w[m + 1:]
        un = torch.sqrt(torch.sum(u_c * u_c, -1))
        gn = torch.sqrt(torch.sum(g_c * g_c, (-2, -1)))
        bu = pad(un).reshape(-1, CEN_BLOCK).amax(1)
        bg = pad(gn).reshape(-1, CEN_BLOCK).amax(1)
    bfr = torch.sqrt(torch.sum(w[m + 1:] ** 2))
    if certified:
        max_disp = torch.amax(bu)
    else:
        # Max over centers (u interpolates there) with the between-sample
        # safety, plus the Lipschitz fill term.
        max_disp = 1.15 * torch.amax(bu) + torch.amax(bg) * interp.fill_dist
    return WendlandSpec(
        centers=cen, w=wr, waff=waff, bu=bu.detach(), bg=bg.detach(),
        bfr=bfr.detach(), max_disp=max_disp.float().detach(),
        sigma=float(interp.sigma), k_refresh=int(k_refresh),
    )


def pull_back_rbf(interp: DispInterp, w: torch.Tensor, y: torch.Tensor,
                  iters: int = FIXED_POINT_ITERS) -> torch.Tensor:
    """Invert phi(x) = x + u(x) by the fixed point x <- y - u(x)."""
    x = y
    for _ in range(iters):
        x = y - sample_disp_rbf(interp, w, x)
    return x


def deformed_field_rbf(scene: Scene, interp: DispInterp, w: torch.Tensor,
                       y: torch.Tensor,
                       iters: int = FIXED_POINT_ITERS) -> torch.Tensor:
    return field(scene, pull_back_rbf(interp, w, y, iters))


def march_step_bounds(interp: DispInterp, w: torch.Tensor,
                      bound_pts: torch.Tensor | None = None):
    """The deformed march's (shrink, slack) step factors, as constants:
    sampled at `bound_pts` (disp_bounds_sampled) or, without them, the
    certified global bounds clamp(1 - L, 0, 1) and disp_slack."""
    if bound_pts is not None:
        return disp_bounds_sampled(interp, w.detach(), bound_pts)
    with torch.no_grad():
        return (torch.clamp(1.0 - disp_lipschitz(interp, w), 0.0, 1.0),
                disp_slack(interp, w))


def trace_deformed_rbf(scene: Scene, interp: DispInterp, w: torch.Tensor,
                       ro: torch.Tensor, rd: torch.Tensor,
                       params: TraceParams = TraceParams(),
                       max_disp: float = 0.5,
                       fp_iters: int = FIXED_POINT_ITERS,
                       bound_pts: torch.Tensor | None = None):
    """Dense sphere trace of the RBF-deformed field: every eval pulls
    back through all centers with `fp_iters` fixed-point iterations from
    scratch; steps use max((1 - L) d, d - 2 max|u|) with (shrink, slack)
    sampled at `bound_pts` or, without them, the certified global bounds.
    The exact plain tracer the tile traces are held to; t is
    differentiable in w (and the scene) by implicit differentiation."""
    iso = params.iso
    lo = scene.bbox_lo - 0.05 - max_disp
    hi = scene.bbox_hi + 0.05 + max_disp
    if scene.can_cull:
        t_enter, t_exit, alive0 = prim_interval(scene, ro, rd,
                                                margin=0.05 + max_disp)
    else:
        t_enter, t_exit = _ray_box(ro, rd, lo[None], hi[None])
        alive0 = t_exit > t_enter
        t_enter = torch.where(alive0, t_enter, 0.0)
        t_exit = torch.where(alive0, t_exit, 0.0)
    base_step = torch.linalg.norm(hi - lo) * params.step_frac
    inv_stretch = 1.0 / max(scene.max_world_to_local_scale, 1e-6)
    shrink, slack = march_step_bounds(interp, w, bound_pts)

    def step_size(fv):
        if not scene.monotone_field:
            return base_step
        d = (support_radius_bound(fv) - params.r_iso) * inv_stretch
        return torch.maximum(
            base_step, 0.95 * torch.maximum(shrink * d, d - slack)
        )

    def eval_f(t):
        return deformed_field_rbf(scene, interp, w, ro + t[:, None] * rd,
                                  fp_iters) - iso

    with torch.no_grad():
        t_root, found = march_all(eval_f, step_size, t_enter, t_exit,
                                  alive0, params)
    t_hit = newton_nudge(
        lambda p: deformed_field_rbf(scene, interp, w, p, fp_iters) - iso,
        ro, rd, t_root, found, 0.5 * base_step,
    )
    return t_hit, found


def biharmonic_spec(interp: DispInterp, w: torch.Tensor, shrink, slack,
                    max_disp: float = 0.5,
                    fp_iters: int = FIXED_POINT_ITERS) -> BiharmonicSpec:
    """Per-frame spec for the biharmonic tile trace (K4): the centers, the
    weights and the global march-step factors, as constants."""
    return BiharmonicSpec(
        centers=interp.centers.float().contiguous(),
        w=w.detach().float(),
        shrink=torch.as_tensor(shrink).detach().float(),
        slack=torch.as_tensor(slack).detach().float(),
        max_disp=float(max_disp),
        fp_iters=int(fp_iters),
    )


def trace_deformed_rbf_fast(scene: Scene, interp: DispInterp,
                            w: torch.Tensor, ro: torch.Tensor,
                            rd: torch.Tensor,
                            params: TraceParams = TraceParams(),
                            max_disp: float = 0.5,
                            image_hw: tuple[int, int] | None = None,
                            fp_iters: int = FIXED_POINT_ITERS,
                            need_grads: bool = True,
                            bound_pts: torch.Tensor | None = None,
                            tile: int | None = None, k_refresh: int = 0):
    """RBF-deformed sphere trace through the tile tracer: K4 for a
    biharmonic interpolant (fp_iters pull-back iterations from scratch per
    eval, global (shrink, slack) from `bound_pts` or the certified
    bounds, brackets inflated by the static `max_disp`), K2 for a
    Wendland one (per-tile bounds from the compact support, brackets
    inflated by this frame's |u| bound). The kernel's raw roots are
    constants; with need_grads the implicit-differentiation correction
    against the dense deformed field makes t differentiable in w.
    image_hw enables the block-coherent pixel permutation for row-major
    H x W ray grids. Scenes off the additive tile path take the dense
    tracer."""
    tile = TILE if tile is None else tile
    if not (is_additive_path(scene) and supports_rows_fast_path(scene)):
        return trace_deformed_rbf(scene, interp, w, ro, rd, params, max_disp,
                                  fp_iters, bound_pts=bound_pts)
    wd = w.detach()
    if interp.kind == "wendland":
        disp = wendland_spec(interp, wd, k_refresh=k_refresh)
    else:
        shrink, slack = march_step_bounds(interp, wd, bound_pts)
        disp = biharmonic_spec(interp, wd, shrink, slack, max_disp, fp_iters)
    with torch.no_grad():
        if image_hw is not None:
            t_root, found = trace_tiles_image(scene, ro, rd, image_hw[0],
                                              image_hw[1], params, tile, disp)
        else:
            t_root, found = trace_tiles(scene, ro, rd, params, tile, disp)
    if not need_grads:
        return t_root, found
    iso = params.iso
    lo = scene.bbox_lo - 0.05 - max_disp
    hi = scene.bbox_hi + 0.05 + max_disp
    base_step = torch.linalg.norm(hi - lo) * params.step_frac
    t_hit = newton_nudge(
        lambda p: deformed_field_rbf(scene, interp, w, p, fp_iters) - iso,
        ro, rd, t_root, found, 0.5 * base_step,
    )
    return t_hit, found


def coupled_step_fast(scene: Scene, fem_mesh, interp: DispInterp,
                      state, f_ext: torch.Tensor,
                      ro: torch.Tensor, rd: torch.Tensor,
                      h: float = 0.0333,
                      E_scale: torch.Tensor | float | None = 1.0,
                      params: TraceParams = TraceParams(),
                      image_hw: tuple[int, int] | None = None,
                      differentiable: bool = False,
                      cg_tol: float | None = None,
                      max_disp: float = 0.5,
                      fp_iters: int = FIXED_POINT_ITERS,
                      bound_pts: torch.Tensor | None = None,
                      tile: int = TILE, k_refresh: int = 0,
                      solve_stats: dict | None = None):
    """The coupled frame on the unstructured solver: force -> implicit
    FEM step (fem.integrator.timestep on a fem.tetmesh.FemMesh, `state`
    and f_ext [N, 3]) -> RBF weights (one product) -> deformed tile
    trace. differentiable=False, the rendering default, warm-starts PCG
    from state.dv; differentiable=True is the training step: the solve
    runs cold and adjoint-differentiable and the trace applies its
    implicit-differentiation correction, so a loss on t reaches E_scale
    (which scales the element stiffness, Young's modulus) and the scene.
    max_disp inflates the biharmonic trace's brackets and must bound the
    frame's |u| (see coupling_telemetry). Returns (t, hit, new_state,
    cg_iterations); the count is -1 on the differentiable solve, whose
    counts go to `solve_stats`."""
    from ..fem import integrator as integ

    mesh2 = fem_mesh if E_scale is None else dataclasses.replace(
        fem_mesh, ke=fem_mesh.ke * E_scale)
    kw = {} if cg_tol is None else {"cg_tol": cg_tol}
    new_state, iters = integ.timestep(mesh2, state, f_ext, h=h,
                                      differentiable=differentiable,
                                      solve_stats=solve_stats, **kw)
    w = disp_weights(interp, new_state.q)
    t, hit = trace_deformed_rbf_fast(
        scene, interp, w, ro, rd, params, max_disp=max_disp,
        image_hw=image_hw, fp_iters=fp_iters, need_grads=differentiable,
        bound_pts=bound_pts, tile=tile, k_refresh=k_refresh,
    )
    return t, hit, new_state, iters


def coupled_step(scene: Scene, fem_mesh, grid: GridSpec,
                 grid_to_node: torch.Tensor, state, f_ext: torch.Tensor,
                 ro: torch.Tensor, rd: torch.Tensor,
                 h: float = 0.0333,
                 E_scale: torch.Tensor | float = 1.0,
                 params: TraceParams = TraceParams()):
    """The exact differentiable frame: force -> implicit FEM solve
    (adjoint-differentiable) -> trilinear displacement field -> dense
    deformed trace. Returns (t_hit, hit_mask, new_state). E_scale scales
    Young's modulus, so d(image loss)/d(E_scale) is the material
    gradient; gradients also reach the BlobTree's parameters through the
    rest field."""
    from ..fem import integrator as integ

    mesh2 = dataclasses.replace(fem_mesh, ke=fem_mesh.ke * E_scale)
    new_state, _ = integ.timestep(mesh2, state, f_ext, h=h,
                                  differentiable=True)
    u_grid = displacement_grid(grid, grid_to_node, new_state.q)
    t, hit = trace_deformed(scene, grid, u_grid, ro, rd, params)
    return t, hit, new_state


def coupled_step_grid_fast(scene: Scene, gf, interp: DispInterp,
                           center_grid_idx: torch.Tensor,
                           state, f_ext: torch.Tensor,
                           ro: torch.Tensor, rd: torch.Tensor,
                           h: float = 0.0333,
                           E_scale: torch.Tensor | float | None = 1.0,
                           params: TraceParams = TraceParams(),
                           image_hw: tuple[int, int] | None = None,
                           differentiable: bool = False,
                           cg_tol: float | None = None,
                           max_disp: float = 0.5,
                           fp_iters: int = FIXED_POINT_ITERS,
                           bound_pts: torch.Tensor | None = None,
                           tile: int = TILE, k_refresh: int = 0,
                           solve_stats: dict | None = None):
    """The coupled frame: grid-FEM implicit step -> RBF weights from the
    centers' displacements -> deformed tile trace. `gf` is a
    fem.grid_fem.GridFem, `state` a grid FemState ([X,Y,Z,3] fields),
    f_ext [X,Y,Z,3], and `center_grid_idx` [M] maps the interpolant's
    centers to flat grid vertices. E_scale scales the element stiffness
    (Young's modulus). differentiable=True is the training step: the
    solve runs cold and adjoint-differentiable, and the trace applies its
    implicit-differentiation correction, so a loss on t reaches E_scale.
    `solve_stats`, if given, receives the CG iteration counts. Returns
    (t, hit, new_state, cg_iterations)."""
    from ..fem import grid_fem as gfm

    gf2 = gf if E_scale is None else dataclasses.replace(gf,
                                                         ke=gf.ke * E_scale)
    kw = {} if cg_tol is None else {"cg_tol": cg_tol}
    new_state, iters = gfm.timestep(gf2, state, f_ext, h=h,
                                    differentiable=differentiable,
                                    solve_stats=solve_stats, **kw)
    u_c = new_state.q.reshape(-1, 3)[center_grid_idx]
    w = disp_weights_centers(interp, u_c)
    t, hit = trace_deformed_rbf_fast(
        scene, interp, w, ro, rd, params, max_disp=max_disp,
        image_hw=image_hw, fp_iters=fp_iters, need_grads=differentiable,
        bound_pts=bound_pts, tile=tile, k_refresh=k_refresh,
    )
    return t, hit, new_state, iters


def max_disp_bound(interp: DispInterp, w: torch.Tensor,
                   q: torch.Tensor) -> torch.Tensor:
    """Per-frame upper bound on |u(x)| over the tissue: u interpolates the
    nodal state q [N, 3] at the centers, so max|u| <= max_j |q(c_j)| +
    L * fill_dist with L = disp_lipschitz(w). Checks that a static
    `max_disp` bracket inflation covers the frame."""
    u_c = torch.sqrt(torch.sum(q[interp.center_nodes.long()] ** 2, -1))
    return torch.amax(u_c) + disp_lipschitz(interp, w) * interp.fill_dist


def coupling_telemetry(interp: DispInterp, w: torch.Tensor,
                       q: torch.Tensor) -> dict:
    """Per-frame coupling health: the displacement Lipschitz bound L, the
    adaptive march's shrink factor clamp(1 - L) (0 means the trace
    degraded to fixed stepping), and the max-|u| bound that must stay
    under the static max_disp inflation. Tensors on the device: log them,
    do not branch on them. q is the full nodal state [N, 3] or the
    already gathered center rows [M, 3]."""
    L = disp_lipschitz(interp, w)
    u = q if q.shape[0] == interp.centers.shape[0] else (
        q[interp.center_nodes.long()])
    u_c = torch.sqrt(torch.sum(u ** 2, -1))
    return {
        "disp_lipschitz": L,
        "march_shrink": torch.clamp(1.0 - L, 0.0, 1.0),
        "max_disp_bound": torch.amax(u_c) + L * interp.fill_dist,
    }
