"""The plain sphere trace of an image, rest or deformed, and the work it
needs.

Rays come from an orbit camera (pixel centres, 45 degree field of view).
The image is cut into tiles of 16 x 16 pixels; a ray is bracketed by the
primitives' support boxes grown by 0.05 and the frame's displacement
bound; then it marches to the first crossing of the iso value 0.5, with
steps from the Wyvill kernel's support radius and the tile's stretch and
displacement bounds, two sub-steps an iteration for at most 160, six
halvings and a secant. A deformed field is the rest field at the point
pulled back through the displacement: for a Wendland interpolant one
fixed-point iteration a refresh and a linear model of the rest point in
between (a refresh every `k_refresh` sub-steps and at the first halving);
for a biharmonic one `fp_iters` iterations from scratch at every point.
This is the march the FemBrain port's tile kernels run (K1, K2, K4),
written again for every ray on its own: a ray's march does not depend on
its neighbours, only the step bounds are the tile's.

`Work` counts what a frame's march needs (the evaluations whose value it
uses, the primitives whose support box holds each point, the centres of
each pull-back); `bound_s` turns that into the least time an H100 could
take.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .field import Field, Precision
from .scene import ISO, RefScene

TILE = 256
MAX_STEPS, BISECT_STEPS, STEP_FRAC = 160, 6, 1.0 / 160
R_ISO = float(np.sqrt(np.float32(1.0 - ISO ** (1.0 / 3.0))))
PRIM_BLOCK, CEN_BLOCK, HULL_EPS = 8, 32, 1e-4
FOVY_DEG = 45.0
RAY_CHUNK = 1 << 18

# fp32 operations of one evaluation (an FMA counts 2): per primitive the
# world -> local transform 18 and the Wyvill kernel 4, plus the skeleton
# distance (point 8, cylinder 24); per biharmonic centre 16, per
# Wendland centre within reach 23, per pull-back iteration 24 besides.
PRIM_FLOPS = {"POINT": 30, "CYLINDER": 46}
BIHARMONIC_CENTER_FLOPS, WENDLAND_CENTER_FLOPS, PULL_TAIL_FLOPS = 16, 23, 24
# Bytes a launch must move: of every ray its liveness and t_exit read,
# t and hit written; of a ray that starts alive seven more rows.
RAY_BYTES_DEAD, RAY_BYTES_ALIVE = 16, 28


@dataclasses.dataclass
class Work:
    lane_evals: int = 0
    prim_evals: dict = dataclasses.field(default_factory=dict)
    pull_iters: int = 0
    biharmonic_center_evals: int = 0
    wendland_center_evals: int = 0
    rays: int = 0
    rays_alive: int = 0

    @property
    def flops(self) -> int:
        return (sum(c * PRIM_FLOPS[k] for k, c in self.prim_evals.items())
                + self.biharmonic_center_evals * BIHARMONIC_CENTER_FLOPS
                + self.wendland_center_evals * WENDLAND_CENTER_FLOPS
                + self.pull_iters * PULL_TAIL_FLOPS)

    @property
    def bytes(self) -> int:
        return RAY_BYTES_DEAD * self.rays + RAY_BYTES_ALIVE * self.rays_alive

    def bound_s(self, peak_flops: float, peak_bytes: float) -> float:
        return max(self.flops / peak_flops, self.bytes / peak_bytes)


def support_radius_bound(fv):
    r = torch.full_like(fv, 0.4542)
    for lim, val in ((0.30, 0.5749), (0.20, 0.6444), (0.15, 0.6846),
                     (0.10, 0.7320), (0.05, 0.7947), (0.02, 0.8536),
                     (0.005, 0.9105), (0.001, 0.9487), (0.0001, 0.9765)):
        r = torch.where(fv <= lim, val, r)
    return r


def orbit_rays(roll, tilt, zoom, width, height, device):
    """Row-major rays ([H*W, 3] origins, directions) of the orbit pose."""
    r, t = np.deg2rad(roll), np.deg2rad(tilt)
    eye = np.array([zoom * np.cos(t) * np.sin(r), zoom * np.sin(t),
                    zoom * np.cos(t) * np.cos(r)])
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    eye, target, up = f32(eye), f32([0, 0, 0]), f32([0, 1, 0])
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    up = torch.linalg.cross(right, fwd)
    tan_half = torch.tan(torch.deg2rad(f32(FOVY_DEG)) * 0.5)
    ys = (0.5 - (torch.arange(height, device=device, dtype=torch.float32)
                 + 0.5) / height) * 2.0 * tan_half
    xs = ((torch.arange(width, device=device, dtype=torch.float32) + 0.5)
          / width - 0.5) * 2.0 * tan_half * (width / height)
    d = fwd + xs[None, :, None] * right + ys[:, None, None] * up
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.broadcast_to(eye, d.shape)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def to_tiles(ro, rd, height, width):
    """Rays in 16 x 16 pixel tiles (padding rays start far off along +x)
    and the map of a per-ray result back to row-major order."""
    b = int(math.isqrt(TILE))
    hb, wb = -(-height // b), -(-width // b)

    def blocks(a, fill):
        img = torch.nn.functional.pad(
            a.reshape(height, width, 3),
            (0, 0, 0, wb * b - width, 0, hb * b - height), value=fill)
        return img.reshape(hb, b, wb, b, 3).permute(0, 2, 1, 3, 4).reshape(-1, 3)

    ro_t, rd_t = blocks(ro, 1e7), blocks(rd, 0.0)
    real = blocks(torch.ones_like(ro), 0.0)[:, :1] > 0.5
    rd_t = torch.where(real, rd_t, torch.tensor([1.0, 0.0, 0.0],
                                                device=rd.device))

    def back(v):
        img = v.reshape(hb, wb, b, b).permute(0, 2, 1, 3)
        return img.reshape(hb * b, wb * b)[:height, :width].reshape(-1)

    return ro_t, rd_t, back


def _safe_inv(rd):
    return 1.0 / torch.where(torch.abs(rd) < 1e-12,
                             torch.where(rd < 0, -1e-12, 1e-12), rd)


def bracket(scene: RefScene, ro, rd, margin):
    """Per ray [t_enter, t_exit] over the support boxes grown by
    `margin`, within the scene box grown by it; alive where any box is
    met."""
    dev = ro.device
    lo_b = torch.as_tensor(scene.box_lo, device=dev)
    hi_b = torch.as_tensor(scene.box_hi, device=dev)
    outs = []
    for i in range(0, ro.shape[0], RAY_CHUNK):
        o, inv = ro[i:i + RAY_CHUNK], _safe_inv(rd[i:i + RAY_CHUNK])
        ta = (lo_b[None] - margin - o[:, None]) * inv[:, None]
        tb = (hi_b[None] + margin - o[:, None]) * inv[:, None]
        enter = torch.clamp(torch.minimum(ta, tb).amax(-1), min=0.0)
        exit_ = torch.maximum(ta, tb).amin(-1)
        ok = (exit_ >= enter) & (exit_ > 0.0)
        t0 = torch.where(ok, enter, torch.inf).amin(-1)
        t1 = torch.where(ok, exit_, -torch.inf).amax(-1)
        lo = torch.as_tensor(scene.bbox_lo, device=dev) - margin
        hi = torch.as_tensor(scene.bbox_hi, device=dev) + margin
        sa, sb = (lo[None] - o) * inv, (hi[None] - o) * inv
        s0 = torch.clamp(torch.minimum(sa, sb).amax(-1), min=0.0)
        s1 = torch.maximum(sa, sb).amin(-1)
        t0, t1 = torch.maximum(t0, s0), torch.minimum(t1, s1)
        alive = ok.any(-1) & (s1 > s0) & (t1 >= t0)
        outs.append((torch.where(alive, t0, 0.0), torch.where(alive, t1, 0.0),
                     alive))
    return tuple(torch.cat(p) for p in zip(*outs))


def _morton(points, lo, hi):
    qn = np.clip((points - lo) / np.maximum(hi - lo, np.float32(1e-6)),
                 0.0, 1.0)
    q = (qn * np.float32(1023.0)).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def prim_blocks(scene: RefScene, device):
    """Blocks of 8 primitives in Morton order of their box centres:
    (block boxes lo, hi [B, 3], block stretch [B]); a block's stretch is
    the largest over its primitives of min(|A|_F, the scene's stretch)."""
    n = scene.n_prims
    cap = -(-max(n, 8) // PRIM_BLOCK) * PRIM_BLOCK
    centers = np.float32(0.5) * (scene.box_lo + scene.box_hi)
    code = _morton(centers, scene.bbox_lo, scene.bbox_hi)
    order = np.argsort(np.concatenate(
        [code, np.full(cap - n, 0xFFFFFFFF, np.uint32)]), kind="stable")
    lo = np.concatenate([scene.box_lo, np.full((cap - n, 3), 1e8, np.float32)])
    hi = np.concatenate([scene.box_hi, np.full((cap - n, 3), -1e8, np.float32)])
    a = torch.as_tensor(np.concatenate(
        [scene.bwd[:, :, :3], np.zeros((cap - n, 3, 3))]).astype(np.float32))
    frob = torch.sqrt(torch.sum(a ** 2, (1, 2)))
    per = torch.clamp(frob, max=float(np.float32(scene.stretch)))
    per = torch.where(torch.arange(cap) < n, per, 0.0)
    o = torch.as_tensor(order)
    blo = torch.as_tensor(lo)[o].reshape(-1, PRIM_BLOCK, 3).amin(1)
    bhi = torch.as_tensor(hi)[o].reshape(-1, PRIM_BLOCK, 3).amax(1)
    return (blo.to(device), bhi.to(device),
            per[o].reshape(-1, PRIM_BLOCK).amax(1).to(device))


def _hull_live(h_lo, h_hi, lo, hi):
    return torch.all((h_lo[:, None] <= hi[None] + HULL_EPS)
                     & (h_hi[:, None] >= lo[None] - HULL_EPS), -1)


@dataclasses.dataclass
class Wendland:
    """A Wendland displacement u(x) = sum_k w_k phi(|x - c_k| / sigma),
    phi(t) = (1 - t)^4 (4 t + 1), centres in Morton order, and its per
    block of 32 centres sampled bounds (reference.interp builds it)."""

    centers: torch.Tensor   # [Mp, 3] (padding rows at 1e6)
    w: torch.Tensor         # [Mp, 3]
    waff: torch.Tensor      # [3, 4] affine tail (zero for Wendland)
    bu: torch.Tensor        # [Mp / 32]
    bg: torch.Tensor
    bfr: torch.Tensor       # []
    max_disp: torch.Tensor  # []
    sigma: float
    k_refresh: int


@dataclasses.dataclass
class Biharmonic:
    """u(x) = sum_k w_k |x - c_k| + a + B x, `fp_iters` pull-back
    iterations an evaluation, global step factors (shrink, slack)."""

    centers: torch.Tensor   # [M, 3]
    w: torch.Tensor         # [M, 3]
    waff: torch.Tensor      # [3, 4]
    shrink: torch.Tensor
    slack: torch.Tensor
    max_disp: float
    fp_iters: int


def tile_bounds(scene, ro, rd, t0, t1, alive0, disp, max_disp, prec):
    """Per ray (inv_stretch, shrink, slack, drift) from its tile."""
    dev = ro.device
    tiles = ro.shape[0] // TILE

    def hull(pick):
        a, b = ro + t0[:, None] * rd, ro + t1[:, None] * rd
        v = torch.where(alive0[:, None], pick(a, b),
                        torch.inf if pick is torch.minimum else -torch.inf)
        return v.reshape(tiles, -1, 3)

    h_lo = hull(torch.minimum).amin(1)
    h_hi = hull(torch.maximum).amax(1)
    blo, bhi, bst = prim_blocks(scene, dev)
    live = _hull_live(h_lo, h_hi, blo - max_disp, bhi + max_disp)
    inv = 1.0 / torch.clamp(torch.where(live, bst[None], 0.0).amax(-1),
                            min=1e-6)
    shrink = torch.ones_like(inv)
    slack = torch.zeros_like(inv)
    drift = torch.zeros_like(inv)
    if isinstance(disp, Wendland):
        cb = disp.centers.reshape(-1, CEN_BLOCK, 3)
        clive = _hull_live(h_lo, h_hi, cb.amin(1) - disp.sigma - max_disp,
                           cb.amax(1) + disp.sigma + max_disp)
        any_alive = alive0.reshape(tiles, -1).any(-1)
        g = torch.where(clive, disp.bg[None], 0.0).amax(-1)
        u = torch.where(clive, disp.bu[None], 0.0).amax(-1)
        h_c = 0.5 * (h_lo + h_hi)
        h_r = torch.linalg.norm(0.5 * (h_hi - h_lo), dim=-1) + max_disp
        aff = disp.waff[:, 0][None] + prec.mm(h_c, disp.waff[:, 1:4].T)
        aff_u = torch.linalg.norm(aff, dim=-1) + disp.bfr * h_r
        lt = torch.maximum(1.25 * g, disp.bfr)
        um = torch.maximum(1.15 * u, aff_u)
        shrink = torch.where(any_alive, torch.clamp(1.0 - lt, 0.0, 1.0), 1.0)
        slack = torch.where(any_alive, 2.0 * um, 0.0)
        drift = torch.where(any_alive, lt, 0.0)
    elif isinstance(disp, Biharmonic):
        shrink = torch.broadcast_to(disp.shrink, inv.shape)
        slack = torch.broadcast_to(disp.slack, inv.shape)
    per_ray = torch.arange(ro.shape[0], device=dev) // TILE
    return tuple(v[per_ray] for v in (inv, shrink, slack, drift))


class Marcher:
    """The march of one chunk of rays; `work` (a Work or None) counts."""

    def __init__(self, field: Field, disp, prec: Precision, base_step, work):
        self.f, self.disp, self.prec = field, disp, prec
        self.base_step, self.work = base_step, work

    def rest_field(self, p, need):
        if self.work is not None:
            for k, c in self.f.in_reach(p, need).items():
                self.work.prim_evals[k] = self.work.prim_evals.get(k, 0) + c
        return self.f(p) - ISO

    def wendland_u(self, x, need):
        """u at the points x, centres summed a block of 32 at a time."""
        d = self.disp
        if self.work is not None:
            self.work.pull_iters += int(need.sum())
        u = d.waff[:, 0][None] + self.prec.mm(x, d.waff[:, 1:4].T)
        for b in range(0, d.centers.shape[0], CEN_BLOCK):
            c = d.centers[b:b + CEN_BLOCK]
            diff = x[:, None] - c[None]
            t = torch.clamp(torch.sqrt(torch.sum(diff * diff, -1))
                            * (1.0 / d.sigma), max=1.0)
            if self.work is not None:
                self.work.wendland_center_evals += int(
                    ((t < 1.0) & need[:, None]).sum())
            omt = 1.0 - t
            o2 = omt * omt
            phi = o2 * o2 * (4.0 * t + 1.0)
            u = u + torch.sum(d.w[None, b:b + CEN_BLOCK] * phi[..., None], 1)
        return u

    def biharmonic_pull(self, p, need):
        d = self.disp
        x = p
        for _ in range(d.fp_iters):
            r = torch.sqrt(torch.clamp(
                torch.sum((x[:, None] - d.centers[None]) ** 2, -1), min=1e-24))
            x = p - (d.waff[:, 0][None] + self.prec.mm(x, d.waff[:, 1:4].T)
                     + torch.sum(r[..., None] * d.w[None], 1))
        if self.work is not None:
            it = int(need.sum()) * d.fp_iters
            self.work.pull_iters += it
            self.work.biharmonic_center_evals += it * d.centers.shape[0]
        return x

    def run(self, ro, rd, t0, t1, alive0, inv, shrink, slack, drift):
        w, wend = self.work, isinstance(self.disp, Wendland)
        point = lambda t: ro + t[:, None] * rd
        everyone = torch.ones_like(alive0)

        def ev(t, carry, refresh, upd, need):
            if w is not None:
                w.lane_evals += int(need.sum())
            p = point(t)
            if wend:
                if refresh:
                    x_r, v, t_r = carry
                    adv = t - t_r
                    est = x_r + adv[:, None] * v
                    x2 = p - self.wendland_u(est, need)
                    big = adv > 1e-5
                    inv_adv = 1.0 / torch.where(big, adv, 1.0)
                    v2 = torch.where(big[:, None], (x2 - x_r) * inv_adv[:, None], v)
                    carry = (torch.where(upd[:, None], x2, x_r),
                             torch.where(upd[:, None], v2, v),
                             torch.where(upd, t, t_r))
                x_r, v, t_r = carry
                return self.rest_field(x_r + (t - t_r)[:, None] * v, need), carry
            if isinstance(self.disp, Biharmonic):
                p = self.biharmonic_pull(p, need)
            return self.rest_field(p, need), carry

        def step(f, t, carry):
            d = (support_radius_bound(f + ISO) - R_ISO) * inv
            if wend:
                d = d - 2.0 * drift * torch.abs(t - carry[2])
            d = torch.maximum(shrink * d, d - slack)
            return torch.clamp(0.95 * d, min=self.base_step)

        carry = (point(t0), rd, t0) if wend else ()
        subs = [True] + [False] * (self.disp.k_refresh - 1) if wend else [False, False]
        f0, carry = ev(t0, carry, True, everyone, alive0)
        t, f, tp, fp = t0, f0, t0, f0
        found = alive0 & (f0 >= 0.0)
        alive = alive0 & (f0 < 0.0)
        it = 0
        while it < MAX_STEPS and bool(alive.any()):
            for refresh in subs:
                tn = torch.minimum(t + step(f, t, carry), t1)
                m = alive
                fn, carry = ev(tn, carry, refresh, m, m)
                crossed = m & (fn >= 0.0)
                done = m & (tn >= t1) & (fn < 0.0)
                tp, fp = torch.where(m, t, tp), torch.where(m, f, fp)
                t, f = torch.where(m, tn, t), torch.where(m, fn, f)
                found = found | crossed
                alive = alive & ~crossed & ~done
            it += len(subs)
        a, b, fa, fb = tp, t, fp, f
        for i in range(BISECT_STEPS):
            mid = 0.5 * (a + b)
            fm, carry = ev(mid, carry, i == 0, everyone, found)
            neg = fm < 0.0
            a, b = torch.where(neg, mid, a), torch.where(neg, b, mid)
            fa, fb = torch.where(neg, fm, fa), torch.where(neg, fb, fm)
        den = fb - fa
        ts = a - fa * (b - a) / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
        root = torch.where(torch.abs(den) < 1e-9, 0.5 * (a + b), ts)
        slope = den / torch.clamp(b - a, min=1e-30)
        return torch.where(found, root, t1), found, slope


def trace_image(scene: RefScene, ro, rd, height, width, disp=None,
                prec: Precision | None = None, work: Work | None = None,
                slope: bool = False):
    """Row-major (t [H*W], hit [H*W]) of the rest (disp None) or deformed
    scene; misses return their t_exit. With `slope`, also the field's
    rise along the ray at each hit, d(f - iso)/dt over the last bracket."""
    prec = prec or Precision()
    dev = ro.device
    if isinstance(disp, Wendland):
        max_disp = disp.max_disp
    elif isinstance(disp, Biharmonic):
        max_disp = torch.tensor(disp.max_disp, device=dev)
    else:
        max_disp = torch.zeros((), device=dev)
    ro_t, rd_t, back = to_tiles(ro, rd, height, width)
    t0, t1, alive0 = bracket(scene, ro_t, rd_t, 0.05 + max_disp)
    lo = torch.as_tensor(scene.bbox_lo, device=dev) - max_disp - 0.05
    hi = torch.as_tensor(scene.bbox_hi, device=dev) + max_disp + 0.05
    base_step = float(torch.sqrt(torch.sum((hi - lo) ** 2)) * STEP_FRAC)
    bounds = tile_bounds(scene, ro_t, rd_t, t0, t1, alive0, disp, max_disp,
                         prec)
    if work is not None:
        work.rays += ro_t.shape[0]
        work.rays_alive += int(alive0.sum())
    marcher = Marcher(Field(scene, dev, prec), disp, prec, base_step, work)
    parts = []
    for i in range(0, ro_t.shape[0], RAY_CHUNK):
        s = slice(i, i + RAY_CHUNK)
        parts.append(marcher.run(ro_t[s], rd_t[s], t0[s], t1[s], alive0[s],
                                 *(v[s] for v in bounds)))
    t, hit, rise = (torch.cat(p) for p in zip(*parts))
    out = (back(t), back(hit.float()) > 0.5)
    return (*out, back(rise)) if slope else out


def surface_residual(scene: RefScene, ro, rd, t, hit, disp=None,
                     prec: Precision | None = None, fp_iters: int = 8):
    """|f - iso| at each hit point o + t d (0 elsewhere): how far off the
    surface an answer lies, in field units. The field is the rest field,
    or the deformed one at the point pulled back through `disp` (from
    scratch: the biharmonic interpolant's own `fp_iters` iterations, a
    Wendland one's `fp_iters` fixed-point iterations)."""
    prec = prec or Precision()
    field = Field(scene, ro.device, prec)
    marcher = Marcher(field, disp, prec, 0.0, None)
    out = torch.zeros_like(t)
    idx = torch.nonzero(hit).squeeze(-1)
    for i in range(0, idx.numel(), RAY_CHUNK):
        j = idx[i:i + RAY_CHUNK]
        p = ro[j] + t[j, None] * rd[j]
        if isinstance(disp, Biharmonic):
            p = marcher.biharmonic_pull(p, None)
        elif isinstance(disp, Wendland):
            y = p
            for _ in range(fp_iters):
                p = y - marcher.wendland_u(p, None)
        out[j] = torch.abs(field(p) - ISO)
    return out
