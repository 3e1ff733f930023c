"""Sphere tracing of the BlobTree field in plain torch: ray brackets, the
shared step table, the reference tracer, and shading.

PyTorch counterpart of fembrain_tpu/render/sphere_trace.py. Rays march
in lock-step as one [N] batch with an all-rays-done exit; the step adapts
with the Wyvill support bound; roots are refined by bisection plus a
secant, then nudged by one implicit-differentiation Newton step, which
carries the gradient (`newton_nudge`). The tile tracer
(render.tile_trace) shares `prim_interval`, `support_radius_bound` and
`newton_nudge` with it, so both march identical steps. `shade` turns
hits from any of the tracers into Blinn-Phong colours; `render_image` is
the dense tracer plus `shade`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.utils.checkpoint

from ..blob.scene import Scene
from ..blob.types import ISO_VALUE
from ..graphics.materials import PHONG, Material, triplanar_sample_tensor
from ..ops.field import field, vertex_attributes
from ..utils.profiler import span
from .camera import Camera, generate_rays


@dataclasses.dataclass(frozen=True)
class TraceParams:
    iso: float = ISO_VALUE
    max_steps: int = 160
    # 6 halvings of a near-surface step bracket + the closing secant put
    # the raw root well inside 1e-4.
    bisect_steps: int = 6
    # Base step as a fraction of the scene bbox diagonal.
    step_frac: float = 1 / 160

    @property
    def r_iso(self) -> float:
        """sqrt(1 - iso^(1/3)) rounded to float32, as the tracers use it."""
        return float(np.sqrt(np.float32(1.0 - self.iso ** (1.0 / 3.0))))


def _safe_inv(rd):
    return 1.0 / torch.where(
        torch.abs(rd) < 1e-12, torch.where(rd < 0, -1e-12, 1e-12), rd
    )


def _ray_box(ro, rd, lo, hi):
    """Ray/AABB slab intersection -> (t_enter, t_exit), t_enter >= 0."""
    inv = _safe_inv(rd)
    t0 = (lo - ro) * inv
    t1 = (hi - ro) * inv
    tmin = torch.amax(torch.minimum(t0, t1), -1)
    tmax = torch.amin(torch.maximum(t0, t1), -1)
    return torch.clamp(tmin, min=0.0), tmax


def support_radius_bound(fv):
    """Piecewise-constant lower bound on r(f) = sqrt(1 - f^(1/3)), the
    conservative local distance to the nearest Wyvill skeleton given a
    total field value f. One table shared by every tracer (and the CUDA
    kernel) keeps their march step sequences identical."""
    r = torch.full_like(fv, 0.4542)  # r at f = iso = 0.5
    r = torch.where(fv <= 0.30, 0.5749, r)
    r = torch.where(fv <= 0.20, 0.6444, r)
    r = torch.where(fv <= 0.15, 0.6846, r)
    r = torch.where(fv <= 0.10, 0.7320, r)
    r = torch.where(fv <= 0.05, 0.7947, r)
    r = torch.where(fv <= 0.02, 0.8536, r)
    r = torch.where(fv <= 0.005, 0.9105, r)
    r = torch.where(fv <= 0.001, 0.9487, r)
    r = torch.where(fv <= 0.0001, 0.9765, r)
    return r


# Rays per chunk of the dense [rays, prims] bracket test: bounds the
# temporaries at 1080p (2,073,600 x 163 f32 is 1.35 GB each).
PRIM_INTERVAL_CHUNK = 1 << 18

# Calls of `prim_interval` by path: "card" launched the bracket kernel
# (csrc/ray_bracket.cu), "plain" ran the dense test.
BRACKET = {"card": 0, "plain": 0}


def prim_interval(scene: Scene, ro, rd, margin: float = 0.05):
    """Tight per-ray march bracket from per-primitive support boxes.

    Intersects every ray with every prim's conservative support AABB and
    returns the hull [t_enter, t_exit] of the valid intervals plus an
    any-overlap mask, intersected with the scene slab. The field is
    exactly zero outside the union of the boxes. `margin` inflates every
    box; a float or a 0-d tensor. On a CUDA tensor one launch of the
    bracket kernel gives the plain version's three tensors bit for bit,
    outside autograd (no caller differentiates a march bound); elsewhere
    the plain version, a dense [N, P] test chunked over rays."""
    if ro.is_cuda:
        BRACKET["card"] += 1
        return _prim_interval_cuda(scene, ro, rd, margin)
    BRACKET["plain"] += 1
    return _prim_interval_plain(scene, ro, rd, margin)


def _prim_interval_cuda(scene: Scene, ro, rd, margin):
    """`prim_interval` as one launch of the CUDA bracket kernel on the
    current stream. The inflated boxes, the scene slab last, are rounded
    here as the plain version rounds them; the margin is never read to
    the host."""
    from .. import native

    n, P = ro.shape[0], scene.n_prims
    with torch.no_grad():
        lo = torch.cat([scene.prim_bb_lo[:P], scene.bbox_lo[None]]) - margin
        hi = torch.cat([scene.prim_bb_hi[:P], scene.bbox_hi[None]]) + margin
        boxes = torch.cat([lo, hi], 1)  # [P + 1, 6]
        ro, rd = ro.detach().contiguous(), rd.detach().contiguous()
    for name, t in (("ro", ro), ("rd", rd)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, 3):
            raise ValueError(f"{name} must be float32 of shape {(n, 3)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if boxes.dtype != torch.float32:
        raise ValueError(f"the scene's boxes must be float32, got "
                         f"{boxes.dtype}")
    lib = native.load()
    t_enter = torch.empty(n, device=ro.device, dtype=torch.float32)
    t_exit = torch.empty_like(t_enter)
    alive = torch.empty(n, device=ro.device, dtype=torch.bool)
    ptr = ctypes.c_void_p
    rc = lib.fb_ray_bracket(
        ptr(ro.data_ptr()), ptr(rd.data_ptr()), ptr(boxes.data_ptr()),
        ptr(t_enter.data_ptr()), ptr(t_exit.data_ptr()),
        ptr(alive.data_ptr()), ctypes.c_int(n), ctypes.c_int(P),
        ptr(torch.cuda.current_stream(ro.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"ray_bracket launch failed: "
                           f"{native.error_string(rc)}")
    return t_enter, t_exit, alive


def _prim_interval_plain(scene: Scene, ro, rd, margin=0.05):
    """`prim_interval` in plain torch: the dense [N, P] test, chunked over
    rays."""
    if ro.shape[0] > PRIM_INTERVAL_CHUNK:
        parts = [
            _prim_interval_plain(scene, ro[i : i + PRIM_INTERVAL_CHUNK],
                                 rd[i : i + PRIM_INTERVAL_CHUNK], margin)
            for i in range(0, ro.shape[0], PRIM_INTERVAL_CHUNK)
        ]
        return tuple(torch.cat(p) for p in zip(*parts))
    bb_lo = scene.prim_bb_lo[: scene.n_prims]
    bb_hi = scene.prim_bb_hi[: scene.n_prims]
    inv = _safe_inv(rd)  # [N, 3]
    enter = torch.full((ro.shape[0], bb_lo.shape[0]), -torch.inf,
                       device=ro.device)
    exit_ = torch.full_like(enter, torch.inf)
    for i in range(3):
        ta = (bb_lo[None, :, i] - margin - ro[:, i : i + 1]) * inv[:, i : i + 1]
        tb = (bb_hi[None, :, i] + margin - ro[:, i : i + 1]) * inv[:, i : i + 1]
        enter = torch.maximum(enter, torch.minimum(ta, tb))
        exit_ = torch.minimum(exit_, torch.maximum(ta, tb))
    enter = torch.clamp(enter, min=0.0)
    valid = (exit_ >= enter) & (exit_ > 0.0)  # [N, P]
    t_enter = torch.amin(torch.where(valid, enter, torch.inf), -1)
    t_exit = torch.amax(torch.where(valid, exit_, -torch.inf), -1)
    alive = torch.any(valid, -1)
    s_enter, s_exit = _ray_box(
        ro, rd, scene.bbox_lo[None] - margin, scene.bbox_hi[None] + margin
    )
    t_enter = torch.maximum(t_enter, s_enter)
    t_exit = torch.minimum(t_exit, s_exit)
    alive = alive & (s_exit > s_enter) & (t_exit >= t_enter)
    t_enter = torch.where(alive, t_enter, 0.0)
    t_exit = torch.where(alive, t_exit, 0.0)
    return t_enter, t_exit, alive


def march_all(eval_f, step_size, t_enter, t_exit, alive0,
              params: TraceParams):
    """Lock-step march of every ray from t_enter to the first iso
    crossing, then bisection + secant on the bracket. eval_f maps t [N]
    to field-minus-iso; step_size maps the total field to a step.
    Returns (t_root, found), t_root = t_exit where not found."""
    f0 = eval_f(t_enter)
    t, f, t_prev, f_prev = t_enter, f0, t_enter, f0
    found = (f0 >= 0.0) & alive0
    alive = alive0 & (f0 < 0.0)
    it = 0
    while it < params.max_steps and bool(alive.any()):
        t_new = torch.minimum(t + step_size(f + params.iso), t_exit)
        f_new = eval_f(t_new)
        crossed = alive & (f_new >= 0.0)
        done = alive & (t_new >= t_exit) & (f_new < 0.0)
        t_prev = torch.where(alive, t, t_prev)
        f_prev = torch.where(alive, f, f_prev)
        t = torch.where(alive, t_new, t)
        f = torch.where(alive, f_new, f)
        found = found | crossed
        alive = alive & ~crossed & ~done
        it += 1

    a, b, fa, fb = t_prev, t, f_prev, f
    for _ in range(params.bisect_steps):
        m = 0.5 * (a + b)
        fm = eval_f(m)
        neg = fm < 0.0
        a, b = torch.where(neg, m, a), torch.where(neg, b, m)
        fa, fb = torch.where(neg, fm, fa), torch.where(neg, fb, fm)
    denom = fb - fa
    t_sec = a - fa * (b - a) / torch.where(torch.abs(denom) < 1e-12, 1e-12,
                                           denom)
    t_root = torch.where(torch.abs(denom) < 1e-9, 0.5 * (a + b), t_sec)
    return torch.where(found, t_root, t_exit), found


# Hit rays per chunk of the implicit-differentiation correction: bounds the
# dense field temporaries (and, under autograd, what backward keeps) at
# 1080p, where a [rays, prims] f32 temporary is over a gigabyte.
CORRECTION_CHUNK = 1 << 16


def newton_nudge(field_fn, ro, rd, t_root, found, cap):
    """Implicit differentiation of F(ro + t rd) = iso at the root.

    t_root and the slope dF/dt are constants (the reference's
    stop_gradient); the returned t = t0 - clamp(f_at / dfdt, +-cap) carries
    dt/dθ = -F_θ / (∇F · rd) through f_at = field_fn(x0), the field minus
    iso at x0 = ro + t0 rd. Only hit rays are corrected (misses return
    t0). Their correction runs in chunks of CORRECTION_CHUNK rays, each
    recomputed in backward, so memory stays bounded at any image size."""
    with span("trace.correct"):
        t0 = t_root.detach()
        idx = torch.nonzero(found).squeeze(-1)
        if idx.numel() == 0:
            return t0
        x0 = ro[idx] + t0[idx, None] * rd[idx]
        rdh = rd[idx].detach()
        grad_on = torch.is_grad_enabled()
        corr = []
        for i in range(0, idx.numel(), CORRECTION_CHUNK):
            x = x0[i : i + CORRECTION_CHUNK]
            with torch.enable_grad():
                p = x.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(field_fn(p).sum(), p)
            dfdt = torch.sum(g * rdh[i : i + CORRECTION_CHUNK], -1)
            dfdt = torch.where(torch.abs(dfdt) < 1e-6,
                               torch.where(dfdt < 0, -1e-6, 1e-6), dfdt)
            if grad_on and idx.numel() > CORRECTION_CHUNK:
                f_at = torch.utils.checkpoint.checkpoint(field_fn, x,
                                                         use_reentrant=False)
            else:
                f_at = field_fn(x)
            corr.append(torch.clamp(f_at / dfdt, -cap, cap))
        return t0.index_put((idx,), t0[idx] - torch.cat(corr))


def trace(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
          params: TraceParams = TraceParams()):
    """March rays to the iso surface: ro, rd [N, 3] -> (t_hit [N], hit [N]),
    t_hit differentiable in the scene's parameters by implicit
    differentiation at the root (the march itself is not differentiated)."""
    iso = params.iso
    lo = scene.bbox_lo - 0.05
    hi = scene.bbox_hi + 0.05
    if scene.can_cull:
        t_enter, t_exit, alive0 = prim_interval(scene, ro, rd)
    else:
        t_enter, t_exit = _ray_box(ro, rd, lo[None], hi[None])
        alive0 = t_exit > t_enter
    base_step = torch.linalg.norm(hi - lo) * params.step_frac
    inv_stretch = 1.0 / max(scene.max_world_to_local_scale, 1e-6)

    def step_size(fv):
        if not scene.monotone_field:
            return base_step
        r = support_radius_bound(fv)
        return torch.maximum(base_step,
                             0.95 * (r - params.r_iso) * inv_stretch)

    def eval_f(t):
        return field(scene, ro + t[:, None] * rd) - iso

    with torch.no_grad():
        t_root, found = march_all(eval_f, step_size, t_enter, t_exit,
                                  alive0, params)
    t_hit = newton_nudge(lambda x: field(scene, x) - iso, ro, rd, t_root,
                         found, 0.5 * base_step)
    return t_hit, found


def shade_hits(attrs, ro, rd, t_hit, hit_mask, light_dir, background,
               material: Material, texture, texture_scale: float):
    """Blinn-Phong colours [N, 3] of the rays that hit, the background
    for the rest. attrs(x) -> (field gradient [n, 3], colour [n, 4],
    texture-space point [n, 3]) at surface points x; it is called on the
    hit rays only, in chunks of CORRECTION_CHUNK, so the dense
    [rays, prims] temporaries stay bounded at any image size."""
    bg = torch.as_tensor(background, dtype=ro.dtype, device=ro.device)
    out = bg[None].expand(ro.shape[0], 3)
    idx = torch.nonzero(hit_mask).squeeze(-1)
    if idx.numel() == 0:
        return out.clone()
    ldir = torch.as_tensor(light_dir, dtype=ro.dtype, device=ro.device)
    ldir = ldir / torch.linalg.norm(ldir)
    parts = []
    for i in range(0, idx.numel(), CORRECTION_CHUNK):
        j = idx[i : i + CORRECTION_CHUNK]
        rdj = rd[j]
        g, col, x_tex = attrs(ro[j] + t_hit[j, None] * rdj)
        n = -g * torch.rsqrt(
            torch.clamp(torch.sum(g * g, -1, keepdim=True), min=1e-24))
        albedo = col[:, :3]
        if texture is not None:
            albedo = albedo * triplanar_sample_tensor(texture, x_tex, n,
                                                      texture_scale)
        ndotl = torch.clamp(torch.sum(n * ldir, -1), min=0.0)
        hv = ldir - rdj
        hv = hv / torch.linalg.norm(hv, dim=-1, keepdim=True)
        spec = torch.clamp(torch.sum(n * hv, -1), min=0.0) ** material.shininess
        parts.append(
            albedo * (material.ambient + material.diffuse * ndotl)[:, None]
            + material.specular * spec[:, None])
    return out.index_put((idx,), torch.cat(parts))


def shade(scene: Scene, ro, rd, t_hit, hit_mask,
          light_dir=(0.577, 0.577, 0.577), background=(1.0, 1.0, 1.0),
          material: Material = PHONG, texture=None,
          texture_scale: float = 1.0):
    """Lambert + Blinn-Phong shading with field-weighted material colors
    (reference phong shaders, data/shaders/phong.{vsh,fsh}). `material`
    selects the shading parameters (graphics.materials). `texture` (a
    [H, W, 3] tensor) modulates the albedo by world-space triplanar
    sampling. Field gradient and colour come from one primitive pass over
    the hit rays; misses take the background."""
    def attrs(x):
        _, g, col = vertex_attributes(scene, x)
        return g, col, x

    return shade_hits(attrs, ro, rd, t_hit, hit_mask, light_dir, background,
                      material, texture, texture_scale)


def render_rays(scene: Scene, ro, rd, params: TraceParams = TraceParams()):
    t_hit, hit = trace(scene, ro, rd, params)
    return shade(scene, ro, rd, t_hit, hit)


def render_image(scene: Scene, cam: Camera, width: int, height: int,
                 params: TraceParams = TraceParams()) -> torch.Tensor:
    """Render a [H, W, 3] image (values in [0, ~1.3], clip for display)
    with the dense tracer."""
    ro, rd = generate_rays(cam, width, height)
    rgb = render_rays(scene, ro.reshape(-1, 3), rd.reshape(-1, 3), params)
    return rgb.reshape(height, width, 3)


def depth_image(scene: Scene, cam: Camera, width: int, height: int,
                params: TraceParams = TraceParams()):
    """(t_hit, hit_mask) images: the differentiable geometric output."""
    ro, rd = generate_rays(cam, width, height)
    t, hit = trace(scene, ro.reshape(-1, 3), rd.reshape(-1, 3), params)
    return t.reshape(height, width), hit.reshape(height, width)
