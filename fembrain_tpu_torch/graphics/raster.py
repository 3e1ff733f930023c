"""Tiny z-buffered software rasterizer for scene-graph draw batches.

Counterpart of fembrain_tpu/graphics/raster.py, host numpy like it: the
headless analog of the reference's GL mesh/debug drawing
(src/graphics/GLMeshBuffer draw paths, src/deformable/VolMeshRender).
It renders SceneGraph.draw() batches — flat-shaded triangles, wireframes,
or point clouds — into an RGB image with a shared depth buffer. The heavy
rendering path is the sphere tracer; this is for mesh/FEM/debug views.
As in the reference, a texture is looked up at the world position
interpolated with the screen-space (affine) barycentrics, not the
perspective-correct ones the depth uses, so textures swim under
perspective.
"""
from __future__ import annotations

import numpy as np
import torch

from ..render.camera import DEFAULT_FOVY_DEG, Camera
from .scenegraph import DrawBatch


def _host(v) -> np.ndarray:
    """A camera field (a tensor on any device) as a float64 array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float64)


def project(cam: Camera, pts: np.ndarray, width: int, height: int):
    """World points -> (screen xy [N,2], view depth [N]); y down."""
    eye = _host(cam.eye)
    target = _host(cam.target)
    up = _host(cam.up)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    upv = np.cross(right, fwd)

    rel = np.atleast_2d(pts) - eye
    x = rel @ right
    y = rel @ upv
    z = rel @ fwd                       # positive in front of the camera
    fovy = float(_host(cam.fovy_deg)) or DEFAULT_FOVY_DEG
    tan_half = np.tan(np.deg2rad(fovy) * 0.5)
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    aspect = width / height
    sx = (x / (zs * tan_half * aspect) * 0.5 + 0.5) * width
    sy = (0.5 - y / (zs * tan_half) * 0.5) * height
    return np.stack([sx, sy], -1), z


def _edge(p, a, b):
    return (p[..., 0] - a[0]) * (b[1] - a[1]) - (p[..., 1] - a[1]) * (
        b[0] - a[0]
    )


def rasterize(
    batches: list[DrawBatch],
    cam: Camera,
    width: int = 320,
    height: int = 240,
    background=(1.0, 1.0, 1.0),
    light_dir=(0.577, 0.577, 0.577),
    wireframe: bool = False,
    point_size: int = 2,
    material=None,
    texture=None,
    texture_scale: float = 1.0,
) -> np.ndarray:
    """Render draw batches -> [H, W, 3] float image in [0, 1].
    `material` picks named shading parameters (graphics.materials) —
    the same registry the tracer consumes. `texture` (a
    graphics.materials.Texture) modulates the albedo by world-space
    triplanar sampling at `texture_scale` tiles per world unit
    (TexManager parity — implicit surfaces carry no UV atlas)."""
    if material is None:
        from .materials import PHONG as material
    img = np.ones((height, width, 3)) * np.asarray(background)
    zbuf = np.full((height, width), np.inf)
    ldir = np.asarray(light_dir, np.float64)
    ldir = ldir / np.linalg.norm(ldir)

    for batch in batches:
        xy, z = project(cam, batch.verts, width, height)
        col = np.asarray(batch.color[:3], np.float64)
        if batch.faces is None or wireframe:
            _draw_points(img, zbuf, xy, z, col, point_size)
            if batch.faces is None:
                continue
        if batch.faces is not None and not wireframe:
            _draw_triangles(img, zbuf, batch, xy, z, col, ldir,
                            width, height, material,
                            texture, texture_scale)
    return np.clip(img, 0.0, 1.0)


def _draw_points(img, zbuf, xy, z, col, size):
    h, w = zbuf.shape
    for (sx, sy), zz in zip(xy, z):
        if zz <= 0:
            continue
        xi, yi = int(round(sx)), int(round(sy))
        x0, x1 = max(0, xi - size // 2), min(w, xi + (size + 1) // 2)
        y0, y1 = max(0, yi - size // 2), min(h, yi + (size + 1) // 2)
        if x0 >= x1 or y0 >= y1:
            continue
        patch = zbuf[y0:y1, x0:x1]
        mask = zz < patch
        patch[mask] = zz
        img[y0:y1, x0:x1][mask] = col


def _draw_triangles(img, zbuf, batch, xy, z, col, ldir, width, height,
                    material, texture=None, texture_scale=1.0):
    verts = batch.verts
    for f in batch.faces:
        a, b, c = xy[f[0]], xy[f[1]], xy[f[2]]
        za, zb, zc = z[f[0]], z[f[1]], z[f[2]]
        if za <= 0 and zb <= 0 and zc <= 0:
            continue
        # Flat Lambert shade from the world-space face normal.
        n = np.cross(verts[f[1]] - verts[f[0]], verts[f[2]] - verts[f[0]])
        nl = np.linalg.norm(n)
        if nl < 1e-20:
            continue
        shade = (
            material.ambient
            + material.diffuse * abs(float(n @ ldir)) / nl
        )
        x0 = max(int(np.floor(min(a[0], b[0], c[0]))), 0)
        x1 = min(int(np.ceil(max(a[0], b[0], c[0]))) + 1, width)
        y0 = max(int(np.floor(min(a[1], b[1], c[1]))), 0)
        y1 = min(int(np.ceil(max(a[1], b[1], c[1]))) + 1, height)
        if x0 >= x1 or y0 >= y1:
            continue
        ys, xs = np.mgrid[y0:y1, x0:x1]
        p = np.stack([xs + 0.5, ys + 0.5], -1)
        w0 = _edge(p, b, c)
        w1 = _edge(p, c, a)
        w2 = _edge(p, a, b)
        area = _edge(a[None], b, c)[0]
        if abs(area) < 1e-12:
            continue
        inside = (
            ((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
            if area > 0
            else ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
        )
        if not inside.any():
            continue
        l0, l1, l2 = w0 / area, w1 / area, w2 / area
        # Perspective-correct depth via 1/z interpolation.
        iz = l0 / max(za, 1e-9) + l1 / max(zb, 1e-9) + l2 / max(zc, 1e-9)
        depth = 1.0 / np.maximum(iz, 1e-12)
        tile_z = zbuf[y0:y1, x0:x1]
        upd = inside & (depth < tile_z) & (depth > 0)
        tile_z[upd] = depth[upd]
        if texture is not None:
            from .materials import triplanar_sample

            # Per-pixel world position by barycentric interpolation,
            # triplanar-sampled with the face normal as projector.
            wpos = (
                l0[..., None] * verts[f[0]]
                + l1[..., None] * verts[f[1]]
                + l2[..., None] * verts[f[2]]
            )
            alb = triplanar_sample(
                texture, wpos[upd], np.broadcast_to(n / nl, (upd.sum(), 3)),
                texture_scale,
            )
            img[y0:y1, x0:x1][upd] = col * alb * shade
        else:
            img[y0:y1, x0:x1][upd] = col * shade
