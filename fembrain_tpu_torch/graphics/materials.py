"""Shading parameters and the tensor texture sampler.

PyTorch counterpart of the part of fembrain_tpu/graphics/materials.py that
the tracers' shading uses (the reference's named GLSL programs,
src/graphics/ShaderManager.h:37, become named sets of shading
parameters): `Material` with the stock presets, and the world-space
triplanar texture sampler on tensors. The registry, the INI loader and
the PIL image loader are not ported.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Material:
    """Blinn-Phong shading parameters (the phong.{vsh,fsh} analog)."""

    ambient: float = 0.25
    diffuse: float = 0.75
    specular: float = 0.3
    shininess: float = 32.0


# The reference's stock programs, as parameter presets.
PHONG = Material()
FLAT = Material(ambient=1.0, diffuse=0.0, specular=0.0)          # "green"
EDGES = Material(ambient=0.6, diffuse=0.4, specular=0.0)  # "avataredges"


def triplanar_sample(image: torch.Tensor, pts: torch.Tensor,
                     normals: torch.Tensor, scale: float = 1.0):
    """World-space triplanar projection -> [N, 3] albedo: `image` is a
    [H, W, 3] tensor sampled bilinearly with wrap addressing on the three
    axis-aligned planes at `scale` texels per world unit, blended by the
    squared normal components (the UV-free mapping for implicit
    surfaces)."""
    h, w = image.shape[0], image.shape[1]

    def samp(u, v):
        x = torch.remainder(u, 1.0) * (w - 1)
        y = torch.remainder(v, 1.0) * (h - 1)
        x0 = torch.floor(x).long()
        y0 = torch.floor(y).long()
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        top = image[y0, x0] * (1 - fx) + image[y0, x1] * fx
        bot = image[y1, x0] * (1 - fx) + image[y1, x1] * fx
        return top * (1 - fy) + bot * fy

    p = pts * scale
    n2 = normals * normals
    wgt = n2 / torch.clamp(torch.sum(n2, -1, keepdim=True), min=1e-12)
    cx = samp(p[..., 1], p[..., 2])   # YZ plane (x normal)
    cy = samp(p[..., 0], p[..., 2])   # XZ plane
    cz = samp(p[..., 0], p[..., 1])   # XY plane
    return cx * wgt[..., 0:1] + cy * wgt[..., 1:2] + cz * wgt[..., 2:3]
