"""Cameras: orbiting arcball (reference src/graphics/ArcBallCamera.h:19)
and pinhole ray generation for the sphere tracer. PyTorch counterpart of
fembrain_tpu/render/camera.py."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device

# Reference defaults (src/settings.h:19-23).
DEFAULT_FOVY_DEG = 45.0
DEFAULT_ZNEAR = 0.01
DEFAULT_ZFAR = 100.0


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera; all fields are tensors."""

    eye: torch.Tensor       # [3]
    target: torch.Tensor    # [3]
    up: torch.Tensor        # [3]
    fovy_deg: torch.Tensor  # scalar

    @classmethod
    def make(cls, eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
             fovy_deg=DEFAULT_FOVY_DEG,
             device: torch.device | str | None = None) -> "Camera":
        """Tensors land on `device` (the card when None)."""
        device = default_device() if device is None else device

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        return cls(eye=f32(eye), target=f32(target), up=f32(up),
                   fovy_deg=f32(fovy_deg))

    @classmethod
    def orbit(cls, roll_deg: float, tilt_deg: float, zoom: float,
              target=(0.0, 0.0, 0.0),
              device: torch.device | str | None = None) -> "Camera":
        """Arcball pose (reference ArcBallCamera roll/tilt/zoom orbit)."""
        r = np.deg2rad(roll_deg)
        t = np.deg2rad(tilt_deg)
        eye = np.array(
            [
                zoom * np.cos(t) * np.sin(r),
                zoom * np.sin(t),
                zoom * np.cos(t) * np.cos(r),
            ]
        ) + np.asarray(target)
        return cls.make(eye, target=target, device=device)


def generate_rays(cam: Camera, width: int, height: int):
    """Ray origins/directions for a W x H image: ([H,W,3], [H,W,3]).

    Pixel centers, y-down image convention, right-handed look-at basis.
    """
    dev = cam.eye.device
    fwd = cam.target - cam.eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, cam.up)
    right = right / torch.linalg.norm(right)
    up = torch.linalg.cross(right, fwd)

    aspect = width / height
    tan_half = torch.tan(torch.deg2rad(cam.fovy_deg) * 0.5)
    ar_h = torch.arange(height, device=dev, dtype=torch.float32)
    ar_w = torch.arange(width, device=dev, dtype=torch.float32)
    ys = (0.5 - (ar_h + 0.5) / height) * 2.0 * tan_half
    xs = ((ar_w + 0.5) / width - 0.5) * 2.0 * tan_half * aspect
    dirs = (
        fwd[None, None, :]
        + xs[None, :, None] * right[None, None, :]
        + ys[:, None, None] * up[None, None, :]
    )
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = torch.broadcast_to(cam.eye, dirs.shape)
    return origins, dirs
