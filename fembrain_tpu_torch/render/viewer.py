"""Offline viewer: turntable/frame rendering with a HUD — the headless
analog of the reference's GLUT scene graph + SGHeaders on-screen rows
(src/graphics/SceneGraph.h:51-152, src/main.cpp:877-887).

Counterpart of fembrain_tpu/render/viewer.py: images are rendered by the
port's dense tracer on the scene's device and written with PIL on the
host.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

from ..blob.scene import Scene
from .camera import Camera
from .sphere_trace import TraceParams, render_image


def _put_text(img: np.ndarray, text: str) -> np.ndarray:
    """Stamp HUD text into the top rows of an [H, W, 3] image in [0, 1]."""
    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    ImageDraw.Draw(im).text((4, 2), text, fill=(20, 20, 20))
    return np.asarray(im).astype(np.float32) / 255.0


def render_turntable(
    scene: Scene,
    out_dir: str | Path,
    frames: int = 12,
    width: int = 320,
    height: int = 240,
    tilt: float = 20.0,
    zoom: float | None = None,
    params: TraceParams = TraceParams(),
    hud: bool = True,
) -> list[Path]:
    """Render an orbit around the scene; returns written PNG paths."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lo = scene.bbox_lo.cpu().numpy()
    hi = scene.bbox_hi.cpu().numpy()
    center = 0.5 * (lo + hi)
    if zoom is None:
        zoom = 2.2 * float(np.linalg.norm(hi - lo))
    paths = []
    for k in range(frames):
        cam = Camera.orbit(360.0 * k / frames, tilt, zoom, target=center,
                           device=scene.bbox_lo.device)
        img = render_image(scene, cam, width, height, params).cpu().numpy()
        if hud:
            img = _put_text(
                img,
                f"fembrain_tpu  prims={scene.n_prims} ops={scene.n_ops} "
                f"frame {k + 1}/{frames}",
            )
        p = out_dir / f"turn_{k:03d}.png"
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths
