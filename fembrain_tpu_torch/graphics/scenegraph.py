"""Retained scene graph: named nodes, transforms, draw/timestep fan-out.

Headless analog of the reference's scene graph
(src/graphics/SceneGraph.h:51-152, SGNode.h:28, SGMesh.h:12): a node list
with per-node name/visibility/affine transform/AABB, a `draw()` that
composes per-node geometry batches (instead of issuing GL calls), a
`timestep()` fan-out, screen<->world ray casting through the camera, an
FPS moving average (SceneGraph.h:141-146) and HUD header lines
(src/main.cpp:877-887 SGHeaders).

Counterpart of fembrain_tpu/graphics/scenegraph.py: host numpy geometry;
picking goes through the port's `generate_rays` on the camera's device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..render.camera import Camera, generate_rays


def _identity() -> np.ndarray:
    return np.eye(4)


@dataclass
class DrawBatch:
    """One node's drawable geometry in world space."""

    name: str
    verts: np.ndarray                  # [V, 3] world-space
    faces: np.ndarray | None = None    # [F, 3] int, None = point cloud
    color: tuple = (0.7, 0.7, 0.7, 1.0)


class SGNode:
    """Scene node base (reference SGNode.h:28): name, visibility, affine
    transform, AABB; subclasses override draw()/timestep()."""

    def __init__(self, name: str = ""):
        self.name = name
        self.visible = True
        self.animate = True
        self.transform = _identity()  # local -> world

    # -- geometry ------------------------------------------------------
    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        return np.zeros(3), np.zeros(3)

    def set_translation(self, t) -> None:
        self.transform[:3, 3] = np.asarray(t, np.float64)

    def translation(self) -> np.ndarray:
        return self.transform[:3, 3].copy()

    def map_to_world(self, pts: np.ndarray) -> np.ndarray:
        pts = np.atleast_2d(pts)
        return pts @ self.transform[:3, :3].T + self.transform[:3, 3]

    # -- hooks ---------------------------------------------------------
    def draw(self) -> DrawBatch | None:
        return None

    def timestep(self) -> None:
        pass


class SGMesh(SGNode):
    """Triangle-mesh node (reference SGMesh/GLMeshBuffer): holds vertex
    and face arrays; draw() maps vertices through the node transform."""

    def __init__(self, name: str, verts, faces=None,
                 color=(0.7, 0.7, 0.7, 1.0)):
        super().__init__(name)
        self.verts = np.asarray(verts, np.float64).reshape(-1, 3)
        self.faces = None if faces is None else np.asarray(faces, np.int32)
        self.color = tuple(color)

    def aabb(self):
        w = self.map_to_world(self.verts)
        if len(w) == 0:
            return np.zeros(3), np.zeros(3)
        return w.min(0), w.max(0)

    def draw(self) -> DrawBatch:
        return DrawBatch(
            self.name, self.map_to_world(self.verts), self.faces, self.color
        )


@dataclass
class _FpsTracker:
    """Moving-average FPS (reference SceneGraph.h:141-146)."""

    window: int = 30
    _times: list = field(default_factory=list)

    def tick(self) -> float:
        now = time.perf_counter()
        self._times.append(now)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / max(dt, 1e-9)


class SceneGraph:
    """Node registry with draw/timestep fan-out (SceneGraph.h:51-152).

    The reference exposes a process singleton (`TheSceneGraph`); use
    `the_scenegraph()` for that, or instantiate directly in tests.
    """

    def __init__(self):
        self._nodes: list[SGNode] = []
        self.camera: Camera | None = None
        self.headers: dict[str, str] = {}   # HUD lines (SGHeaders analog)
        self._fps = _FpsTracker()

    # -- node management ----------------------------------------------
    def add(self, node: SGNode) -> SGNode:
        self._nodes.append(node)
        return node

    def remove(self, node_or_name) -> bool:
        node = (
            self.get(node_or_name)
            if isinstance(node_or_name, str)
            else node_or_name
        )
        if node in self._nodes:
            self._nodes.remove(node)
            return True
        return False

    def get(self, name: str) -> SGNode | None:
        for n in self._nodes:
            if n.name == name:
                return n
        return None

    def __len__(self) -> int:
        return len(self._nodes)

    def __iter__(self):
        return iter(self._nodes)

    # -- frame hooks ---------------------------------------------------
    def draw(self) -> list[DrawBatch]:
        """Per-node draw fan-out -> world-space geometry batches
        (the GL issue loop of SceneGraph::draw, SceneGraph.cpp)."""
        out = []
        for n in self._nodes:
            if not n.visible:
                continue
            batch = n.draw()
            if batch is not None:
                out.append(batch)
        self.headers["fps"] = f"FPS {self._fps.tick():.1f}"
        return out

    def timestep(self) -> None:
        for n in self._nodes:
            if n.animate:
                n.timestep()

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        los, his = [], []
        for n in self._nodes:
            lo, hi = n.aabb()
            if np.any(hi > lo):
                los.append(lo)
                his.append(hi)
        if not los:
            return np.zeros(3), np.zeros(3)
        return np.min(los, 0), np.max(his, 0)

    # -- picking -------------------------------------------------------
    def screen_to_world_ray(self, x: float, y: float, width: int,
                            height: int) -> tuple[np.ndarray, np.ndarray]:
        """Pixel (x right, y down) -> world (origin, direction) through
        the current camera (SceneGraph screen->world ray casting)."""
        if self.camera is None:
            raise ValueError("scene graph has no camera")
        # Single-pixel ray via the shared pinhole math.
        ro, rd = generate_rays(self.camera, width, height)
        xi = int(np.clip(x, 0, width - 1))
        yi = int(np.clip(y, 0, height - 1))
        return ro[yi, xi].cpu().numpy(), rd[yi, xi].cpu().numpy()


_instance: SceneGraph | None = None


def the_scenegraph() -> SceneGraph:
    """Process-wide instance (reference `TheSceneGraph` singleton)."""
    global _instance
    if _instance is None:
        _instance = SceneGraph()
    return _instance
