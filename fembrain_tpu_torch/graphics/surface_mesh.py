"""OBJ-backed surface mesh node with vertex picking and fixed-vertex sets.

Analog of the reference's legacy surface-mesh path
(src/deformable/SurfaceMesh.h:21: obj-loaded render/physics surface with
vertex pick, used pre-VolMesh): wraps mesh.io.read_obj into an SGMesh
node, adds nearest-vertex / radius picking and a persistent fixed-vertex
selection (the `.sim` [FIXEDVERTICES] workflow, src/settings.h:40-128).

Counterpart of fembrain_tpu/graphics/surface_mesh.py: numpy on the host.
It is a scene-graph node, and not the polygonizer's `SurfaceMesh`
(mesh.polygonize), which holds the device tensors of a polygonized
surface; the two are apart in the reference too.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..mesh.io import read_obj, write_obj
from .scenegraph import SGMesh


class SurfaceMesh(SGMesh):
    def __init__(self, name: str, verts, faces, color=(0.7, 0.7, 0.7, 1.0)):
        super().__init__(name, verts, faces, color)
        self.fixed: set[int] = set()

    # -- I/O -----------------------------------------------------------
    @classmethod
    def from_obj(cls, path: str | Path, name: str | None = None
                 ) -> "SurfaceMesh":
        verts, faces = read_obj(path)
        return cls(name or Path(path).stem, verts, faces)

    def save_obj(self, path: str | Path) -> None:
        write_obj(path, self.map_to_world(self.verts), self.faces)

    # -- picking -------------------------------------------------------
    def pick_vertex(self, ro, rd, max_dist: float = 0.25) -> int:
        """Nearest vertex to the ray (origin ro, direction rd) within
        `max_dist` of it; -1 when nothing is close (reference
        SurfaceMesh vertex pick)."""
        w = self.map_to_world(self.verts)
        ro = np.asarray(ro, np.float64)
        rd = np.asarray(rd, np.float64)
        rd = rd / max(np.linalg.norm(rd), 1e-12)
        rel = w - ro
        t = rel @ rd
        perp = rel - t[:, None] * rd[None]
        d = np.linalg.norm(perp, axis=1)
        d = np.where(t >= 0.0, d, np.inf)  # behind the origin: ignore
        i = int(np.argmin(d))
        return i if d[i] <= max_dist else -1

    def pick_vertices_in_sphere(self, center, radius: float) -> np.ndarray:
        w = self.map_to_world(self.verts)
        d = np.linalg.norm(w - np.asarray(center, np.float64), axis=1)
        return np.nonzero(d <= radius)[0]

    # -- fixed set -----------------------------------------------------
    def toggle_fixed(self, idx: int) -> bool:
        """Add/remove a vertex from the fixed set; returns new state."""
        if idx in self.fixed:
            self.fixed.discard(idx)
            return False
        self.fixed.add(idx)
        return True
