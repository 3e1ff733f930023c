"""Collision detection utilities.

Port of the reference's AABB-based `CollisionDetection` node
(src/deformable/CollisionDetection.h:23) plus the analytic ground-plane
response actually used per frame (Deformable.cpp:347-400; the Bullet
rigid-environment glue is out of north-star scope — SURVEY §2.7 keeps the
plane response the reference code exercises).

Counterpart of fembrain_tpu/fem/collision.py: numpy on the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class AABB:
    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def of_points(cls, pts: np.ndarray, pad: float = 0.0) -> "AABB":
        pts = np.asarray(pts)
        return cls(pts.min(0) - pad, pts.max(0) + pad)

    def intersects(self, other: "AABB") -> bool:
        return bool(
            np.all(self.lo <= other.hi) and np.all(other.lo <= self.hi)
        )

    def contains(self, p: np.ndarray) -> np.ndarray:
        p = np.atleast_2d(p)
        return np.all((p >= self.lo) & (p <= self.hi), axis=1)

    def expanded(self, d: float) -> "AABB":
        return AABB(self.lo - d, self.hi + d)


@dataclass
class CollisionDetection:
    """Pairwise AABB broad phase over registered bodies; reports
    overlapping pairs and per-pair contained vertices."""

    bodies: dict[str, AABB] = field(default_factory=dict)

    def update(self, name: str, points: np.ndarray, pad: float = 0.0) -> None:
        self.bodies[name] = AABB.of_points(points, pad)

    def overlaps(self) -> list[tuple[str, str]]:
        names = sorted(self.bodies)
        out = []
        for i, a in enumerate(names):
            for b in names[i + 1 :]:
                if self.bodies[a].intersects(self.bodies[b]):
                    out.append((a, b))
        return out

    def vertices_inside(self, name: str, points: np.ndarray) -> np.ndarray:
        """Indices of `points` inside body `name`'s box (the probe contact
        query, AvatarProbe/Deformable::pickVertices)."""
        return np.where(self.bodies[name].contains(points))[0]
