"""Catmull-Rom spline (reference src/graphics/SplineCatmullRom.{h,cpp}):
C1 interpolating spline through control points, with arc-length tables
for uniform-speed evaluation — used by the reference for camera and tool
trajectories. Vectorized over parameters with NumPy (host-side path
authoring; the device never sees splines). Counterpart of
fembrain_tpu/graphics/spline.py."""
from __future__ import annotations

import numpy as np


class CatmullRom:
    def __init__(self, points, closed: bool = False):
        pts = np.asarray(points, np.float64).reshape(-1, 3)
        if len(pts) < 2:
            raise ValueError("need at least two control points")
        self.closed = closed
        self.points = pts

    # -- internals -----------------------------------------------------
    def _segment_points(self, i: int):
        """Control quad (p0..p3) for segment i -> i+1 with endpoint
        clamping (open) or wraparound (closed)."""
        n = len(self.points)
        if self.closed:
            idx = [(i - 1) % n, i % n, (i + 1) % n, (i + 2) % n]
        else:
            idx = [max(i - 1, 0), i, min(i + 1, n - 1), min(i + 2, n - 1)]
        return self.points[idx]

    @property
    def n_segments(self) -> int:
        return len(self.points) if self.closed else len(self.points) - 1

    # -- evaluation ----------------------------------------------------
    def position(self, u) -> np.ndarray:
        """Spline position at global parameter u in [0, n_segments];
        vectorized over u -> [len(u), 3] (or [3] for scalar u)."""
        u = np.asarray(u, np.float64)
        scalar = u.ndim == 0
        u = np.atleast_1d(u)
        seg = np.clip(u.astype(int), 0, self.n_segments - 1)
        t = u - seg
        out = np.empty((len(u), 3))
        for s in np.unique(seg):
            m = seg == s
            p0, p1, p2, p3 = self._segment_points(int(s))
            tt = t[m][:, None]
            out[m] = 0.5 * (
                2.0 * p1
                + (p2 - p0) * tt
                + (2 * p0 - 5 * p1 + 4 * p2 - p3) * tt**2
                + (3 * p1 - 3 * p2 + p3 - p0) * tt**3
            )
        return out[0] if scalar else out

    def tangent(self, u) -> np.ndarray:
        """dP/du (same vectorization as position)."""
        u = np.asarray(u, np.float64)
        scalar = u.ndim == 0
        u = np.atleast_1d(u)
        seg = np.clip(u.astype(int), 0, self.n_segments - 1)
        t = u - seg
        out = np.empty((len(u), 3))
        for s in np.unique(seg):
            m = seg == s
            p0, p1, p2, p3 = self._segment_points(int(s))
            tt = t[m][:, None]
            out[m] = 0.5 * (
                (p2 - p0)
                + 2.0 * (2 * p0 - 5 * p1 + 4 * p2 - p3) * tt
                + 3.0 * (3 * p1 - 3 * p2 + p3 - p0) * tt**2
            )
        return out[0] if scalar else out

    # -- arc length ----------------------------------------------------
    def arc_length_table(self, samples_per_seg: int = 32):
        """(u values, cumulative lengths) for uniform-speed lookup."""
        us = np.linspace(0.0, self.n_segments, self.n_segments * samples_per_seg + 1)
        pts = self.position(us)
        d = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        return us, np.concatenate([[0.0], np.cumsum(d)])

    def position_at_length(self, s) -> np.ndarray:
        """Uniform-speed evaluation: position at arc length s."""
        us, ls = self.arc_length_table()
        u = np.interp(np.asarray(s, np.float64), ls, us)
        return self.position(u)

    @property
    def total_length(self) -> float:
        return float(self.arc_length_table()[1][-1])
