"""Mesh quality metrics (reference SimdPoly::measureQuality,
src/implicit/PolyMemManager.h:114, and the VolMesh per-cell metrics).

Counterpart of fembrain_tpu/mesh/quality.py: numpy on the host."""
from __future__ import annotations

import numpy as np


def triangle_quality(verts: np.ndarray, tris: np.ndarray) -> dict:
    """Surface-mesh quality: per-triangle radius-ratio quality in [0,1]
    (1 = equilateral), area stats, degenerate count."""
    v = np.asarray(verts)
    t = np.asarray(tris)
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    ab, bc, ca = b - a, c - b, a - c
    la = np.linalg.norm(bc, axis=1)
    lb = np.linalg.norm(ca, axis=1)
    lc = np.linalg.norm(ab, axis=1)
    area = 0.5 * np.linalg.norm(np.cross(ab, -ca), axis=1)
    denom = la * lb * lc
    # q = 4*sqrt(3)*A / (la^2+lb^2+lc^2): 1 for equilateral.
    l2 = la * la + lb * lb + lc * lc
    q = np.where(l2 > 0, 4 * np.sqrt(3) * area / np.maximum(l2, 1e-30), 0.0)
    return {
        "count": int(len(t)),
        "quality_mean": float(q.mean()) if len(q) else 0.0,
        "quality_min": float(q.min()) if len(q) else 0.0,
        "area_total": float(area.sum()),
        "degenerate": int((area < 1e-12).sum()),
    }


def tet_quality(nodes: np.ndarray, tets: np.ndarray) -> dict:
    """Tet-mesh quality: signed volumes, aspect ratios (longest edge over
    min height), inverted/degenerate counts."""
    n = np.asarray(nodes)
    t = np.asarray(tets)
    a, b, c, d = n[t[:, 0]], n[t[:, 1]], n[t[:, 2]], n[t[:, 3]]
    vols = np.einsum("ij,ij->i", b - a, np.cross(c - a, d - a)) / 6.0
    edges = [b - a, c - a, d - a, c - b, d - b, d - c]
    emax = np.max([np.linalg.norm(e, axis=1) for e in edges], axis=0)
    faces = [(a, b, c), (a, b, d), (a, c, d), (b, c, d)]
    amax = np.max(
        [
            0.5 * np.linalg.norm(np.cross(f1 - f0, f2 - f0), axis=1)
            for f0, f1, f2 in faces
        ],
        axis=0,
    )
    hmin = 3.0 * np.abs(vols) / np.maximum(amax, 1e-30)
    aspect = emax / np.maximum(hmin, 1e-30)
    return {
        "count": int(len(t)),
        "volume_total": float(np.abs(vols).sum()),
        "inverted": int((vols < 0).sum()),
        "degenerate": int((np.abs(vols) < 1e-12).sum()),
        "aspect_mean": float(aspect.mean()) if len(t) else 0.0,
        "aspect_max": float(aspect.max()) if len(t) else 0.0,
    }
