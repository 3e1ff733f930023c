"""The scene of the plain reference, read from the raw .blob file.

Only what the benchmark's scenes hold is understood: one BLEND (a sum)
over POINT and CYLINDER primitives, each with an affine transform
T(R(S p)). Anything else raises, so a scene the reference cannot
evaluate is never judged by it.

Per primitive the field is the Wyvill kernel (1 - d^2)^3 of the squared
skeleton distance d^2 in its local frame (zero for d^2 >= 1); the scene's
field is their sum. Its support box is the local skeleton box grown by 1
(the kernel's reach) and mapped to the world with the |A| half-width rule;
the scene box is the union of the primitives' boxes at the iso offset 0.5
(the upstream FemBrain's LinearBlobTree box rule).
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np

ISO = 0.5
POINT, CYLINDER = "POINT", "CYLINDER"


@dataclasses.dataclass(frozen=True)
class RefScene:
    """Primitives as host arrays (float64 unless noted)."""

    kind: tuple            # [P] POINT / CYLINDER
    bwd: np.ndarray        # [P, 3, 4] world -> local
    fwd: np.ndarray        # [P, 3, 4] local -> world
    pos: np.ndarray        # [P, 3]
    axis: np.ndarray       # [P, 3] cylinder direction (0 for points)
    radius: np.ndarray     # [P] cylinder radius
    height: np.ndarray     # [P] cylinder height
    box_lo: np.ndarray     # [P, 3] float32 support boxes
    box_hi: np.ndarray
    bbox_lo: np.ndarray    # [3] float32 scene box
    bbox_hi: np.ndarray
    stretch: float         # max spectral norm of the world -> local maps

    @property
    def n_prims(self) -> int:
        return len(self.kind)


def _sections(text: str) -> dict:
    out, cur = {}, None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith(("#", ";")):
            continue
        m = re.fullmatch(r"\[(.+)\]", line)
        if m:
            cur = out.setdefault(m.group(1).strip(), {})
        elif "=" in line and cur is not None:
            k, v = line.split("=", 1)
            cur[k.strip()] = v.strip()
    return out


def _vec(s: str) -> np.ndarray:
    return np.array([float(v) for v in s.strip("()").split(",")])


def _quat(q) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _map_box(fwd: np.ndarray, lo, hi):
    """World box of the local box [lo, hi] under fwd (|A| half-widths)."""
    c, h = 0.5 * (lo + hi), 0.5 * (hi - lo)
    cw = fwd[:, :3] @ c + fwd[:, 3]
    hw = np.abs(fwd[:, :3]) @ h
    return cw - hw, cw + hw


def _map_corners(fwd: np.ndarray, lo, hi):
    """min / max of the two mapped corners (the upstream box rule)."""
    a = fwd[:, :3] @ lo + fwd[:, 3]
    b = fwd[:, :3] @ hi + fwd[:, 3]
    return np.minimum(a, b), np.maximum(a, b)


def load(path: str | Path) -> RefScene:
    """Read an additive .blob of POINT and CYLINDER primitives."""
    secs = _sections(Path(path).read_text())
    root = secs["BLOBNODE 0"]
    if root.get("OperatorType", "").upper() != "BLEND" or int(
            root.get("ChildrenIDsUseRange", "0")) != 1:
        raise ValueError("the reference reads one ranged BLEND of primitives")
    first, last = (int(v) for v in _vec(root["ChildrenIDsRange"]))
    rows = []
    for nid in range(first, last + 1):
        s = secs[f"BLOBNODE {nid}"]
        if int(s.get("IsOperator", "0")):
            raise ValueError(f"node {nid}: nested operators are not read")
        kind = s.get("PrimitiveType", "").upper()
        fwd = np.eye(4)
        fwd[:3, :3] = _quat(_vec(s.get("AffineRotate", "(0, 0, 0, 1)"))) @ \
            np.diag(_vec(s.get("AffineScale", "(1, 1, 1)")))
        fwd[:3, 3] = _vec(s.get("AffineTranslate", "(0, 0, 0)"))
        bwd = np.linalg.inv(fwd)
        pos = _vec(s["position"])
        axis, radius, height = np.zeros(3), 0.0, 0.0
        if kind == POINT:
            sup = (pos - 1.0, pos + 1.0)
            iso_box = (pos - ISO, pos + ISO)
        elif kind == CYLINDER:
            axis = _vec(s["direction"])
            radius, height = float(s["radius"]), float(s["height"])
            s1 = pos + height * axis
            e = radius + 1.0
            sup = (np.minimum(pos, s1) - e, np.maximum(pos, s1) + e)
            grow = (ISO + radius) + 0.5 * ISO * axis
            iso_box = (pos - grow, s1 + grow)
        else:
            raise ValueError(f"node {nid}: primitive {kind!r} is not read")
        rows.append((kind, fwd[:3], bwd[:3], pos, axis, radius, height,
                     _map_box(fwd[:3], *sup), _map_corners(fwd[:3], *iso_box)))
    kind, fwd, bwd, pos, axis, radius, height, sup, iso_box = zip(*rows)
    box_lo = np.array([b[0] for b in sup], np.float32)
    box_hi = np.array([b[1] for b in sup], np.float32)
    bbox_lo = np.min([b[0] for b in iso_box], 0).astype(np.float32)
    bbox_hi = np.max([b[1] for b in iso_box], 0).astype(np.float32)
    stretch = max(float(np.linalg.norm(b[:, :3], 2)) for b in bwd)
    return RefScene(
        kind=tuple(kind), bwd=np.array(bwd), fwd=np.array(fwd),
        pos=np.array(pos), axis=np.array(axis),
        radius=np.array(radius), height=np.array(height),
        box_lo=box_lo, box_hi=box_hi, bbox_lo=bbox_lo, bbox_hi=bbox_hi,
        stretch=stretch,
    )
