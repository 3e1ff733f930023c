"""Scalar NumPy re-implementation of the BlobTree field — the test oracle.

A direct transliteration of the reference evaluator's math
(data/opencl/Polygonizer.cl:483-729 `ComputePrimitiveField` /
`ComputeOpField` / `ComputeRangeField`, stack traversal `:1676-1771`),
evaluated by naive recursion over the host-side SceneDef. Used only in
tests to validate the vectorized evaluator; deliberately written with
plain Python control flow and float64 NumPy so it shares no code paths
with `ops.field` (except the warp transforms, which have no reference
semantics — the reference stubs them, Polygonizer.cpp:2048-2063).

Counterpart of fembrain_tpu/ops/field_ref.py over the port's SceneDef;
its warps go through the port's `ops.warp` in float64 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..blob.scene import SceneDef
from ..blob.types import OpType, PrimType
from .warp import warp_point


def wyvill(dd: float) -> float:
    if dd > 1.0:
        return 0.0
    t = 1.0 - dd
    return t * t * t


def prim_field(scene: SceneDef, idx: int, v: np.ndarray) -> float:
    p = scene.prims[idx]
    vt = p.bwd[:3, :3] @ v + p.bwd[:3, 3]
    t = p.ptype
    pos, d, res = p.pos, p.dir, p.res

    if t == PrimType.POINT:
        dist2 = float(np.dot(pos - vt, pos - vt))
    elif t == PrimType.LINE:
        delta = d - pos
        s = float(np.dot(vt - pos, delta) / np.dot(delta, delta))
        tt = vt - (pos + s * delta)
        dist2 = float(np.dot(tt, tt))
    elif t == PrimType.CYLINDER:
        q = vt - pos
        y = float(np.dot(q, d))
        x = max(0.0, np.sqrt(max(float(np.dot(q, q)) - y * y, 0.0)) - res[0])
        if y > 0.0:
            y = max(0.0, y - res[1])
        dist2 = x * x + y * y
    elif t == PrimType.CUBE:
        dif = vt - pos
        side = res[0]
        dist2 = 0.0
        for k in range(3):
            if dif[k] < -side:
                dist2 += (dif[k] + side) ** 2
            elif dif[k] > side:
                dist2 += (dif[k] - side) ** 2
    elif t == PrimType.DISC:
        delta = vt - pos
        in_plane = delta - np.dot(delta, d) * d
        len2 = float(np.dot(in_plane, in_plane))
        r = res[0]
        if len2 <= r * r:
            dist2 = abs(float(np.dot(delta, delta)) - len2)
        else:
            u = in_plane / np.sqrt(len2)
            x = r * u - delta
            dist2 = float(np.dot(x, x))
    elif t == PrimType.RING:
        delta = vt - pos
        in_plane = delta - np.dot(delta, d) * d
        len2 = float(np.dot(in_plane, in_plane))
        r = res[0]
        if len2 == 0.0:
            dist2 = r * r + float(np.dot(delta, delta))
        else:
            u = in_plane / np.sqrt(len2)
            x = r * u - delta
            dist2 = float(np.dot(x, x))
    elif t == PrimType.QUADRIC_POINT:
        dt = vt - pos
        dd = float(np.dot(dt, dt))
        rs = d[2]
        if rs > dd:
            return dd * dd * res[0] + dd * res[1] + res[2]
        dist2 = dd
    elif t == PrimType.TRIANGLE:
        dist2 = _point_triangle_dist2(vt, pos, d, res[:3])
    elif t == PrimType.INSTANCE:
        raise ValueError("oracle requires flattened instances")
    else:  # NULL
        dist2 = 10.0
    return wyvill(dist2)


def _point_triangle_dist2(p, a, b, c) -> float:
    """Brute-force reference: dense barycentric sampling refinement-free
    exact closest point via the standard region method (Ericson RTCD 5.1.5)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = float(np.dot(ab, ap)), float(np.dot(ac, ap))
    if d1 <= 0 and d2 <= 0:
        q = a
    else:
        bp = p - b
        d3, d4 = float(np.dot(ab, bp)), float(np.dot(ac, bp))
        if d3 >= 0 and d4 <= d3:
            q = b
        else:
            cp = p - c
            d5, d6 = float(np.dot(ab, cp)), float(np.dot(ac, cp))
            if d6 >= 0 and d5 <= d6:
                q = c
            else:
                vc = d1 * d4 - d3 * d2
                if vc <= 0 and d1 >= 0 and d3 <= 0:
                    q = a + ab * (d1 / (d1 - d3))
                else:
                    vb = d5 * d2 - d1 * d6
                    if vb <= 0 and d2 >= 0 and d6 <= 0:
                        q = a + ac * (d2 / (d2 - d6))
                    else:
                        va = d3 * d6 - d5 * d4
                        if va <= 0 and (d4 - d3) >= 0 and (d5 - d6) >= 0:
                            w = (d4 - d3) / ((d4 - d3) + (d5 - d6))
                            q = b + w * (c - b)
                        else:
                            denom = va + vb + vc
                            v = vb / denom
                            w = vc / denom
                            q = a + ab * v + ac * w
    return float(np.dot(p - q, p - q))


def op_field(scene: SceneDef, idx: int, v: np.ndarray) -> float:
    op = scene.ops[idx]
    t = op.otype
    params = op.params

    if t in (OpType.WARP_TWIST, OpType.WARP_TAPER, OpType.WARP_BEND,
             OpType.WARP_SHEAR):
        v = _warp_np(t, params, v)
        # Unary: evaluate the single child at the warped point.
        if op.left_is_op:
            return op_field(scene, op.left, v)
        return prim_field(scene, op.left, v)
    if t == OpType.CACHE:
        if op.left_is_op:
            return op_field(scene, op.left, v)
        return prim_field(scene, op.left, v)

    if op.is_range:
        fields = [prim_field(scene, i, v) for i in range(op.left, op.right + 1)]
        if t == OpType.UNION:
            return max(fields)
        if t == OpType.INTERSECT:
            return min(fields)
        if t == OpType.RICCI_BLEND:
            return float(np.sum(np.power(fields, params[0])) ** params[1])
        return float(np.sum(fields))

    lf = op_field(scene, op.left, v) if op.left_is_op else prim_field(scene, op.left, v)
    if op.is_unary:
        rf = 0.0
    else:
        rf = (
            op_field(scene, op.right, v)
            if op.right_is_op
            else prim_field(scene, op.right, v)
        )

    if t == OpType.UNION:
        return max(lf, rf)
    if t == OpType.INTERSECT:
        return min(lf, rf)
    if t in (OpType.BLEND, OpType.GRADIENT_BLEND, OpType.FAST_QUADRIC_POINT_SET):
        return lf + rf
    if t == OpType.RICCI_BLEND:
        return float((lf ** params[0] + rf ** params[0]) ** params[1])
    if t == OpType.DIF:
        return min(lf, 1.0 - rf)
    if t == OpType.SMOOTH_DIF:
        return lf * (1.0 - rf)
    return lf


def _warp_np(t: OpType, params, v: np.ndarray) -> np.ndarray:
    """ops.warp on one float64 point (validated against it in tests)."""
    wtype = int(t)
    if t == OpType.WARP_TWIST:
        aa, ab = int(params[1]), 0
    elif t in (OpType.WARP_TAPER, OpType.WARP_SHEAR):
        aa, ab = int(params[1]), int(params[2])
    else:
        aa, ab = 0, 0
    out = warp_point(
        wtype, torch.as_tensor(np.asarray(params, np.float64)), aa, ab,
        torch.as_tensor(v.astype(np.float64)),
    )
    return out.numpy()


def field(scene: SceneDef, v: np.ndarray) -> float:
    """Field at one world point (scene must have instances flattened)."""
    v = np.asarray(v, np.float64)
    if not scene.root_is_op:
        if not scene.prims:
            return 0.0
        return float(sum(prim_field(scene, i, v) for i in range(len(scene.prims))))
    return op_field(scene, scene.root_idx, v)


def field_many(scene: SceneDef, pts: np.ndarray) -> np.ndarray:
    return np.array([field(scene, p) for p in np.asarray(pts)], np.float64)


def gradient_fd(scene: SceneDef, v: np.ndarray, delta: float = 1e-4) -> np.ndarray:
    """Central finite-difference gradient (oracle for autograd checks;
    the reference uses forward differences with NORMAL_DELTA=1e-4,
    Polygonizer.cl:1134-1150)."""
    v = np.asarray(v, np.float64)
    g = np.zeros(3)
    for k in range(3):
        e = np.zeros(3)
        e[k] = delta
        g[k] = (field(scene, v + e) - field(scene, v - e)) / (2 * delta)
    return g
