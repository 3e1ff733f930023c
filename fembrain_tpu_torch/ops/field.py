"""Vectorized BlobTree field evaluation — the core compute primitive.

PyTorch counterpart of fembrain_tpu/ops/field.py. All primitive fields
for all points are evaluated as one batched computation, then operators
are folded in topological order, unrolled in Python over the scene's
static wiring. The same per-type distance code (`rows_prim_fields`) is
the plain version of the prim evaluator inside the CUDA trace kernels
(csrc/prim_field.cuh), and `field_rows` that of the general kernel's
per-point field (csrc/trace_general.cu).

Scenes with more than UNROLL_LIMIT scheduled ops fold through the
register-allocated plan (`_fold_scan`), which keeps at most
`scene.fold_registers` op values alive however many operators the
instance-flattened scene has.

The reference's `field_jit` is `jax.jit` of `field` and has no
counterpart: PyTorch runs `field` eagerly.
"""
from __future__ import annotations

import torch

from ..blob.scene import SRC_PRIM, SRC_RANGE, SRC_REG, Scene
from ..blob.types import OpType, PrimType
from .warp import warp_components, warp_point

_BIG = 10.0  # reference's "far" squared distance for NULL prims


def wyvill(dd: torch.Tensor) -> torch.Tensor:
    """Wyvill kernel (1-d^2)^3 for d^2<1 else 0 (Polygonizer.cl:278-284)."""
    t = torch.clamp(1.0 - dd, min=0.0)
    return t * t * t


def _safe_div(num, den, eps=1e-12):
    return num / torch.where(
        torch.abs(den) < eps, torch.where(den < 0, -eps, eps), den
    )


# All distance functions work on COMPONENT (SoA) arrays: vt is a 3-tuple
# of [N, G] coordinates, prim params are 3-tuples of [1, G] (or [G, 1]).


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _dist2_point(vt, pos, dirv, res):
    d = _sub3(pos, vt)
    return _dot3(d, d)


def _dist2_line(vt, pos, dirv, res):
    # pos = segment start, dirv = segment end (Polygonizer.cl:549-557).
    delta = _sub3(dirv, pos)
    dd = _dot3(delta, delta)
    t = _safe_div(_dot3(_sub3(vt, pos), delta), dd)
    proj = tuple(pos[i] + t * delta[i] for i in range(3))
    d = _sub3(vt, proj)
    return _dot3(d, d)


def _dist2_cylinder(vt, pos, dirv, res):
    # res = (radius, height, ...) (Polygonizer.cl:559-571). The 1e-20
    # floor makes the formula safe as the degenerate-POINT branch.
    p = _sub3(vt, pos)
    y = _dot3(p, dirv)
    pp = _dot3(p, p)
    x = torch.clamp(torch.sqrt(torch.clamp(pp - y * y, min=1e-20)) - res[0],
                    min=0.0)
    y = torch.where(y > 0.0, torch.clamp(y - res[1], min=0.0), y)
    return x * x + y * y


def _dist2_cube(vt, pos, dirv, res):
    # res = (side, ...) — axis-aligned in local space (Polygonizer.cl:587-637).
    side = res[0]
    out = 0.0
    for i in range(3):
        d = torch.clamp(torch.abs(vt[i] - pos[i]) - side, min=0.0)
        out = out + d * d
    return out


def _disc_ring_common(vt, pos, dirv, r):
    delta = _sub3(vt, pos)
    dn = _dot3(delta, dirv)
    in_plane = tuple(delta[i] - dn * dirv[i] for i in range(3))
    len2 = _dot3(in_plane, in_plane)
    dd = _dot3(delta, delta)
    inv_len = 1.0 / torch.sqrt(torch.where(len2 < 1e-24, 1.0, len2))
    edge = tuple(r * in_plane[i] * inv_len - delta[i] for i in range(3))
    edge2 = _dot3(edge, edge)
    return len2, dd, edge2


def _dist2_disc(vt, pos, dirv, res):
    # dirv = unit normal, res = (radius, ...) (Polygonizer.cl:639-654).
    r = res[0]
    len2, dd, edge2 = _disc_ring_common(vt, pos, dirv, r)
    return torch.where(len2 <= r * r, torch.abs(dd - len2), edge2)


def _dist2_ring(vt, pos, dirv, res):
    # dirv = unit normal, res = (radius, ...) (Polygonizer.cl:656-671).
    r = res[0]
    len2, dd, edge2 = _disc_ring_common(vt, pos, dirv, r)
    return torch.where(len2 < 1e-24, r * r + dd, edge2)


def _dist2_triangle(vt, pos, dirv, res):
    """Exact point-triangle squared distance (corners pos, dirv, res[:3]),
    region-free clamped-projection form (Ericson RTCD 5.1.5)."""
    a, b, c = pos, dirv, (res[0], res[1], res[2])
    ab = _sub3(b, a)
    ac = _sub3(c, a)
    d1 = _dot3(ab, _sub3(vt, a))
    d2 = _dot3(ac, _sub3(vt, a))
    d3 = _dot3(ab, _sub3(vt, b))
    d4 = _dot3(ac, _sub3(vt, b))
    d5 = _dot3(ab, _sub3(vt, c))
    d6 = _dot3(ac, _sub3(vt, c))

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    v = _safe_div(vb, denom)
    w = _safe_div(vc, denom)
    p_face = tuple(a[i] + v * ab[i] + w * ac[i] for i in range(3))

    def seg_closest(p0, e, num, den):
        t = torch.clamp(_safe_div(num, den), 0.0, 1.0)
        return tuple(p0[i] + t * e[i] for i in range(3))

    p_ab = seg_closest(a, ab, d1, d1 - d3)
    p_ac = seg_closest(a, ac, d2, d2 - d6)
    bc = _sub3(c, b)
    p_bc = seg_closest(b, bc, d4 - d3, (d4 - d3) + (d5 - d6))

    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    at_a = (d1 <= 0) & (d2 <= 0)
    at_b = (d3 >= 0) & (d4 <= d3)
    at_c = (d6 >= 0) & (d5 <= d6)

    closest = []
    for i in range(3):
        ci = p_face[i]
        ci = torch.where(in_bc, p_bc[i], ci)
        ci = torch.where(in_ac, p_ac[i], ci)
        ci = torch.where(in_ab, p_ab[i], ci)
        ci = torch.where(at_c, c[i], ci)
        ci = torch.where(at_b, b[i], ci)
        ci = torch.where(at_a, a[i], ci)
        closest.append(ci)
    d = _sub3(vt, tuple(closest))
    return _dot3(d, d)


_DIST2_FNS = {
    int(PrimType.POINT): _dist2_point,
    int(PrimType.LINE): _dist2_line,
    int(PrimType.CYLINDER): _dist2_cylinder,
    int(PrimType.DISC): _dist2_disc,
    int(PrimType.RING): _dist2_ring,
    int(PrimType.CUBE): _dist2_cube,
    int(PrimType.TRIANGLE): _dist2_triangle,
}


def point_merge_target(present) -> int | None:
    """The branch POINT prims are routed through when a type set mixes
    POINT with LINE (dir := pos) or CYLINDER (dir = 0, r = h = 0): the
    degenerate forms give the point distance and save a branch pass."""
    if int(PrimType.POINT) in present:
        if int(PrimType.LINE) in present:
            return int(PrimType.LINE)
        if int(PrimType.CYLINDER) in present:
            return int(PrimType.CYLINDER)
    return None


def _typed_dist2(vt, pos_c, dir_c, res_c, type_row, present):
    """Squared skeleton distance per prim with one branch per present
    type (see point_merge_target for the POINT merge)."""
    merge_into = point_merge_target(present)
    dist2 = torch.full_like(vt[0], _BIG)
    zero = torch.zeros_like(pos_c[0])
    for t, fn in _DIST2_FNS.items():
        if t not in present:
            continue
        if merge_into is not None and t == int(PrimType.POINT):
            continue
        if merge_into is not None and t == merge_into:
            is_pt = type_row == int(PrimType.POINT)
            if t == int(PrimType.LINE):
                dir_eff = tuple(
                    torch.where(is_pt, pos_c[i], dir_c[i]) for i in range(3)
                )
                res_eff = res_c
            else:  # CYLINDER
                dir_eff = tuple(
                    torch.where(is_pt, zero, dir_c[i]) for i in range(3)
                )
                res_eff = (
                    torch.where(is_pt, zero, res_c[0]),
                    torch.where(is_pt, zero, res_c[1]),
                ) + tuple(res_c[2:])
            d2 = fn(vt, pos_c, dir_eff, res_eff)
            sel = is_pt | (type_row == t)
        else:
            d2 = fn(vt, pos_c, dir_c, res_c)
            sel = type_row == t
        dist2 = torch.where(sel, d2, dist2)
    return dist2


def rows_prim_fields(vt, pos_c, dir_c, res_c, type_col, present):
    """Wyvill prim fields from local coordinates vt (3-tuple, any
    broadcastable 2-D layout) and per-prim parameter tuples; `present`
    is the static set of primitive types whose branches are emitted.
    Shared by the field evaluator and the plain tile tracer."""
    present = set(int(t) for t in present)
    pf = wyvill(_typed_dist2(vt, pos_c, dir_c, res_c, type_col, present))
    if int(PrimType.QUADRIC_POINT) in present:
        # Quadric point: polynomial inside support radius, else Wyvill of
        # dist^2 (Polygonizer.cl:673-686).
        d = _sub3(vt, pos_c)
        dd = _dot3(d, d)
        quad = dd * dd * res_c[0] + dd * res_c[1] + res_c[2]
        fq = torch.where(dir_c[2] > dd, quad, wyvill(dd))
        pf = torch.where(type_col == int(PrimType.QUADRIC_POINT), fq, pf)
    return pf


def local_coords(px, py, pz, mtx):
    """World -> prim-local coordinates: 3-tuple of m[i,0] x + m[i,1] y +
    m[i,2] z + m[i,3] for [P,3,4] matrices broadcast against the point
    components (elementwise, in the kernel's operation order)."""
    return tuple(
        mtx[..., i, 0] * px + mtx[..., i, 1] * py + mtx[..., i, 2] * pz
        + mtx[..., i, 3]
        for i in range(3)
    )


def _group_fields(pts, mtx, ptype, pos, dirv, res, present):
    """[N,3] points x [G] prims -> [N,G] fields."""
    vt = local_coords(pts[:, 0:1], pts[:, 1:2], pts[:, 2:3], mtx[None])
    pos_c = tuple(pos[:, i][None, :] for i in range(3))
    dir_c = tuple(dirv[:, i][None, :] for i in range(3))
    res_c = tuple(res[:, i][None, :] for i in range(4))
    return rows_prim_fields(vt, pos_c, dir_c, res_c, ptype[None, :], present)


def prim_fields(scene: Scene, points: torch.Tensor) -> torch.Tensor:
    """Field of every primitive at every point: [N, 3] -> [N, P].

    Per primitive: world point -> warp chain (root-first) -> inverse node
    transform -> squared distance by skeleton type -> Wyvill kernel."""
    N = points.shape[0]
    P = scene.capacity_prims
    out = torch.zeros((N, P), dtype=points.dtype, device=points.device)
    for chain, prim_idx in scene.warp_groups:
        if not prim_idx and len(scene.warp_groups) > 1:
            continue
        pts = points
        for wire in chain:
            pts = warp_point(
                wire.wtype, scene.op_params[wire.op_idx],
                wire.axis_a, wire.axis_b, pts,
            )
        if len(scene.warp_groups) == 1:
            # Fast path: no gather, evaluate all (incl. padding) prims.
            return _group_fields(
                pts, scene.prim_mtx, scene.prim_type, scene.prim_pos,
                scene.prim_dir, scene.prim_res, scene.prim_types_present,
            )
        idx = torch.as_tensor(prim_idx, device=points.device)
        out[:, idx] = _group_fields(
            pts, scene.prim_mtx[idx], scene.prim_type[idx],
            scene.prim_pos[idx], scene.prim_dir[idx], scene.prim_res[idx],
            scene.prim_types_present,
        )
    return out


def _op_apply(otype: int, lf, rf, params):
    """Binary operator semantics (Polygonizer.cl:697-729 `ComputeOpField`)."""
    if otype == int(OpType.UNION):
        return torch.maximum(lf, rf)
    if otype == int(OpType.INTERSECT):
        return torch.minimum(lf, rf)
    if otype in (int(OpType.BLEND), int(OpType.GRADIENT_BLEND),
                 int(OpType.FAST_QUADRIC_POINT_SET)):
        return lf + rf
    if otype == int(OpType.RICCI_BLEND):
        p, inv_p = params[0], params[1]
        return torch.pow(torch.pow(lf, p) + torch.pow(rf, p), inv_p)
    if otype == int(OpType.DIF):
        return torch.minimum(lf, 1.0 - rf)
    if otype == int(OpType.SMOOTH_DIF):
        return lf * (1.0 - rf)
    # Warps and CACHE are pass-through in the fold (warp geometry is
    # applied via per-prim chains).
    return lf


def _op_range(otype: int, fields, params):
    """Range-op fold over a contiguous primitive span [N, R] -> [N]
    (Polygonizer.cl:731-770 `ComputeRangeField`, with a masked min for
    INTERSECT)."""
    if otype == int(OpType.UNION):
        return torch.amax(fields, -1)
    if otype == int(OpType.INTERSECT):
        return torch.amin(fields, -1)
    if otype == int(OpType.RICCI_BLEND):
        p, inv_p = params[0], params[1]
        return torch.pow(torch.sum(torch.pow(fields, p), -1), inv_p)
    return torch.sum(fields, -1)  # BLEND and everything else: sum


# Above this op count `field` folds through the register-allocated plan;
# the per-point evaluator `field_rows` (and the general tile-trace kernel
# it is the plain version of) stops here, as the reference's does.
UNROLL_LIMIT = 96


def supports_rows_fast_path(scene: Scene) -> bool:
    """Whether the fold is small enough for the unrolled per-point
    evaluator `field_rows` and the general tile-trace kernel."""
    return len(scene.schedule) <= UNROLL_LIMIT


def _fold_unrolled(scene: Scene, pf: torch.Tensor) -> torch.Tensor:
    op_vals: dict[int, torch.Tensor] = {}
    for k in scene.schedule:
        w = scene.wiring[k]
        params = scene.op_params[k]
        if w.is_range:
            val = _op_range(w.otype, pf[:, w.left : w.right + 1], params)
        else:
            lf = op_vals[w.left] if w.left_is_op else pf[:, w.left]
            if w.is_unary:
                rf = torch.zeros_like(lf)
            else:
                rf = op_vals[w.right] if w.right_is_op else pf[:, w.right]
            val = _op_apply(w.otype, lf, rf, params)
        op_vals[k] = val
    return op_vals[scene.root_idx]


def _range_values_segmented(scene: Scene, pf: torch.Tensor) -> torch.Tensor:
    """All range-op values at once via segment reductions: [n_ranges, N].

    Range spans are disjoint (each primitive has exactly one parent), so
    one segment id per primitive column computes every range op's
    reduction in one pass; columns outside every range go to a dump
    segment that is sliced off."""
    ranges = [(k, scene.wiring[k]) for k in scene.schedule
              if scene.wiring[k].is_range]
    R = len(ranges)
    N, P = pf.shape
    if R == 0:
        return pf.new_zeros((1, N))
    dev = pf.device
    seg_h = [R] * P
    for slot, (_, w) in enumerate(ranges):
        seg_h[w.left : w.right + 1] = [slot] * (w.right + 1 - w.left)
    otypes_h = [w.otype for _, w in ranges]
    seg = torch.tensor(seg_h, dtype=torch.long, device=dev)
    otypes = torch.tensor(otypes_h, device=dev)[:, None]          # [R, 1]
    pfT = pf.T                                                     # [P, N]
    present = set(otypes_h)

    def seg_reduce(src, how):
        idx = seg[:, None].expand(P, N)
        return src.new_zeros((R + 1, N)).scatter_reduce(
            0, idx, src, how, include_self=False)[:R]

    rv = pf.new_zeros((R + 1, N)).index_add(0, seg, pfT)[:R]
    if int(OpType.UNION) in present:
        rv = torch.where(otypes == int(OpType.UNION),
                         seg_reduce(pfT, "amax"), rv)
    if int(OpType.INTERSECT) in present:
        rv = torch.where(otypes == int(OpType.INTERSECT),
                         seg_reduce(pfT, "amin"), rv)
    if int(OpType.RICCI_BLEND) in present:
        # Per-prim power = its range op's power; dump columns get power 1.
        ks = torch.tensor([k for k, _ in ranges], device=dev)
        pw_slot = scene.op_params[ks, 0]
        inv_slot = scene.op_params[ks, 1]
        pw_col = torch.cat([pw_slot, pw_slot.new_ones(1)])[seg]
        spow = pf.new_zeros((R + 1, N)).index_add(
            0, seg, torch.pow(pfT, pw_col[:, None]))[:R]
        rv = torch.where(otypes == int(OpType.RICCI_BLEND),
                         torch.pow(spow, inv_slot[:, None]), rv)
    return rv


def _fold_scan(scene: Scene, pf: torch.Tensor) -> torch.Tensor:
    """Fold over the register-allocated plan: a register file of
    `scene.fold_registers` op values [N] (the tree-depth bound), range
    values from `_range_values_segmented`. A register's old value is
    dropped when its slot is written, so live memory stays flat however
    many operators the scene has."""
    rv = _range_values_segmented(scene, pf)
    zero = pf.new_zeros(pf.shape[0])
    regs = [zero] * scene.fold_registers

    def fetch(kind, idx):
        if kind == SRC_REG:
            return regs[idx]
        if kind == SRC_PRIM:
            return pf[:, idx]
        if kind == SRC_RANGE:
            return rv[idx]
        return zero

    for k, otype, dst, lk, li, rk, ri in scene.fold_plan:
        regs[dst] = _op_apply(min(max(otype, 0), 12), fetch(lk, li),
                              fetch(rk, ri), scene.op_params[k])
    return regs[scene.root_reg]


def _fold(scene: Scene, pf: torch.Tensor) -> torch.Tensor:
    """Operator fold over a primitive-field matrix [N, P] -> [N]."""
    if not scene.root_is_op:
        # No operators: blend (sum) all primitives (Polygonizer.cpp:2088-2097).
        return torch.sum(pf[:, : scene.n_prims], -1)
    if len(scene.schedule) <= UNROLL_LIMIT:
        return _fold_unrolled(scene, pf)
    return _fold_scan(scene, pf)


def field(scene: Scene, points: torch.Tensor) -> torch.Tensor:
    """BlobTree field at points [..., 3] -> [...]."""
    shape = points.shape[:-1]
    pts = points.reshape(-1, 3)
    return _fold(scene, prim_fields(scene, pts)).reshape(shape)


def field_via(scene: Scene, points: torch.Tensor,
              strategy: str) -> torch.Tensor:
    """Field evaluation with an explicit fold strategy: 'unrolled' (the
    dataflow unroll over the schedule) or 'scan' (the register-file fold
    over the plan). Both give the same values; `field` picks by op
    count."""
    shape = points.shape[:-1]
    pf = prim_fields(scene, points.reshape(-1, 3))
    if not scene.root_is_op:
        return torch.sum(pf[:, : scene.n_prims], -1).reshape(shape)
    if strategy == "unrolled":
        out = _fold_unrolled(scene, pf)
    elif strategy == "scan":
        out = _fold_scan(scene, pf)
    else:
        raise ValueError(f"unknown fold strategy {strategy!r}")
    return out.reshape(shape)


def _field_color(scene: Scene, pts: torch.Tensor):
    """(field [N], colour [N, 4]) from ONE primitive pass: the colour is
    the field-weighted mean of the primitives' diffuse colours
    (Polygonizer.cl:895-1128 `ComputeFieldAndColor`)."""
    pf = prim_fields(scene, pts)
    n = scene.n_prims
    w = pf[:, :n]
    wsum = torch.sum(w, -1, keepdim=True)
    col = (w @ scene.prim_color[:n]) / torch.clamp(wsum, min=1e-8)
    return _fold(scene, pf), col


def field_and_color(scene: Scene, points: torch.Tensor):
    """Field plus field-weighted material color [..., 3] -> ([...],
    [..., 4])."""
    shape = points.shape[:-1]
    f, col = _field_color(scene, points.reshape(-1, 3))
    return f.reshape(shape), col.reshape(*shape, 4)


def vertex_attributes(scene: Scene, points: torch.Tensor, warp=None,
                      warp_inputs=()):
    """(field, gradient, color) at points [..., 3] in one primitive
    evaluation and one backward sweep (the reference's
    ComputeVertexAttribs, Polygonizer.cl:1429-1561, pays 6 field
    evaluations per vertex). Points are independent, so the gradient of
    f.sum() with respect to the points is the per-point gradient.

    `warp`, if given, maps the points [N, 3] -> [N, 3] before the field
    (a deformation's pull-back): field and colour are then taken at the
    warped points and the gradient is that of the composed field;
    `warp_inputs` are the tensors the map closes over. The three results
    carry a graph when the points, a scene parameter or a warp input
    requires grad, and are constants otherwise."""
    shape = points.shape[:-1]
    pts = points.reshape(-1, 3)
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (
            pts, scene.prim_pos, scene.prim_dir, scene.prim_res,
            scene.prim_mtx, scene.prim_color, scene.op_params, *warp_inputs))
    with torch.enable_grad():
        p = pts if pts.requires_grad else pts.detach().requires_grad_(True)
        f, col = _field_color(scene, p if warp is None else warp(p))
        (g,) = torch.autograd.grad(f.sum(), p, create_graph=keep)
    if not keep:
        f, col = f.detach(), col.detach()
    return f.reshape(shape), g.reshape(*shape, 3), col.reshape(*shape, 4)


def field_rows(scene: Scene, x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor,
               prim_live: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point field evaluation on component tensors x, y, z [N] -> [N]
    (fembrain_tpu/ops/field.py `field_rows`): every warp group's chain is
    applied root-first to the components, prims take their group's local
    coordinates, and the unrolled op fold follows the schedule. The plain
    version of the general tile-trace kernel's field evaluator
    (csrc/trace_general.cu). `prim_live` [N, P] bool masks prim fields to
    0 before the fold, as the kernel's culled prims contribute."""
    if not supports_rows_fast_path(scene):
        raise ValueError(
            f"field_rows unrolls at most {UNROLL_LIMIT} ops, the scene "
            f"schedules {len(scene.schedule)}; use `field`"
        )
    x, y, z = x[:, None], y[:, None], z[:, None]
    mtx = scene.prim_mtx[None]
    plain = len(scene.warp_groups) == 1 and not scene.warp_groups[0][0]
    if plain:
        vt = local_coords(x, y, z, mtx)
    else:
        # Prims sharing a warp chain see the chain-warped point; rows are
        # stitched by static group masks, prims of no group take the first
        # group's coordinates (they are never folded).
        vt = None
        for chain, prim_idx in scene.warp_groups:
            if not prim_idx:
                continue
            wx, wy, wz = x, y, z
            for wire in chain:
                p = tuple(scene.op_params[wire.op_idx, i] for i in range(4))
                wx, wy, wz = warp_components(
                    wire.wtype, p, wire.axis_a, wire.axis_b, wx, wy, wz
                )
            vt_g = local_coords(wx, wy, wz, mtx)
            if vt is None:
                vt = vt_g
            else:
                mask = torch.zeros(scene.capacity_prims, dtype=torch.bool,
                                   device=x.device)
                mask[list(prim_idx)] = True
                vt = tuple(torch.where(mask, vt_g[i], vt[i]) for i in range(3))
    pos_c = tuple(scene.prim_pos[:, i][None] for i in range(3))
    dir_c = tuple(scene.prim_dir[:, i][None] for i in range(3))
    res_c = tuple(scene.prim_res[:, i][None] for i in range(4))
    pf = rows_prim_fields(vt, pos_c, dir_c, res_c, scene.prim_type[None],
                          scene.prim_types_present)           # [N, P]
    if prim_live is not None:
        pf = torch.where(prim_live, pf, 0.0)
    if not scene.root_is_op:
        return torch.sum(pf[:, : scene.n_prims], -1)
    return _fold_unrolled(scene, pf)


def gradient(scene: Scene, points: torch.Tensor) -> torch.Tensor:
    """∇field at points [..., 3] -> [..., 3] via autograd (the value only;
    the result carries no graph)."""
    with torch.enable_grad():
        p = points.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(field(scene, p).sum(), p)
    return g


def normal(scene: Scene, points: torch.Tensor) -> torch.Tensor:
    """Outward surface normal -∇f / |∇f| (Polygonizer.cl:1152-1173)."""
    g = gradient(scene, points)
    n2 = torch.sum(g * g, -1, keepdim=True)
    return -g * torch.rsqrt(torch.clamp(n2, min=1e-24))


def field_image(scene: Scene, axis: int, coord: float,
                width: int = 128, height: int = 128) -> torch.Tensor:
    """2-D field slice for debugging (reference ComputeFieldImage,
    Polygonizer.cl:1288-1325): sample the plane `axis` = coord across the
    scene bbox -> [height, width] field values."""
    lo, hi = scene.bbox_lo, scene.bbox_hi
    a, b = (k for k in range(3) if k != axis)
    us = torch.linspace(float(lo[a]), float(hi[a]), width, device=lo.device)
    vs = torch.linspace(float(lo[b]), float(hi[b]), height, device=lo.device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    pts = torch.zeros((height, width, 3), device=lo.device)
    pts[..., a] = uu
    pts[..., b] = vv
    pts[..., axis] = coord
    return field(scene, pts.reshape(-1, 3)).reshape(height, width)


def off_surface_points_and_fields(scene: Scene, points: torch.Tensor,
                                  offset: float = 0.1):
    """+/- normal offset samples with their field values (reference
    ComputeOffSurfacePointsAndFields, Polygonizer.cl:1329-1350), the RBF
    training data, with autograd normals: ([2N, 3] points, [2N] fields)."""
    n = normal(scene, points)
    p_out = points + offset * n
    p_in = points - offset * n
    return (torch.cat([p_out, p_in], 0),
            torch.cat([field(scene, p_out), field(scene, p_in)], 0))
