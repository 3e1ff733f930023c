"""Tile sphere tracer: host-side layout, the CUDA kernel wrappers, the
kernels' plain PyTorch versions, and the differentiable `trace_fast`.

PyTorch counterpart of fembrain_tpu/render/pallas_trace.py (`trace_pallas`,
`trace_pallas_image`, `trace_fast` and their helpers). Rays are cut into
tiles of `tile` rays; each tile marches on its own with a tile-wide early
exit. Two kernels:

* the additive kernel (csrc/trace_additive.cu) sphere-marches the sum of
  Morton-ordered prim blocks of PRIM_BLOCK prims, with whole blocks
  skipped when the tile's ray hull misses a block's support box and single
  prims when the hull of a patch of PATCH rays misses theirs, in three
  modes: K1 rest; K2 Wendland-deformed (`WendlandSpec`: every march point
  pulled back through a compact-support interpolant, centers culled per
  CEN_BLOCK block and tile and one by one per patch, a per-lane linear
  rest-point model between refreshes); K4 biharmonic-deformed
  (`BiharmonicSpec`: every eval pulls back from scratch through all
  centers, global step bounds). Its CTAs stay resident and take the
  patches that hold a live ray from a list (`live_patches`), with the
  scene's tables copied once per CTA from one block (`pack_tables`);
* K3, the general kernel (csrc/trace_general.cu), marches any BlobTree
  of at most UNROLL_LIMIT ops: warp chains, the typed prim distances and
  the op fold along the schedule, fixed steps where the field is not
  monotone; prims under no warp are skipped where the tile's ray hull
  misses their support box (`GeneralInputs.live`).

On a CUDA tensor `run_tiles` launches the hand-written kernel (built by
fembrain_tpu_torch.native); on a CPU tensor it runs the plain version
(`trace_tiles_plain`, `trace_tiles_wendland_plain`,
`trace_tiles_biharmonic_plain`, `trace_tiles_general_plain`), which
computes the same march with the same tile partition, step rule,
iteration and refresh schedule, bisection and secant, vectorised over
all rays at once. Given a `WorkCount`, a plain version also counts the
work its inputs need (the field evaluations whose value the march uses,
the prims in reach of each, the centers of each pull-back), from which
`WorkCount.flops` gives the kernels' fp32 lower bound, and what the
kernels' culls let run for it (`WorkCount.prims_run` and its like).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..blob.scene import SRC_RANGE, Scene
from ..blob.types import PrimType
from ..ops.field import (
    UNROLL_LIMIT, field, field_rows, local_coords, point_merge_target,
    rows_prim_fields, supports_rows_fast_path,
)
from ..ops.warp import warp_components
from .sphere_trace import (
    TraceParams, _ray_box, newton_nudge, prim_interval,
    support_radius_bound, trace,
)

TILE = 256        # rays per CTA: one 16x16 pixel block, one ray a thread
PRIM_BLOCK = 8    # prims per cull block (the pack's Morton block size)
CEN_BLOCK = 32    # Wendland centers per step-bound block and tile flag
PATCH = 32        # rays a warp marches together: an 8x4 pixel patch
HULL_EPS = 1e-4   # slack of every hull/box overlap test
K_REFRESH = 4     # evals per pull-back refresh cycle when a spec gives 0
PRIM_ROW = 24     # floats per packed prim row: m[3][4] pos dir res type aux
STEP_ROW = 6      # ints per general op step: type dst lkind lidx rkind ridx
WARP_ROW = 8      # floats per warp wire: type axis_a axis_b pad params[4]
MAX_REGS = 32     # op-value registers per thread in the general kernel
MAX_TILE = 256    # largest tile the kernels take
MODE_REST, MODE_WENDLAND, MODE_BIHARMONIC = 0, 1, 2  # trace_additive.cu Mode
N_COUNTERS = 5    # the counting builds' counters, see `trace_additive_cuda`
# GeneralInputs.live: the prim adds exactly 0 on this tile's rays; it is
# evaluated where its support box meets the evaluation points; it is
# always evaluated (it sits under a warp chain).
LIVE_DEAD, LIVE_BOXED, LIVE_ALWAYS = 0, 1, 2

# Flops of the plain arithmetic, an FMA as 2, a sqrt or divide as 1, min,
# max and abs as 1, compares and selects as 0 (csrc/prim_field.cuh,
# csrc/trace_additive.cu). One prim: 18 for the world->local transform
# (three rows of 3 mul + 3 add), 4 for the Wyvill kernel, plus the
# skeleton distance of its type: point 3 sub + dot 5; line 3 + 5 + 3 + 5
# + safe_div 2 + 9 + 5; cylinder 3 + 5 + 5 + 2 + max, sqrt, sub, max 4 +
# sub, max 2 + 3; disc 3 + 5 + 6 + 5 + 5 + rsqrt 1 + 9 + 5 + 3 (ring: + 2
# for 3); cube 12 + 6; triangle 129 (six edge dots of 8, three areas of
# 3, ...); the quadric point 3 + 5 + its polynomial 5, with no Wyvill.
_LOCAL, _WYVILL = 18, 4
PRIM_FLOPS = {
    int(PrimType.POINT): _LOCAL + 8 + _WYVILL,
    int(PrimType.LINE): _LOCAL + 32 + _WYVILL,
    int(PrimType.CYLINDER): _LOCAL + 24 + _WYVILL,
    int(PrimType.DISC): _LOCAL + 42 + _WYVILL,
    int(PrimType.RING): _LOCAL + 41 + _WYVILL,
    int(PrimType.CUBE): _LOCAL + 18 + _WYVILL,
    int(PrimType.TRIANGLE): _LOCAL + 129 + _WYVILL,
    int(PrimType.QUADRIC_POINT): _LOCAL + 13,
}
# One center of one biharmonic pull-back iteration: 3 sub, |.|^2 5, max 1,
# sqrt 1, three FMAs 6. One Wendland center: 3 sub, |.|^2 5, sqrt 1, scale
# and min 2, 1 - t 1, square 1, o2 o2 (4 t + 1) 4, three FMAs 6.
BIHARMONIC_CENTER_FLOPS = 16
WENDLAND_CENTER_FLOPS = 23
# One pull-back iteration besides its centers: the affine tail (three rows
# of 3 mul + 3 add) and x = y - (tail + sum), 6.
PULL_TAIL_FLOPS = 24
# Bytes a launch must move: of every ray alive0 and t_exit read, t and
# hit written; of a ray that starts alive the other seven rows as well.
RAY_BYTES_DEAD = 16
RAY_BYTES_ALIVE = 28


def ray_bytes(rays: torch.Tensor) -> int:
    """Least bytes one launch on `rays` [9, n] reads and writes."""
    return (RAY_BYTES_DEAD * rays.shape[1]
            + RAY_BYTES_ALIVE * int((rays[8] > 0).sum()))


@dataclasses.dataclass
class WorkCount:
    """What one launch's inputs need, counted by the plain version. A
    needed lane-eval is one field evaluation whose value the march uses:
    the entry eval of a ray that starts alive, a march sub-step of a ray
    still alive, a bisection eval of a ray that found a root."""

    lane_evals: int = 0
    # prim type -> (needed lane-eval, prim whose support box holds the
    # evaluation point) pairs
    prim_evals: dict = dataclasses.field(default_factory=dict)
    pull_iters: int = 0             # pull-back iterations of needed lanes
    biharmonic_center_evals: int = 0  # pull_iters x M
    wendland_center_evals: int = 0  # centers within sigma of the estimate
    # What the kernels' culls let run for that, all PATCH lanes of a warp
    # counted wherever one of them needs the value: lanes of the patch
    # evals, (lane, prim) pairs whose prim passes the tile's flags and the
    # patch hull's box test, lanes of the patch pull-backs (K2), (lane,
    # center) pairs whose center lies within sigma of the patch hull (K2).
    lanes_run: int = 0
    prims_run: int = 0
    pull_lanes_run: int = 0
    centers_run: int = 0

    def add_prims(self, types: torch.Tensor, counts: torch.Tensor) -> None:
        for t, c in zip(types.tolist(), counts.tolist()):
            if c:
                self.prim_evals[int(t)] = self.prim_evals.get(int(t), 0) + c

    @property
    def prims_in_reach(self) -> int:
        return sum(self.prim_evals.values())

    @property
    def flops(self) -> int:
        return (
            sum(c * PRIM_FLOPS.get(t, 0) for t, c in self.prim_evals.items())
            + self.biharmonic_center_evals * BIHARMONIC_CENTER_FLOPS
            + self.wendland_center_evals * WENDLAND_CENTER_FLOPS
            + self.pull_iters * PULL_TAIL_FLOPS
        )


def _count_in_boxes(count, boxes, types, px, py, pz, need):
    """Add, per prim type, the (needed lane, prim) pairs whose box [G, 6]
    holds the lane's point."""
    inside = need[:, None]
    for i, p in enumerate((px, py, pz)):
        inside = (inside & (p[:, None] >= boxes[None, :, i])
                  & (p[:, None] <= boxes[None, :, 3 + i]))
    count.add_prims(types, inside.sum(0))


def patch_slots(tile: int, device=None) -> torch.Tensor:
    """[tile // PATCH, PATCH] the slot within a tile of each lane of each
    patch, as the kernels assign them: a tile of 256 rays is a 16x16 pixel
    block in row-major order and patch w its 8x4 pixel patch at column
    8 (w & 1), row 4 (w >> 1); any other tile is cut into runs of PATCH."""
    w = torch.arange(tile // PATCH, device=device)[:, None]
    lane = torch.arange(PATCH, device=device)[None]
    if tile == 256:
        return ((w >> 1) * 4 + (lane >> 3)) * 16 + (w & 1) * 8 + (lane & 7)
    return w * PATCH + lane


def patch_rays(n: int, tile: int, device=None) -> torch.Tensor:
    """[n // PATCH, PATCH] the ray of each lane of each patch, patches
    numbered tile by tile."""
    first = torch.arange(n // tile, device=device)[:, None, None] * tile
    return (first + patch_slots(tile, device)[None]).reshape(-1, PATCH)


def live_patches(rays: torch.Tensor, tile: int):
    """The kernels' work list: (work [n // PATCH] int32, n_work [1] int32),
    the patches that hold a ray that starts alive, in order, in the first
    n_work entries of `work` (the rest is -1). Built without reading
    anything back to the host."""
    n = rays.shape[1]
    dev = rays.device
    alive = (rays[8] > 0)[patch_rays(n, tile, dev)].any(-1)
    rank = torch.cumsum(alive, 0)
    n_patches = alive.shape[0]
    # Dead patches scatter into a spare last slot.
    work = torch.full((n_patches + 1,), -1, dtype=torch.int32, device=dev)
    dst = torch.where(alive, rank - 1, n_patches)
    work.scatter_(0, dst, torch.arange(n_patches, dtype=torch.int32,
                                       device=dev))
    return work[:n_patches], alive.sum().reshape(1).to(torch.int32)


def _pad_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """[G, 6] lo|hi boxes as [G, 8] lo xyz 0 | hi xyz 0."""
    zero = torch.zeros_like(boxes[:, :1])
    return torch.cat([boxes[:, :3], zero, boxes[:, 3:], zero], 1)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def table_layout(n_prims: int, n_centers: int = 0) -> dict:
    """Word offsets of the tables in the block the additive kernel copies
    into shared memory (csrc/trace_additive.cu `make_layout`); every table
    starts on a 16-byte boundary. The rest mode has no centers."""
    lay, o = {}, 0
    lay["prims"], o = o, o + n_prims * PRIM_ROW
    lay["pboxes"], o = o, o + n_prims * 8
    if n_centers:
        lay["centers"], o = o, o + n_centers * 4
        lay["weights"], o = o, o + _round4(n_centers * 2)
        lay["waff"], o = o, o + 12
    lay["total"] = o
    return lay


def pack_tables(prims, prim_boxes, centers=None, w=None,
                waff=None) -> torch.Tensor:
    """The tables of one additive launch as one flat float32 block in the
    kernel's shared-memory layout: prim rows; prim boxes as lo xyz _ | hi
    xyz _; in the deformed modes a center with its weights as c xyz w_x
    (16 bytes) and w_y w_z (8 bytes), then the affine tail."""
    m = 0 if centers is None else centers.shape[0]
    lay = table_layout(prims.shape[0], m)
    out = torch.zeros(lay["total"], dtype=torch.float32, device=prims.device)

    def put(name, t):
        out[lay[name] : lay[name] + t.numel()] = t.reshape(-1)

    put("prims", prims)
    put("pboxes", _pad_boxes(prim_boxes))
    if centers is not None:
        put("centers", torch.cat([centers, w[:, :1]], 1))
        put("weights", w[:, 1:])
        put("waff", waff)
    return out


def unpack_tables(tables, n_prims: int, n_centers: int = 0) -> dict:
    """The inverse of `pack_tables`: prims, prim_boxes and, in the
    deformed modes, centers, w, waff."""
    lay = table_layout(n_prims, n_centers)

    def take(name, rows, cols):
        return tables[lay[name] : lay[name] + rows * cols].reshape(rows, cols)

    b = take("pboxes", n_prims, 8)
    out = {"prims": take("prims", n_prims, PRIM_ROW),
           "prim_boxes": torch.cat([b[:, :3], b[:, 4:7]], 1)}
    if n_centers:
        c4 = take("centers", n_centers, 4)
        out["centers"] = c4[:, :3]
        out["w"] = torch.cat([c4[:, 3:], take("weights", n_centers, 2)], 1)
        out["waff"] = take("waff", 3, 4)
    return out


def _patch_hull(px, py, pz, need, lanes):
    """Hull of the needed lanes' points per patch (`lanes` [np, PATCH] ray
    of each lane): lo, hi [np, 3] and which patches need anything."""
    pts = torch.stack([px, py, pz], -1)[lanes]
    m = need[lanes]
    lo = torch.where(m[..., None], pts, torch.inf).amin(1)
    hi = torch.where(m[..., None], pts, -torch.inf).amax(1)
    return lo, hi, m.any(-1)


def _boxes_run(flags, boxes, hull) -> int:
    """How many (patch, box) pairs a kernel's cull lets run: boxes [G, 6]
    allowed by the patch's flags [np, G] that the patch hull meets (or
    every allowed box where `hull` is (None, None, run))."""
    lo, hi, run = hull
    ok = flags & run[:, None]
    if lo is not None:
        ok = ok & (_hull_box_live(lo, hi, boxes[:, :3], boxes[:, 3:]) > 0)
    return int(ok.sum())


def _balls_run(flags, centers, reach, hull) -> int:
    """How many (patch, center) pairs K2's cull lets run: centers [M, 3]
    allowed by the patch's flags [np, M] that lie within `reach` of the
    patch hull (of what lies farther, every point of the hull is farther
    than `reach`)."""
    lo, hi, run = hull
    gap = torch.clamp(torch.maximum(lo[:, None] - centers[None],
                                    centers[None] - hi[:, None]), min=0.0)
    near = torch.sum(gap * gap, -1) <= reach * reach
    return int((flags & run[:, None] & near).sum())


# Kernel launches made through `run_tiles`, per kernel and mode.
LAUNCHES = {"trace_additive_rest": 0, "trace_additive_wendland": 0,
            "trace_additive_biharmonic": 0, "trace_general": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class WendlandSpec:
    """Per-frame compact-support displacement spec for the deformed tile
    trace (render.deformed.wendland_spec builds it)."""

    centers: torch.Tensor   # [Mp, 3] Morton-blocked centers (pad 1e6)
    w: torch.Tensor         # [Mp, 3] kernel weights (pad 0)
    waff: torch.Tensor      # [3, 4] affine tail (col 0 constant, 1:4 B^T)
    bu: torch.Tensor        # [NBc] per-block max |u| sampled at centers
    bg: torch.Tensor        # [NBc] per-block max |grad u|_F at centers
    bfr: torch.Tensor       # [] Frobenius norm of the affine part B
    max_disp: torch.Tensor  # [] this frame's |u| bound
    sigma: float = 1.0
    k_refresh: int = 0


@dataclasses.dataclass(frozen=True)
class BiharmonicSpec:
    """Per-frame biharmonic displacement spec for the deformed tile trace
    (render.deformed.biharmonic_spec builds it): u(x) = sum_j w_j |x - c_j|
    + a + B x over all M centers."""

    centers: torch.Tensor   # [M, 3]
    w: torch.Tensor         # [M+4, 3] kernel weights, then a, then B
    shrink: torch.Tensor    # [] global multiplicative step factor 1 - L
    slack: torch.Tensor     # [] global subtractive step slack 2 max|u|
    max_disp: float = 0.5   # static bracket and cull-box inflation
    fp_iters: int = 2       # pull-back iterations per eval


@dataclasses.dataclass(frozen=True)
class WendlandInputs:
    centers: torch.Tensor   # [Mp, 3]
    w: torch.Tensor         # [Mp, 3]
    waff: torch.Tensor      # [3, 4]
    clive: torch.Tensor     # [tiles, n_cb] int32 static flags per CEN_BLOCK
    sigma: float
    inv_sigma: float
    k_refresh: int


@dataclasses.dataclass(frozen=True)
class BiharmonicInputs:
    centers: torch.Tensor   # [M, 3]
    w: torch.Tensor         # [M, 3] kernel weights
    waff: torch.Tensor      # [3, 4] affine tail (col 0 constant, 1:4 B^T)
    fp_iters: int


@dataclasses.dataclass(frozen=True)
class TileInputs:
    """Everything one additive tile-trace launch reads, laid out for the
    kernel. `work`, `n_work` and `tables` are not given but derived here
    from the other fields, also by `dataclasses.replace`: the work list is
    always that of `rays`, and the kernel's table block always holds what
    the plain version reads (`prims`, `prim_boxes`, the displacement's
    centers and weights)."""

    rays: torch.Tensor       # [9, n] ro xyz, rd xyz, t_enter, t_exit, alive0
    live: torch.Tensor       # [tiles, nb] int32 blocks a tile may evaluate
    tile_rows: torch.Tensor  # [tiles, 4] inv_stretch, shrink, slack, L
    prims: torch.Tensor      # [P, PRIM_ROW] packed prim rows
    prim_boxes: torch.Tensor  # [P, 6] prim support boxes lo|hi, row order
    prim_types: torch.Tensor  # [P] int64 each row's own type (work counts)
    block_types: tuple       # per block: effective prim types present
    tile: int
    dyn_cull: bool           # per-eval hull cull (scenes with > 4 blocks)
    iso: float
    r_iso: float
    base_step: float
    max_steps: int
    bisect_steps: int
    wendland: WendlandInputs | None = None
    biharmonic: BiharmonicInputs | None = None
    # [n / PATCH] int32 `live_patches` of `rays`, and [1] int32 how many.
    work: torch.Tensor = dataclasses.field(init=False, repr=False)
    n_work: torch.Tensor = dataclasses.field(init=False, repr=False)
    # `pack_tables` of prims, boxes and the displacement's centers.
    tables: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        work, n_work = live_patches(self.rays, self.tile)
        d = self.wendland or self.biharmonic
        tables = (pack_tables(self.prims, self.prim_boxes) if d is None else
                  pack_tables(self.prims, self.prim_boxes, d.centers, d.w,
                              d.waff))
        for name, value in (("work", work), ("n_work", n_work),
                            ("tables", tables)):
            object.__setattr__(self, name, value)

    @property
    def mode(self) -> int:
        if self.wendland is not None:
            return MODE_WENDLAND
        return MODE_REST if self.biharmonic is None else MODE_BIHARMONIC


@dataclasses.dataclass(frozen=True)
class GeneralInputs:
    """Everything one general (K3) tile-trace launch reads."""

    rays: torch.Tensor         # [9, n] as TileInputs.rays
    prims: torch.Tensor        # [P, PRIM_ROW]; column 23 the warp group
    steps: torch.Tensor        # [S, STEP_ROW] int32 op fold in schedule order
    step_params: torch.Tensor  # [S, 2] op params 0:2 (Ricci p, 1/p)
    warps: torch.Tensor        # [groups * chain_len, WARP_ROW] root-first
    live: torch.Tensor         # [tiles, P] int32 LIVE_* flag per tile and prim
    boxes: torch.Tensor        # [P, 6] prim support boxes lo|hi
    scene: Scene               # what the plain version evaluates
    tile: int
    n_real: int                # real prims (the sum when the root is a prim)
    n_groups: int
    chain_len: int
    n_regs: int
    root_reg: int
    root_is_op: bool
    adaptive: bool             # Wyvill step bound (monotone field) or fixed
    iso: float
    r_iso: float
    base_step: float
    inv_stretch: float
    max_steps: int
    bisect_steps: int


def _prim_rows(pm, pos, dirv, res, ptype, aux):
    """[P, PRIM_ROW] packed rows: m[3][4], pos, dir, res, type, aux."""
    P = pm.shape[0]
    return torch.cat(
        [pm.reshape(P, 12), pos, dirv, res, ptype.to(pos.dtype)[:, None],
         aux.to(pos.dtype)[:, None]], 1
    ).contiguous()


def _additive_layout(scene: Scene):
    """Prim rows in Morton block order plus per-block support boxes and
    world->local stretch bounds. Pack-normalized scenes are already in
    Morton order; others are sorted here (padding rows last)."""
    P = scene.capacity_prims
    dev = scene.prim_type.device
    real = torch.arange(P, device=dev) < scene.n_prims
    if scene.additive_block_types:
        perm = torch.arange(P, device=dev)
    else:
        c = 0.5 * (scene.prim_bb_lo + scene.prim_bb_hi)
        span = torch.clamp(scene.bbox_hi - scene.bbox_lo, min=1e-6)
        qn = torch.clamp((c - scene.bbox_lo[None]) / span[None], 0.0, 1.0)
        q = (qn * 1023.0).to(torch.int64)

        def spread(x):
            x = (x | (x << 16)) & 0x030000FF
            x = (x | (x << 8)) & 0x0300F00F
            x = (x | (x << 4)) & 0x030C30C3
            x = (x | (x << 2)) & 0x09249249
            return x

        code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
        code = torch.where(real, code, 0xFFFFFFFF)
        perm = torch.argsort(code, stable=True)
    pm = scene.prim_mtx[perm]
    ptype = scene.prim_type[perm]
    pos, dirv, res = scene.prim_pos[perm], scene.prim_dir[perm], scene.prim_res[perm]
    nb = P // PRIM_BLOCK
    blk_lo = scene.prim_bb_lo[perm].reshape(nb, PRIM_BLOCK, 3).amin(1)
    blk_hi = scene.prim_bb_hi[perm].reshape(nb, PRIM_BLOCK, 3).amax(1)
    # Per-block stretch bound: min(Frobenius norm of the prim's linear
    # part, global spectral max); padding rows (sorted last) get 0.
    frob = torch.sqrt(torch.sum(pm[:, :, :3] ** 2, (1, 2)))
    per_prim = torch.clamp(
        frob, max=float(np.float32(max(scene.max_world_to_local_scale, 1e-6)))
    )
    per_prim = torch.where(real, per_prim, 0.0)
    blk_stretch = per_prim.reshape(nb, PRIM_BLOCK).amax(1)

    # Points inside a block that mixes POINT with LINE or CYLINDER are
    # routed through that branch in degenerate form (ops.field
    # point_merge_target), so each row carries its effective type.
    block_types = scene.additive_block_types or (
        (tuple(scene.prim_types_present),) * nb
    )
    merge = torch.full((P,), -1, dtype=torch.int64, device=dev)
    eff_types = []
    for b, types in enumerate(block_types):
        tgt = point_merge_target(set(types))
        if tgt is not None:
            merge[b * PRIM_BLOCK : (b + 1) * PRIM_BLOCK] = tgt
        eff_types.append(
            tuple(t for t in types if tgt is None or t != int(PrimType.POINT))
        )
    is_pt = (ptype == int(PrimType.POINT)) & (merge >= 0)
    to_line = is_pt & (merge == int(PrimType.LINE))
    to_cyl = is_pt & (merge == int(PrimType.CYLINDER))
    eff_type = torch.where(is_pt, merge, ptype.to(torch.int64))
    dirv = torch.where(to_line[:, None], pos, dirv)
    dirv = torch.where(to_cyl[:, None], 0.0, dirv)
    res = torch.cat(
        [torch.where(to_cyl[:, None], 0.0, res[:, :2]), res[:, 2:]], 1
    )
    prims = _prim_rows(pm, pos, dirv, res, eff_type, torch.zeros_like(eff_type))
    prim_boxes = torch.cat([scene.prim_bb_lo[perm], scene.prim_bb_hi[perm]], 1)
    return (prims, prim_boxes, ptype.to(torch.int64), blk_lo, blk_hi,
            blk_stretch, tuple(eff_types))


def _tile_hulls(ro, rd, t_enter, t_exit, alive, tiles):
    """[tiles, 3] x2 segment hulls: every marched/refined t lies in
    [t_enter, t_exit], so points stay inside the endpoint hull."""
    a = ro + t_enter[:, None] * rd
    b = ro + t_exit[:, None] * rd
    lo_pts = torch.where(alive[:, None], torch.minimum(a, b), torch.inf)
    hi_pts = torch.where(alive[:, None], torch.maximum(a, b), -torch.inf)
    return (lo_pts.reshape(tiles, -1, 3).amin(1),
            hi_pts.reshape(tiles, -1, 3).amax(1))


def _hull_box_live(hull_lo, hull_hi, blk_lo, blk_hi):
    """[tiles, NB] int32 hull/AABB overlap flags."""
    live = torch.all(
        (hull_lo[:, None] <= blk_hi[None] + HULL_EPS)
        & (hull_hi[:, None] >= blk_lo[None] - HULL_EPS),
        -1,
    )
    return live.to(torch.int32)


def _pad_rays(ro, rd, tile):
    """Pad the rays to whole tiles: padded rays start far away pointing +x
    and miss everything."""
    n = ro.shape[0]
    pad = -(-n // tile) * tile - n
    if pad:
        dev = ro.device
        ro = torch.cat([ro, torch.full((pad, 3), 1e7, device=dev)], 0)
        far = torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(pad, 3)
        rd = torch.cat([rd, far], 0)
    return ro, rd


def _ray_rows(ro, rd, t_enter, t_exit, alive0):
    return torch.stack(
        [ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2],
         t_enter, t_exit, alive0.to(ro.dtype)], 0
    ).contiguous()


def is_additive_path(scene: Scene) -> bool:
    """Whether the additive kernel (K1, K2, K4) takes this scene; every
    other scene goes through the general kernel (K3)."""
    return scene.is_additive and scene.capacity_prims % PRIM_BLOCK == 0


def prepare_tiles(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                  params: TraceParams = TraceParams(), tile: int = TILE,
                  disp: WendlandSpec | BiharmonicSpec | None = None
                  ) -> TileInputs:
    """Pad the rays to whole tiles, bracket them, and build the per-tile
    flags and step rows one additive launch reads (the additive branch of
    the reference's trace_pallas, lines 845-1029)."""
    if not is_additive_path(scene):
        raise ValueError("the additive tile tracer takes additive scenes "
                         "only; prepare_general takes the others")
    dev = ro.device
    if disp is not None:
        max_disp = disp.max_disp
    else:
        max_disp = torch.zeros((), device=dev)
    ro, rd = _pad_rays(ro, rd, tile)
    tiles = ro.shape[0] // tile
    t_enter, t_exit, alive0 = prim_interval(scene, ro, rd,
                                            margin=0.05 + max_disp)

    (prims, prim_boxes, prim_types, blk_lo, blk_hi, blk_stretch,
     eff_types) = _additive_layout(scene)
    # The deformed trace derives its base step from the max_disp-inflated
    # bbox and tests deformed-space hulls against inflated block boxes.
    lo = scene.bbox_lo - max_disp - 0.05
    hi = scene.bbox_hi + max_disp + 0.05
    base_step = torch.sqrt(torch.sum((hi - lo) ** 2)) * params.step_frac
    hull_lo, hull_hi = _tile_hulls(ro, rd, t_enter, t_exit, alive0, tiles)
    live = _hull_box_live(hull_lo, hull_hi, blk_lo - max_disp,
                          blk_hi + max_disp)
    tile_stretch = torch.amax(torch.where(live > 0, blk_stretch[None], 0.0), -1)
    tile_inv = 1.0 / torch.clamp(tile_stretch, min=1e-6)
    wend = bih = None
    shrink_t = torch.ones_like(tile_inv)
    slack_t = torch.zeros_like(tile_inv)
    ldrift_t = torch.zeros_like(tile_inv)
    if isinstance(disp, WendlandSpec):
        # Per-tile deformed march bounds from the compact support: only
        # center blocks whose sigma box touches the tile's inflated
        # segment hull contribute; L and max|u| come from their sampled
        # per-block maxima (x1.25 / x1.15), and outside every support box
        # u is the affine tail, bounded over the hull box.
        n_cb = disp.centers.shape[0] // CEN_BLOCK
        cblk = disp.centers.reshape(n_cb, CEN_BLOCK, 3)
        cb_lo = cblk.amin(1) - disp.sigma
        cb_hi = cblk.amax(1) + disp.sigma
        clive = _hull_box_live(hull_lo, hull_hi, cb_lo - max_disp,
                               cb_hi + max_disp)
        any_alive = alive0.reshape(tiles, -1).any(-1)
        live_g = torch.amax(torch.where(clive > 0, disp.bg[None], 0.0), -1)
        live_u = torch.amax(torch.where(clive > 0, disp.bu[None], 0.0), -1)
        h_c = 0.5 * (hull_lo + hull_hi)
        h_r = torch.linalg.norm(0.5 * (hull_hi - hull_lo), dim=-1) + max_disp
        aff_c = disp.waff[:, 0][None] + h_c @ disp.waff[:, 1:4].T
        aff_u = torch.linalg.norm(aff_c, dim=-1) + disp.bfr * h_r
        l_tile = torch.maximum(1.25 * live_g, disp.bfr)
        u_max = torch.maximum(1.15 * live_u, aff_u)
        shrink_t = torch.where(any_alive, torch.clamp(1.0 - l_tile, 0.0, 1.0),
                               1.0)
        slack_t = torch.where(any_alive, 2.0 * u_max, 0.0)
        ldrift_t = torch.where(any_alive, l_tile, 0.0)
        wend = WendlandInputs(
            centers=disp.centers.contiguous(),
            w=disp.w.contiguous(),
            waff=disp.waff.contiguous(),
            clive=clive.contiguous(),
            sigma=float(np.float32(disp.sigma)),
            inv_sigma=float(np.float32(1.0 / disp.sigma)),
            k_refresh=int(disp.k_refresh) or K_REFRESH,
        )
    elif isinstance(disp, BiharmonicSpec):
        # Global (shrink, slack) on every tile; the hull cull tests the
        # pulled-back rest points against the exact rest boxes.
        m = disp.centers.shape[0]
        shrink_t = torch.broadcast_to(disp.shrink, tile_inv.shape)
        slack_t = torch.broadcast_to(disp.slack, tile_inv.shape)
        bih = BiharmonicInputs(
            centers=disp.centers.contiguous(),
            w=disp.w[:m].contiguous(),
            waff=disp.w[m:].T.contiguous(),
            fp_iters=int(disp.fp_iters),
        )
    elif disp is not None:
        raise TypeError(f"unknown displacement spec {type(disp).__name__}")
    tile_rows = torch.stack([tile_inv, shrink_t, slack_t, ldrift_t], -1)

    # Scenes with few real blocks evaluate every real block (the cull's
    # reductions would cost more than it skips); others apply the static
    # tile flags and cull per eval against the live lanes' hull.
    real = torch.tensor([bool(t) for t in eff_types], device=dev)
    dyn_cull = int(real.sum()) > 4
    live = (live.bool() & real[None]) if dyn_cull else real[None].expand_as(live)
    return TileInputs(
        rays=_ray_rows(ro, rd, t_enter, t_exit, alive0),
        live=live.to(torch.int32).contiguous(),
        tile_rows=tile_rows.contiguous(),
        prims=prims,
        prim_boxes=prim_boxes.contiguous(),
        prim_types=prim_types,
        block_types=eff_types,
        tile=tile,
        dyn_cull=dyn_cull,
        iso=float(params.iso),
        r_iso=params.r_iso,
        base_step=float(base_step),
        max_steps=int(params.max_steps),
        bisect_steps=int(params.bisect_steps),
        wendland=wend,
        biharmonic=bih,
    )


def prepare_general(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                    params: TraceParams = TraceParams(),
                    tile: int = TILE) -> GeneralInputs:
    """Pad and bracket the rays and lay the scene out for one general
    (K3) launch (the general branch of the reference's trace_pallas): the
    bracket is `prim_interval` where the prim support boxes bound the
    field, else the scene slab with margin 0.05, zeroed on dead rays."""
    if not supports_rows_fast_path(scene):
        raise ValueError(
            f"the general tile trace unrolls at most {UNROLL_LIMIT} ops, the "
            f"scene schedules {len(scene.schedule)}; use sphere_trace.trace")
    dev = ro.device
    ro, rd = _pad_rays(ro, rd, tile)
    lo = scene.bbox_lo - 0.05
    hi = scene.bbox_hi + 0.05
    if scene.can_cull:
        t_enter, t_exit, alive0 = prim_interval(scene, ro, rd, margin=0.05)
    else:
        t_enter, t_exit = _ray_box(ro, rd, lo[None], hi[None])
        alive0 = t_exit > t_enter
        t_enter = torch.where(alive0, t_enter, 0.0)
        t_exit = torch.where(alive0, t_exit, 0.0)

    # The op fold as register steps in schedule order (the scene's fold
    # plan); a range step carries its prim span instead of a range slot.
    steps = []
    for op_idx, otype, dst, lk, li, rk, ri in scene.fold_plan:
        if lk == SRC_RANGE:
            w = scene.wiring[op_idx]
            li, ri = w.left, w.right
        steps.append((otype, dst, lk, li, rk, ri))
    if not steps:
        steps = [(0, 0, 0, 0, 0, 0)]
    sched = [p[0] for p in scene.fold_plan] or [0]
    step_params = scene.op_params[torch.tensor(sched, device=dev)][:, :2]

    # Warp chains per group, root-first, with their op's parameters.
    P = scene.capacity_prims
    group = torch.zeros(P, dtype=torch.int64, device=dev)
    chain_len = max(1, max(len(c) for c, _ in scene.warp_groups))
    warps = torch.zeros((len(scene.warp_groups) * chain_len, WARP_ROW),
                        device=dev)
    warps[:, 0] = -1.0
    for g, (chain, prim_idx) in enumerate(scene.warp_groups):
        if prim_idx:
            group[list(prim_idx)] = g
        for j, wire in enumerate(chain):
            row = g * chain_len + j
            warps[row, :3] = torch.tensor(
                [wire.wtype, wire.axis_a, wire.axis_b], dtype=torch.float32)
            warps[row, 4:] = scene.op_params[wire.op_idx]
    prims = _prim_rows(scene.prim_mtx, scene.prim_pos, scene.prim_dir,
                       scene.prim_res, scene.prim_type, group)
    base_step = torch.sqrt(torch.sum((hi - lo) ** 2)) * params.step_frac

    # Per-tile prim flags. A prim's field is exactly 0 outside its support
    # box whatever op consumes it, and every point the march evaluates for
    # a live ray lies in the tile's segment hull: a prim under no warp is
    # dead on a tile whose hull misses its box. Warped prims see moved
    # points and stay always live; padding rows are dead.
    tiles = ro.shape[0] // tile
    hull_lo, hull_hi = _tile_hulls(ro, rd, t_enter, t_exit, alive0, tiles)
    boxed = torch.zeros(P, dtype=torch.bool, device=dev)
    for chain, prim_idx in scene.warp_groups:
        if not chain and prim_idx:
            boxed[list(prim_idx)] = True
    real = torch.arange(P, device=dev) < scene.n_prims
    live = torch.where(
        boxed[None],
        _hull_box_live(hull_lo, hull_hi, scene.prim_bb_lo, scene.prim_bb_hi),
        LIVE_ALWAYS)
    live = torch.where(real[None], live, LIVE_DEAD).to(torch.int32)
    return GeneralInputs(
        rays=_ray_rows(ro, rd, t_enter, t_exit, alive0),
        prims=prims,
        steps=torch.tensor(steps, dtype=torch.int32, device=dev),
        step_params=step_params.float().contiguous(),
        warps=warps.contiguous(),
        live=live.contiguous(),
        boxes=torch.cat([scene.prim_bb_lo, scene.prim_bb_hi], 1).contiguous(),
        scene=scene,
        tile=tile,
        n_real=scene.n_prims,
        n_groups=len(scene.warp_groups),
        chain_len=chain_len,
        n_regs=scene.fold_registers,
        root_reg=scene.root_reg,
        root_is_op=bool(scene.root_is_op),
        adaptive=bool(scene.monotone_field),
        iso=float(params.iso),
        r_iso=params.r_iso,
        base_step=float(base_step),
        inv_stretch=1.0 / max(scene.max_world_to_local_scale, 1e-6),
        max_steps=int(params.max_steps),
        bisect_steps=int(params.bisect_steps),
    )


# ----------------------------------------------------------- the kernels

_F32 = ctypes.c_float
_I32 = ctypes.c_int
_PTR = ctypes.c_void_p


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tiling(n, tile):
    if tile % 32 or not 32 <= tile <= MAX_TILE or n % tile:
        raise ValueError(f"tile {tile} must be a multiple of 32 in "
                         f"[32, {MAX_TILE}] dividing {n} rays")


def _ptr(t):
    return _PTR(t.data_ptr())


def _counts_ptr(lane_counts):
    """The counting build's N_COUNTERS counters, or a null pointer for the
    shipped kernel."""
    if lane_counts is None:
        return _PTR(None)
    _check("lane_counts", lane_counts, torch.int64, (N_COUNTERS,))
    return _ptr(lane_counts)


_ADDITIVE_NAMES = {MODE_REST: "trace_additive_rest",
                   MODE_WENDLAND: "trace_additive_wendland",
                   MODE_BIHARMONIC: "trace_additive_biharmonic"}


def trace_additive_cuda(inp: TileInputs, lane_counts=None,
                        two_ctas: bool = False):
    """Launch the CUDA additive tile-trace kernel (K1 rest, K2 Wendland or
    K4 biharmonic) on the current stream: (t [n], hit [n]) with hit 0/1 as
    float. The kernel marches the patches on `inp.work` (which TileInputs
    derives from `inp.rays`) and writes a miss for every ray that starts
    dead, so every output is written. With `lane_counts`
    (N_COUNTERS int64 on the card) the kernel's counting build runs
    instead and adds: the needed lane-evals; PATCH for every warp-eval
    that ran; PATCH for every prim a warp evaluated; PATCH for every warp
    pull-back that ran (K2); PATCH for every center a warp evaluated (K2).
    `two_ctas` picks K2's build for two resident CTAs an SM instead of the
    shipped three (the one residency variant kept for measuring; the other
    modes have none and raise).

    Replaces the Pallas TPU kernel fembrain_tpu/render/pallas_trace.py
    `_trace_kernel_additive` (rest, Wendland and biharmonic modes)."""
    from .. import native

    n = inp.rays.shape[1]
    tiles = n // inp.tile
    nb = inp.live.shape[1]
    P = inp.prims.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check_tiling(n, inp.tile)
    _check("rays", inp.rays, f32, (9, n))
    _check("work", inp.work, i32, (n // PATCH,))
    _check("n_work", inp.n_work, i32, (1,))
    _check("live", inp.live, i32, (tiles, nb))
    _check("tile_rows", inp.tile_rows, f32, (tiles, 4))
    if P != nb * PRIM_BLOCK:
        raise ValueError(f"{P} prims in {nb} blocks of {PRIM_BLOCK}")
    w, b = inp.wendland, inp.biharmonic
    if w is not None and b is not None:
        raise ValueError("one displacement mode per launch")
    m, clive, sigma, inv_sigma, k_refresh, fp_iters = (
        0, _PTR(None), 0.0, 0.0, 0, 0)
    if w is not None:
        m = w.centers.shape[0]
        if m % CEN_BLOCK:
            raise ValueError(f"{m} centers are not whole blocks of "
                             f"{CEN_BLOCK}")
        _check("clive", w.clive, i32, (tiles, m // CEN_BLOCK))
        clive, k_refresh = _ptr(w.clive), w.k_refresh
        sigma, inv_sigma = w.sigma, w.inv_sigma
    if b is not None:
        m, fp_iters = b.centers.shape[0], b.fp_iters
    _check("tables", inp.tables, f32,
           (table_layout(P, m)["total"],))
    lib = native.load()
    dev = inp.rays.device
    t_out = torch.empty(n, device=dev, dtype=f32)
    hit_out = torch.empty_like(t_out)
    taken = torch.zeros(1, device=dev, dtype=i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = _ADDITIVE_NAMES[inp.mode]
    rc = lib.fb_trace_additive(
        _I32(inp.mode), _ptr(inp.rays), _ptr(inp.live), _ptr(inp.tile_rows),
        _ptr(inp.tables), _ptr(inp.work), _ptr(inp.n_work), _ptr(taken),
        _ptr(t_out), _ptr(hit_out), _counts_ptr(lane_counts),
        _I32(n), _I32(inp.tile), _I32(P), _I32(nb), _I32(int(inp.dyn_cull)),
        _F32(inp.iso), _F32(inp.r_iso), _F32(inp.base_step),
        _I32(inp.max_steps), _I32(inp.bisect_steps), clive, _I32(m),
        _F32(sigma), _F32(inv_sigma), _I32(k_refresh), _I32(fp_iters),
        _I32(int(two_ctas)), _PTR(stream),
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {native.error_string(rc)}")
    LAUNCHES[name] += 1
    return t_out, hit_out


def trace_general_cuda(inp: GeneralInputs, lane_counts=None):
    """Launch the CUDA general tile-trace kernel (K3) on the current
    stream: (t [n], hit [n]) with hit 0/1 as float; `lane_counts` as in
    `trace_additive_cuda` (its first three counters).

    Replaces the Pallas TPU kernel fembrain_tpu/render/pallas_trace.py
    `_trace_kernel` with fembrain_tpu/ops/field.py `field_rows`."""
    from .. import native

    n = inp.rays.shape[1]
    P = inp.prims.shape[0]
    S = inp.steps.shape[0]
    f32 = torch.float32
    _check_tiling(n, inp.tile)
    _check("rays", inp.rays, f32, (9, n))
    _check("prims", inp.prims, f32, (P, PRIM_ROW))
    _check("steps", inp.steps, torch.int32, (S, STEP_ROW))
    _check("step_params", inp.step_params, f32, (S, 2))
    _check("warps", inp.warps, f32, (inp.n_groups * inp.chain_len, WARP_ROW))
    _check("live", inp.live, torch.int32, (n // inp.tile, P))
    _check("boxes", inp.boxes, f32, (P, 6))
    if inp.n_regs > MAX_REGS:
        raise ValueError(f"the fold needs {inp.n_regs} registers, the kernel "
                         f"has {MAX_REGS}")
    lib = native.load()
    t_out = torch.empty(n, device=inp.rays.device, dtype=f32)
    hit_out = torch.empty_like(t_out)
    stream = torch.cuda.current_stream(inp.rays.device).cuda_stream
    rc = lib.fb_trace_general(
        _ptr(inp.rays), _ptr(inp.prims), _ptr(inp.steps),
        _ptr(inp.step_params), _ptr(inp.warps), _ptr(inp.live),
        _ptr(inp.boxes), _ptr(t_out), _ptr(hit_out),
        _counts_ptr(lane_counts),
        _I32(n), _I32(inp.tile), _I32(P), _I32(inp.n_real), _I32(S),
        _I32(inp.n_groups), _I32(inp.chain_len), _I32(int(inp.root_is_op)),
        _I32(inp.root_reg), _I32(int(inp.adaptive)),
        _F32(inp.iso), _F32(inp.r_iso), _F32(inp.base_step),
        _F32(inp.inv_stretch), _I32(inp.max_steps), _I32(inp.bisect_steps),
        _PTR(stream),
    )
    if rc != 0:
        raise RuntimeError(f"trace_general launch failed: "
                           f"{native.error_string(rc)}")
    LAUNCHES["trace_general"] += 1
    return t_out, hit_out


# ---------------------------------------------------- the plain versions

def _march_rows(rays, tile, max_steps, bisect_steps, eval_c, carry, step_dt,
                subs, count=None):
    """The tile march in plain torch, all rays at once: a tile's loop state
    advances only while the tile itself would still be looping, as in the
    kernels. eval_c(t, carry, refresh, upd, need) -> (field - iso, carry),
    `need` marking the lanes whose value the march uses (eval_c reads it
    only to count); step_dt(f, t, carry) -> the step; `subs` lists each
    loop iteration's sub-steps by their refresh flag (`it` counts
    sub-steps, the loop test runs once per iteration). `upd` marks the
    lanes whose state a refresh may renew: every lane at the entry and in
    the refinement, the lanes still marching in between (a lane's march
    does not depend on its neighbours). `count`, a WorkCount, gets the
    needed lane-evals and the lanes of the patch evals that hold one.
    Returns (t, hit as float)."""
    rox, roy, roz, rdx, rdy, rdz, t_enter, t_exit, alive0f = rays
    n = rox.shape[0]
    tiles = n // tile
    alive0 = alive0f > 0.0
    tile_of = torch.arange(n, device=rox.device) // tile
    everyone = torch.ones_like(alive0)

    lanes = patch_rays(n, tile, rox.device) if count is not None else None

    def counted(need):
        if count is not None:
            count.lane_evals += int(need.sum())
            count.lanes_run += PATCH * int(need[lanes].any(-1).sum())
        return need

    f0, carry = eval_c(t_enter, carry, True, everyone, counted(alive0))
    t, f, t_prev, f_prev = t_enter, f0, t_enter, f0
    found = alive0 & (f0 >= 0.0)
    alive = alive0 & (f0 < 0.0)
    it = torch.zeros(tiles, dtype=torch.int64, device=rox.device)

    def tile_any(mask):
        return mask.reshape(tiles, -1).any(-1)

    running = (it < max_steps) & tile_any(alive)
    while bool(running.any()):
        run = running[tile_of]
        for refresh in subs:
            t_new = torch.minimum(t + step_dt(f, t, carry), t_exit)
            m = alive & run
            f_new, carry = eval_c(t_new, carry, refresh, m, counted(m))
            crossed = m & (f_new >= 0.0)
            done = m & (t_new >= t_exit) & (f_new < 0.0)
            t_prev = torch.where(m, t, t_prev)
            f_prev = torch.where(m, f, f_prev)
            t = torch.where(m, t_new, t)
            f = torch.where(m, f_new, f)
            found = found | crossed
            alive = alive & ~crossed & ~done
        it = it + len(subs) * running
        running = running & (it < max_steps) & tile_any(alive)

    # Refinement: bisection (in K2 the first halving refreshes the
    # pull-back and the rest ride the refreshed linear model), then a
    # secant on the bracket.
    a, b, fa, fb = t_prev, t, f_prev, f
    for i in range(bisect_steps):
        mid = 0.5 * (a + b)
        fm, carry = eval_c(mid, carry, i == 0, everyone, counted(found))
        neg = fm < 0.0
        a, b = torch.where(neg, mid, a), torch.where(neg, b, mid)
        fa, fb = torch.where(neg, fm, fa), torch.where(neg, fb, fm)
    denom = fb - fa
    t_sec = a - fa * (b - a) / torch.where(torch.abs(denom) < 1e-12, 1e-12,
                                           denom)
    t_root = torch.where(torch.abs(denom) < 1e-9, 0.5 * (a + b), t_sec)
    return torch.where(found, t_root, t_exit), found.to(torch.float32)


def _march_plain(inp: TileInputs, count: WorkCount | None = None):
    """The additive march (K1, K2, K4). Blocks are masked by the static
    tile flags only: the per-eval hull cull is exact for the lanes whose
    values are used (compact support), so it is left out. `count` gets
    the work these inputs need and what the kernel's culls (per patch and
    eval, against the hull of the lanes that need the value) let run for
    it; the results do not depend on it."""
    rox, roy, roz, rdx, rdy, rdz, t_enter = inp.rays[:7]
    n = rox.shape[0]
    tile_of = torch.arange(n, device=rox.device) // inp.tile
    live = inp.live[tile_of] > 0                       # [n, nb]
    inv_stretch, shrink, slack, ldrift = inp.tile_rows[tile_of].unbind(-1)
    iso = inp.iso
    if count is not None:
        lanes = patch_rays(n, inp.tile, rox.device)
        patch_tile = torch.arange(lanes.shape[0], device=rox.device) // (
            inp.tile // PATCH)
        # A prim is allowed on a patch where its block is on the tile.
        prim_ok = inp.live[patch_tile].repeat_interleave(PRIM_BLOCK, 1) > 0

    def patch_hull(px, py, pz, need, cull=True):
        lo, hi, run = _patch_hull(px, py, pz, need, lanes)
        return (lo, hi, run) if cull else (None, None, run)
    blocks = []
    for b, types in enumerate(inp.block_types):
        if not types:
            continue
        rows = inp.prims[b * PRIM_BLOCK : (b + 1) * PRIM_BLOCK]
        blocks.append((
            b, inp.prim_boxes[b * PRIM_BLOCK : (b + 1) * PRIM_BLOCK],
            inp.prim_types[b * PRIM_BLOCK : (b + 1) * PRIM_BLOCK],
            rows[:, :12].reshape(-1, 3, 4)[None],
            tuple(rows[:, 12 + i][None] for i in range(3)),
            tuple(rows[:, 15 + i][None] for i in range(3)),
            tuple(rows[:, 18 + i][None] for i in range(4)),
            rows[:, 22].to(torch.int64)[None], types,
        ))

    def field_rest(px, py, pz, need):
        f = torch.zeros_like(px)
        if count is not None:
            count.prims_run += PATCH * _boxes_run(
                prim_ok, inp.prim_boxes,
                patch_hull(px, py, pz, need, inp.dyn_cull))
        for (b, boxes, own_types, mtx, pos_c, dir_c, res_c, type_row,
             types) in blocks:
            if count is not None:
                # A point routed through a line or cylinder branch counts
                # as the point it is: the work is the function's, not the
                # layout's.
                _count_in_boxes(count, boxes, own_types, px, py, pz, need)
            vt = local_coords(px[:, None], py[:, None], pz[:, None], mtx)
            pf = rows_prim_fields(vt, pos_c, dir_c, res_c, type_row, types)
            f = f + torch.where(live[:, b], pf.sum(-1), 0.0)
        return f - iso

    def point(t):
        return rox + t * rdx, roy + t * rdy, roz + t * rdz

    w, bh = inp.wendland, inp.biharmonic
    if w is not None:
        clive = w.clive[tile_of] > 0                   # [n, n_cb]
        n_cb = w.centers.shape[0] // CEN_BLOCK
        wa = w.waff

        if count is not None:
            center_ok = w.clive[patch_tile].repeat_interleave(CEN_BLOCK,
                                                              1) > 0

        def pull(xx, yy, zz, px, py, pz, need):
            if count is not None:
                count.pull_iters += int(need.sum())
                hull = patch_hull(xx, yy, zz, need)
                count.pull_lanes_run += PATCH * int(hull[2].sum())
                count.centers_run += PATCH * _balls_run(
                    center_ok, w.centers, w.sigma + HULL_EPS, hull)
            u = [wa[i, 0] + wa[i, 1] * xx + wa[i, 2] * yy + wa[i, 3] * zz
                 for i in range(3)]
            for cb in range(n_cb):
                c = w.centers[cb * CEN_BLOCK : (cb + 1) * CEN_BLOCK]
                wc = w.w[cb * CEN_BLOCK : (cb + 1) * CEN_BLOCK]
                dx = xx[:, None] - c[None, :, 0]
                dy = yy[:, None] - c[None, :, 1]
                dz = zz[:, None] - c[None, :, 2]
                d = torch.sqrt(dx * dx + dy * dy + dz * dz)
                tt = torch.clamp(d * w.inv_sigma, max=1.0)
                if count is not None:
                    count.wendland_center_evals += int(
                        ((tt < 1.0) & need[:, None]).sum())
                omt = 1.0 - tt
                o2 = omt * omt
                ph = o2 * o2 * (4.0 * tt + 1.0)
                for i in range(3):
                    s = torch.sum(wc[None, :, i] * ph, -1)
                    u[i] = u[i] + torch.where(clive[:, cb], s, 0.0)
            return px - u[0], py - u[1], pz - u[2]

        def eval_c(t, carry, refresh, upd, need):
            px, py, pz = point(t)
            if refresh:
                xr, yr, zr, vx, vy, vz, tr = carry
                adv = t - tr
                x2, y2, z2 = pull(xr + adv * vx, yr + adv * vy,
                                  zr + adv * vz, px, py, pz, need)
                big = adv > 1e-5
                inv = 1.0 / torch.where(big, adv, 1.0)
                new = (x2, y2, z2,
                       torch.where(big, (x2 - xr) * inv, vx),
                       torch.where(big, (y2 - yr) * inv, vy),
                       torch.where(big, (z2 - zr) * inv, vz), t)
                carry = tuple(torch.where(upd, a, b)
                              for a, b in zip(new, carry))
            a2 = t - carry[6]
            return field_rest(carry[0] + a2 * carry[3],
                              carry[1] + a2 * carry[4],
                              carry[2] + a2 * carry[5], need), carry

        def step_dt(f, t, carry):
            # The model's staleness 2 L |t - t_r| comes off d before both
            # deformed-space bounds.
            d = (support_radius_bound(f + iso) - inp.r_iso) * inv_stretch
            de = d - 2.0 * ldrift * torch.abs(t - carry[6])
            d = torch.maximum(shrink * de, de - slack)
            return torch.clamp(0.95 * d, min=inp.base_step)

        carry = (*point(t_enter), rdx, rdy, rdz, t_enter)
        subs = [True] + [False] * (w.k_refresh - 1)
    else:
        if bh is not None:
            wa = bh.waff

            def pull_back(px, py, pz):
                xx, yy, zz = px, py, pz
                for _ in range(bh.fp_iters):
                    dx = xx[:, None] - bh.centers[None, :, 0]
                    dy = yy[:, None] - bh.centers[None, :, 1]
                    dz = zz[:, None] - bh.centers[None, :, 2]
                    d = torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz,
                                               min=1e-24))
                    u = [wa[i, 0] + wa[i, 1] * xx + wa[i, 2] * yy
                         + wa[i, 3] * zz + torch.sum(d * bh.w[None, :, i], -1)
                         for i in range(3)]
                    xx, yy, zz = px - u[0], py - u[1], pz - u[2]
                return xx, yy, zz

            def eval_c(t, carry, refresh, upd, need):
                if count is not None:
                    iters = int(need.sum()) * bh.fp_iters
                    count.pull_iters += iters
                    count.biharmonic_center_evals += (
                        iters * bh.centers.shape[0])
                return field_rest(*pull_back(*point(t)), need), carry
        else:
            def eval_c(t, carry, refresh, upd, need):
                return field_rest(*point(t), need), carry

        def step_dt(f, t, carry):
            d = (support_radius_bound(f + iso) - inp.r_iso) * inv_stretch
            d = torch.maximum(shrink * d, d - slack)
            return torch.clamp(0.95 * d, min=inp.base_step)

        carry = ()
        subs = [False, False]
    return _march_rows(inp.rays, inp.tile, inp.max_steps, inp.bisect_steps,
                       eval_c, carry, step_dt, subs, count)


def trace_tiles_plain(inp: TileInputs, count: WorkCount | None = None):
    """Plain version of K1 (the rest tile trace): (t [n], hit [n])."""
    if inp.wendland is not None or inp.biharmonic is not None:
        raise ValueError("K1 takes no displacement inputs")
    return _march_plain(inp, count)


def trace_tiles_wendland_plain(inp: TileInputs,
                               count: WorkCount | None = None):
    """Plain version of K2 (the Wendland-deformed tile trace)."""
    if inp.wendland is None:
        raise ValueError("K2 needs Wendland inputs")
    return _march_plain(inp, count)


def trace_tiles_biharmonic_plain(inp: TileInputs,
                                 count: WorkCount | None = None):
    """Plain version of K4 (the biharmonic-deformed tile trace)."""
    if inp.biharmonic is None:
        raise ValueError("K4 needs biharmonic inputs")
    return _march_plain(inp, count)


def trace_tiles_general_plain(inp: GeneralInputs,
                              count: WorkCount | None = None,
                              use_live: bool = True):
    """Plain version of K3 (the general tile trace): the same march on
    ops.field.field_rows, two sub-steps per iteration, the Wyvill step
    bound where the field is monotone and fixed steps elsewhere. Prims
    flagged dead on a ray's tile are masked to the 0 they would compute
    (`use_live=False` evaluates them: the results are the same bit for
    bit). `count` gets the work these inputs need."""
    rox, roy, roz, rdx, rdy, rdz = inp.rays[:6]
    scene = inp.scene
    prim_live = None
    if use_live:
        tile_of = torch.arange(rox.shape[0], device=rox.device) // inp.tile
        prim_live = inp.live[tile_of] > 0

    if count is not None:
        lanes = patch_rays(rox.shape[0], inp.tile, rox.device)
        flags = inp.live[torch.arange(lanes.shape[0], device=rox.device)
                         // (inp.tile // PATCH)]

    def count_reach(x, y, z, need):
        # What the kernel's masks let run: always-live prims, and boxed
        # ones whose box the patch hull of the needed points meets.
        hull = _patch_hull(x, y, z, need, lanes)
        count.prims_run += PATCH * (
            _boxes_run(flags == LIVE_ALWAYS, inp.boxes, (None, None, hull[2]))
            + _boxes_run(flags == LIVE_BOXED, inp.boxes, hull))
        # Each prim's box is tested at its warp group's point.
        for chain, prim_idx in scene.warp_groups:
            if not prim_idx:
                continue
            wx, wy, wz = x, y, z
            for wire in chain:
                p = tuple(scene.op_params[wire.op_idx, i] for i in range(4))
                wx, wy, wz = warp_components(
                    wire.wtype, p, wire.axis_a, wire.axis_b, wx, wy, wz)
            idx = torch.as_tensor(prim_idx, device=x.device)
            _count_in_boxes(count, inp.boxes[idx], scene.prim_type[idx],
                            wx, wy, wz, need)

    def eval_c(t, carry, refresh, upd, need):
        x, y, z = rox + t * rdx, roy + t * rdy, roz + t * rdz
        if count is not None:
            count_reach(x, y, z, need)
        return field_rows(scene, x, y, z, prim_live) - inp.iso, carry

    def step_dt(f, t, carry):
        if not inp.adaptive:
            return inp.base_step
        d = (support_radius_bound(f + inp.iso) - inp.r_iso) * inp.inv_stretch
        return torch.clamp(0.95 * d, min=inp.base_step)

    return _march_rows(inp.rays, inp.tile, inp.max_steps, inp.bisect_steps,
                       eval_c, (), step_dt, [False, False], count)


def run_tiles(inp: TileInputs | GeneralInputs):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    general = isinstance(inp, GeneralInputs)
    if inp.rays.is_cuda:
        return trace_general_cuda(inp) if general else trace_additive_cuda(inp)
    if inp.rays.device.type != "cpu":
        raise ValueError(f"no tile tracer for device {inp.rays.device}")
    if general:
        return trace_tiles_general_plain(inp)
    if inp.wendland is not None:
        return trace_tiles_wendland_plain(inp)
    if inp.biharmonic is not None:
        return trace_tiles_biharmonic_plain(inp)
    return trace_tiles_plain(inp)


def trace_tiles(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                params: TraceParams = TraceParams(), tile: int = TILE,
                disp: WendlandSpec | BiharmonicSpec | None = None):
    """Forward tile trace (raw hit parameters): ro, rd [N, 3] ->
    (t [N], hit [N] bool), t = t_exit on a miss. Additive scenes take the
    additive kernel (deformed with `disp`), all others the general one."""
    n = ro.shape[0]
    if is_additive_path(scene):
        inp = prepare_tiles(scene, ro, rd, params, tile, disp)
    elif disp is not None:
        raise ValueError("the deformed tile trace needs an additive scene")
    else:
        inp = prepare_general(scene, ro, rd, params, tile)
    t, hit = run_tiles(inp)
    return t[:n], hit[:n] > 0.5


def trace_fast(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
               params: TraceParams = TraceParams(), tile: int = TILE):
    """Tile-kernel forward march plus the implicit-differentiation
    correction: the output and gradients of sphere_trace.trace, at kernel
    speed (fembrain_tpu/render/pallas_trace.py `trace_fast`). The kernel
    (K1 on additive scenes, K3 on the others) runs on detached inputs, so
    its roots are constants; t = t0 - clamp(f_at / dfdt) carries the
    derivative through f_at = field(scene, x0) - iso, with the clamp at
    half a base step of the scene box. Scenes beyond the unrolled fold
    take sphere_trace.trace."""
    if not supports_rows_fast_path(scene):
        return trace(scene, ro, rd, params)
    with torch.no_grad():
        t_root, found = trace_tiles(scene, ro, rd, params, tile)
    diag = torch.sqrt(torch.sum((scene.bbox_hi - scene.bbox_lo + 0.1) ** 2))
    cap = 0.5 * diag * params.step_frac
    t_hit = newton_nudge(lambda p: field(scene, p) - params.iso, ro, rd,
                         t_root, found, cap)
    return t_hit, found


def _block_layout(height: int, width: int, tile: int):
    """Row-major <-> block-major converters for the coherent-tile image
    path: near-square bh x bw pixel blocks, bh * bw == tile."""
    bh = 1 << (int(math.log2(tile)) // 2)
    bw = tile // bh
    hb, wb = -(-height // bh), -(-width // bw)
    ph, pw = hb * bh - height, wb * bw - width

    def to_blocks(a, fill):
        img = a.reshape(height, width, 3)
        img = torch.nn.functional.pad(img, (0, 0, 0, pw, 0, ph), value=fill)
        img = img.reshape(hb, bh, wb, bw, 3).permute(0, 2, 1, 3, 4)
        return img.reshape(-1, 3)

    def from_blocks(a):
        img = a.reshape(hb, wb, bh, bw).permute(0, 2, 1, 3)
        img = img.reshape(hb * bh, wb * bw)[:height, :width]
        return img.reshape(-1)

    return to_blocks, from_blocks, (ph, pw), hb * wb * bh * bw


def image_rays_to_blocks(ro, rd, height, width, tile=TILE):
    """Permute row-major image rays into coherent pixel blocks of `tile`
    rays; padded rays start far away pointing +x and miss everything.
    Returns (ro_b, rd_b, from_blocks), from_blocks mapping a per-ray
    result back to row-major order."""
    to_blocks, from_blocks, (ph, pw), _ = _block_layout(height, width, tile)
    ro_b = to_blocks(ro, 1e7)
    rd_b = to_blocks(rd, 0.0)
    if pw or ph:
        mask = to_blocks(torch.ones_like(ro), 0.0)[:, :1] > 0.5
        plus_x = torch.tensor([1.0, 0.0, 0.0], device=rd.device)
        rd_b = torch.where(mask, rd_b, plus_x)
    return ro_b, rd_b, from_blocks


def trace_tiles_image(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                      height: int, width: int,
                      params: TraceParams = TraceParams(), tile: int = TILE,
                      disp: WendlandSpec | BiharmonicSpec | None = None):
    """trace_tiles over a row-major H x W ray grid, one pixel block per
    tile, results mapped back to row-major order."""
    ro_b, rd_b, from_blocks = image_rays_to_blocks(ro, rd, height, width,
                                                   tile)
    t_b, hit_b = trace_tiles(scene, ro_b, rd_b, params, tile, disp)
    return from_blocks(t_b), from_blocks(hit_b)
