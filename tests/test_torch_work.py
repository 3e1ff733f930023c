"""PyTorch port: the work counter of the plain tile tracers
(`tile_trace.WorkCount`), from which the kernels' fp32 lower bound is
computed. The counts on a one-sphere scene and on brain equal a scalar
march written here, ray by ray; they do not depend on the tile size; and
counting changes no result. What the kernel's culls let run for that work
(`lanes_run`, `prims_run`, ...) is held to the same scalar march on rays
that sit alone in their patch."""
import dataclasses

import numpy as np
import pytest
import torch

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.blob.types import PrimType
from fembrain_tpu_torch.ops.field import field
from fembrain_tpu_torch.render import tile_trace as tt
from fembrain_tpu_torch.render.camera import Camera, generate_rays
from fembrain_tpu_torch.render.deformed import (
    biharmonic_spec, build_disp_interp, disp_bounds_sampled,
    disp_weights_centers, wendland_spec,
)

from test_torch_fixtures import BRAIN, blend_twist, brain_resection

# support_radius_bound's table (render/sphere_trace.py), as scalars.
_RADIUS = ((0.0001, 0.9765), (0.001, 0.9487), (0.005, 0.9105),
           (0.02, 0.8536), (0.05, 0.7947), (0.10, 0.7320), (0.15, 0.6846),
           (0.20, 0.6444), (0.30, 0.5749))


def _scene(name):
    if name == "sphere":
        sc = pscene.SceneDef()
        sc.add_prim(pscene.PrimDef(PrimType.POINT, pos=np.zeros(3)))
        return sc.pack(device="cpu"), (30.0, 20.0, 4.0)
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    return sc.pack(device="cpu"), (30.0, 20.0, 6.0)


def _rays(pose, w=32, h=18):
    ro, rd = generate_rays(Camera.orbit(*pose, device="cpu"), w, h)
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def _only(inp, chosen):
    """The same inputs with every ray but the chosen ones dead."""
    rays = inp.rays.clone()
    keep = torch.zeros(rays.shape[1], dtype=torch.bool)
    keep[chosen] = True
    rays[8] = torch.where(keep, rays[8], 0.0)
    return dataclasses.replace(inp, rays=rays)


def _scalar_march(scene, inp, g):
    """One ray of the rest march (K1) in scalar arithmetic: (needed
    lane-evals, prims whose support box holds an evaluation point, prims
    the kernel's cull lets run for a patch that holds this ray alone:
    those its tile's flags allow and, where the scene culls per eval,
    whose box meets the point with the hull slack)."""
    f32 = np.float32
    r = inp.rays[:, g].numpy()
    ro, rd, t_enter, t_exit = r[:3], r[3:6], r[6], r[7]
    inv_stretch = inp.tile_rows[g // inp.tile, 0].numpy()
    boxes = inp.prim_boxes.numpy()
    allowed = np.repeat(inp.live[g // inp.tile].numpy() > 0, tt.PRIM_BLOCK)
    eps = f32(tt.HULL_EPS)
    evals = reach = run = 0

    def f_at(t):
        nonlocal evals, reach, run
        p = (ro + f32(t) * rd).astype(f32)
        evals += 1
        reach += int(np.sum(np.all((p >= boxes[:, :3]) & (p <= boxes[:, 3:]),
                                   axis=1)))
        met = np.all((p <= boxes[:, 3:] + eps) & (p >= boxes[:, :3] - eps),
                     axis=1) if inp.dyn_cull else True
        run += int(np.sum(allowed & met))
        return f32(field(scene, torch.tensor(p)[None])[0]) - f32(inp.iso)

    if not r[8] > 0:
        return 0, 0, 0
    t = t_prev = t_enter
    f = f_prev = f_at(t)
    found, alive, it = f >= 0, f < 0, 0
    while it < inp.max_steps and alive:
        for _ in range(2):
            if alive:
                rad = f32(0.4542)
                for lim, val in _RADIUS:
                    if f + f32(inp.iso) <= f32(lim):
                        rad = f32(val)
                        break
                d = (rad - f32(inp.r_iso)) * inv_stretch
                dt = max(f32(inp.base_step), f32(0.95) * d)
                t_new = min(f32(t + dt), t_exit)
                f_new = f_at(t_new)
                t_prev, f_prev, t, f = t, f, t_new, f_new
                found = found or f_new >= 0
                alive = f_new < 0 and not t_new >= t_exit
            it += 1
    if found:
        a, b = t_prev, t
        for _ in range(inp.bisect_steps):
            m = f32(0.5) * (a + b)
            if f_at(m) < 0:
                a = m
            else:
                b = m
    return evals, reach, run


@pytest.mark.parametrize("name", ["sphere", "brain"])
def test_count_equals_scalar_march(name):
    scene, pose = _scene(name)
    inp = tt.prepare_tiles(scene, *_rays(pose))
    alive = torch.nonzero(inp.rays[8] > 0).squeeze(-1)
    assert alive.numel() >= 16
    chosen = alive[np.random.default_rng(5).permutation(alive.numel())[:16]]
    count = tt.WorkCount()
    _, hit = tt.trace_tiles_plain(_only(inp, chosen), count)
    want = [_scalar_march(scene, inp, int(g)) for g in chosen]
    assert 0 < int(hit.sum()) <= 16
    assert count.lane_evals == sum(e for e, _, _ in want) > 16
    assert count.prims_in_reach == sum(r for _, r, _ in want) > 0
    assert count.flops == sum(
        c * tt.PRIM_FLOPS[t] for t, c in count.prim_evals.items())


@pytest.mark.parametrize("tile", [32, 256])
@pytest.mark.parametrize("name", ["sphere", "brain"])
def test_run_counts_equal_scalar_march(name, tile):
    """With one live ray in a patch its hull is the ray's point: the
    kernel's warp runs all 32 lanes for every eval that ray needs, and
    every prim that the tile's flags and the point's box test let by."""
    scene, pose = _scene(name)
    inp = tt.prepare_tiles(scene, *_rays(pose), tile=tile)
    alive = (inp.rays[8] > 0)[tt.patch_rays(inp.rays.shape[1], tile)]
    first = torch.argmax(alive.to(torch.int8), 1)
    chosen = tt.patch_rays(inp.rays.shape[1], tile)[
        torch.arange(alive.shape[0]), first][alive.any(-1)][:12]
    assert chosen.numel() >= 3
    assert inp.dyn_cull == (name == "brain")
    count = tt.WorkCount()
    tt.trace_tiles_plain(_only(inp, chosen), count)
    want = [_scalar_march(scene, inp, int(g)) for g in chosen]
    assert count.lane_evals == sum(e for e, _, _ in want)
    assert count.lanes_run == 32 * count.lane_evals > 0
    assert count.prims_run == 32 * sum(r for _, _, r in want)
    assert count.prims_run >= 32 * count.prims_in_reach > 0
    assert count.pull_lanes_run == count.centers_run == 0


@pytest.mark.parametrize("name", ["sphere", "brain"])
def test_count_is_the_same_at_tile_32_and_256(name):
    """A ray's march depends on its tile only through the tile's stretch
    bound (the largest over the blocks the tile may meet), so with one
    stretch bound on every tile the counts of what is needed are the tile
    size's own. What the kernel lets run for it is counted per patch of 32
    rays, and a patch is another set of rays at another tile size."""
    scene, pose = _scene(name)
    ro, rd = _rays(pose)
    counts = []
    for tile in (32, 256):
        inp = tt.prepare_tiles(scene, ro, rd, tile=tile)
        rows = inp.tile_rows.clone()
        rows[:, 0] = 1.0 / scene.max_world_to_local_scale
        count = tt.WorkCount()
        tt.trace_tiles_plain(dataclasses.replace(inp, tile_rows=rows), count)
        assert count.lanes_run >= count.lane_evals
        assert count.prims_run >= count.prims_in_reach
        counts.append({k: v for k, v in dataclasses.asdict(count).items()
                       if not k.endswith("_run")})
    assert counts[0] == counts[1] and counts[0]["lane_evals"] > 0


def _sag(scene, kernel, n_centers=32, n_nodes=300):
    """A sag u = -0.15 s^2 (s the normalised height) through centers among
    seeded points of the scene's box: (interp, weights, points)."""
    lo, hi = scene.bbox_lo.numpy(), scene.bbox_hi.numpy()
    nodes = lo + np.random.default_rng(3).random((n_nodes, 3)) * (hi - lo)
    interp = build_disp_interp(nodes, n_centers=n_centers, kernel=kernel,
                               sigma_fill=2.5, device="cpu")
    y = interp.centers[:, 1]
    u_c = torch.zeros_like(interp.centers)
    u_c[:, 1] = -0.15 * ((y - y.min()) / (y.max() - y.min())) ** 2
    return (interp, disp_weights_centers(interp, u_c),
            torch.as_tensor(nodes, dtype=torch.float32))


@pytest.mark.parametrize("mode", ["rest", "wendland", "biharmonic",
                                  "resection", "twist"])
def test_counting_changes_no_result(mode):
    if mode in ("resection", "twist"):
        make, pose = ((brain_resection, (30.0, 20.0, 6.0))
                      if mode == "resection"
                      else (blend_twist, (25.0, 20.0, 2.5)))
        scene = make(pscene).pack(device="cpu")
        inp = tt.prepare_general(scene, *_rays(pose, 24, 16))
        plain = tt.trace_tiles_general_plain
    else:
        scene, pose = _scene("brain")
        disp = None
        if mode == "wendland":
            interp, w, _ = _sag(scene, "wendland")
            disp = wendland_spec(interp, w, k_refresh=4)
        elif mode == "biharmonic":
            interp, w, pts = _sag(scene, "biharmonic")
            disp = biharmonic_spec(interp, w,
                                   *disp_bounds_sampled(interp, w, pts))
        inp = tt.prepare_tiles(scene, *_rays(pose, 24, 16), disp=disp)
        plain = tt._march_plain
    count = tt.WorkCount()
    t_c, h_c = plain(inp, count)
    t_p, h_p = plain(inp)
    assert torch.equal(t_c, t_p) and torch.equal(h_c, h_p)
    assert int(h_p.sum()) > 0
    assert count.prims_in_reach > count.lane_evals > int(h_p.sum())
    if mode == "biharmonic":
        m = inp.biharmonic.centers.shape[0]
        assert count.pull_iters == 2 * count.lane_evals
        assert count.biharmonic_center_evals == m * count.pull_iters
    elif mode == "wendland":
        assert 0 < count.pull_iters < count.lane_evals
        assert 0 < count.wendland_center_evals < 32 * count.pull_iters
        # What K2's culls let run covers what is needed, in whole warps.
        assert count.pull_lanes_run >= count.pull_iters
        assert count.centers_run >= count.wendland_center_evals
        assert count.pull_lanes_run % 32 == count.centers_run % 32 == 0
        assert count.centers_run <= (inp.wendland.centers.shape[0]
                                     * count.pull_lanes_run)
    else:
        assert count.pull_iters == 0
    assert count.flops >= 30 * count.prims_in_reach
    assert count.lanes_run >= count.lane_evals and count.lanes_run % 32 == 0
    assert count.prims_run >= count.prims_in_reach


def test_prims_count_as_their_own_type():
    """Brain routes the points of its one mixed block through the
    cylinder branch; seen from behind, where the march reaches them, the
    counter charges them as the points they are."""
    scene, _ = _scene("brain")
    inp = tt.prepare_tiles(scene, *_rays((210.0, -20.0, 6.0)))
    row_types = inp.prims[:, 22].to(torch.int64)
    routed = row_types != inp.prim_types
    assert bool(routed.any())
    assert bool((inp.prim_types[routed] == int(PrimType.POINT)).all())
    assert torch.equal(inp.prim_types, scene.prim_type.to(torch.int64))
    own, by_row = tt.WorkCount(), tt.WorkCount()
    tt.trace_tiles_plain(inp, own)
    tt.trace_tiles_plain(dataclasses.replace(inp, prim_types=row_types),
                         by_row)
    assert own.prims_in_reach == by_row.prims_in_reach
    moved = (own.prim_evals[int(PrimType.POINT)]
             - by_row.prim_evals[int(PrimType.POINT)])
    assert moved > 0
    assert by_row.flops - own.flops == moved * (
        tt.PRIM_FLOPS[int(PrimType.CYLINDER)]
        - tt.PRIM_FLOPS[int(PrimType.POINT)])


@pytest.mark.parametrize("name", ["sphere", "brain"])
def test_ray_bytes_count_what_the_rays_need(name):
    """16 bytes for every ray, 28 more for one that starts alive."""
    scene, pose = _scene(name)
    inp = tt.prepare_tiles(scene, *_rays(pose))
    n = inp.rays.shape[1]
    alive = int((inp.rays[8] > 0).sum())
    assert 0 < alive < n
    assert tt.ray_bytes(inp.rays) == 16 * n + 28 * alive
    none = _only(inp, [])
    assert tt.ray_bytes(none.rays) == 16 * n
