"""PyTorch port: what the additive tile-trace kernel reads beside the
rays, built and checked on the CPU. The work list holds exactly the
patches with a ray that starts alive, in order, and every ray off the list
is a miss in the plain version; the table block unpacks bit for bit to the
tensors the plain version uses; the finer culls (a prim by its own box, a
Wendland center by its own reach sigma) change no bit of the sums; and a
center farther than sigma from a patch hull reaches no point of it."""
import dataclasses

import numpy as np
import pytest
import torch

from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.ops.field import prim_fields
from fembrain_tpu_torch.render import tile_trace as tt
from fembrain_tpu_torch.render.camera import Camera, generate_rays
from fembrain_tpu_torch.render.deformed import (
    biharmonic_spec, disp_bounds_sampled, wendland_spec,
)

from test_torch_fixtures import BRAIN
from test_torch_work import _sag


@pytest.fixture(scope="module")
def brain():
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    return sc.pack(device="cpu")


def _block_rays(w, h, tile, pose=(30.0, 20.0, 6.0)):
    ro, rd = generate_rays(Camera.orbit(*pose, device="cpu"), w, h)
    ro_b, rd_b, _ = tt.image_rays_to_blocks(ro.reshape(-1, 3),
                                            rd.reshape(-1, 3), h, w, tile)
    return ro_b, rd_b


def _disp(scene, mode, **kw):
    if mode == "wendland":
        interp, w, _ = _sag(scene, "wendland", **{"n_centers": 64, **kw})
        return wendland_spec(interp, w, k_refresh=4)
    if mode == "biharmonic":
        interp, w, pts = _sag(scene, "biharmonic", n_centers=64)
        return biharmonic_spec(interp, w, *disp_bounds_sampled(interp, w, pts))
    return None


def test_patch_slots_cut_a_tile_into_8x4_pixel_patches():
    """Tile 256: patch w is the 8x4 patch at column 8 (w & 1), row
    4 (w >> 1) of the 16x16 block; other tiles: runs of 32."""
    slots = tt.patch_slots(256)
    assert slots.shape == (8, 32)
    assert sorted(slots.reshape(-1).tolist()) == list(range(256))
    for w in range(8):
        rows, cols = slots[w] // 16, slots[w] % 16
        assert rows.min() == 4 * (w >> 1) and rows.max() == 4 * (w >> 1) + 3
        assert cols.min() == 8 * (w & 1) and cols.max() == 8 * (w & 1) + 7
    assert torch.equal(tt.patch_slots(64), torch.arange(64).reshape(2, 32))
    lanes = tt.patch_rays(512, 256)
    assert torch.equal(lanes[8:], lanes[:8] + 256)


@pytest.mark.parametrize("tile", [32, 64, 256])
def test_work_list_is_the_live_patches_in_order(brain, tile):
    inp = tt.prepare_tiles(brain, *_block_rays(96, 64, tile), tile=tile)
    n = inp.rays.shape[1]
    alive = (inp.rays[8] > 0)[tt.patch_rays(n, tile)].any(-1)
    want = torch.nonzero(alive).squeeze(-1).to(torch.int32)
    assert 0 < want.numel() < alive.numel()
    assert inp.work.dtype == torch.int32 and inp.work.shape == (n // 32,)
    assert inp.n_work.tolist() == [want.numel()]
    assert torch.equal(inp.work[: want.numel()], want)
    assert bool((inp.work[want.numel():] == -1).all())
    # Every ray of a patch off the list is a miss in the plain version:
    # t = t_exit and no hit, which is what the kernel writes for a ray
    # that starts dead.
    t, hit = tt.trace_tiles_plain(inp)
    off = tt.patch_rays(n, tile)[~alive].reshape(-1)
    assert torch.equal(t[off], inp.rays[7][off])
    assert not bool(hit[off].any()) and int(hit.sum()) > 0


def test_replacing_the_rays_rebuilds_the_work_list(brain):
    """The work list and the table block are derived fields: they follow
    `dataclasses.replace` and cannot be given or go stale."""
    inp = tt.prepare_tiles(brain, *_block_rays(96, 64, 256))
    dead = inp.rays.clone()
    dead[8] = 0.0
    none = dataclasses.replace(inp, rays=dead)
    assert none.n_work.tolist() == [0] and bool((none.work == -1).all())
    assert torch.equal(none.tables, inp.tables) and none.live is inp.live
    with pytest.raises(ValueError):
        dataclasses.replace(inp, work=inp.work)
    with pytest.raises(TypeError):
        tt.TileInputs(**{f.name: getattr(inp, f.name)
                         for f in dataclasses.fields(inp)})
    t, hit = tt.trace_tiles_plain(none)
    assert torch.equal(t, inp.rays[7]) and not bool(hit.any())
    everyone = inp.rays.clone()
    everyone[8] = 1.0
    full = dataclasses.replace(inp, rays=everyone)
    assert full.n_work.tolist() == [everyone.shape[1] // 32]
    assert torch.equal(full.work,
                       torch.arange(everyone.shape[1] // 32,
                                    dtype=torch.int32))


def test_replacing_the_prims_rebuilds_the_table_block(brain):
    """What the kernel copies is what the plain version reads, whatever
    was replaced."""
    inp = tt.prepare_tiles(brain, *_block_rays(48, 32, 256))
    moved = dataclasses.replace(inp, prims=inp.prims + 1.0)
    got = tt.unpack_tables(moved.tables, moved.prims.shape[0])
    assert torch.equal(got["prims"], moved.prims)
    assert not torch.equal(moved.tables, inp.tables)
    assert torch.equal(moved.work, inp.work)


@pytest.mark.parametrize("mode", ["rest", "wendland", "biharmonic"])
def test_tables_unpack_bit_exactly(brain, mode):
    inp = tt.prepare_tiles(brain, *_block_rays(48, 32, 256),
                           disp=_disp(brain, mode))
    d = inp.wendland or inp.biharmonic
    m = 0 if d is None else d.centers.shape[0]
    lay = tt.table_layout(inp.prims.shape[0], m)
    assert all(v % 4 == 0 for v in lay.values())  # 16-byte boundaries
    assert inp.tables.shape == (lay["total"],)
    assert inp.tables.dtype == torch.float32 and inp.tables.is_contiguous()
    got = tt.unpack_tables(inp.tables, inp.prims.shape[0], m)
    assert torch.equal(got["prims"], inp.prims)
    assert torch.equal(got["prim_boxes"], inp.prim_boxes)
    assert set(got) == {"prims", "prim_boxes"} | (
        set() if mode == "rest" else {"centers", "w", "waff"})
    if d is not None:
        assert torch.equal(got["centers"], d.centers)
        assert torch.equal(got["w"], d.w)
        assert torch.equal(got["waff"], d.waff)


def _points(scene, n=4096, seed=11):
    lo = scene.bbox_lo.numpy() - 0.2
    hi = scene.bbox_hi.numpy() + 0.2
    p = lo + np.random.default_rng(seed).random((n, 3)) * (hi - lo)
    return torch.as_tensor(p, dtype=torch.float32)


def _holds(boxes, pts):
    """[N, G] whether box g [G, 6] holds point n."""
    return torch.all((pts[:, None] >= boxes[None, :, :3])
                     & (pts[:, None] <= boxes[None, :, 3:]), -1)


def test_block_sums_over_prims_in_reach_equal_the_full_block_sums(brain):
    """The kernel's order: a partial sum per Morton block of 8, blocks in
    order, over the prims whose own box holds the point. A prim outside
    its box adds exactly 0, so every partial sum and the field keep their
    bits."""
    inp = tt.prepare_tiles(brain, *_block_rays(48, 32, 256))
    pts = _points(brain)
    pf = prim_fields(brain, pts)
    inside = _holds(inp.prim_boxes, pts)
    assert 0.0 < float(inside.float().mean()) < 0.5
    full = pf.reshape(len(pts), -1, tt.PRIM_BLOCK)
    culled = torch.where(inside, pf, 0.0).reshape(full.shape)
    assert torch.equal(culled, full)
    f_full = torch.zeros(len(pts))
    f_culled = torch.zeros(len(pts))
    for b in range(full.shape[1]):
        f_full = f_full + full[:, b].sum(-1)
        f_culled = f_culled + culled[:, b].sum(-1)
    assert torch.equal(f_culled, f_full) and float(f_full.max()) > 0.5


def test_displacement_over_centers_in_reach_equals_the_full_sum(brain):
    """A Wendland center farther than sigma adds exactly 0: the
    displacement summed over the centers within the kernel's reach
    (sigma plus the hull slack) of the estimate equals the full sum bit
    for bit, per block of CEN_BLOCK as the kernel sums it. 256 centers, as
    the coupled frame has."""
    spec = _disp(brain, "wendland", n_centers=256, n_nodes=3000)
    inp = tt.prepare_tiles(brain, *_block_rays(48, 32, 256), disp=spec)
    w = inp.wendland
    pts = _points(brain, seed=12)
    d = torch.linalg.norm(pts[:, None] - w.centers[None], dim=-1)
    tt_ = torch.clamp(d * w.inv_sigma, max=1.0)
    ph = (1.0 - tt_) ** 4 * (4.0 * tt_ + 1.0)
    contrib = ph[..., None] * w.w[None]                     # [N, Mp, 3]
    inside = d <= w.sigma + tt.HULL_EPS
    assert 0.0 < float(inside.float().mean()) < 0.3
    assert float(contrib.abs().max()) > 0.0
    culled = torch.where(inside[..., None], contrib, 0.0)
    assert torch.equal(culled, contrib)
    blocks = (len(pts), -1, tt.CEN_BLOCK, 3)
    assert torch.equal(culled.reshape(blocks).sum(2),
                       contrib.reshape(blocks).sum(2))


def test_center_out_of_reach_of_a_hull_reaches_no_point_of_it(brain):
    """K2 tests one center per lane against the hull of a patch's
    estimates (`_balls_run`, as the kernel does): where the center is
    farther than its reach from the hull box, it is from every point in
    the box, so the patch may skip it; and the cull does skip most."""
    spec = _disp(brain, "wendland", n_centers=256, n_nodes=3000)
    inp = tt.prepare_tiles(brain, *_block_rays(48, 32, 256), disp=spec)
    w = inp.wendland
    rng = np.random.default_rng(13)
    lo_s, hi_s = brain.bbox_lo.numpy(), brain.bbox_hi.numpy()
    # 64 patches of 32 estimates, each patch within a 0.1 cube.
    base = lo_s + rng.random((64, 1, 3)) * (hi_s - lo_s)
    pts = torch.as_tensor(base + 0.1 * rng.random((64, 32, 3)),
                          dtype=torch.float32)
    need = torch.as_tensor(rng.random((64, 32)) < 0.7)
    need[:, 0] = True
    lanes = torch.arange(64 * 32).reshape(64, 32)
    flat = pts.reshape(-1, 3)
    hull = tt._patch_hull(flat[:, 0], flat[:, 1], flat[:, 2],
                          need.reshape(-1), lanes)
    reach = w.sigma + tt.HULL_EPS
    m = w.centers.shape[0]
    everything = torch.ones(64, m, dtype=torch.bool)
    ran = tt._balls_run(everything, w.centers, reach, hull)
    d = torch.linalg.norm(pts[:, :, None] - w.centers[None, None], dim=-1)
    in_reach = ((d <= w.sigma) & need[..., None]).any(1)     # [64, M]
    assert int(in_reach.sum()) <= ran < 0.5 * 64 * m
    # One patch and center at a time: skipped means out of reach.
    for p in range(64):
        one = torch.zeros(64, m, dtype=torch.bool)
        one[p] = True
        kept = tt._balls_run(one, w.centers, reach, hull)
        assert kept >= int(in_reach[p].sum())
    lo, hi, run = hull
    gap = torch.clamp(torch.maximum(lo[:, None] - w.centers[None],
                                    w.centers[None] - hi[:, None]), min=0.0)
    skipped = torch.sum(gap * gap, -1) > reach * reach
    assert bool(run.all()) and not bool((skipped & in_reach).any())
    assert w.clive.shape == (inp.rays.shape[1] // inp.tile,
                             m // tt.CEN_BLOCK)
