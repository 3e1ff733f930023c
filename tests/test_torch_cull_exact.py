"""PyTorch port: the culls of the tile-trace kernels are exact. A prim's
field is exactly 0 outside its support box, so the field summed over only
the prims whose box holds the point equals the full sum bit for bit, and
the general tile trace gives the same bits with and without its per-tile
live flags."""
import numpy as np
import pytest
import torch

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.ops.field import field_rows, prim_fields
from fembrain_tpu_torch.render import tile_trace as tt
from fembrain_tpu_torch.render.camera import Camera, generate_rays

from test_torch_fixtures import BRAIN, blend_twist, brain_resection


def _brain():
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    return sc


def _points(scene, n=4096):
    lo = scene.bbox_lo.numpy() - 0.2
    hi = scene.bbox_hi.numpy() + 0.2
    p = lo + np.random.default_rng(11).random((n, 3)) * (hi - lo)
    return torch.as_tensor(p, dtype=torch.float32)


def _inside(scene, pts):
    """[N, P] whether prim p's support box holds point n."""
    return torch.all((pts[:, None] >= scene.prim_bb_lo[None])
                     & (pts[:, None] <= scene.prim_bb_hi[None]), -1)


@pytest.mark.parametrize("make", [lambda mod: _brain(), brain_resection])
def test_field_over_prims_in_reach_equals_the_full_field(make):
    scene = make(pscene).pack(device="cpu")
    pts = _points(scene)
    inside = _inside(scene, pts)
    pf = prim_fields(scene, pts)
    assert float(pf.max()) > 0.5 and 0.0 < float(inside.float().mean()) < 0.5
    # Outside its box a prim contributes exactly 0 ...
    assert torch.equal(torch.where(inside, pf, 0.0), pf)
    # ... so the sum over the prims in reach is the full sum,
    culled = torch.where(inside, pf, 0.0)[:, : scene.n_prims].sum(-1)
    assert torch.equal(culled, pf[:, : scene.n_prims].sum(-1))
    # and the folded field (a BLEND, then the resection's DIF) is too.
    x, y, z = pts.unbind(-1)
    assert torch.equal(field_rows(scene, x, y, z, inside),
                       field_rows(scene, x, y, z))


@pytest.mark.parametrize("make,pose,flags", [
    (brain_resection, (30.0, 20.0, 6.0), {tt.LIVE_DEAD, tt.LIVE_BOXED}),
    (blend_twist, (25.0, 20.0, 2.5), {tt.LIVE_DEAD, tt.LIVE_ALWAYS}),
])
def test_general_trace_is_the_same_with_and_without_live_flags(make, pose,
                                                               flags):
    """The resection's prims sit under no warp and are culled per tile;
    the twisted blend's sit under one and stay always live (padding rows
    are dead in both)."""
    scene = make(pscene).pack(device="cpu")
    ro, rd = generate_rays(Camera.orbit(*pose, device="cpu"), 48, 27)
    ro_b, rd_b, _ = tt.image_rays_to_blocks(
        ro.reshape(-1, 3), rd.reshape(-1, 3), 27, 48, 64)
    inp = tt.prepare_general(scene, ro_b, rd_b, tile=64)
    assert set(inp.live.unique().tolist()) == flags
    real = inp.live[:, : scene.n_prims]
    if tt.LIVE_BOXED in flags:
        # Some live tile skips most prims.
        frac = (real > 0).float().mean(-1)
        assert 0.0 < float(frac[frac > 0].min()) < 0.5
    t_l, h_l = tt.trace_tiles_general_plain(inp)
    t_a, h_a = tt.trace_tiles_general_plain(inp, use_live=False)
    assert int(h_a.sum()) > 50
    assert torch.equal(t_l, t_a) and torch.equal(h_l, h_a)
