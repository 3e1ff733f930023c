"""PyTorch port on a CUDA card: the hand-written tile-trace kernels against
their plain versions on the same inputs. The additive kernel (K1 rest, K2
Wendland, K4 biharmonic) on brain.blob (21 prim blocks, per-eval cull on)
and on a scene with one prim of every type (2 blocks, cull off); the
general kernel (K3) on the brain resection (a DIF, fixed steps) and on a
twisted blend (a warp chain, slab brackets). At 480x270 in pixel-block
order every kernel also runs with tiles whose rays all miss, K3 with its
per-tile live flags, and each kernel's counting build is held to the
plain version's count of needed lane-evals and of what the culls let run.
The additive kernel's resident CTAs and work list: an image of fewer
tiles than CTAs, every ray dead, every ray alive, tiles of 64 rays, and
the same launch twice.

Needs a card; skips without one. It imports only the port, so it runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.render import tile_trace as tt
from fembrain_tpu_torch.render.camera import Camera, generate_rays
from fembrain_tpu_torch.render.deformed import (
    biharmonic_spec, build_disp_interp, disp_bounds_sampled,
    disp_weights_centers, wendland_spec,
)

from test_torch_fixtures import BRAIN, blend_twist, brain_resection, every_type

# Thresholds against the plain version: hit agreement, max |dt| on common
# hits (and the median for K2, whose linear rest-point model drifts).
K1_AGREE, K1_MAX = 0.999, 1e-4
K2_AGREE, K2_MEDIAN, K2_MAX = 0.995, 5e-3, 5e-2
K3_AGREE, K3_MAX = 0.999, 1e-4
K4_AGREE, K4_MAX = 0.995, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scene(name, device):
    if name == "brain":
        sc = load_blob(BRAIN)
        sc.flatten_instances()
        return sc.pack(device=device), (30.0, 20.0, 6.0)
    return every_type(pscene).pack(device=device), (25.0, 20.0, 2.5)


def _rays(pose, device, w=160, h=90):
    ro, rd = generate_rays(Camera.orbit(*pose, device=device), w, h)
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def _sag_interp(scene, device, kernel):
    """A sag u = -0.15 s^2 (s the normalised height), interpolated
    through 64 centers among 400 seeded points of the scene's box:
    (interp, weights, points)."""
    lo, hi = scene.bbox_lo.cpu().numpy(), scene.bbox_hi.cpu().numpy()
    nodes = lo + np.random.default_rng(3).random((400, 3)) * (hi - lo)
    interp = build_disp_interp(nodes, n_centers=64, kernel=kernel,
                               sigma_fill=2.5, device=device)
    y = interp.centers[:, 1]
    s = (y - y.min()) / (y.max() - y.min())
    u_c = torch.zeros_like(interp.centers)
    u_c[:, 1] = -0.15 * s**2
    pts = torch.as_tensor(nodes, dtype=torch.float32, device=device)
    return interp, disp_weights_centers(interp, u_c), pts


def _compare(inp, kname, plain, agree, max_dt, median=None, count=None):
    before = dict(tt.LAUNCHES)
    t_k, h_k = tt.run_tiles(inp)
    t_p, h_p = plain(inp, count)
    torch.cuda.synchronize()
    assert tt.LAUNCHES[kname] == before[kname] + 1
    hk, hp = h_k > 0.5, h_p > 0.5
    assert int(hk.sum()) > 100 and bool(torch.isfinite(t_k).all())
    assert float((hk == hp).float().mean()) > agree
    diff = torch.abs(t_k - t_p)[hk & hp]
    assert float(diff.max()) < max_dt
    if median is not None:
        assert float(diff.median()) < median


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["brain", "every_type"])
@pytest.mark.parametrize("mode", ["rest", "wendland", "biharmonic"])
def test_kernel_matches_plain_version(cuda, name, mode):
    """The additive kernel in each mode."""
    scene, pose = _scene(name, cuda)
    ro, rd = _rays(pose, cuda)
    disp, median = None, None
    if mode == "wendland":
        interp, w, _ = _sag_interp(scene, cuda, "wendland")
        disp = wendland_spec(interp, w, k_refresh=4)
        plain, agree, max_dt, median = (tt.trace_tiles_wendland_plain,
                                        K2_AGREE, K2_MAX, K2_MEDIAN)
    elif mode == "biharmonic":
        interp, w, pts = _sag_interp(scene, cuda, "biharmonic")
        disp = biharmonic_spec(interp, w, *disp_bounds_sampled(interp, w, pts))
        plain, agree, max_dt = tt.trace_tiles_biharmonic_plain, K4_AGREE, K4_MAX
    else:
        plain, agree, max_dt = tt.trace_tiles_plain, K1_AGREE, K1_MAX
    inp = tt.prepare_tiles(scene, ro, rd, disp=disp)
    assert inp.dyn_cull == (name == "brain")
    if disp is None:
        reads = _device_reads(lambda: tt.prepare_tiles(scene, ro, rd))
        assert reads == [], reads
    _compare(inp, f"trace_additive_{mode}", plain, agree, max_dt, median)


def _device_reads(fn):
    """The names of the reads to the host of a CUDA tensor's value that
    `fn()` makes, counted by patching `torch.Tensor.item`, `__float__`,
    `__int__`, `__bool__` and `tolist` around the call. A warm rest-mode
    `prepare_tiles` makes none: its `dyn_cull` and `base_step` come from
    the scene's cached layout."""
    reads = []

    def counting(name):
        read = getattr(torch.Tensor, name)

        def wrapper(self, *args):
            if self.is_cuda:
                reads.append(name)
            return read(self, *args)
        return wrapper

    with contextlib.ExitStack() as stack:
        for name in ("item", "__float__", "__int__", "__bool__", "tolist"):
            stack.enter_context(
                mock.patch.object(torch.Tensor, name, counting(name)))
        fn()
    return reads


@pytest.mark.cuda
@pytest.mark.parametrize("make,pose", [
    (brain_resection, (30.0, 20.0, 8.0)),
    (blend_twist, (25.0, 20.0, 2.5)),
])
def test_general_kernel_matches_plain_version(cuda, make, pose):
    scene = make(pscene).pack(device=cuda)
    ro, rd = _rays(pose, cuda)
    inp = tt.prepare_general(scene, ro, rd)
    _compare(inp, "trace_general", _general_plain_unmasked, K3_AGREE,
             K3_MAX)


def _general_plain_unmasked(inp, count=None):
    """K3's plain version evaluating every prim: a wrong per-tile live
    list in `inp` then shows as a disagreement with the kernel."""
    return tt.trace_tiles_general_plain(inp, count, use_live=False)


def _block_rays(pose, device, w=480, h=270):
    ro, rd = _rays(pose, device, w, h)
    ro_b, rd_b, _ = tt.image_rays_to_blocks(ro, rd, h, w)
    return ro_b, rd_b


def _check_tiles_and_counts(inp, kernel, kname, plain, agree, max_dt):
    """Kernel against plain version, the tiles whose rays all miss, and
    the counting build against the plain version's needed lane-evals."""
    count = tt.WorkCount()
    _compare(inp, kname, plain, agree, max_dt, count=count)
    t_k, h_k = tt.run_tiles(inp)
    dead = ~(inp.rays[8] > 0).reshape(-1, inp.tile).any(-1)
    assert 0 < int(dead.sum()) < dead.numel()
    dead_rays = dead.repeat_interleave(inp.tile)
    assert torch.equal(t_k[dead_rays], inp.rays[7][dead_rays])
    assert not bool(h_k[dead_rays].any())
    lanes = torch.zeros(tt.N_COUNTERS, dtype=torch.int64,
                        device=inp.rays.device)
    t_c, h_c = kernel(inp, lanes)
    torch.cuda.synchronize()
    assert torch.equal(t_c, t_k) and torch.equal(h_c, h_k)
    needed, ran, prims, pulls, centers = lanes.tolist()
    assert abs(needed - count.lane_evals) <= 0.01 * count.lane_evals
    assert needed <= ran and ran % 32 == 0
    assert count.flops > 0
    # What the culls let run, against the plain version's count of it.
    for got, want in ((ran, count.lanes_run), (prims, count.prims_run),
                      (pulls, count.pull_lanes_run),
                      (centers, count.centers_run)):
        assert abs(got - want) <= 0.01 * want
    assert prims >= count.prims_in_reach
    assert centers >= count.wendland_center_evals


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["brain", "every_type"])
def test_biharmonic_kernel_at_480x270(cuda, name):
    """K4 with the hull narrowed to the needed lanes: brain (21 blocks,
    per-eval cull) and the every-type scene (2 blocks, cull off)."""
    scene, pose = _scene(name, cuda)
    interp, w, pts = _sag_interp(scene, cuda, "biharmonic")
    disp = biharmonic_spec(interp, w, *disp_bounds_sampled(interp, w, pts))
    inp = tt.prepare_tiles(scene, *_block_rays((pose[0], pose[1], 8.0), cuda),
                           disp=disp)
    assert inp.dyn_cull == (name == "brain")
    _check_tiles_and_counts(inp, tt.trace_additive_cuda,
                            "trace_additive_biharmonic",
                            tt.trace_tiles_biharmonic_plain, K4_AGREE, K4_MAX)


def _additive_inputs(cuda, mode, rays, tile=tt.TILE):
    """Brain inputs of the additive kernel in `mode` on `rays` (ro, rd):
    (inputs, plain version, thresholds)."""
    scene, _ = _scene("brain", cuda)
    if mode == "wendland":
        interp, w, _ = _sag_interp(scene, cuda, "wendland")
        disp = wendland_spec(interp, w, k_refresh=4)
        plain, thr = tt.trace_tiles_wendland_plain, (K2_AGREE, K2_MAX,
                                                     K2_MEDIAN)
    elif mode == "biharmonic":
        interp, w, pts = _sag_interp(scene, cuda, "biharmonic")
        disp = biharmonic_spec(interp, w, *disp_bounds_sampled(interp, w, pts))
        plain, thr = tt.trace_tiles_biharmonic_plain, (K4_AGREE, K4_MAX, None)
    else:
        disp, plain, thr = None, tt.trace_tiles_plain, (K1_AGREE, K1_MAX, None)

    def prepare(ro, rd):
        return tt.prepare_tiles(scene, ro, rd, tile=tile, disp=disp)

    return prepare(*rays), plain, thr, prepare


MODES = ["rest", "wendland", "biharmonic"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rest", "wendland"])
def test_additive_kernel_at_480x270(cuda, mode):
    """K1 and K2 on pixel blocks, with dead tiles and the counting
    build's five counters."""
    inp, plain, (agree, max_dt, _), _ = _additive_inputs(
        cuda, mode, _block_rays((30.0, 20.0, 8.0), cuda))
    _check_tiles_and_counts(inp, tt.trace_additive_cuda,
                            f"trace_additive_{mode}", plain, agree, max_dt)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_fewer_tiles_than_resident_ctas(cuda, mode):
    """A 32x32 image is four tiles: the launch is cut to four CTAs and
    most warps find the list empty."""
    inp, plain, (agree, max_dt, median), _ = _additive_inputs(
        cuda, mode, _block_rays((30.0, 20.0, 6.0), cuda, 32, 32))
    assert inp.rays.shape[1] == 4 * tt.TILE
    _compare(inp, f"trace_additive_{mode}", plain, agree, max_dt, median)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_every_ray_dead_and_every_ray_alive(cuda, mode):
    ro, rd = _rays((30.0, 20.0, 6.0), cuda)
    inp, plain, (agree, max_dt, median), prepare = _additive_inputs(
        cuda, mode, (ro, rd))
    dead = inp.rays.clone()
    dead[8] = 0.0
    none = dataclasses.replace(inp, rays=dead)
    assert int(none.n_work) == 0
    t, hit = tt.run_tiles(none)
    torch.cuda.synchronize()
    assert torch.equal(t, inp.rays[7]) and not bool(hit.any())
    # Only the rays that start alive, in whole tiles: every patch is on
    # the list.
    idx = torch.nonzero(inp.rays[8][: ro.shape[0]] > 0).squeeze(-1)
    idx = idx[: idx.numel() // tt.TILE * tt.TILE]
    assert idx.numel() >= 4 * tt.TILE
    full = prepare(ro[idx], rd[idx])
    assert bool((full.rays[8] > 0).all())
    assert int(full.n_work) == idx.numel() // tt.PATCH
    _compare(full, f"trace_additive_{mode}", plain, agree, max_dt, median)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_tile_smaller_than_256(cuda, mode):
    """Tiles of 64 rays: two patches of 32 rays in a row each."""
    inp, plain, (agree, max_dt, median), _ = _additive_inputs(
        cuda, mode, _rays((30.0, 20.0, 6.0), cuda), tile=64)
    assert inp.tile == 64 and inp.live.shape[0] == inp.rays.shape[1] // 64
    _compare(inp, f"trace_additive_{mode}", plain, agree, max_dt, median)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_two_launches_give_equal_outputs(cuda, mode):
    """Which warp takes which patch changes from launch to launch; the
    outputs do not (no sum is taken with atomics). Nor do they with K2's
    build for two CTAs an SM, which the other modes do not have."""
    inp, _, _, _ = _additive_inputs(
        cuda, mode, _block_rays((30.0, 20.0, 8.0), cuda))
    t1, h1 = tt.trace_additive_cuda(inp)
    t2, h2 = tt.trace_additive_cuda(inp)
    torch.cuda.synchronize()
    assert int(h1.sum()) > 100
    assert torch.equal(t1, t2) and torch.equal(h1, h2)
    if mode == "wendland":
        t3, h3 = tt.trace_additive_cuda(inp, two_ctas=True)
        torch.cuda.synchronize()
        assert torch.equal(t1, t3) and torch.equal(h1, h3)
    else:
        with pytest.raises(RuntimeError):
            tt.trace_additive_cuda(inp, two_ctas=True)


@pytest.mark.cuda
@pytest.mark.parametrize("make,pose,flag", [
    (brain_resection, (30.0, 20.0, 8.0), tt.LIVE_BOXED),
    (blend_twist, (25.0, 20.0, 6.0), tt.LIVE_ALWAYS),
])
def test_general_kernel_at_480x270(cuda, make, pose, flag):
    """K3 with its per-tile live flags: culled prims on the resection,
    always-live prims under the twist."""
    scene = make(pscene).pack(device=cuda)
    inp = tt.prepare_general(scene, *_block_rays(pose, cuda))
    assert flag in inp.live.unique().tolist()
    _check_tiles_and_counts(inp, tt.trace_general_cuda, "trace_general",
                            _general_plain_unmasked, K3_AGREE, K3_MAX)
