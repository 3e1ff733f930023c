"""PyTorch port: the rest tile trace (K1's plain version) against the
JAX Pallas kernel in interpret mode and against the port's own lock-step
tracer, on identical rays; plus the tile layout helpers."""
import dataclasses
import gc
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import fembrain_tpu.blob.scene as jscene
from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.render.camera import Camera as JaxCamera
from fembrain_tpu.render.camera import generate_rays as jax_rays
from fembrain_tpu.render.pallas_trace import trace_pallas, trace_pallas_image

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch import convert
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.blob.types import PrimType
from fembrain_tpu_torch.render import tile_trace as tt
from fembrain_tpu_torch.render.camera import Camera, generate_rays
from fembrain_tpu_torch.render.deformed import (
    biharmonic_spec, disp_bounds_sampled, wendland_spec,
)
from fembrain_tpu_torch.render.sphere_trace import trace

from test_torch_fixtures import (
    assert_same_inputs, every_type, small_blend, uncached_layouts,
    unnormalised,
)
from test_torch_work import _sag

BRAIN = Path(__file__).resolve().parent.parent / "data/models/blobtree/brain.blob"
TILE = 256


def _agree(h_ref, t_ref, hit, t, agree=0.999, max_dt=1e-4):
    assert (h_ref == hit).mean() > agree, (h_ref != hit).sum()
    both = h_ref & hit
    assert both.sum() > 10
    assert np.abs(t_ref[both] - t[both]).max() < max_dt


def _scene(name):
    if name == "brain":
        sc = jax_load_blob(BRAIN)
        sc.flatten_instances()
        return sc.pack(), (30.0, 20.0, 8.0), (32, 20)
    make = small_blend if name == "small" else every_type
    return make(jscene).pack(), (25.0, 20.0, 2.5), (40, 26)


@pytest.mark.parametrize("name", ["brain", "small", "every_type"])
def test_rest_trace_matches_pallas_and_port_tracer(name):
    js, pose, (w, h) = _scene(name)
    assert js.is_additive
    ro, rd = jax_rays(JaxCamera.orbit(*pose), w, h)
    ro, rd = np.asarray(ro).reshape(-1, 3), np.asarray(rd).reshape(-1, 3)
    t_j, h_j = trace_pallas(js, ro, rd, interpret=True, tile=TILE)
    t_j, h_j = np.asarray(t_j), np.asarray(h_j)

    ps = convert.scene(convert.numpy_fields(js), device="cpu")
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    t_p, h_p = tt.trace_tiles(ps, ro_t, rd_t, tile=TILE)
    t_p, h_p = t_p.numpy(), h_p.numpy()
    _agree(h_j, t_j, h_p, t_p)

    t_x, h_x = trace(ps, ro_t, rd_t)
    _agree(h_x.numpy(), t_x.numpy(), h_p, t_p)


def test_image_trace_matches_pallas_image():
    """Block-coherent image path: pixel blocks of 16x16 at tile 256, with
    a ragged edge (30 x 20 is not a block multiple)."""
    js, pose, _ = _scene("small")
    w, h = 30, 20
    ro, rd = jax_rays(JaxCamera.orbit(*pose), w, h)
    ro, rd = np.asarray(ro).reshape(-1, 3), np.asarray(rd).reshape(-1, 3)
    t_j, h_j = trace_pallas_image(js, ro, rd, h, w, interpret=True, tile=TILE)
    ps = convert.scene(convert.numpy_fields(js), device="cpu")
    t_p, h_p = tt.trace_tiles_image(ps, torch.tensor(ro), torch.tensor(rd),
                                    h, w, tile=TILE)
    _agree(np.asarray(h_j), np.asarray(t_j), h_p.numpy(), t_p.numpy())


def test_block_layout_round_trip():
    to_blocks, from_blocks, (ph, pw), n = tt._block_layout(20, 30, TILE)
    assert (ph, pw) == (12, 2) and n == 2 * 2 * TILE
    a = torch.arange(20 * 30, dtype=torch.float32)
    blocks = to_blocks(a[:, None].expand(-1, 3), -1.0)[:, 0]
    assert blocks.shape == (n,)
    assert torch.equal(blocks[:16], torch.arange(16, dtype=torch.float32))
    assert torch.equal(from_blocks(blocks), a)


def test_wrapper_takes_plain_version_on_cpu_only():
    js, pose, (w, h) = _scene("small")
    ps = convert.scene(convert.numpy_fields(js), device="cpu")
    ro, rd = jax_rays(JaxCamera.orbit(*pose), w, h)
    inp = tt.prepare_tiles(ps, torch.tensor(np.asarray(ro).reshape(-1, 3)),
                           torch.tensor(np.asarray(rd).reshape(-1, 3)),
                           tile=TILE)
    assert inp.rays.shape == (9, 5 * TILE) and not inp.dyn_cull
    before = dict(tt.LAUNCHES)
    t, hit = tt.run_tiles(inp)
    t_plain, hit_plain = tt.trace_tiles_plain(inp)
    assert torch.equal(t, t_plain) and torch.equal(hit, hit_plain)
    assert tt.LAUNCHES == before  # no kernel launch on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        tt.trace_additive_cuda(inp)


def test_brain_layout_cull_flags():
    """Brain: 21 real blocks, so the per-eval cull is on and the static
    flags skip blocks a tile's rays can never reach."""
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    ps = convert.scene(convert.numpy_fields(sc.pack()), device="cpu")
    ro, rd = jax_rays(JaxCamera.orbit(30.0, 20.0, 8.0), 64, 40)
    inp = tt.prepare_tiles(ps, torch.tensor(np.asarray(ro).reshape(-1, 3)),
                           torch.tensor(np.asarray(rd).reshape(-1, 3)),
                           tile=TILE)
    assert inp.dyn_cull and inp.live.shape == (10, 21)
    assert 0 < int(inp.live.sum()) < inp.live.numel()
    # The one block mixing points with the cylinder routes its points
    # through the cylinder branch.
    mixed = [t for t in inp.block_types if len(t) > 0 and 0 not in t]
    assert mixed == [(2,)]


def _port_rays(pose, w=30, h=20):
    ro, rd = generate_rays(Camera.orbit(*pose, device="cpu"), w, h)
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def test_layout_is_built_once_per_scene_object():
    """Five frames on one Scene lay it out once. A Scene with one prim
    moved is a new object: it gets its own layout, whose trace equals the
    one from a layout built outside the cache and differs from the first
    scene's; its layout goes with it."""
    ps = small_blend(pscene).pack(device="cpu")
    ro, rd = _port_rays((25.0, 20.0, 2.5))
    with mock.patch.object(tt, "_additive_layout",
                           wraps=tt._additive_layout) as build:
        frames = [tt.trace_tiles_image(ps, ro, rd, 20, 30) for _ in range(5)]
        assert build.call_count == 1
        pos = ps.prim_pos.clone()
        pos[0, 1] += 0.2
        moved = dataclasses.replace(ps, prim_pos=pos)
        t, hit = tt.trace_tiles_image(moved, ro, rd, 20, 30)
        assert build.call_count == 2
    for t_f, hit_f in frames[1:]:
        assert torch.equal(t_f, frames[0][0]) and torch.equal(hit_f,
                                                              frames[0][1])
    with uncached_layouts():
        t_u, hit_u = tt.trace_tiles_image(moved, ro, rd, 20, 30)
    assert torch.equal(t, t_u) and torch.equal(hit, hit_u)
    assert not torch.equal(t, frames[0][0])
    # The cache holds no Scene: an entry leaves with its Scene.
    gone = id(moved)
    build.reset_mock()  # its call record holds the Scene
    del moved
    gc.collect()
    assert all(key[0] != gone for key in tt._LAYOUTS)


def _sphere():
    sc = pscene.SceneDef()
    sc.add_prim(pscene.PrimDef(PrimType.POINT, pos=np.zeros(3)))
    return sc.pack(device="cpu")


def _brain():
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    return sc.pack(device="cpu")


# Scenes the pack left unnormalised reach the additive path with no
# `additive_block_types`: one prim (the pack keeps its identity order),
# and packed scenes given back in another row order.
ADDITIVE = {
    "every_type": (lambda: every_type(pscene).pack(device="cpu"),
                   (25.0, 20.0, 2.5)),
    "sphere": (_sphere, (30.0, 20.0, 4.0)),
    "every_type_unnormalised": (
        lambda: unnormalised(every_type(pscene).pack(device="cpu"), 8),
        (25.0, 20.0, 2.5)),
    "brain_unnormalised": (lambda: unnormalised(_brain(), 7),
                           (30.0, 20.0, 6.0)),
}


@pytest.mark.parametrize("name,mode", [
    ("every_type", "rest"), ("every_type", "wendland"),
    ("every_type", "biharmonic"), ("sphere", "rest"),
    ("every_type_unnormalised", "rest"), ("brain_unnormalised", "rest"),
])
def test_prepare_tiles_from_cache_equals_uncached_layout(name, mode):
    """prepare_tiles, cold and warm, builds every field as it does from a
    layout made outside the cache; an unnormalised scene is laid out in
    the pack's Morton order."""
    make, pose = ADDITIVE[name]
    scene = make()
    assert tt.is_additive_path(scene)
    assert bool(scene.additive_block_types) == (name == "every_type")
    disp = None
    if mode == "wendland":
        interp, w, _ = _sag(scene, "wendland")
        disp = wendland_spec(interp, w, k_refresh=4)
    elif mode == "biharmonic":
        interp, w, pts = _sag(scene, "biharmonic")
        disp = biharmonic_spec(interp, w, *disp_bounds_sampled(interp, w,
                                                               pts))
    ro, rd = _port_rays(pose)
    cold = tt.prepare_tiles(scene, ro, rd, disp=disp)
    warm = tt.prepare_tiles(scene, ro, rd, disp=disp)
    with uncached_layouts():
        ref = tt.prepare_tiles(scene, ro, rd, disp=disp)
    assert_same_inputs(cold, ref)
    assert_same_inputs(warm, ref)
    if name.endswith("_unnormalised"):
        order = torch.as_tensor(pscene.morton_order(scene))
        assert torch.equal(ref.prim_boxes[:, :3], scene.prim_bb_lo[order])
