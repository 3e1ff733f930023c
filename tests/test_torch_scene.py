"""PyTorch port: scene packing, field evaluation and rays against the
JAX package on identical inputs (brain.blob and the scenes of
test_torch_fixtures)."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fembrain_tpu.blob.scene as jscene
from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.ops.field import field as jax_field
from fembrain_tpu.render.camera import Camera as JaxCamera
from fembrain_tpu.render.camera import generate_rays as jax_rays

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch import convert
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.blob.types import PrimType
from fembrain_tpu_torch.ops.field import field
from fembrain_tpu_torch.render.camera import Camera, generate_rays

from test_torch_fixtures import every_type, small_blend

BRAIN = Path(__file__).resolve().parent.parent / "data/models/blobtree/brain.blob"


def _brain(load):
    sc = load(BRAIN)
    sc.flatten_instances()
    return sc


FIXTURES = {
    "brain": (lambda: _brain(jax_load_blob), lambda: _brain(load_blob)),
    "small": (lambda: small_blend(jscene), lambda: small_blend(pscene)),
    "every_type": (lambda: every_type(jscene), lambda: every_type(pscene)),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pack_matches_jax(name):
    """Packed arrays equal (atol 0) and static metadata equal."""
    make_jax, make_port = FIXTURES[name]
    js, ps = make_jax().pack(), make_port().pack(device="cpu")
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(ps, f.name)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f.name)
            assert np.asarray(a).dtype == b.numpy().dtype, f.name
        else:
            assert a == b, f.name
    for prop in ("is_additive", "can_cull", "capacity_prims"):
        assert getattr(js, prop) == getattr(ps, prop), prop


def test_brain_static_metadata():
    ps = _brain(load_blob).pack(device="cpu")
    assert (ps.n_prims, ps.capacity_prims) == (163, 168)
    assert len(ps.additive_block_types) == 21
    assert ps.prim_types_present == (int(PrimType.POINT),
                                     int(PrimType.CYLINDER))
    assert ps.schedule == (0,)
    assert ps.is_additive and ps.monotone_field and ps.can_cull
    assert ps.max_world_to_local_scale == pytest.approx(3.3333333, rel=1e-6)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_field_matches_jax(name):
    """field at 4096 seeded points, atol 1e-5."""
    make_jax, _ = FIXTURES[name]
    js = make_jax().pack()
    ps = convert.scene(convert.numpy_fields(js), device="cpu")
    lo, hi = np.asarray(js.bbox_lo), np.asarray(js.bbox_hi)
    rng = np.random.default_rng(7)
    pts = (lo - 0.2 + rng.random((4096, 3)) * (hi - lo + 0.4)).astype(
        np.float32)
    ref = np.asarray(jax_field(js, jnp.asarray(pts)))
    got = field(ps, torch.tensor(pts)).numpy()
    assert ref.max() > 0.5  # the sample reaches inside the surface
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_convert_scene_round_trip():
    """convert.scene rebuilds the same packed scene the port packs."""
    js = _brain(jax_load_blob).pack()
    cs = convert.scene(convert.numpy_fields(js), device="cpu")
    ps = _brain(load_blob).pack(device="cpu")
    for f in dataclasses.fields(ps):
        a, b = getattr(cs, f.name), getattr(ps, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_rays_match_jax():
    ro_j, rd_j = jax_rays(JaxCamera.orbit(30.0, 20.0, 8.0), 48, 27)
    ro, rd = generate_rays(
        Camera.orbit(30.0, 20.0, 8.0, device="cpu"), 48, 27)
    np.testing.assert_allclose(ro.numpy(), np.asarray(ro_j), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(rd_j), atol=1e-6)
