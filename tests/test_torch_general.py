"""PyTorch port: the general BlobTree trace (K3's plain version), the
per-point field evaluator `field_rows` and `normal`, and the
differentiable traces `trace_fast` and `trace`, against the JAX package
(Pallas kernels in interpret mode) on identical inputs. Scenes: the brain
resection (a DIF over brain.blob), a twisted blend (a warp chain), a small
CSG tree (DIF, Ricci, UNION) and every prim type under one UNION."""
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fembrain_tpu.blob.scene as jscene
from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.ops.field import field as jax_field
from fembrain_tpu.ops.field import normal as jax_normal
from fembrain_tpu.render.camera import Camera as JaxCamera
from fembrain_tpu.render.camera import generate_rays as jax_rays
from fembrain_tpu.render.pallas_trace import trace_fast as jax_trace_fast
from fembrain_tpu.render.pallas_trace import trace_pallas
from fembrain_tpu.render.sphere_trace import trace as jax_trace

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch import convert
from fembrain_tpu_torch.blob.types import OpType
from fembrain_tpu_torch.ops.field import field, field_rows, normal
from fembrain_tpu_torch.render import tile_trace as tt
from fembrain_tpu_torch.render.sphere_trace import trace

from test_torch_fixtures import (
    BRAIN, assert_same_inputs, blend_twist, brain_resection, dif_scene,
    every_type, graph_size, small_blend, uncached_layouts,
)

TILE = 256
SCENES = {
    "resection": (brain_resection, (30.0, 20.0, 8.0), (32, 20)),
    "twist": (blend_twist, (25.0, 20.0, 2.5), (40, 26)),
    "dif": (dif_scene, (25.0, 20.0, 2.5), (40, 26)),
    "union": (lambda mod: every_type(mod, OpType.UNION), (25.0, 20.0, 2.5),
              (40, 26)),
    "small": (small_blend, (25.0, 20.0, 2.5), (16, 16)),
}


def _setup(name, size=None):
    make, pose, wh = SCENES[name]
    js = make(jscene).pack()
    w, h = size or wh
    ro, rd = jax_rays(JaxCamera.orbit(*pose), w, h)
    return (js, convert.scene(convert.numpy_fields(js), device="cpu"),
            np.asarray(ro).reshape(-1, 3), np.asarray(rd).reshape(-1, 3))


def _agree(h_ref, t_ref, hit, t, agree=0.999, max_dt=1e-4):
    """K3 thresholds: hit agreement > 0.999, max |dt| on common hits
    < 1e-4."""
    assert (h_ref == hit).mean() > agree, (h_ref != hit).sum()
    both = h_ref & hit
    assert both.sum() > 10
    assert np.abs(t_ref[both] - t[both]).max() < max_dt


def _points(js, n=500):
    lo, hi = np.asarray(js.bbox_lo), np.asarray(js.bbox_hi)
    return (lo - 0.2 + np.random.default_rng(5).random((n, 3))
            * (hi - lo + 0.4)).astype(np.float32)


@pytest.mark.parametrize("name", ["resection", "twist", "dif", "union"])
def test_field_rows_match_jax(name):
    js, ps, _, _ = _setup(name)
    pts = _points(js)
    ref = np.asarray(jax_field(js, jnp.asarray(pts)))
    p = torch.tensor(pts)
    got = field_rows(ps, p[:, 0], p[:, 1], p[:, 2]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(field(ps, p).numpy(), ref, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["twist", "dif"])
def test_normal_matches_jax(name):
    """The normal is compared where the field varies. The reference's is
    NaN where both inputs of the Ricci blend are 0 (its pow gradient at
    0); the port's stays finite there."""
    js, ps, _, _ = _setup(name)
    pts = _points(js)
    ref = np.asarray(jax_field(js, jnp.asarray(pts)))
    n_ref = np.asarray(jax_normal(js, jnp.asarray(pts)))
    n_got = normal(ps, torch.tensor(pts)).numpy()
    assert np.isfinite(n_got).all()
    inside = (ref > 1e-3) & np.isfinite(n_ref).all(-1)
    assert inside.sum() > 50
    np.testing.assert_allclose(n_got[inside], n_ref[inside], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["resection", "twist", "dif", "union"])
def test_general_trace_matches_pallas_and_port_tracer(name):
    js, ps, ro, rd = _setup(name)
    assert not js.is_additive
    t_j, h_j = trace_pallas(js, ro, rd, interpret=True, tile=TILE)
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    t_p, h_p = tt.trace_tiles(ps, ro_t, rd_t, tile=TILE)
    _agree(np.asarray(h_j), np.asarray(t_j), h_p.numpy(), t_p.numpy())
    t_x, h_x = trace(ps, ro_t, rd_t)
    _agree(h_x.numpy(), t_x.detach().numpy(), h_p.numpy(), t_p.numpy())


def test_general_inputs_on_cpu():
    """The packed K3 inputs: fold steps with range spans, the warp chain
    table, the slab bracket of a warp scene; on the CPU the wrapper runs
    the plain version and launches nothing."""
    _, ps, ro, rd = _setup("twist")
    inp = tt.prepare_general(ps, torch.tensor(ro), torch.tensor(rd),
                             tile=TILE)
    assert inp.rays.shape == (9, 5 * TILE)
    assert (inp.n_groups, inp.chain_len, inp.adaptive) == (1, 1, False)
    assert int(inp.warps[0, 0]) == int(OpType.WARP_TWIST)
    assert float(inp.warps[0, 4]) == pytest.approx(0.9)
    assert inp.steps.shape == (2, tt.STEP_ROW)
    before = dict(tt.LAUNCHES)
    t, hit = tt.run_tiles(inp)
    t2, hit2 = tt.trace_tiles_general_plain(inp)
    assert torch.equal(t, t2) and torch.equal(hit, hit2)
    assert tt.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tt.trace_general_cuda(inp)
    _, pr, ro, rd = _setup("resection")
    inp = tt.prepare_general(pr, torch.tensor(ro), torch.tensor(rd))
    # Range BLEND over the brain's 163 prims, then the DIF with the cut.
    assert inp.steps[0].tolist()[2:4] == [2, 0] and inp.steps[0, 5] == 162
    assert inp.steps[1, 0] == int(OpType.DIF) and inp.n_real == 164


def test_resection_cuts_the_brain():
    """The channel is visible: at 64 x 36 it moves the hit of at least 10
    rays by more than 0.05."""
    _, pr, ro, rd = _setup("resection", (64, 36))
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    brain = convert.scene(convert.numpy_fields(sc.pack()), device="cpu")
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    t_b, h_b = tt.trace_tiles(brain, ro_t, rd_t)
    t_r, h_r = tt.trace_tiles(pr, ro_t, rd_t)
    moved = h_r & (~h_b | (torch.abs(t_r - t_b) > 0.05))
    assert int(moved.sum()) >= 10, int(moved.sum())
    assert int(h_r.sum()) > 100


def _pos_grads(js, ps, ro, rd, jax_tracer, port_tracer):
    def loss_jax(pos):
        t, h = jax_tracer(dataclasses.replace(js, prim_pos=pos))
        return jnp.sum(jnp.where(h, t, 0.0))

    g_j = np.asarray(jax.grad(loss_jax)(js.prim_pos))
    pos = ps.prim_pos.clone().requires_grad_(True)
    t, h = port_tracer(dataclasses.replace(ps, prim_pos=pos),
                       torch.tensor(ro), torch.tensor(rd))
    torch.sum(torch.where(h, t, 0.0)).backward()
    assert np.abs(g_j).max() > 1e-3
    return g_j, pos.grad.numpy()


@pytest.mark.parametrize("name", ["twist", "small"])
def test_trace_fast_gradient_matches_jax(name):
    """trace_fast (K3 on the warp scene, K1 on the blend) carries the JAX
    trace_fast's implicit-differentiation gradient."""
    js, ps, ro, rd = _setup(name, (16, 16))
    g_j, g_p = _pos_grads(
        js, ps, ro, rd,
        lambda s: jax_trace_fast(s, ro, rd, interpret=True), tt.trace_fast)
    np.testing.assert_allclose(g_p, g_j, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", ["small", "twist"])
def test_trace_gradient_matches_jax(name):
    """The lock-step tracer differentiates only through the root's
    correction (the march, bisection and secant are constants), as the
    reference's stop_gradient does."""
    js, ps, ro, rd = _setup(name, (16, 16))
    g_j, g_p = _pos_grads(js, ps, ro, rd, lambda s: jax_trace(s, ro, rd),
                          trace)
    np.testing.assert_allclose(g_p, g_j, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("tracer", [trace, tt.trace_fast])
def test_traced_depth_holds_only_the_correction(tracer):
    """The march is not in the autograd graph: t depends on the scene
    through one field evaluation at the root (plus the correction's few
    operations), however many steps the march took."""
    _, ps, ro, rd = _setup("small", (16, 16))
    pos = ps.prim_pos.clone().requires_grad_(True)
    sc = dataclasses.replace(ps, prim_pos=pos)
    t, hit = tracer(sc, torch.tensor(ro), torch.tensor(rd))
    assert int(hit.sum()) > 20
    one_eval = graph_size(field(sc, torch.tensor(ro)))
    assert graph_size(t) < one_eval + 30, (graph_size(t), one_eval)


@pytest.mark.parametrize("name", ["resection", "twist", "dif", "union"])
def test_prepare_general_from_cache_equals_uncached_layout(name):
    """prepare_general, cold and warm, builds every field as it does from
    a layout made outside the per-Scene cache, and one Scene object is laid
    out once."""
    make, pose, (w, h) = SCENES[name]
    scene = make(pscene).pack(device="cpu")
    ro, rd = jax_rays(JaxCamera.orbit(*pose), w, h)
    ro = torch.tensor(np.asarray(ro).reshape(-1, 3))
    rd = torch.tensor(np.asarray(rd).reshape(-1, 3))
    with mock.patch.object(tt, "_general_layout",
                           wraps=tt._general_layout) as build:
        cold = tt.prepare_general(scene, ro, rd)
        warm = tt.prepare_general(scene, ro, rd)
        assert build.call_count == 1
    with uncached_layouts():
        ref = tt.prepare_general(scene, ro, rd)
    assert_same_inputs(cold, ref)
    assert_same_inputs(warm, ref)
