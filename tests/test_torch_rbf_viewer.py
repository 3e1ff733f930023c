"""PyTorch port, FastRBF, the scene graph and the offline viewer against
the JAX package's (tests/test_graphics.py and tests/test_misc.py are the
models), on seeded points and small scenes."""
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import fembrain_tpu.blob.scene as jscene
from fembrain_tpu.graphics import scenegraph as jsg
from fembrain_tpu.ops import rbf as jrbf
from fembrain_tpu.render import viewer as jviewer
from fembrain_tpu.render.camera import Camera as JaxCamera

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch.graphics import scenegraph as psg
from fembrain_tpu_torch.ops import rbf as prbf
from fembrain_tpu_torch.render import viewer as pviewer
from fembrain_tpu_torch.render.camera import Camera

from test_torch_fixtures import small_blend

# FastRBF evaluation, relative to the largest value (f32 sums over up to
# 400 centers in two frameworks).
RBF_RTOL = 1e-4


def _shell(n, seed):
    """Seeded points on a bumpy closed surface with their normals."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 1.0 + 0.15 * np.sin(3 * d[:, 0]) * np.cos(2 * d[:, 1])
    return (r[:, None] * d).astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("n,kw", [
    (120, {}), (160, {"start_count": 64, "step": 32, "max_centers": 256}),
])
def test_fast_rbf_fit_matches_jax(n, kw):
    """The greedy fit selects the same centers in the same order as the
    reference, with the same weights; evaluation, the autograd gradient
    and the penetration query agree within RBF_RTOL on seeded points."""
    pts, nrm = _shell(n, seed=n)
    samples, vals = prbf.off_surface_samples(pts, nrm)
    js, jv = jrbf.off_surface_samples(pts, nrm)
    np.testing.assert_array_equal(samples, js)
    np.testing.assert_array_equal(vals, jv)
    ref = jrbf.FastRBF()
    err_j = ref.fit_greedy(js, jv, **kw)
    rbf = prbf.FastRBF(device="cpu")
    err = rbf.fit_greedy(samples, vals, **kw)
    np.testing.assert_array_equal(rbf.centers, ref.centers)
    np.testing.assert_allclose(rbf.lambdas, ref.lambdas, rtol=1e-12)
    assert err == pytest.approx(err_j, rel=1e-3, abs=1e-6)
    q = np.random.default_rng(1).uniform(-1.3, 1.3, size=(64, 3))
    f, fj = rbf.evaluate(q), np.asarray(ref.evaluate(q))
    scale = np.abs(fj).max()
    np.testing.assert_allclose(f, fj, rtol=0, atol=RBF_RTOL * scale)
    g = rbf.gradient(q).numpy()
    gj = np.asarray(ref.gradient(jnp.asarray(q)))
    np.testing.assert_allclose(g, gj, rtol=0,
                               atol=RBF_RTOL * np.abs(gj).max())
    tf = rbf.field(torch.tensor(q, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(tf, fj, rtol=0, atol=RBF_RTOL * scale)
    inside, pen = rbf.intersects(np.zeros(3))
    inside_j, pen_j = ref.intersects(np.zeros(3))
    assert bool(inside[0]) == bool(inside_j[0]) is True
    assert float(pen[0]) == pytest.approx(float(pen_j[0]), rel=RBF_RTOL)


def _tri_mesh(mod, name="tri"):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], float)
    faces = np.array([[0, 1, 2]], np.int32)
    return mod.SGMesh(name, verts, faces)


def test_scenegraph_nodes_draw_and_aabb_match_jax():
    """Add/get/remove, visibility, transforms, timestep fan-out and the
    union AABB behave as the reference's (tests/test_graphics.py)."""
    out = {}
    for key, mod in (("p", psg), ("j", jsg)):
        calls = []

        class Stepper(mod.SGNode):
            def timestep(self):
                calls.append(self.name)

        sg = mod.SceneGraph()
        a = sg.add(_tri_mesh(mod, "a"))
        hidden = sg.add(_tri_mesh(mod, "hidden"))
        hidden.visible = False
        gone = sg.add(_tri_mesh(mod, "gone"))
        assert sg.remove("gone") and not sg.remove(gone)
        assert sg.get("a") is a and sg.get("gone") is None
        a.set_translation([5.0, 0.0, 0.0])
        sg.add(Stepper("x"))
        frozen = sg.add(Stepper("frozen"))
        frozen.animate = False
        sg.timestep()
        batches = sg.draw()
        lo, hi = sg.aabb()
        out[key] = (len(sg), [b.name for b in batches], batches[0].verts,
                    batches[0].faces, batches[0].color, lo, hi, calls,
                    sorted(sg.headers), a.translation())
    p, j = out["p"], out["j"]
    assert p[0] == j[0] == 4 and p[1] == j[1] == ["a"] and p[7] == j[7]
    for i in (2, 3, 5, 6, 9):
        np.testing.assert_array_equal(p[i], j[i])
    assert p[4] == j[4] and p[8] == j[8] == ["fps"]
    assert p[6][0] == 6.0 and p[5][0] == 0.0
    assert psg.the_scenegraph() is psg.the_scenegraph()
    assert psg._FpsTracker(window=3).tick() == 0.0


@pytest.mark.parametrize("x,y", [(32, 32), (0, 0), (63, 10), (100, -5)])
def test_screen_to_world_ray_matches_jax(x, y):
    """Picking through the port's camera and `generate_rays`, pixel
    clamped to the image, as the reference's."""
    sg, jg = psg.SceneGraph(), jsg.SceneGraph()
    sg.camera = Camera.orbit(30.0, 20.0, 5.0, device="cpu")
    jg.camera = JaxCamera.orbit(30.0, 20.0, 5.0)
    ro, rd = sg.screen_to_world_ray(x, y, 64, 48)
    jro, jrd = jg.screen_to_world_ray(x, y, 64, 48)
    np.testing.assert_allclose(ro, jro, atol=1e-5)
    np.testing.assert_allclose(rd, jrd, atol=1e-5)
    with pytest.raises(ValueError):
        psg.SceneGraph().screen_to_world_ray(0, 0, 8, 8)


def test_put_text_stamps_the_same_pixels_as_jax():
    """The HUD text lands in the top-left rows, the same pixels as the
    reference's (both draw with PIL)."""
    img = np.full((40, 120, 3), 0.8, np.float32)
    got = pviewer._put_text(img, "frame 3  cg 212\nmax|q| 0.1")
    ref = jviewer._put_text(img, "frame 3  cg 212\nmax|q| 0.1")
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float32 and not np.allclose(got, img)
    assert np.allclose(got[30:], np.float32(204 / 255))


def test_render_turntable_matches_jax(tmp_path):
    """Two 24x16 turntable frames of a small blend with the HUD: the same
    files, and images within 2/255 of the reference's on 99% of the
    pixels (the dense tracers' roots agree to f32 rounding)."""
    paths = pviewer.render_turntable(small_blend(pscene).pack(device="cpu"),
                                     tmp_path / "p", frames=2, width=24,
                                     height=16)
    jpaths = jviewer.render_turntable(small_blend(jscene).pack(),
                                      tmp_path / "j", frames=2, width=24,
                                      height=16)
    assert [p.name for p in paths] == [p.name for p in jpaths] == [
        "turn_000.png", "turn_001.png"]
    for p, j in zip(paths, jpaths):
        a = np.asarray(Image.open(p)).astype(int)
        b = np.asarray(Image.open(j)).astype(int)
        assert a.shape == b.shape == (16, 24, 3)
        assert (np.abs(a - b) <= 2).mean() > 0.99
        assert a.min() < 200
