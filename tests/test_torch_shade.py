"""PyTorch port: colour and attribute functions, shading, the dense
renderers and the trilinear deformed path against the JAX package on
brain at 48x36 rays. Tolerances: field 1e-6, gradient and colour 1e-5;
traces: hit agreement > 0.999 and |dt| < 1e-4 on common hits; rgb within
1e-4 on common hits."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.graphics import materials as jmat
from fembrain_tpu.mesh import polygonize as jpoly
from fembrain_tpu.ops import field as jfield
from fembrain_tpu.render import deformed as jdeformed
from fembrain_tpu.render import sphere_trace as jtrace
from fembrain_tpu.render.camera import Camera as JaxCamera
from fembrain_tpu.render.camera import generate_rays as jax_rays

from fembrain_tpu_torch import convert
from fembrain_tpu_torch.graphics import materials as pmat
from fembrain_tpu_torch.mesh.polygonize import GridSpec
from fembrain_tpu_torch.ops import field as pfield
from fembrain_tpu_torch.render import deformed as pdeformed
from fembrain_tpu_torch.render import sphere_trace as ptrace
from fembrain_tpu_torch.render.camera import Camera

from test_torch_fixtures import BRAIN

W, H = 48, 36
POSE = (30.0, 20.0, 8.0)


@pytest.fixture(scope="module")
def brain():
    sc = jax_load_blob(BRAIN)
    sc.flatten_instances()
    js = sc.pack()
    ps = convert.scene(convert.numpy_fields(js), device="cpu")
    ro, rd = jax_rays(JaxCamera.orbit(*POSE), W, H)
    ro = np.asarray(ro).reshape(-1, 3)
    rd = np.asarray(rd).reshape(-1, 3)
    grid = jpoly.grid_for_scene(js, cellsize=0.35)
    jtm = jpoly.extract_tet_mesh(js, grid, ncap=grid.n_vertices,
                                 tetcap=grid.n_cells * 6)
    nodes = np.asarray(jtm.nodes)[: int(jtm.n_nodes)]
    # A smooth displacement of the nodes (a bend with a sag), about 0.1.
    u = np.stack([0.06 * np.sin(1.3 * nodes[:, 1]),
                  -0.08 * np.cos(0.9 * nodes[:, 0]) * (nodes[:, 1] + 1.1),
                  0.05 * np.sin(1.1 * nodes[:, 0] + 0.4 * nodes[:, 2])],
                 1).astype(np.float32)
    return dict(js=js, ps=ps, ro=ro, rd=rd, grid=grid, jtm=jtm, u=u,
                pgrid=GridSpec(grid.lo, grid.dims, grid.cellsize),
                g2n=np.asarray(jtm.grid_to_node))


def _points(js, seed, n=300):
    lo, hi = np.asarray(js.bbox_lo), np.asarray(js.bbox_hi)
    rng = np.random.default_rng(seed)
    return (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)


def _agree(hit_ref, t_ref, hit, t, min_hits=150):
    hit_ref, hit = np.asarray(hit_ref), np.asarray(hit)
    assert (hit_ref == hit).mean() > 0.999
    both = hit_ref & hit
    assert both.sum() > min_hits
    assert np.abs(np.asarray(t_ref) - np.asarray(t))[both].max() < 1e-4
    return both


def test_field_and_color_and_vertex_attributes(brain):
    js, ps = brain["js"], brain["ps"]
    pts = _points(js, 0).reshape(20, 15, 3)
    jf, jc = jfield.field_and_color(js, jnp.asarray(pts))
    f, c = pfield.field_and_color(ps, torch.tensor(pts))
    assert f.shape == (20, 15) and c.shape == (20, 15, 4)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    jf2, jg, jc2 = jfield.vertex_attributes(js, jnp.asarray(pts))
    f2, g, c2 = pfield.vertex_attributes(ps, torch.tensor(pts))
    assert g.shape == (20, 15, 3) and not g.requires_grad
    np.testing.assert_allclose(f2.numpy(), np.asarray(jf2), atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jc2), atol=1e-5)
    np.testing.assert_allclose(
        g.numpy(), pfield.gradient(ps, torch.tensor(pts)).numpy(), atol=1e-6)
    # With points that require grad the results carry a graph.
    x = torch.tensor(pts, requires_grad=True)
    _, g3, _ = pfield.vertex_attributes(ps, x)
    assert g3.requires_grad
    (h,) = torch.autograd.grad(g3.sum(), x)
    assert bool(torch.isfinite(h).all()) and float(h.abs().max()) > 0


@pytest.mark.parametrize("material,textured", [
    ("PHONG", False), ("FLAT", False), ("EDGES", True)])
def test_shade_matches_jax(brain, material, textured):
    """shade on the JAX package's own hits, so that both shade the same
    rays: every pixel within 1e-4, misses exactly the background."""
    js, ps, ro, rd = (brain[k] for k in ("js", "ps", "ro", "rd"))
    t, hit = jtrace.trace(js, jnp.asarray(ro), jnp.asarray(rd))
    tex = np.random.default_rng(1).random((8, 6, 3)).astype(np.float32)
    bg = (0.2, 0.3, 0.4)
    kw = dict(texture=jnp.asarray(tex), texture_scale=1.7) if textured else {}
    ref = np.asarray(jtrace.shade(
        js, jnp.asarray(ro), jnp.asarray(rd), t, hit, background=bg,
        material=getattr(jmat, material), **kw))
    if textured:
        kw["texture"] = torch.tensor(tex)
    hit_t = torch.tensor(np.asarray(hit))
    rgb = ptrace.shade(ps, torch.tensor(ro), torch.tensor(rd),
                       torch.tensor(np.asarray(t)), hit_t, background=bg,
                       material=getattr(pmat, material), **kw)
    assert rgb.shape == (W * H, 3) and int(hit_t.sum()) > 150
    np.testing.assert_allclose(rgb.numpy(), ref, atol=1e-4)
    assert bool((rgb[~hit_t] == torch.tensor(bg)).all())
    assert getattr(pmat, material) == pmat.Material(**{
        k: getattr(getattr(jmat, material), k)
        for k in ("ambient", "diffuse", "specular", "shininess")})


def test_shade_chunks_do_not_change_the_result(brain, monkeypatch):
    ps, ro, rd = brain["ps"], torch.tensor(brain["ro"]), torch.tensor(
        brain["rd"])
    with torch.no_grad():
        t, hit = ptrace.trace(ps, ro, rd)
    whole = ptrace.shade(ps, ro, rd, t, hit)
    monkeypatch.setattr(ptrace, "CORRECTION_CHUNK", 64)
    assert int(hit.sum()) > 3 * 64
    assert torch.equal(ptrace.shade(ps, ro, rd, t, hit), whole)
    none = torch.zeros_like(hit)
    assert bool((ptrace.shade(ps, ro, rd, t, none) == 1.0).all())


def test_render_image_and_depth_image_match_jax(brain):
    js, ps = brain["js"], brain["ps"]
    jcam, cam = JaxCamera.orbit(*POSE), Camera.orbit(*POSE, device="cpu")
    jt, jhit = jtrace.depth_image(js, jcam, W, H)
    with torch.no_grad():
        t, hit = ptrace.depth_image(ps, cam, W, H)
        img = ptrace.render_image(ps, cam, W, H)
    assert t.shape == hit.shape == (H, W) and img.shape == (H, W, 3)
    both = _agree(jhit, jt, hit.numpy(), t.numpy())
    ref = np.asarray(jtrace.render_image(js, jcam, W, H))
    assert np.abs(img.numpy() - ref)[both].max() < 1e-4
    assert bool(torch.isfinite(img).all())


def test_trilinear_path_matches_jax(brain):
    """displacement_grid, sample_displacement, pull_back, deformed_field,
    trace_deformed and render_deformed on a smooth nodal displacement."""
    js, ps, grid, pgrid = (brain[k] for k in ("js", "ps", "grid", "pgrid"))
    u, g2n = brain["u"], brain["g2n"]
    jug = jdeformed.displacement_grid(grid, jnp.asarray(g2n), jnp.asarray(u))
    ug = pdeformed.displacement_grid(pgrid, torch.tensor(g2n),
                                     torch.tensor(u))
    np.testing.assert_array_equal(ug.numpy(), np.asarray(jug))
    # Sample points reach past the grid on every side (clamped there).
    pts = (_points(js, 2) * 1.3).astype(np.float32)
    np.testing.assert_allclose(
        pdeformed.sample_displacement(pgrid, ug, torch.tensor(pts)).numpy(),
        np.asarray(jdeformed.sample_displacement(grid, jug,
                                                 jnp.asarray(pts))),
        atol=1e-6)
    np.testing.assert_allclose(
        pdeformed.pull_back(pgrid, ug, torch.tensor(pts)).numpy(),
        np.asarray(jdeformed.pull_back(grid, jug, jnp.asarray(pts))),
        atol=1e-6)
    np.testing.assert_allclose(
        pdeformed.deformed_field(ps, pgrid, ug, torch.tensor(pts)).numpy(),
        np.asarray(jdeformed.deformed_field(js, grid, jug,
                                            jnp.asarray(pts))), atol=1e-5)
    ro, rd = brain["ro"], brain["rd"]
    jt, jhit = jax.jit(lambda a, b: jdeformed.trace_deformed(
        js, grid, jug, a, b))(jnp.asarray(ro), jnp.asarray(rd))
    with torch.no_grad():
        t, hit = pdeformed.trace_deformed(ps, pgrid, ug, torch.tensor(ro),
                                          torch.tensor(rd))
    both = _agree(jhit, jt, hit.numpy(), t.numpy())
    jcam, cam = JaxCamera.orbit(*POSE), Camera.orbit(*POSE, device="cpu")
    ref = np.asarray(jdeformed.render_deformed(
        js, grid, jnp.asarray(g2n), jnp.asarray(u), jcam, W, H))
    with torch.no_grad():
        img = pdeformed.render_deformed(ps, pgrid, torch.tensor(g2n),
                                        torch.tensor(u), cam, W, H)
        rest = ptrace.render_image(ps, cam, W, H)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    assert np.abs(img.numpy() - ref).reshape(-1, 3)[both].max() < 1e-4
    assert float((img - rest).abs().max()) > 0.05


def test_trace_deformed_gradient_to_the_displacement(brain):
    """d sum(t) / d (displacement scale) by implicit differentiation,
    against the JAX package (rtol 1e-3) on a 16x12 image."""
    js, ps, grid, pgrid = (brain[k] for k in ("js", "ps", "grid", "pgrid"))
    u, g2n = brain["u"], brain["g2n"]
    ro, rd = jax_rays(JaxCamera.orbit(*POSE), 16, 12)
    ro = np.asarray(ro).reshape(-1, 3)
    rd = np.asarray(rd).reshape(-1, 3)

    def jloss(s):
        ug = jdeformed.displacement_grid(grid, jnp.asarray(g2n),
                                         jnp.asarray(u) * s)
        t, hit = jdeformed.trace_deformed(js, grid, ug, jnp.asarray(ro),
                                          jnp.asarray(rd))
        return jnp.sum(jnp.where(hit, t, 0.0))

    ref = float(jax.grad(jloss)(jnp.float32(1.0)))
    s = torch.tensor(1.0, requires_grad=True)
    ug = pdeformed.displacement_grid(pgrid, torch.tensor(g2n),
                                     torch.tensor(u) * s)
    t, hit = pdeformed.trace_deformed(ps, pgrid, ug, torch.tensor(ro),
                                      torch.tensor(rd))
    torch.sum(torch.where(hit, t, 0.0)).backward()
    assert int(hit.sum()) > 15 and abs(ref) > 1e-3
    assert abs(float(s.grad) - ref) <= 1e-3 * abs(ref), (float(s.grad), ref)
