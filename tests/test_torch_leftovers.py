"""PyTorch port, the leftovers of files already ported, against the JAX
package on identical inputs: the `.blob` writer, `field_image` and
`off_surface_points_and_fields`, the scalar numpy oracle `field_ref`,
`refine_disp_interp`, the tet-mesh fixtures of `mesh/samples.py` and
`block_permutation`."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fembrain_tpu.blob.scene as jscene
from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.blob.writer import save_blob as jax_save_blob
from fembrain_tpu.mesh import samples as jsamples
from fembrain_tpu.mesh.polygonize import extract_tet_mesh as jax_extract
from fembrain_tpu.mesh.polygonize import grid_for_scene as jax_grid
from fembrain_tpu.ops import field as jfield
from fembrain_tpu.ops import field_ref as jfield_ref
from fembrain_tpu.render import deformed as jd
from fembrain_tpu.render.pallas_trace import (
    block_permutation as jax_block_permutation,
)

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch import convert
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.blob.writer import save_blob
from fembrain_tpu_torch.mesh import samples as psamples
from fembrain_tpu_torch.ops import field as pfield
from fembrain_tpu_torch.ops import field_ref
from fembrain_tpu_torch.render import deformed as pd
from fembrain_tpu_torch.render import tile_trace as tt

from test_torch_fixtures import (
    BRAIN, blend_twist, dif_scene, every_type, small_blend,
)

# f32 field values of the two packages (the same operations, possibly in
# another order) and of the port against its float64 oracle.
FIELD_ATOL = 1e-5


def _brain(load):
    sc = load(BRAIN)
    sc.flatten_instances()
    return sc


SCENES = {
    "brain": (lambda: _brain(jax_load_blob), lambda: _brain(load_blob)),
    "every_type": (lambda: every_type(jscene), lambda: every_type(pscene)),
    "dif": (lambda: dif_scene(jscene), lambda: dif_scene(pscene)),
    "twist": (lambda: blend_twist(jscene), lambda: blend_twist(pscene)),
    "small": (lambda: small_blend(jscene), lambda: small_blend(pscene)),
}


def _points(scene_def, n, seed, margin=0.2):
    lo, hi = scene_def.aabb()
    rng = np.random.default_rng(seed)
    return rng.uniform(np.asarray(lo) - margin, np.asarray(hi) + margin,
                       size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_save_blob_matches_jax(tmp_path, name):
    """Both writers give the same text; the file reads back, in either
    package, to the same packed arrays, whose field is the written
    scene's (the reader may number the nodes in another order)."""
    make_j, make_p = SCENES[name]
    jax_save_blob(make_j(), tmp_path / "j.blob")
    save_blob(make_p(), tmp_path / "p.blob")
    text = (tmp_path / "p.blob").read_text()
    assert text == (tmp_path / "j.blob").read_text()
    assert "[Global]" in text and "FileVersion=6" in text
    if name == "every_type":
        # Its quadric point has scale and radius 0 in `dir`; the reader
        # of either package derives res from them and divides by 0.
        for load, path in ((jax_load_blob, "j.blob"), (load_blob, "p.blob")):
            with pytest.raises(ZeroDivisionError):
                load(tmp_path / path)
        return
    ref = convert.numpy_fields(jax_load_blob(tmp_path / "j.blob").pack())
    got = convert.numpy_fields(load_blob(tmp_path / "p.blob").pack(
        device="cpu"))
    for key in ("prim_pos", "prim_dir", "prim_res", "prim_mtx", "prim_type",
                "op_type", "op_params", "bbox_lo", "bbox_hi"):
        np.testing.assert_array_equal(got[key], ref[key], key)
    sd = make_p()
    assert got["n_prims"] == ref["n_prims"] == len(sd.prims)
    pts = torch.tensor(_points(sd, 64, seed=1))
    back = load_blob(tmp_path / "p.blob").pack(device="cpu")
    np.testing.assert_allclose(pfield.field(back, pts).numpy(),
                               pfield.field(sd.pack(device="cpu"), pts).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_field_image_matches_jax(axis):
    """A 40x24 slice through brain's middle, within FIELD_ATOL."""
    js = _brain(jax_load_blob).pack()
    ps = _brain(load_blob).pack(device="cpu")
    coord = float(0.5 * (js.bbox_lo[axis] + js.bbox_hi[axis]))
    ref = np.asarray(jfield.field_image(js, axis, coord, width=40, height=24))
    got = pfield.field_image(ps, axis, coord, width=40, height=24)
    assert got.shape == (24, 40) and ref.max() > 0.5
    np.testing.assert_allclose(got.numpy(), ref, atol=FIELD_ATOL)


@pytest.mark.parametrize("name", ["brain", "every_type"])
def test_off_surface_points_and_fields_match_jax(name):
    """Points pushed along the autograd normals, and their fields: points
    within 1e-5, fields within FIELD_ATOL, on 96 seeded points."""
    make_j, make_p = SCENES[name]
    sd = make_p()
    pts = _points(sd, 96, seed=3)
    js, ps = make_j().pack(), sd.pack(device="cpu")
    rp, rf = jfield.off_surface_points_and_fields(js, jnp.asarray(pts), 0.1)
    gp, gf = pfield.off_surface_points_and_fields(ps, torch.tensor(pts), 0.1)
    assert gp.shape == (192, 3) and gf.shape == (192,)
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), atol=1e-5)
    np.testing.assert_allclose(gf.numpy(), np.asarray(rf), atol=FIELD_ATOL)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_field_ref_is_the_oracle_of_field(name):
    """The port's numpy oracle equals the JAX package's (both float64,
    the same recursion) to 1e-12, to 1e-6 where a warp runs (the
    reference's warp runs in JAX's float32); the port's f32 `field`
    agrees with it within FIELD_ATOL, and its central-difference gradient
    with the port's autograd gradient where the field is smooth."""
    make_j, make_p = SCENES[name]
    sd_j, sd_p = make_j(), make_p()
    n = 24 if name == "brain" else 64
    pts = _points(sd_p, n, seed=5)
    ref = jfield_ref.field_many(sd_j, pts)
    got = field_ref.field_many(sd_p, pts)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 if name == "twist" else 1e-12)
    f = pfield.field(sd_p.pack(device="cpu"), torch.tensor(pts)).numpy()
    np.testing.assert_allclose(f, got, atol=FIELD_ATOL, rtol=1e-4)
    if name == "brain":
        p = pts[np.argmax(got)]
        g = pfield.gradient(sd_p.pack(device="cpu"),
                            torch.tensor(p[None]))[0].numpy()
        np.testing.assert_allclose(field_ref.gradient_fd(sd_p, p), g,
                                   atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def brain_nodes():
    js = _brain(jax_load_blob).pack()
    grid = jax_grid(js, cellsize=0.35)
    tm = jax_extract(js, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6)
    return np.asarray(tm.nodes)[: int(tm.n_nodes)]


@pytest.mark.parametrize("kernel,kw", [
    ("biharmonic", {"n_centers": 32}),
    ("wendland", {"n_centers": 48, "sigma_fill": 2.5}),
])
def test_refine_disp_interp_matches_jax(brain_nodes, kernel, kw):
    """On one shared node array and a seeded displacement (a sag plus
    noise), refinement picks the same center nodes in the same order as
    the reference, and factors the same system (float32 storage)."""
    nodes = brain_nodes
    rng = np.random.default_rng(11)
    y = nodes[:, 1]
    u = rng.normal(scale=0.01, size=nodes.shape)
    u[:, 1] -= 0.15 * ((y - y.min()) / (y.max() - y.min())) ** 2
    ji = jd.refine_disp_interp(
        jd.build_disp_interp(nodes, kernel=kernel, **kw), nodes, u,
        n_extra=24, batch=8)
    pi = pd.refine_disp_interp(
        pd.build_disp_interp(nodes, kernel=kernel, device="cpu", **kw),
        nodes, u, n_extra=24, batch=8, device="cpu")
    base = kw["n_centers"]
    assert len(pi.center_nodes) > base
    np.testing.assert_array_equal(pi.center_nodes.numpy(),
                                  np.asarray(ji.center_nodes))
    assert pi.kind == ji.kind and pi.sigma == ji.sigma
    np.testing.assert_array_equal(pi.a_inv.numpy(), np.asarray(ji.a_inv))
    np.testing.assert_array_equal(pi.centers.numpy(), np.asarray(ji.centers))


@pytest.mark.parametrize("name,args", [
    ("one_tetra", ()), ("two_tetra", ()), ("truth_cube", ()),
    ("truth_cube", (3, 5, 2, 0.25)), ("egg_shell", ()),
    ("egg_shell", (6, 4, 1.5, 0.2)),
])
def test_sample_meshes_match_jax(name, args):
    """Every fixture gives the reference's arrays exactly, all its tets
    positively oriented."""
    nodes, tets = getattr(psamples, name)(*args)
    ref_nodes, ref_tets = getattr(jsamples, name)(*args)
    np.testing.assert_array_equal(nodes, ref_nodes)
    np.testing.assert_array_equal(tets, ref_tets)
    assert tets.dtype == np.int32 and nodes.dtype == np.float64
    vols = psamples._signed_vols(nodes, tets)
    np.testing.assert_array_equal(vols, jsamples._signed_vols(nodes, tets))
    assert (vols > 0).all()
    flipped = tets[:, [0, 2, 1, 3]]
    _, re = psamples._orient(nodes, flipped)
    np.testing.assert_array_equal(re, jsamples._orient(nodes, flipped)[1])
    assert (psamples._signed_vols(nodes, re) > 0).all()


@pytest.mark.parametrize("hw,block", [
    ((48, 64), (32, 64)), ((37, 91), (32, 64)), ((20, 30), (16, 16))])
def test_block_permutation_matches_jax(hw, block):
    """The same permutation as the reference; with a tile's block shape it
    is the ray order of `image_rays_to_blocks`."""
    h, w = hw
    perm = tt.block_permutation(h, w, *block)
    np.testing.assert_array_equal(perm, jax_block_permutation(h, w, *block))
    valid = perm[perm >= 0]
    assert sorted(valid.tolist()) == list(range(h * w))
    if block == (16, 16):
        ro = torch.arange(h * w * 3, dtype=torch.float32).reshape(-1, 3)
        ro_b, _, _ = tt.image_rays_to_blocks(ro, ro, h, w, tile=256)
        np.testing.assert_array_equal(ro_b[perm >= 0].numpy(),
                                      ro[valid].numpy())
