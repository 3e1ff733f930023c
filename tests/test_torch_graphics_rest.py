"""PyTorch port, the rest of graphics/ and mesh/: the host rasterizer
(graphics/raster.py), the material registry, image textures and both
triplanar samplers (graphics/materials.py) and the volume reader
(mesh/minc.py), against the JAX package on the same numpy inputs. Two
faults of the reference are copied and pinned in both packages: the
texture seam where u wraps (materials.py:86) and the affine, not
perspective-correct, barycentric texture lookup (raster.py:154)."""
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from fembrain_tpu.graphics import materials as jmat
from fembrain_tpu.graphics import raster as jras
from fembrain_tpu.graphics.scenegraph import DrawBatch as JDrawBatch
from fembrain_tpu.mesh import minc as jminc
from fembrain_tpu.render.camera import Camera as JCamera

from fembrain_tpu_torch.graphics import materials as pmat
from fembrain_tpu_torch.graphics import raster as pras
from fembrain_tpu_torch.graphics.scenegraph import DrawBatch
from fembrain_tpu_torch.mesh import minc as pminc
from fembrain_tpu_torch.render.camera import Camera


def _image(seed=0, h=9, w=13):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _pts(seed=1, n=200):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


def test_texture_sample_and_triplanar_take_a_texture():
    """The port's triplanar_sample takes a Texture, as the reference's
    does, and gives its numbers; the tensor sampler is the reference's
    triplanar_sample_jax."""
    img = _image()
    pts, nrm = _pts()
    jt, pt = jmat.Texture(img, "t"), pmat.Texture(img, "t")
    u, v = pts[:, 0], pts[:, 1]
    np.testing.assert_array_equal(pt.sample(u, v), jt.sample(u, v))
    ref = jmat.triplanar_sample(jt, pts, nrm, 1.7)
    np.testing.assert_array_equal(pmat.triplanar_sample(pt, pts, nrm, 1.7),
                                  ref)
    got = pmat.triplanar_sample_tensor(torch.tensor(img), torch.tensor(pts),
                                       torch.tensor(nrm), 1.7)
    jref = jmat.triplanar_sample_jax(jnp.asarray(img), jnp.asarray(pts),
                                     jnp.asarray(nrm), 1.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_texture_seam_is_copied():
    """Wrap addressing spans texels 0 .. w-1 over u in [0, 1) and clamps
    the last texel's right neighbour, so the sample jumps where u wraps
    (a seamless wrap would blend texel w-1 into texel 0): in both
    packages, by the same amount."""
    img = _image(3)
    v = np.full(5, 0.25)
    for tex in (jmat.Texture(img), pmat.Texture(img)):
        before = tex.sample(np.full(5, 1.0 - 1e-7), v)
        after = tex.sample(np.zeros(5), v)
        jump = np.abs(before - after).max()
        col = img[2, -1]                  # v = 0.25 is texel row 2 of 9
        np.testing.assert_allclose(before[0], col, atol=1e-5)
        assert jump > 0.05
    np.testing.assert_array_equal(
        pmat.Texture(img).sample(np.full(5, 1.0 - 1e-7), v),
        jmat.Texture(img).sample(np.full(5, 1.0 - 1e-7), v))


def test_texture_load_and_registry(tmp_path):
    img = (_image(4) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "stripes.png")
    (tmp_path / "notes.txt").write_text("not a texture")
    (tmp_path / "tissue.mat").write_text(
        "[MATERIAL]\nambient=0.3\ndiffuse=0.6\nspecular=0.2\nshininess=16\n")
    jt, pt = jmat.Texture.load(tmp_path / "stripes.png"), pmat.Texture.load(
        tmp_path / "stripes.png")
    assert pt.name == jt.name == "stripes"
    np.testing.assert_array_equal(pt.image, jt.image)
    regs = (jmat.MaterialRegistry(), pmat.MaterialRegistry())
    for reg in regs:
        assert reg.add_textures_from_folder(tmp_path) == 1
        assert reg.add_from_folder(tmp_path) == 1
        reg.add("soft", type(reg.get("phong"))(ambient=0.4, shininess=8.0))
    jr, pr = regs
    assert pr.names() == jr.names() and pr.texture_names() == ["stripes"]
    assert "tissue" in pr and "nothing" not in pr
    assert pr.get("tissue") == pmat.Material(0.3, 0.6, 0.2, 16.0)
    assert pmat.Material.from_ini(tmp_path / "tissue.mat") == pr.get("tissue")
    np.testing.assert_array_equal(pr.get_texture("stripes").image,
                                  jr.get_texture("stripes").image)
    assert pmat.the_materials.names() == jmat.the_materials.names()


def _cams(eye=(0.4, 0.6, 3.0)):
    return (JCamera.make(eye, target=(0.0, 0.0, -1.0)),
            Camera.make(eye, target=(0.0, 0.0, -1.0), device="cpu"))


def _batches(mod):
    tri = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, -4.0], [0.0, 1.2, -2.0],
                    [0.5, 0.8, 0.5]])
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    cloud = np.random.default_rng(5).uniform(-1, 1, (40, 3))
    return [mod(name="tri", verts=tri, faces=faces, color=(0.9, 0.5, 0.3)),
            mod(name="cloud", verts=cloud, faces=None, color=(0.1, 0.2, 0.8))]


@pytest.mark.parametrize("kw", [{}, {"wireframe": True},
                                {"material": "flat"}, {"texture": True}])
def test_rasterize_matches_reference(kw):
    jc, pc = _cams()
    args = dict(kw)
    if "material" in kw:
        args_j = dict(args, material=jmat.FLAT)
        args_p = dict(args, material=pmat.FLAT)
    elif "texture" in kw:
        img = _image(6)
        args_j = dict(texture=jmat.Texture(img), texture_scale=2.0)
        args_p = dict(texture=pmat.Texture(img), texture_scale=2.0)
    else:
        args_j = args_p = args
    ref = jras.rasterize(_batches(JDrawBatch), jc, 64, 48, **args_j)
    got = pras.rasterize(_batches(DrawBatch), pc, 64, 48, **args_p)
    np.testing.assert_allclose(got, ref, atol=1e-12)
    assert got.shape == (48, 64, 3) and (got < 1).any()
    pts = _batches(DrawBatch)[1].verts
    for a, b in zip(pras.project(pc, pts, 64, 48),
                    jras.project(jc, pts, 64, 48)):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_texture_lookup_uses_affine_barycentrics():
    """At a pixel inside a triangle whose corners lie at very different
    depths, both packages sample the texture at the world point blended
    by the SCREEN-space barycentrics (affine), not at the perspective-
    correct point the depth test uses: the reference's fault, copied."""
    img = np.zeros((2, 64, 3), np.float32)
    img[:, :, 0] = np.linspace(0.0, 1.0, 64)[None]   # red ramps with u
    verts = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, -4.0],
                      [0.0, 1.2, -2.0]])
    faces = np.array([[0, 1, 2]])
    w, h = 64, 48
    jc, pc = _cams((0.0, 0.0, 3.0))
    shade_n = np.cross(verts[1] - verts[0], verts[2] - verts[0])
    shade_n /= np.linalg.norm(shade_n)
    xy, z = pras.project(pc, verts, w, h)
    px, py = 30, 30
    p = np.array([px + 0.5, py + 0.5])
    a, b, c = xy
    area = pras._edge(a[None], b, c)[0]
    lam = np.array([pras._edge(p, b, c), pras._edge(p, c, a),
                    pras._edge(p, a, b)]) / area
    assert (lam > 0.05).all()
    affine = lam @ verts
    persp = (lam / z) @ verts / np.sum(lam / z)
    assert np.abs(affine - persp).max() > 0.1
    for mod, ras, cam, mat, bat in (
            (pmat, pras, pc, pmat.FLAT, DrawBatch),
            (jmat, jras, jc, jmat.FLAT, JDrawBatch)):
        tex = mod.Texture(img)
        out = ras.rasterize([bat("t", verts, faces, (1.0, 1.0, 1.0))], cam,
                            w, h, background=(0, 0, 0), material=mat,
                            texture=tex, texture_scale=0.3)
        want = mod.triplanar_sample(tex, affine[None],
                                    shade_n[None], 0.3)[0]
        not_want = mod.triplanar_sample(tex, persp[None], shade_n[None],
                                        0.3)[0]
        np.testing.assert_allclose(out[py, px], want, atol=1e-9)
        assert np.abs(out[py, px] - not_want).max() > 1e-3


@pytest.mark.parametrize("suffix", [".npy", ".npz", ".raw"])
def test_volume_read_write_matches_reference(tmp_path, suffix):
    data = np.random.default_rng(8).normal(size=(4, 5, 6)).astype(np.float32)
    path = tmp_path / f"vol{suffix}"
    if suffix == ".npy":
        np.save(path, data)
    elif suffix == ".npz":
        np.savez(path, data=data, spacing=np.array([0.5, 0.5, 2.0]),
                 origin=np.array([1.0, 2.0, 3.0]))
    else:
        pminc.write_volume(path, pminc.Volume(data, (0.5, 1.0, 2.0),
                                              (1.0, 0.0, -1.0)))
    got, ref = pminc.read_volume(path), jminc.read_volume(path)
    np.testing.assert_array_equal(got.data, ref.data)
    assert got.data.dtype == np.float32
    assert tuple(got.spacing) == tuple(ref.spacing)
    assert tuple(got.origin) == tuple(ref.origin)
    with pytest.raises(ValueError):
        pminc.read_volume(tmp_path / "vol.nii")
    with pytest.raises(ValueError):
        pminc.write_volume(tmp_path / "vol.npy", got)
