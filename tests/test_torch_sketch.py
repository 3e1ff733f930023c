"""PyTorch port: the kd-tree picker and the sketch machine against the JAX
package — picks, box tests and SAH cost on seeded boxes (exact: both are
float64 numpy), the reference's flat-box fault pinned in both, undo/redo,
action scripts across packages, select, the packed scene after an edit
(exact), and the sketched brain traced by the port's plain tile trace
against the JAX Pallas kernel in interpret mode at 64x48 (hit agreement
above 0.999, |dt| below 1e-4 on common hits, as test_torch_trace)."""
import dataclasses

import numpy as np
import pytest
import torch

from fembrain_tpu.blob import kdtree as jkd
from fembrain_tpu.blob import sketch as jsk
from fembrain_tpu.blob.reader import load_blob as jax_load_blob
from fembrain_tpu.ops.field import field as jax_field
from fembrain_tpu.render.camera import Camera as JaxCamera
from fembrain_tpu.render.camera import generate_rays as jax_rays
from fembrain_tpu.render.pallas_trace import trace_pallas
from fembrain_tpu.utils.ini import SettingsScript as JaxSettings

from fembrain_tpu_torch.blob import kdtree as pkd
from fembrain_tpu_torch.blob import sketch as psk
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.blob.types import OpType, PrimType
from fembrain_tpu_torch.ops.field import field
from fembrain_tpu_torch.render import tile_trace as tt
from fembrain_tpu_torch.utils.ini import SettingsScript

from test_torch_fixtures import BRAIN
from test_torch_trace import _agree

CPU = "cpu"


def _boxes(seed, flat=False):
    rng = np.random.default_rng(seed)
    centers = np.concatenate([
        rng.normal([3, 0, 0], 0.3, (30, 3)),
        rng.normal([-3, 0, 0], 0.3, (30, 3)),
        rng.uniform(-6, 6, (10, 3)),
    ])
    half = rng.uniform(0.05, 0.2, (len(centers), 3))
    if flat:
        half[::7, 1] = 0.0
    return [(c - h, c + h) for c, h in zip(centers, half)]


@pytest.mark.parametrize("seed,method,flat", [
    (0, "sah", False), (1, "sah", True), (2, "median", False),
    (3, "median", True)])
def test_kdtree_picks_box_tests_and_cost_match_jax(seed, method, flat):
    boxes = _boxes(seed, flat)
    pt, jt = (pkd.KDTree(boxes, method=method),
              jkd.KDTree(boxes, method=method))
    assert pt.sah_cost() == jt.sah_cost()
    rng = np.random.default_rng(seed + 10)
    hits = 0
    for _ in range(40):
        o = rng.uniform(-8, 8, 3)
        d = boxes[rng.integers(len(boxes))][0] - o
        a, b = pt.pick(o, d), jt.pick(o, d)
        assert a == b and pt.box_tests == jt.box_tests
        hits += a >= 0
    assert hits > 20


def test_kdtree_sah_beats_median_and_matches_brute_force():
    boxes = _boxes(7)
    sah, med = pkd.KDTree(boxes, method="sah"), pkd.KDTree(boxes,
                                                          method="median")
    rng = np.random.default_rng(8)
    for _ in range(30):
        o = rng.uniform(-8, 8, 3)
        d = boxes[rng.integers(len(boxes))][1] - o
        dn = d / np.linalg.norm(d)
        inv = 1.0 / np.where(np.abs(dn) < 1e-12, 1e-12, dn)
        best, bt = -1, np.inf
        for i, (lo, hi) in enumerate(boxes):
            t = pkd._ray_box_t(o, inv, lo, hi)
            if t is not None and t < bt:
                best, bt = i, t
        assert sah.pick(o, d) == med.pick(o, d) == best
    assert sah.sah_cost() < med.sah_cost()


def _flat_box_scene():
    """Two rows of boxes and, between them, a box of zero extent in x on
    the plane the SAH build splits at."""
    boxes = []
    for i in range(6):
        boxes.append((np.array([-3.0 + 0.3 * i, -1, -1]),
                      np.array([-2.8 + 0.3 * i, 1, 1])))
        boxes.append((np.array([2.0 + 0.3 * i, -1, -1]),
                      np.array([2.2 + 0.3 * i, 1, 1])))
    boxes.append((np.array([0.5, -1, -1]), np.array([0.5, 1, 1])))
    return boxes


def test_kdtree_drops_a_flat_box_on_the_split_plane_in_both_packages():
    """The reference's known fault (fembrain_tpu/blob/kdtree.py:96-97):
    children keep boxes with lo < split or hi > split, so the flat box at
    x = 0.5, on the root's split plane, is in neither child: a ray along
    x that meets it first picks the box behind it."""
    boxes = _flat_box_scene()
    o, d = np.array([-1.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])
    inv = 1.0 / np.where(np.abs(d) < 1e-12, np.copysign(1e-12, d + 1e-15), d)
    for mod in (pkd, jkd):
        ts = [mod._ray_box_t(o, inv, *b) for b in boxes]
        assert ts[12] == 1.5 and min(t for t in ts if t is not None) == 1.5
        tree = mod.KDTree(boxes, leaf_size=4)
        assert (tree.root.axis, tree.root.split) == (0, 0.5)
        assert 12 not in _leaf_items(tree.root)
        assert tree.pick(o, d) == 1       # the right row's first box


def _leaf_items(node):
    if node.items is not None:
        return set(node.items)
    return _leaf_items(node.left) | _leaf_items(node.right)


def _undo_redo(mod, sdef, device_kw, fld):
    sm = mod.SketchMachine(**device_kw)
    sm.add_action(mod.SketchAddPrim(PrimType.POINT, pos=(-0.4, 0, 0)))
    sm.add_action(mod.SketchAddPrim(PrimType.POINT, pos=(0.4, 0, 0)))
    sm.add_action(mod.SketchAddOp(OpType.BLEND, left=0, right=1))
    out = [fld(sm.sync())]
    assert sm.backward()
    assert sm.sync().n_ops == 0
    out.append(fld(sm.sync()))
    assert sm.backward() and sm.sync().n_prims == 1
    assert sm.forward() and sm.forward()
    assert not sm.forward()
    out.append(fld(sm.sync()))
    sm.add_action(mod.SketchTranslate(0, delta=(0.1, 0, 0)))
    out.append(fld(sm.sync()))
    sm.backward()
    out.append(fld(sm.sync()))
    # A new action after an undo drops the undone tail.
    sm.add_action(mod.SketchAddPrim(PrimType.POINT, pos=(0, 0.5, 0)))
    assert len(sm.queue) == 4 and sm.cursor == 4
    out.append(fld(sm.sync()))
    return np.stack(out)


def test_sketch_undo_redo_matches_jax():
    pts = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    got = _undo_redo(psk, None, {"device": CPU},
                     lambda s: field(s, torch.tensor(pts)).numpy())
    ref = _undo_redo(jsk, None, {},
                     lambda s: np.asarray(jax_field(s, pts)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2], got[0], atol=1e-7)   # redo
    np.testing.assert_allclose(got[4], got[2], atol=1e-7)   # untranslate
    assert np.abs(got[3] - got[2]).max() > 1e-3


def _script(mod):
    sm = mod.SketchMachine(**({"device": CPU} if mod is psk else {}))
    sm.add_action(mod.SketchAddPrim(PrimType.POINT, pos=(0.1, 0.2, 0.3)))
    sm.add_action(mod.SketchAddPrim(PrimType.LINE, pos=(0, 0, 0),
                                    dir=(0, 1, 0)))
    sm.add_action(mod.SketchAddOp(OpType.BLEND, left=0, right=1))
    sm.add_action(mod.SketchTranslate(0, delta=(1, 0, -0.5)))
    sm.add_action(mod.SketchTranslate(1, delta=(0, 2, 0)))
    sm.backward()    # only the applied actions are saved
    return sm


def test_action_scripts_cross_packages(tmp_path):
    """A script saved by either package is the same file and is read
    back by the other's SettingsScript."""
    p, j = tmp_path / "port.ini", tmp_path / "jax.ini"
    _script(psk).save_actions(p)
    _script(jsk).save_actions(j)
    assert p.read_bytes() == j.read_bytes()
    for reader, path in ((JaxSettings, p), (SettingsScript, j),
                         (SettingsScript, p)):
        s = reader.load(path)
        assert s.read_int("GLOBAL", "count") == 4
        assert [s.read_str(f"ACTION {i}", "type") for i in range(4)] == [
            "ADDPRIM", "ADDPRIM", "ADDOP", "TRANSLATE"]
        assert s.read_int("ACTION 1", "ptype") == int(PrimType.LINE)
        assert s.read_int_array("ACTION 2", "children") == [0, 1]
        assert s.read_vec3("ACTION 3", "delta") == [1.0, 0.0, -0.5]
        assert s.read_int("ACTION 3", "prim") == 0


@pytest.fixture(scope="module")
def sketched():
    """brain with a POINT just above its top blended onto the old root,
    in both packages."""
    out = {}
    for key, load, mod, kw in (("port", load_blob, psk, {"device": CPU}),
                               ("jax", jax_load_blob, jsk, {})):
        sdef = load(BRAIN)
        sdef.flatten_instances()
        sm = mod.SketchMachine(sdef, **kw)
        n_prims = len(sdef.prims)
        lo, hi = sdef.aabb()
        top = (0.5 * (lo[0] + hi[0]), hi[1] + 0.15, 0.5 * (lo[2] + hi[2]))
        sm.add_action(mod.SketchAddPrim(PrimType.POINT, pos=top))
        sm.add_action(mod.SketchAddOp(OpType.BLEND, left=sdef.root_idx,
                                      left_is_op=True, right=n_prims))
        out[key] = (sm, n_prims, np.asarray(top))
    return out


def test_select_picks_the_new_prim(sketched):
    for key in ("port", "jax"):
        sm, n_prims, top = sketched[key]
        assert sm.select(top + [0.0, 3.0, 0.0], [0.0, -1.0, 0.0]) == n_prims
        assert sm.select(top + [0.0, 3.0, 0.0], [0.0, 1.0, 0.0]) == -1


def test_sketched_pack_matches_jax(sketched):
    ps = sketched["port"][0].sync()
    js = sketched["jax"][0].sync()
    assert ps.n_prims == js.n_prims == sketched["port"][1] + 1
    assert ps.is_additive and js.is_additive
    for f in dataclasses.fields(js):
        a, b = getattr(js, f.name), getattr(ps, f.name)
        if isinstance(b, torch.Tensor):
            assert b.device.type == "cpu"
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f.name)
        else:
            assert a == b, f.name
    assert sketched["port"][0].sync() is ps        # clean: no re-pack


def test_sketched_brain_traced_like_jax_and_undone(sketched):
    sm = sketched["port"][0]
    ro, rd = jax_rays(JaxCamera.orbit(30.0, 20.0, 8.0), 64, 48)
    ro, rd = np.asarray(ro).reshape(-1, 3), np.asarray(rd).reshape(-1, 3)
    ro_t, rd_t = torch.tensor(ro), torch.tensor(rd)
    t_j, h_j = trace_pallas(sketched["jax"][0].sync(), ro, rd,
                            interpret=True, tile=256)
    t_p, h_p = tt.trace_tiles(sm.sync(), ro_t, rd_t, tile=256)
    _agree(np.asarray(h_j), np.asarray(t_j), h_p.numpy(), t_p.numpy())
    edited = int(h_p.sum())
    # Undo both actions: the rest scene and its hits come back.
    assert sm.backward() and sm.backward()
    rest = sm.sync()
    sdef = load_blob(BRAIN)
    sdef.flatten_instances()
    t_r, h_r = tt.trace_tiles(sdef.pack(device=CPU), ro_t, rd_t, tile=256)
    t_u, h_u = tt.trace_tiles(rest, ro_t, rd_t, tile=256)
    assert torch.equal(h_u, h_r) and torch.equal(t_u, t_r)
    assert edited > int(h_u.sum())
    assert sm.forward() and sm.forward()
