"""PyTorch port: the register-plan (scan) fold and the segmented range
reductions against the unrolled fold and against the JAX package, on
identical numpy inputs made from a seed. Tolerance: 1e-6 absolute on
field values (the three folds add the same float32 terms, in orders that
may differ); 1e-5 relative + 1e-6 absolute on gradients."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fembrain_tpu.blob.scene as jscene
from fembrain_tpu.ops import field as jfield

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch.blob.types import OpType, PrimType
from fembrain_tpu_torch.ops import field as pfield
from fembrain_tpu_torch.render import sphere_trace, tile_trace

from test_torch_fixtures import (
    blend_twist, brain_resection, union_chain_over_100_ops,
)

ATOL = 1e-6
N_POINTS = 400


def _both(make):
    return make(jscene).pack(), make(pscene).pack(device="cpu")


def _points(js, seed, n=N_POINTS):
    lo, hi = np.asarray(js.bbox_lo), np.asarray(js.bbox_hi)
    rng = np.random.default_rng(seed)
    return (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)


@pytest.mark.parametrize("make", [blend_twist, brain_resection,
                                  union_chain_over_100_ops])
def test_scan_fold_equals_unrolled_and_jax(make):
    js, ps = _both(make)
    pts = _points(js, 0)
    ref = np.asarray(jfield.field_via(js, jnp.asarray(pts), "scan"))
    scan = pfield.field_via(ps, torch.tensor(pts), "scan").numpy()
    unrolled = pfield.field_via(ps, torch.tensor(pts), "unrolled").numpy()
    assert ref.max() > 0.5 > ref.min()
    np.testing.assert_allclose(scan, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(scan, unrolled, atol=ATOL, rtol=0)


def test_field_dispatches_by_op_count():
    """Above UNROLL_LIMIT `field` takes the scan fold (and no longer
    raises); `field_rows` keeps its limit; an unknown strategy raises."""
    js, ps = _both(union_chain_over_100_ops)
    assert len(ps.schedule) > pfield.UNROLL_LIMIT
    assert not pfield.supports_rows_fast_path(ps)
    pts = torch.tensor(_points(js, 1))
    assert torch.equal(pfield.field(ps, pts),
                       pfield.field_via(ps, pts, "scan"))
    np.testing.assert_allclose(
        pfield.field(ps, pts).numpy(),
        np.asarray(jfield.field(js, jnp.asarray(pts.numpy()))), atol=ATOL,
        rtol=0)
    with pytest.raises(ValueError):
        pfield.field_rows(ps, pts[:, 0], pts[:, 1], pts[:, 2])
    with pytest.raises(ValueError):
        pfield.field_via(ps, pts, "stack")
    with pytest.raises(ValueError, match="at most 96 ops"):
        tile_trace.prepare_general(ps, pts, pts)
    # trace_fast sends such a scene to the dense tracer.
    ro = torch.tensor([[0.0, -0.7, 4.0], [0.0, 5.0, 4.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    t, hit = tile_trace.trace_fast(ps, ro, rd)
    t_ref, hit_ref = sphere_trace.trace(ps, ro, rd)
    assert hit.tolist() == hit_ref.tolist() == [True, False]
    assert torch.equal(t, t_ref)
    small = blend_twist(pscene).pack(device="cpu")
    assert torch.equal(pfield.field(small, pts),
                       pfield.field_via(small, pts, "unrolled"))


def test_scan_fold_keeps_the_register_bound():
    """The fold holds at most `fold_registers` op values: the plan of the
    103-op chain needs two, and every destination lies inside the file."""
    ps = union_chain_over_100_ops(pscene).pack(device="cpu")
    assert ps.fold_registers == 2
    assert len(ps.fold_plan) == len(ps.schedule) == 103
    assert all(0 <= step[2] < ps.fold_registers for step in ps.fold_plan)


RANGE_OPS = [OpType.UNION, OpType.INTERSECT, OpType.BLEND,
             OpType.RICCI_BLEND]


def ranges_scene(mod):
    """Four range ops of three prims each (UNION, INTERSECT, BLEND, Ricci
    with p = 2), joined by binary BLENDs; two prims belong to no range."""
    sc = mod.SceneDef()
    rng = np.random.default_rng(5)
    for _ in range(14):
        sc.add_prim(mod.PrimDef(PrimType.POINT,
                                pos=rng.uniform(-0.5, 0.5, 3)))
    ops = []
    for i, op in enumerate(RANGE_OPS):
        ops.append(sc.add_op(mod.OpDef(
            op, left=3 * i, right=3 * i + 2, is_range=True,
            params=np.array([2.0, 0.5, 0.0, 0.0]))))
    top = sc.add_op(mod.OpDef(OpType.BLEND, left=12, right=13))
    for k in ops:
        top = sc.add_op(mod.OpDef(OpType.BLEND, left=top, left_is_op=True,
                                  right=k, right_is_op=True))
    sc.root_idx, sc.root_is_op = top, True
    return sc


@pytest.fixture(scope="module")
def ranges():
    js, ps = _both(ranges_scene)
    # Prim fields in (0.05, 1): distinct, so no reduction sees a tie.
    pf = np.random.default_rng(6).uniform(
        0.05, 1.0, (64, js.capacity_prims)).astype(np.float32)
    return js, ps, pf


@pytest.mark.parametrize("slot", range(4), ids=[o.name for o in RANGE_OPS])
def test_range_values_segmented_per_op_type(ranges, slot):
    js, ps, pf = ranges
    ref = np.asarray(jfield._range_values_segmented(js, jnp.asarray(pf)))
    got = pfield._range_values_segmented(ps, torch.tensor(pf)).numpy()
    assert got.shape == ref.shape == (4, 64)
    cols = pf[:, 3 * slot : 3 * slot + 3]
    own = {0: cols.max(1), 1: cols.min(1), 2: cols.sum(1),
           3: np.sqrt((cols ** 2).sum(1))}[slot]
    np.testing.assert_allclose(got[slot], own, rtol=1e-6)
    np.testing.assert_allclose(got[slot], ref[slot], atol=ATOL, rtol=0)


def test_range_values_gradient_away_from_ties(ranges):
    js, ps, pf = ranges
    wgt = np.random.default_rng(7).normal(size=(4, 64)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(
        jfield._range_values_segmented(js, x) * wgt))(jnp.asarray(pf)))
    x = torch.tensor(pf, requires_grad=True)
    torch.sum(pfield._range_values_segmented(ps, x)
              * torch.tensor(wgt)).backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5, atol=1e-6)
    # Prims outside every range take no gradient.
    assert float(x.grad[:, 12:].abs().max()) == 0.0


def test_scan_fold_gradient_matches_jax():
    """d field / d points through the scan fold, at random points (no two
    union operands tie there), where the reference is finite: the segmented
    reduction takes the Ricci root of every range's power sum before it
    selects by op type, and the root's slope at 0 is infinite, so the
    gradient is NaN wherever any range's prims all vanish. Half of the
    points lie within the reach of both ranges' spheres."""
    from fembrain_tpu_torch.blob import examples

    js, ps = _both(union_chain_over_100_ops)
    pts = _points(js, 2)
    near = np.array([examples.chain_point(examples.CHAIN_BLEND - 1 + i % 2)
                     for i in range(N_POINTS // 2)], np.float32)
    pts[: N_POINTS // 2] = near + np.random.default_rng(8).uniform(
        -0.3, 0.3, near.shape).astype(np.float32)
    ref = np.asarray(jax.vmap(jax.grad(
        lambda p: jfield.field_via(js, p[None], "scan")[0]))(
            jnp.asarray(pts)))
    x = torch.tensor(pts, requires_grad=True)
    (g,) = torch.autograd.grad(pfield.field_via(ps, x, "scan").sum(), x)
    ok = np.isfinite(ref).all(1)
    assert ok.sum() > N_POINTS // 4 and np.abs(ref[ok]).max() > 0.1
    np.testing.assert_allclose(g.numpy()[ok], ref[ok], rtol=1e-5, atol=1e-5)
