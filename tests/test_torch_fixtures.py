"""Scenes built in code for the port's tests. Each builder takes the
scene module of either package (`fembrain_tpu.blob.scene` or
`fembrain_tpu_torch.blob.scene`), so both build the same scene. This file
imports no JAX: the card-only tests and chip_smoke.py use it where JAX is
not installed."""
import importlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch.blob.types import OpType, PrimType

BRAIN = Path(__file__).resolve().parent.parent / "data/models/blobtree/brain.blob"

# Under pytest-xdist several workers share the host's cores; PyTorch's CPU
# pool would start one thread per core in each worker and oversubscribe
# them (every test_torch_* module imports this one).
if "PYTEST_XDIST_WORKER" in os.environ:
    torch.set_num_threads(1)


def small_blend(mod):
    """Four points and one cylinder under one BLEND."""
    sc = mod.SceneDef()
    for x, y in ((-0.5, 0.0), (0.5, 0.0), (0.0, 0.45), (0.1, -0.4)):
        sc.add_prim(mod.PrimDef(PrimType.POINT, pos=np.array([x, y, 0.0])))
    sc.add_prim(mod.PrimDef(PrimType.CYLINDER, pos=np.array([0.0, -0.3, 0.2]),
                            dir=np.array([0.0, 1.0, 0.0]),
                            res=np.array([0.15, 0.6, 0.0, 0.0])))
    sc.add_op(mod.OpDef(OpType.BLEND, left=0, right=4, is_range=True))
    sc.root_is_op, sc.root_idx = True, 0
    return sc


def every_type(mod, op=OpType.BLEND):
    """One prim of every skeleton type (plus a quadric point and a NULL)
    under one range op (BLEND by default), with a non-trivial transform on
    some of them."""
    sc = mod.SceneDef()
    rot = np.eye(4)
    rot[:3, :3] = [[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]]
    rot[:3, 3] = [0.1, -0.2, 0.05]
    prims = [
        mod.PrimDef(PrimType.POINT, pos=np.array([-0.6, 0.0, 0.0])),
        mod.PrimDef(PrimType.LINE, pos=np.array([0.0, -0.5, 0.0]),
                    dir=np.array([0.3, 0.5, 0.1])),
        mod.PrimDef(PrimType.CYLINDER, pos=np.array([0.5, -0.3, 0.0]),
                    dir=np.array([0.0, 0.0, 1.0]),
                    res=np.array([0.2, 0.4, 0.0, 0.0])),
        mod.PrimDef(PrimType.DISC, pos=np.array([0.0, 0.6, 0.0]),
                    dir=np.array([0.0, 1.0, 0.0]),
                    res=np.array([0.4, 0.0, 0.0, 0.0])),
        mod.PrimDef(PrimType.RING, pos=np.array([0.0, 0.0, 0.6]),
                    dir=np.array([0.0, 0.0, 1.0]),
                    res=np.array([0.35, 0.0, 0.0, 0.0])),
        mod.PrimDef(PrimType.CUBE, pos=np.array([-0.4, -0.5, 0.3]),
                    res=np.array([0.15, 0.0, 0.0, 0.0]), bwd=rot,
                    fwd=np.linalg.inv(rot)),
        mod.PrimDef(PrimType.TRIANGLE, pos=np.array([0.2, 0.2, -0.4]),
                    dir=np.array([0.6, 0.1, -0.3]),
                    res=np.array([0.3, 0.6, -0.5, 0.0])),
        mod.PrimDef(PrimType.QUADRIC_POINT, pos=np.array([0.4, 0.4, 0.4]),
                    dir=np.array([0.0, 0.0, 0.09]),
                    res=np.array([2.0, -1.5, 0.6, 0.0])),
        mod.PrimDef(PrimType.NULL),
    ]
    for p in prims:
        sc.add_prim(p)
    sc.add_op(mod.OpDef(op, left=0, right=len(prims) - 1, is_range=True))
    sc.root_is_op, sc.root_idx = True, 0
    return sc


def brain_resection(mod):
    """brain.blob (a root BLEND over 163 prims) cut by a DIF with one
    cylinder: a surgical channel through the cortex."""
    reader = importlib.import_module(mod.__name__.rsplit(".", 1)[0] + ".reader")
    sc = reader.load_blob(BRAIN)
    sc.flatten_instances()
    cyl = sc.add_prim(mod.PrimDef(PrimType.CYLINDER,
                                  pos=np.array([0.3, 0.4, 0.2]),
                                  dir=np.array([0.0, 1.0, 0.0]),
                                  res=np.array([0.35, 1.2, 0.0, 0.0])))
    sc.root_idx = sc.add_op(mod.OpDef(OpType.DIF, left=sc.root_idx,
                                      left_is_op=True, right=cyl))
    return sc


def blend_twist(mod):
    """Two points under a BLEND, twisted about x (a warp chain)."""
    sc = mod.SceneDef()
    sc.add_prim(mod.PrimDef(PrimType.POINT, pos=np.array([-0.4, 0.0, 0.0])))
    sc.add_prim(mod.PrimDef(PrimType.POINT, pos=np.array([0.4, 0.0, 0.0])))
    blend = sc.add_op(mod.OpDef(OpType.BLEND, left=0, right=1))
    sc.root_idx = sc.add_op(mod.OpDef(
        OpType.WARP_TWIST, left=blend, left_is_op=True, is_unary=True,
        params=np.array([0.9, 0.0, 0.0, 0.0])))
    sc.root_is_op = True
    return sc


def dif_scene(mod):
    """A small CSG tree: three blended points minus a cylinder, unioned
    with a Ricci blend (p = 2) of two more points."""
    sc = mod.SceneDef()
    for pos in ((-0.3, 0.0, 0.0), (0.3, 0.0, 0.0), (0.0, 0.3, 0.0)):
        sc.add_prim(mod.PrimDef(PrimType.POINT, pos=np.array(pos)))
    cyl = sc.add_prim(mod.PrimDef(PrimType.CYLINDER,
                                  pos=np.array([0.0, -0.6, 0.2]),
                                  dir=np.array([0.0, 1.0, 0.0]),
                                  res=np.array([0.15, 1.2, 0.0, 0.0])))
    a = sc.add_prim(mod.PrimDef(PrimType.POINT, pos=np.array([0.7, -0.4, 0.1])))
    b = sc.add_prim(mod.PrimDef(PrimType.POINT, pos=np.array([0.6, -0.5, 0.3])))
    blend = sc.add_op(mod.OpDef(OpType.BLEND, left=0, right=2, is_range=True))
    cut = sc.add_op(mod.OpDef(OpType.DIF, left=blend, left_is_op=True,
                              right=cyl))
    ricci = sc.add_op(mod.OpDef(OpType.RICCI_BLEND, left=a, right=b,
                                params=np.array([2.0, 0.5, 0.0, 0.0])))
    sc.root_idx = sc.add_op(mod.OpDef(OpType.UNION, left=cut, left_is_op=True,
                                      right=ricci, right_is_op=True))
    sc.root_is_op = True
    return sc


def graph_size(t):
    """Number of autograd nodes behind tensor t."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return len(seen)


@pytest.mark.parametrize("make", [small_blend, every_type])
def test_fixture_scenes_are_valid_and_additive(make):
    sc = make(pscene)
    assert sc.validate() == []
    ps = sc.pack(device="cpu")
    assert ps.is_additive and ps.can_cull and ps.monotone_field
    assert ps.n_prims == len(sc.prims)


@pytest.mark.parametrize("make,cull,monotone", [
    (brain_resection, True, False),
    (blend_twist, False, False),
    (dif_scene, True, False),
    (lambda mod: every_type(mod, OpType.UNION), True, True),
])
def test_general_fixture_scenes(make, cull, monotone):
    """The scenes of the general kernel: valid, not additive, with the
    cull and step regime each is meant to exercise."""
    sc = make(pscene)
    assert sc.validate() == []
    ps = sc.pack(device="cpu")
    assert not ps.is_additive
    assert (ps.can_cull, ps.monotone_field) == (cull, monotone)
