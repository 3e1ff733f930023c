"""Scenes built in code for the port's tests. Each function takes the
scene module of either package (`fembrain_tpu.blob.scene` or
`fembrain_tpu_torch.blob.scene`), so both build the same scene. This file
imports no JAX: the card-only tests use it where JAX is
not installed. The two scenes chip_smoke.py drives as well also have a
function in the port (`fembrain_tpu_torch.blob.examples`, the port's own
scene module only), as has the union chain; the functions here share its constants and are held to
it below."""
import dataclasses
import importlib
import inspect
import os

import numpy as np
import pytest
import torch

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch.blob import examples
from fembrain_tpu_torch.blob.examples import BRAIN
from fembrain_tpu_torch.blob.types import OpType, PrimType

# Under pytest-xdist several workers share the host's cores; PyTorch's CPU
# pool would start one thread per core in each worker and oversubscribe
# them (every test_torch_* module imports this one).
if "PYTEST_XDIST_WORKER" in os.environ:
    torch.set_num_threads(1)


def brain_resection(mod):
    """brain.blob cut by a DIF with one cylinder, as
    `examples.brain_resection`, built with package `mod`'s reader and
    scene classes."""
    reader = importlib.import_module(mod.__name__.rsplit(".", 1)[0] + ".reader")
    sc = reader.load_blob(BRAIN)
    sc.flatten_instances()
    cyl = sc.add_prim(mod.PrimDef(PrimType.CYLINDER,
                                  pos=np.array(examples.RESECTION_POS),
                                  dir=np.array(examples.RESECTION_DIR),
                                  res=np.array(examples.RESECTION_RES)))
    sc.root_idx = sc.add_op(mod.OpDef(OpType.DIF, left=sc.root_idx,
                                      left_is_op=True, right=cyl))
    return sc


def blend_twist(mod):
    """Two points under a BLEND, twisted about x, as
    `examples.blend_twist`."""
    sc = mod.SceneDef()
    for pos in examples.TWIST_POINTS:
        sc.add_prim(mod.PrimDef(PrimType.POINT, pos=np.array(pos)))
    blend = sc.add_op(mod.OpDef(OpType.BLEND, left=0, right=1))
    sc.root_idx = sc.add_op(mod.OpDef(
        OpType.WARP_TWIST, left=blend, left_is_op=True, is_unary=True,
        params=np.array(examples.TWIST_PARAMS)))
    sc.root_is_op = True
    return sc


def union_chain_over_100_ops(mod):
    """A left-deep chain of binary UNIONs over spheres on a helix with a
    range BLEND and a Ricci range blend at its start, as
    `examples.union_chain_over_100_ops`: more ops than the unrolled fold
    takes."""
    sc = mod.SceneDef()
    nb, nr = examples.CHAIN_BLEND, examples.CHAIN_RICCI
    n = nb + nr + examples.CHAIN_LINKS
    for i in range(n):
        sc.add_prim(mod.PrimDef(PrimType.POINT,
                                pos=np.array(examples.chain_point(i))))
    blend = sc.add_op(mod.OpDef(OpType.BLEND, left=0, right=nb - 1,
                                is_range=True))
    ricci = sc.add_op(mod.OpDef(
        OpType.RICCI_BLEND, left=nb, right=nb + nr - 1, is_range=True,
        params=np.array(examples.CHAIN_RICCI_PARAMS)))
    top = sc.add_op(mod.OpDef(OpType.UNION, left=blend, left_is_op=True,
                              right=ricci, right_is_op=True))
    for i in range(nb + nr, n):
        top = sc.add_op(mod.OpDef(OpType.UNION, left=top, left_is_op=True,
                                  right=i))
    sc.root_idx, sc.root_is_op = top, True
    return sc


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
    (union_chain_over_100_ops, True, True),
])
def test_general_fixture_scenes(make, cull, monotone):
    """The scenes of the general kernel: valid, not additive, with the
    cull and step regime each is meant to exercise."""
    sc = make(pscene)
    assert sc.validate() == []
    ps = sc.pack(device="cpu")
    assert not ps.is_additive
    assert (ps.can_cull, ps.monotone_field) == (cull, monotone)


@pytest.mark.parametrize("name", ["brain_resection", "blend_twist",
                                  "union_chain_over_100_ops"])
def test_port_examples_build_the_fixture_scenes(name):
    """The port's own functions (what chip_smoke.py drives) and the
    two-package ones here give the same packed scene, bit for bit."""
    a = getattr(examples, name)().pack(device="cpu")
    b = globals()[name](pscene).pack(device="cpu")
    n = 0
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), f.name
            n += 1
        else:
            assert va == vb, f.name
    assert n > 5


def test_port_examples_import_no_other_package():
    """`blob/examples.py` takes no module argument and imports only the
    port: no `importlib`, no name of the JAX package."""
    src = (BRAIN.parents[3] / "fembrain_tpu_torch" / "blob"
           / "examples.py").read_text()
    assert "importlib" not in src and "jax" not in src
    assert "fembrain_tpu." not in src and "import fembrain_tpu\n" not in src
    assert inspect.signature(examples.brain_resection).parameters == {}
    assert inspect.signature(examples.blend_twist).parameters == {}
    assert inspect.signature(
        examples.union_chain_over_100_ops).parameters == {}
