"""Scenes built in code: the non-additive scenes on top of the repo's
brain.blob that the general tile tracer is driven and tested with, and a
union chain deeper than the unrolled fold takes. Each function
returns an unpacked `SceneDef`. The numbers that define a scene are
module constants, so other code that makes the same scene can share them."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .reader import load_blob
from .scene import OpDef, PrimDef, SceneDef
from .types import OpType, PrimType

BRAIN = (Path(__file__).resolve().parents[2]
         / "data" / "models" / "blobtree" / "brain.blob")

# The resection channel: a cylinder at pos along dir, res = radius, length.
RESECTION_POS = (0.3, 0.4, 0.2)
RESECTION_DIR = (0.0, 1.0, 0.0)
RESECTION_RES = (0.35, 1.2, 0.0, 0.0)
# The twisted blend: two points on the x axis and the twist's parameters.
TWIST_POINTS = ((-0.4, 0.0, 0.0), (0.4, 0.0, 0.0))
TWIST_PARAMS = (0.9, 0.0, 0.0, 0.0)
# The union chain: CHAIN_LINKS spheres on a helix, each joined to the rest
# by one binary UNION; the first link is a range BLEND over CHAIN_BLEND
# spheres and the second a Ricci range blend over CHAIN_RICCI more.
CHAIN_LINKS = 100
CHAIN_BLEND = 3
CHAIN_RICCI = 3
CHAIN_RICCI_PARAMS = (2.0, 0.5, 0.0, 0.0)


def chain_point(i: int) -> tuple[float, float, float]:
    """Position of the union chain's i-th sphere: a helix about y."""
    a = 0.45 * i
    return (0.9 * float(np.cos(a)), -0.8 + 0.016 * i, 0.9 * float(np.sin(a)))


def brain_resection() -> SceneDef:
    """brain.blob (a root BLEND over 163 prims) cut by a DIF with one
    cylinder: a surgical channel through the cortex."""
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    cyl = sc.add_prim(PrimDef(PrimType.CYLINDER,
                              pos=np.array(RESECTION_POS),
                              dir=np.array(RESECTION_DIR),
                              res=np.array(RESECTION_RES)))
    sc.root_idx = sc.add_op(OpDef(OpType.DIF, left=sc.root_idx,
                                  left_is_op=True, right=cyl))
    return sc


def blend_twist() -> SceneDef:
    """Two points under a BLEND, twisted about x (a warp chain)."""
    sc = SceneDef()
    for pos in TWIST_POINTS:
        sc.add_prim(PrimDef(PrimType.POINT, pos=np.array(pos)))
    blend = sc.add_op(OpDef(OpType.BLEND, left=0, right=1))
    sc.root_idx = sc.add_op(OpDef(
        OpType.WARP_TWIST, left=blend, left_is_op=True, is_unary=True,
        params=np.array(TWIST_PARAMS)))
    sc.root_is_op = True
    return sc


def union_chain_over_100_ops() -> SceneDef:
    """A left-deep chain of CHAIN_LINKS binary UNIONs over spheres on a
    helix, with one range BLEND and one Ricci range blend at its start:
    CHAIN_LINKS + 3 scheduled ops, more than the unrolled fold (and the
    general tile tracer) takes, so `field` folds it through the register
    plan and `trace_fast` sends it to the dense tracer."""
    sc = SceneDef()
    n = CHAIN_BLEND + CHAIN_RICCI + CHAIN_LINKS
    for i in range(n):
        sc.add_prim(PrimDef(PrimType.POINT, pos=np.array(chain_point(i))))
    blend = sc.add_op(OpDef(OpType.BLEND, left=0, right=CHAIN_BLEND - 1,
                            is_range=True))
    ricci = sc.add_op(OpDef(OpType.RICCI_BLEND, left=CHAIN_BLEND,
                            right=CHAIN_BLEND + CHAIN_RICCI - 1,
                            is_range=True,
                            params=np.array(CHAIN_RICCI_PARAMS)))
    top = sc.add_op(OpDef(OpType.UNION, left=blend, left_is_op=True,
                          right=ricci, right_is_op=True))
    for i in range(CHAIN_BLEND + CHAIN_RICCI, n):
        top = sc.add_op(OpDef(OpType.UNION, left=top, left_is_op=True,
                              right=i))
    sc.root_idx, sc.root_is_op = top, True
    return sc
