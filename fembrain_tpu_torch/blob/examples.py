"""Scenes built in code on top of the repo's brain.blob: the non-additive
scenes the general tile tracer is driven and tested with. Each function
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
