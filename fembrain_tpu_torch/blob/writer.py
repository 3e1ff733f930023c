"""`.blob` scene-file writer (round-trip counterpart of blob.reader).

Emits the reference's INI format (FileVersion 6, [BLOBNODE i] sections,
[Global]) so scenes authored or edited in this framework load in the
reference app and vice versa (format: ReadSceneModel.cpp:238-748).
Counterpart of fembrain_tpu/blob/writer.py: host Python over the port's
SceneDef, the same text.
"""
from __future__ import annotations

from pathlib import Path

from .scene import PrimDef, SceneDef
from .types import OP_TYPE_TO_NAME, PRIM_TYPE_TO_NAME, OpType, PrimType
from ..utils.ini import SettingsScript


def save_blob(scene: SceneDef, path: str | Path) -> None:
    s = SettingsScript()
    next_id = [0]
    written_prims = 0
    written_ops = 0

    def write_affine(sec: str, prim: PrimDef | None):
        if prim is not None and getattr(prim, "affine", None):
            scale, rot, trans = prim.affine
        else:
            scale, rot, trans = (1, 1, 1), (0, 0, 0, 1), (0, 0, 0)
        s.write_value(sec, "AffineScale", list(scale))
        s.write_value(sec, "AffineRotate", list(rot))
        s.write_value(sec, "AffineTranslate", list(trans))

    def write_prim(idx: int) -> int:
        nonlocal written_prims
        nid = next_id[0]
        next_id[0] += 1
        p = scene.prims[idx]
        sec = f"BLOBNODE {nid}"
        s.write_value(sec, "IsOperator", False)
        write_affine(sec, p)
        s.write_value(sec, "MtrlAmbient", [c * 0.5 for c in p.color])
        s.write_value(sec, "MtrlDiffused", list(p.color))
        s.write_value(sec, "MtrlSpecular", [1.0, 1.0, 1.0, 1.0])
        s.write_value(sec, "MtrlShininess", 32.0)
        s.write_value(sec, "PrimitiveType", PRIM_TYPE_TO_NAME[p.ptype])
        t = p.ptype
        if t == PrimType.POINT:
            s.write_value(sec, "position", list(p.pos))
        elif t == PrimType.LINE:
            s.write_value(sec, "start", list(p.pos))
            s.write_value(sec, "end", list(p.dir))
        elif t in (PrimType.RING, PrimType.DISC):
            s.write_value(sec, "position", list(p.pos))
            s.write_value(sec, "direction", list(p.dir))
            s.write_value(sec, "radius", float(p.res[0]))
        elif t == PrimType.CYLINDER:
            s.write_value(sec, "position", list(p.pos))
            s.write_value(sec, "direction", list(p.dir))
            s.write_value(sec, "radius", float(p.res[0]))
            s.write_value(sec, "height", float(p.res[1]))
        elif t == PrimType.CUBE:
            s.write_value(sec, "position", list(p.pos))
            s.write_value(sec, "side", float(p.res[0]))
        elif t == PrimType.TRIANGLE:
            s.write_value(sec, "corner0", list(p.pos))
            s.write_value(sec, "corner1", list(p.dir))
            s.write_value(sec, "corner2", list(p.res[:3]))
        elif t == PrimType.QUADRIC_POINT:
            s.write_value(sec, "position", list(p.pos))
            s.write_value(sec, "scale", float(p.dir[0]))
            s.write_value(sec, "radius", float(p.dir[1]))
        written_prims += 1
        return nid

    def write_op(idx: int) -> int:
        nonlocal written_ops
        op = scene.ops[idx]
        # Children are written before the op references them by id, but
        # the reference reads root-first recursively, so section order is
        # irrelevant — only ids matter. Reserve our id first.
        nid = next_id[0]
        next_id[0] += 1
        sec = f"BLOBNODE {nid}"
        s.write_value(sec, "IsOperator", True)
        write_affine(sec, None)
        s.write_value(sec, "OperatorType", OP_TYPE_TO_NAME[op.otype])
        if op.otype == OpType.RICCI_BLEND:
            s.write_value(sec, "power", float(op.params[0]))
        elif op.otype == OpType.WARP_TWIST:
            s.write_value(sec, "factor", float(op.params[0]))
            s.write_value(sec, "axis", int(op.params[1]))
        elif op.otype == OpType.WARP_TAPER:
            s.write_value(sec, "factor", float(op.params[0]))
            s.write_value(sec, "base axis", int(op.params[1]))
            s.write_value(sec, "taper axis", int(op.params[2]))
        elif op.otype == OpType.WARP_BEND:
            s.write_value(sec, "rate", float(op.params[0]))
            s.write_value(sec, "center", float(op.params[1]))
            s.write_value(sec, "left bound", float(op.params[2]))
            s.write_value(sec, "right bound", float(op.params[3]))
        elif op.otype == OpType.WARP_SHEAR:
            s.write_value(sec, "factor", float(op.params[0]))
            s.write_value(sec, "base axis", int(op.params[1]))
            s.write_value(sec, "shear axis", int(op.params[2]))

        if op.is_range:
            ids = [write_prim(i) for i in range(op.left, op.right + 1)]
            s.write_value(sec, "ChildrenCount", len(ids))
            s.write_value(sec, "ChildrenIDsUseRange", True)
            s.write_value(sec, "ChildrenIDsRange", [ids[0], ids[-1]])
        else:
            lid = write_op(op.left) if op.left_is_op else write_prim(op.left)
            ids = [lid]
            if not op.is_unary:
                rid = (
                    write_op(op.right)
                    if op.right_is_op
                    else write_prim(op.right)
                )
                ids.append(rid)
            s.write_value(sec, "ChildrenCount", len(ids))
            s.write_value(sec, "ChildrenIDs", ids)
        written_ops += 1
        return nid

    root = (
        write_op(scene.root_idx)
        if scene.root_is_op
        else write_prim(scene.root_idx)
    )
    s.write_value("Global", "FileVersion", 6)
    s.write_value("Global", "NumLayers", 1)
    s.write_value("Global", "CurrentLayer", 1)
    s.write_value("Global", "CountPrimitives", written_prims)
    s.write_value("Global", "CountOperators", written_ops)
    s.write_value("Global", "Depth", 1)
    s.write_value("Global", "RootIDs", [root])
    s.save(path)
