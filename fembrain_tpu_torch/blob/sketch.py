"""SketchMachine: live scene editing with an undo/redo action queue.

Port of the reference's `SketchMachine` singleton + `SketchAction` command
objects (src/implicit/SketchMachine.{h,cpp}:36-150,
src/implicit/SketchAction.h:28-112): actions mutate the SceneDef, `sync()`
re-packs the device scene (the analog of re-uploading blob arrays +
re-polygonizing), `forward`/`backward` replay/unwind the queue, and
actions serialize to an INI script for replayable incremental modeling.

Counterpart of fembrain_tpu/blob/sketch.py: the scene definition is host
numpy, and `sync()` packs it onto the machine's device (the card unless
the caller names another).
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import default_device
from .scene import OpDef, PrimDef, Scene, SceneDef
from .types import OpType, PrimType
from ..utils.affine import compose_trs
from ..utils.ini import SettingsScript


class SketchAction:
    def execute(self, scene: SceneDef) -> None:
        raise NotImplementedError

    def unexecute(self, scene: SceneDef) -> None:
        raise NotImplementedError

    def store(self, s: SettingsScript, idx: int) -> None:
        raise NotImplementedError


@dataclass
class SketchAddPrim(SketchAction):
    ptype: PrimType
    pos: tuple = (0.0, 0.0, 0.0)
    dir: tuple = (0.0, 0.0, 1.0)
    res: tuple = (0.0, 0.0, 0.0, 0.0)
    color: tuple = (0.0, 0.6, 0.0, 1.0)
    _added: int = -1

    def execute(self, scene: SceneDef) -> None:
        prim = PrimDef(
            self.ptype,
            pos=np.asarray(self.pos, np.float64),
            dir=np.asarray(self.dir, np.float64),
            res=np.asarray(self.res, np.float64),
            color=np.asarray(self.color, np.float64),
        )
        self._added = scene.add_prim(prim)
        if not scene.prims or len(scene.prims) == 1:
            scene.root_is_op, scene.root_idx = False, 0

    def unexecute(self, scene: SceneDef) -> None:
        assert self._added == len(scene.prims) - 1, "non-LIFO undo"
        scene.prims.pop()

    def store(self, s: SettingsScript, idx: int) -> None:
        sec = f"ACTION {idx}"
        s.write_value(sec, "type", "ADDPRIM")
        s.write_value(sec, "ptype", int(self.ptype))
        s.write_value(sec, "pos", list(self.pos))
        s.write_value(sec, "dir", list(self.dir))
        s.write_value(sec, "res", list(self.res))


@dataclass
class SketchAddOp(SketchAction):
    otype: OpType
    left: int = -1
    right: int = -1
    left_is_op: bool = False
    right_is_op: bool = False
    params: tuple = (0.0, 0.0, 0.0, 0.0)
    make_root: bool = True
    _added: int = -1
    _old_root: tuple | None = None

    def execute(self, scene: SceneDef) -> None:
        op = OpDef(
            self.otype,
            left=self.left,
            right=self.right,
            left_is_op=self.left_is_op,
            right_is_op=self.right_is_op,
            is_unary=self.otype
            in (OpType.WARP_TWIST, OpType.WARP_TAPER, OpType.WARP_BEND,
                OpType.WARP_SHEAR, OpType.CACHE),
            params=np.asarray(self.params, np.float64),
        )
        self._added = scene.add_op(op)
        if self.make_root:
            self._old_root = (scene.root_is_op, scene.root_idx)
            scene.root_is_op, scene.root_idx = True, self._added

    def unexecute(self, scene: SceneDef) -> None:
        assert self._added == len(scene.ops) - 1, "non-LIFO undo"
        scene.ops.pop()
        if self._old_root is not None:
            scene.root_is_op, scene.root_idx = self._old_root

    def store(self, s: SettingsScript, idx: int) -> None:
        sec = f"ACTION {idx}"
        s.write_value(sec, "type", "ADDOP")
        s.write_value(sec, "otype", int(self.otype))
        s.write_value(sec, "children", [self.left, self.right])


@dataclass
class SketchTranslate(SketchAction):
    prim_idx: int
    delta: tuple = (0.0, 0.0, 0.0)

    def _shift(self, scene: SceneDef, sign: float) -> None:
        p = scene.prims[self.prim_idx]
        d = sign * np.asarray(self.delta, np.float64)
        if p.affine is None:
            p.affine = ((1, 1, 1), (0, 0, 0, 1), (0, 0, 0))
        scale, rot, trans = p.affine
        trans = tuple(np.asarray(trans, np.float64) + d)
        p.affine = (scale, rot, trans)
        p.fwd, p.bwd = compose_trs(trans, rot, scale)

    def execute(self, scene: SceneDef) -> None:
        self._shift(scene, +1.0)

    def unexecute(self, scene: SceneDef) -> None:
        self._shift(scene, -1.0)

    def store(self, s: SettingsScript, idx: int) -> None:
        sec = f"ACTION {idx}"
        s.write_value(sec, "type", "TRANSLATE")
        s.write_value(sec, "prim", self.prim_idx)
        s.write_value(sec, "delta", list(self.delta))


class SketchMachine:
    """Owns the live SceneDef + its packed device Scene; queue semantics
    mirror the reference (addAction/forward/backward/sync). The scene is
    packed on `device` (the card when None)."""

    def __init__(self, scene: SceneDef | None = None, device=None):
        self.device = default_device() if device is None else device
        self.scene_def = scene or SceneDef()
        self.queue: list[SketchAction] = []
        self.cursor = 0  # actions [0, cursor) are applied
        self._packed: Scene | None = None
        self.dirty = True

    def add_action(self, action: SketchAction) -> None:
        # Adding truncates any undone tail (standard undo semantics).
        del self.queue[self.cursor :]
        action.execute(self.scene_def)
        self.queue.append(action)
        self.cursor += 1
        self.dirty = True

    def backward(self) -> bool:
        if self.cursor == 0:
            return False
        self.cursor -= 1
        self.queue[self.cursor].unexecute(self.scene_def)
        self.dirty = True
        return True

    def forward(self) -> bool:
        if self.cursor >= len(self.queue):
            return False
        self.queue[self.cursor].execute(self.scene_def)
        self.cursor += 1
        self.dirty = True
        return True

    def sync(self) -> Scene:
        """Re-pack the device scene (reference sync() re-uploads + re-runs
        the polygonizer, SketchMachine.cpp:126-150)."""
        if self.dirty or self._packed is None:
            self._packed = self.scene_def.pack(device=self.device)
            self.dirty = False
        return self._packed

    def select(self, origin, direction) -> int:
        """Ray-pick a primitive by AABB (reference select(),
        SketchMachine.cpp:107-124); returns prim index or -1."""
        from .kdtree import KDTree

        if not self.scene_def.prims:
            return -1
        boxes = [
            self.scene_def.prim_aabb(i)
            for i in range(len(self.scene_def.prims))
        ]
        tree = KDTree(boxes)
        return tree.pick(origin, direction)

    def save_actions(self, path: str | Path) -> None:
        s = SettingsScript()
        s.write_value("GLOBAL", "count", self.cursor)
        for i, a in enumerate(self.queue[: self.cursor]):
            a.store(s, i)
        s.save(path)
