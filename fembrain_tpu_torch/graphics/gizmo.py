"""Gizmo manager: routes manipulation commands to the focused node.

Headless analog of the reference's widget system (src/graphics/Gizmo.h:
28-130, Gizmo.cpp): `TheGizmoManager` keeps a focused node and a gizmo
type (translate/rotate/scale/avatar) and forwards mouse drags to
`IGizmoListener::onTranslate` — which is exactly how the haptic tools are
driven (SURVEY §3.4). Here the drags are programmatic `apply(delta)`
calls; listeners implement `on_translate/on_rotate/on_scale`.

Counterpart of fembrain_tpu/graphics/gizmo.py: numpy on the host.
"""
from __future__ import annotations

import enum
from typing import Protocol, runtime_checkable

import numpy as np


class GizmoType(enum.Enum):
    TRANSLATE = 0
    ROTATE = 1
    SCALE = 2
    AVATAR = 3


class GizmoAxis(enum.Enum):
    X = 0
    Y = 1
    Z = 2
    FREE = 3


@runtime_checkable
class IGizmoListener(Protocol):
    """Manipulation callbacks (reference IGizmoListener, Gizmo.h:28)."""

    def on_translate(self, delta: np.ndarray, pos: np.ndarray) -> None: ...

    def on_rotate(self, quat: np.ndarray) -> None: ...

    def on_scale(self, scale: np.ndarray) -> None: ...


_AXIS_MASK = {
    GizmoAxis.X: np.array([1.0, 0.0, 0.0]),
    GizmoAxis.Y: np.array([0.0, 1.0, 0.0]),
    GizmoAxis.Z: np.array([0.0, 0.0, 1.0]),
    GizmoAxis.FREE: np.array([1.0, 1.0, 1.0]),
}


class GizmoManager:
    """Focused-node manipulation router (reference TheGizmoManager)."""

    def __init__(self):
        self.gizmo_type = GizmoType.TRANSLATE
        self.axis = GizmoAxis.FREE
        self._focused = None           # object with set/get translation
        self._listeners: list[IGizmoListener] = []
        self.pos = np.zeros(3)         # widget anchor (world)

    # -- focus ---------------------------------------------------------
    def set_focused(self, node) -> None:
        self._focused = node
        if node is not None and hasattr(node, "translation"):
            self.pos = np.asarray(node.translation(), np.float64)

    def focused(self):
        return self._focused

    def register(self, listener: IGizmoListener) -> None:
        self._listeners.append(listener)

    # -- manipulation --------------------------------------------------
    def apply(self, delta) -> np.ndarray:
        """Apply a drag `delta` under the current gizmo type/axis; moves
        the focused node and fans out to listeners. Returns the new
        anchor position."""
        delta = np.asarray(delta, np.float64) * _AXIS_MASK[self.axis]
        if self.gizmo_type in (GizmoType.TRANSLATE, GizmoType.AVATAR):
            self.pos = self.pos + delta
            if self._focused is not None and hasattr(
                self._focused, "set_translation"
            ):
                self._focused.set_translation(self.pos)
            for lst in self._listeners:
                lst.on_translate(delta, self.pos.copy())
        elif self.gizmo_type == GizmoType.SCALE:
            for lst in self._listeners:
                lst.on_scale(1.0 + delta)
        else:  # ROTATE: delta = axis-angle vector
            angle = np.linalg.norm(delta)
            axis = delta / angle if angle > 0 else np.array([0.0, 0.0, 1.0])
            half = 0.5 * angle
            quat = np.concatenate([np.sin(half) * axis, [np.cos(half)]])
            for lst in self._listeners:
                lst.on_rotate(quat)
        return self.pos.copy()


_instance: GizmoManager | None = None


def the_gizmo_manager() -> GizmoManager:
    """Process-wide instance (reference `TheGizmoManager` singleton)."""
    global _instance
    if _instance is None:
        _instance = GizmoManager()
    return _instance
