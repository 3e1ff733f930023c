"""Headless scene-graph layer: retained nodes, transforms, gizmo routing.

Counterpart of fembrain_tpu/graphics/__init__.py: no OpenGL — `draw()`
yields geometry batches that the offline viewer (render.viewer)
rasterizes, while the heavy rendering path is the sphere tracer. See
scenegraph.py and gizmo.py.
"""
from .gizmo import GizmoManager, GizmoType, the_gizmo_manager
from .scenegraph import SceneGraph, SGMesh, SGNode, the_scenegraph
from .spline import CatmullRom
from .surface_mesh import SurfaceMesh

__all__ = [
    "CatmullRom",
    "GizmoManager",
    "GizmoType",
    "SceneGraph",
    "SGMesh",
    "SGNode",
    "SurfaceMesh",
    "the_gizmo_manager",
    "the_scenegraph",
]
