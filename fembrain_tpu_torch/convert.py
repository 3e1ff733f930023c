"""Build the port's objects from another implementation's state given as
numpy arrays plus static metadata, so two implementations can compute on
identical inputs.

Each builder takes a mapping from field name to value: arrays as numpy
(or anything `np.asarray` accepts), static metadata as plain Python
values, nested objects as nested mappings. `numpy_fields` produces such a
mapping from any dataclass instance whose array fields convert with
`np.asarray`. Tensors land on the given `device` (the card when None).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import default_device
from .blob.scene import OpWire, Scene, WarpWire
from .fem.grid_fem import GridFem, GridLevel
from .fem.integrator import FemState
from .fem.tetmesh import FemMesh
from .mesh.polygonize import SurfaceMesh, TetMesh
from .render.deformed import DispInterp


def numpy_fields(obj) -> dict:
    """Dataclass instance -> {field: value}, arrays as numpy, nested
    dataclasses (also inside tuples) as nested dicts."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            return numpy_fields(v)
        if isinstance(v, (tuple, list)) and v and dataclasses.is_dataclass(v[0]):
            return [conv(x) for x in v]
        if v is None or isinstance(v, (bool, int, float, str, tuple)):
            return v
        return np.asarray(v)

    return {f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _tensor(v, device):
    return None if v is None else torch.tensor(np.asarray(v), device=device)


def _build(cls, fields: dict, device, nested=None):
    device = default_device() if device is None else device
    nested = nested or {}
    kw = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if f.name in nested:
            kw[f.name] = nested[f.name](v)
        elif isinstance(v, np.ndarray):
            kw[f.name] = _tensor(v, device)
        else:
            kw[f.name] = v
    return cls(**kw)


def scene(fields: dict, device=None) -> Scene:
    """Packed Scene; the wiring tuples are rebuilt as the port's types."""
    def wiring(v):
        return tuple(OpWire(*w) for w in v)

    def warp_groups(v):
        return tuple(
            (tuple(WarpWire(*w) for w in chain), tuple(prims))
            for chain, prims in v
        )

    return _build(Scene, fields, device,
                  {"wiring": wiring, "warp_groups": warp_groups})


def tet_mesh(fields: dict, device=None) -> TetMesh:
    return _build(TetMesh, fields, device, {
        "n_nodes": int, "n_tets": int,
    })


def grid_fem(fields: dict, device=None) -> GridFem:
    """GridFem with every multigrid level and the coarse inverse."""
    def levels(v):
        return tuple(_build(GridLevel, lv, device, {"dims": tuple})
                     for lv in v)

    return _build(GridFem, fields, device, {
        "levels": levels, "dims": tuple, "origin": tuple,
        "coarse_coefs": tuple,
    })


def disp_interp(fields: dict, device=None) -> DispInterp:
    """DispInterp of either kind (biharmonic or Wendland)."""
    if fields["kind"] not in ("biharmonic", "wendland"):
        raise ValueError(f"unknown interpolant kind {fields['kind']!r}")
    return _build(DispInterp, fields, device)


def fem_state(fields: dict, device=None) -> FemState:
    return _build(FemState, fields, device)


def fem_mesh_from_numpy(fields: dict, device=None) -> FemMesh:
    """Unstructured FemMesh (element matrices, mass, fixed mask and the
    gather-form assembly map as given)."""
    return _build(FemMesh, fields, device, {"n_nodes": int, "n_tets": int})


def surface_mesh_from_numpy(fields: dict, device=None) -> SurfaceMesh:
    """Polygonized SurfaceMesh; the two counts stay tensors."""
    return _build(SurfaceMesh, fields, device)
