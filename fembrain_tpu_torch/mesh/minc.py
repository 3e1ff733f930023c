"""MINC medical-volume reader (reference MincReader stub,
src/deformable/MincReader.h:12-19 — the reference never implements it).

Counterpart of fembrain_tpu/mesh/minc.py, host numpy like it: a reader
for the RAW+header sidecar convention (shape/spacing/origin in a small
JSON next to a float32 .raw volume), which covers exported MINC/NIfTI-
style volumes without external dependencies, and NumPy .npy/.npz
volumes.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class Volume:
    data: np.ndarray          # [X, Y, Z] float32
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)


def read_volume(path: str | Path) -> Volume:
    """Read `<name>.raw` (+ `<name>.json` sidecar with dims/spacing) or a
    NumPy `.npy`/`.npz` volume."""
    path = Path(path)
    if path.suffix in (".npy",):
        return Volume(np.load(path).astype(np.float32))
    if path.suffix == ".npz":
        z = np.load(path)
        return Volume(
            z["data"].astype(np.float32),
            tuple(z.get("spacing", np.ones(3))),
            tuple(z.get("origin", np.zeros(3))),
        )
    if path.suffix == ".raw":
        meta = json.loads(path.with_suffix(".json").read_text())
        dims = tuple(meta["dims"])
        data = np.fromfile(path, np.float32).reshape(dims)
        return Volume(
            data,
            tuple(meta.get("spacing", (1, 1, 1))),
            tuple(meta.get("origin", (0, 0, 0))),
        )
    raise ValueError(f"unsupported volume format: {path.suffix}")


def write_volume(path: str | Path, vol: Volume) -> None:
    path = Path(path)
    if path.suffix != ".raw":
        raise ValueError("write_volume emits .raw + .json")
    vol.data.astype(np.float32).tofile(path)
    path.with_suffix(".json").write_text(
        json.dumps(
            {
                "dims": list(vol.data.shape),
                "spacing": list(vol.spacing),
                "origin": list(vol.origin),
            }
        )
    )
