"""Mesh I/O: Vega `.veg` tet meshes and Wavefront OBJ surfaces.

Parity with the reference's VolMeshIO (src/deformable/VolMeshIO.h:16-31)
and the polygonizer's Vega export
(src/implicit/OclPolygonizer.cpp:1651-1694): 1-based indices, *VERTICES /
*ELEMENTS TET / *MATERIAL ENU sections.

Counterpart of fembrain_tpu/mesh/io.py. The writers' header lines name
the original package, so a file written by either package is the same
byte for byte and is read by the other.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def read_veg(path: str | Path):
    """Read a Vega .veg file -> (nodes [N,3] f64, tets [T,4] i32 0-based,
    material dict or None)."""
    lines = Path(path).read_text().splitlines()
    i = 0
    nodes = tets = None
    material = None

    def skip_blank(i):
        while i < len(lines) and (
            not lines[i].strip() or lines[i].lstrip().startswith("#")
        ):
            i += 1
        return i

    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("*VERTICES"):
            i = skip_blank(i + 1)
            n, dim = (int(x) for x in lines[i].split()[:2])
            i += 1
            out = np.empty((n, 3))
            for k in range(n):
                i = skip_blank(i)
                parts = lines[i].split()
                out[k] = [float(x) for x in parts[1 : 1 + dim]]
                i += 1
            nodes = out
        elif line.startswith("*ELEMENTS"):
            i = skip_blank(i + 1)
            kind = lines[i].strip().upper()
            if kind != "TET":
                raise ValueError(f"unsupported element type {kind}")
            i = skip_blank(i + 1)
            n, per = (int(x) for x in lines[i].split()[:2])
            i += 1
            out = np.empty((n, per), np.int32)
            for k in range(n):
                i = skip_blank(i)
                parts = lines[i].split()
                out[k] = [int(x) for x in parts[1 : 1 + per]]
                i += 1
            tets = out - 1
        elif line.startswith("*MATERIAL"):
            name = line.split()[-1] if len(line.split()) > 1 else "BODY"
            i = skip_blank(i + 1)
            parts = [p.strip() for p in lines[i].split(",")]
            if parts[0].upper() == "ENU":
                material = {
                    "name": name,
                    "type": "ENU",
                    "density": float(parts[1]),
                    "E": float(parts[2]),
                    "nu": float(parts[3]),
                }
            i += 1
        else:
            i += 1
    if nodes is None or tets is None:
        raise ValueError(f"incomplete veg file: {path}")
    return nodes, tets, material


def write_veg(path: str | Path, nodes, tets, density=1000.0, E=1e7, nu=0.45):
    """Write Vega format (matches the reference's export layout,
    OclPolygonizer.cpp:1651-1694)."""
    nodes = np.asarray(nodes)
    tets = np.asarray(tets)
    out = [
        "# Vega Mesh File, Generated by fembrain_tpu.",
        f"# {len(nodes)} vertices, {len(tets)} elements",
        "",
        "*VERTICES",
        f"{len(nodes)} 3 0 0",
    ]
    for i, p in enumerate(nodes):
        out.append(f"{i+1} {p[0]:.6g} {p[1]:.6g} {p[2]:.6g}")
    out += ["", "*ELEMENTS", "TET", f"{len(tets)} 4 0"]
    for i, t in enumerate(tets):
        out.append(f"{i+1} {t[0]+1} {t[1]+1} {t[2]+1} {t[3]+1}")
    out += [
        "",
        "*MATERIAL BODY",
        f"ENU, {density:g}, {E:g}, {nu:g}",
        "",
        "*REGION",
        "allElements, BODY",
    ]
    Path(path).write_text("\n".join(out) + "\n")


def write_obj(path: str | Path, verts, tris, normals=None):
    """OBJ surface export (reference ExportMeshAsObj,
    src/implicit/ReadSceneModel.cpp:753-830)."""
    verts = np.asarray(verts)
    tris = np.asarray(tris)
    out = ["# exported by fembrain_tpu"]
    for v in verts:
        out.append(f"v {v[0]:.6g} {v[1]:.6g} {v[2]:.6g}")
    if normals is not None:
        for n in np.asarray(normals):
            out.append(f"vn {n[0]:.6g} {n[1]:.6g} {n[2]:.6g}")
        for t in tris:
            a, b, c = t + 1
            out.append(f"f {a}//{a} {b}//{b} {c}//{c}")
    else:
        for t in tris:
            out.append(f"f {t[0]+1} {t[1]+1} {t[2]+1}")
    Path(path).write_text("\n".join(out) + "\n")


def read_obj(path: str | Path):
    """Minimal OBJ reader -> (verts [N,3], tris [T,3] 0-based)."""
    verts, tris = [], []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
            for k in range(1, len(idx) - 1):
                tris.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(tris, np.int32)
