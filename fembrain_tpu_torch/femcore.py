"""ctypes bindings for the host topology core (csrc/femcore.cpp).

The core does the host work that sits between frames at native speed:
node adjacency and the haptic ring forces over it, unique-edge extraction
with each cell's canonical edge slots, the cell invariant check and the
connected components of a tet mesh. `build` compiles it on first use with
g++ into _build/, named by a hash of the source and the flags; a failed
build raises with the compiler's output. Nothing is compiled when the
package is imported.

Each entry has a numpy twin in the package, which the tests hold it to:
`fem.deformable.node_adjacency` with `haptic_ring_forces`,
`mesh.volmesh.numpy_edges`, and `mesh.samples.union_find_components`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "femcore.cpp"
BUILD_DIR = _HERE / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None  # the bound library, once loaded
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"femcore-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the core unless this source is already built; returns the
    library path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp"
    out = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({out.returncode}) on {SOURCE.name}:"
                           f"\n{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The bound core, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fem_adj_build.restype = ctypes.c_void_p
        lib.fem_adj_build.argtypes = [ctypes.c_int32, ctypes.c_int32, _I32P]
        lib.fem_adj_free.argtypes = [ctypes.c_void_p]
        lib.fem_adj_ring_forces.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, _I32P, _F64P, ctypes.c_int32,
            _F64P,
        ]
        lib.fem_build_edges.restype = ctypes.c_int32
        lib.fem_build_edges.argtypes = [ctypes.c_int32, _I32P, _I32P, _I32P]
        lib.fem_check_cells.restype = ctypes.c_int32
        lib.fem_check_cells.argtypes = [
            ctypes.c_int32, ctypes.c_int32, _I32P, _F64P, ctypes.c_double,
        ]
        lib.fem_components.restype = ctypes.c_int32
        lib.fem_components.argtypes = [
            ctypes.c_int32, ctypes.c_int32, _I32P, _I32P,
        ]
        _lib = lib
    return _lib


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _f64(a: np.ndarray):
    return a.ctypes.data_as(_F64P)


class NativeAdjacency:
    """Node adjacency and BFS ring forces (the per-frame host hot path of
    haptics); frees its handle when collected."""

    def __init__(self, tets: np.ndarray, n_nodes: int):
        self._lib = load()
        self.n_nodes = int(n_nodes)
        self._tets = np.ascontiguousarray(tets, np.int32)
        self._h = self._lib.fem_adj_build(
            self.n_nodes, len(self._tets), _i32(self._tets))

    def ring_forces(self, contact_idx, contact_force,
                    radius: int) -> np.ndarray:
        idx = np.ascontiguousarray(contact_idx, np.int32)
        frc = np.ascontiguousarray(contact_force, np.float64).reshape(-1, 3)
        out = np.zeros((self.n_nodes, 3), np.float64)
        self._lib.fem_adj_ring_forces(self._h, len(idx), _i32(idx),
                                      _f64(frc), int(radius), _f64(out))
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fem_adj_free(self._h)
            self._h = None


def build_edges(tets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(edges [E, 2], cell_edges [T, 6]): unique edges in first-seen order
    and each cell's edges in canonical slot order (volmesh.CELL_EDGES)."""
    tets = np.ascontiguousarray(tets, np.int32)
    edges = np.zeros((6 * len(tets), 2), np.int32)
    cell_edges = np.zeros((len(tets), 6), np.int32)
    n = load().fem_build_edges(len(tets), _i32(tets), _i32(edges),
                               _i32(cell_edges))
    return edges[:n].copy(), cell_edges


def check_cells(tets, pos=None, n_nodes=None, eps=1e-15) -> int:
    """Number of cells with an out-of-range or repeated node, or (given
    positions) a |volume| below eps."""
    tets = np.ascontiguousarray(tets, np.int32)
    n_nodes = int(n_nodes if n_nodes is not None else tets.max() + 1)
    if pos is not None:
        pos = np.ascontiguousarray(pos, np.float64)  # alive for the call
        pos_p = _f64(pos)
    else:
        pos_p = _F64P()
    return int(load().fem_check_cells(n_nodes, len(tets), _i32(tets), pos_p,
                                      eps))


def components(tets, n_nodes=None) -> tuple[int, np.ndarray]:
    """(count, labels [T]): connected components of the cells by shared
    nodes, numbered in order of each component's first cell."""
    tets = np.ascontiguousarray(tets, np.int32)
    n_nodes = int(n_nodes if n_nodes is not None else tets.max() + 1)
    labels = np.zeros(len(tets), np.int32)
    n = load().fem_components(n_nodes, len(tets), _i32(tets), _i32(labels))
    return int(n), labels
