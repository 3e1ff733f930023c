"""Procedural tet-mesh fixtures (parity with the reference's
VolMeshSamples, src/deformable/VolMeshSamples.{h,cpp}:15-190): one-tet,
two-tet, truth cube, egg shell; and anchor sets for tet meshes.

Counterpart of fembrain_tpu/mesh/samples.py, in numpy on the host;
`bottom_nodes_per_component` takes its components from the host core
(csrc/femcore.cpp), as the JAX package does when its core builds."""
from __future__ import annotations

import numpy as np

from .. import femcore
from . import tables as T


def one_tetra() -> tuple[np.ndarray, np.ndarray]:
    """The reference's canonical single tet (VolMeshSamples.cpp:15-39)."""
    nodes = np.array(
        [[-1, 0, 0], [0, 0, -2], [1, 0, 0], [0, 2, -1]], np.float64
    )
    tets = np.array([[0, 1, 2, 3]], np.int32)
    return _orient(nodes, tets)


def two_tetra() -> tuple[np.ndarray, np.ndarray]:
    """Two tets sharing a face (VolMeshSamples.cpp:41-65) — the mesh the
    reference app actually simulates (src/main.cpp:833)."""
    nodes = np.array(
        [[-1, 0, 0], [1, 0, 0], [0, 0, -1], [0, 0, 1], [0, 2, 0]], np.float64
    )
    tets = np.array([[0, 2, 3, 4], [1, 2, 3, 4]], np.int32)
    return _orient(nodes, tets)


def truth_cube(nx: int = 4, ny: int = 4, nz: int = 4, cellsize: float = 0.5):
    """nx x ny x nz node lattice, 6 Kuhn tets per cell, base at y=0 and
    centered in x/z (VolMeshSamples.cpp:67-130)."""
    start = np.array([-nx / 2.0, 0.0, -nz / 2.0]) * cellsize
    ii, jj, kk = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    nodes = start + np.stack([ii, jj, kk], -1).reshape(-1, 3) * cellsize

    def lin(i, j, k):
        return (i * ny + j) * nz + k

    tets = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            for k in range(nz - 1):
                for t in range(6):
                    corners = []
                    for c in range(4):
                        off = T.CORNER_OFFSET[T.TET_CORNERS[t, c]]
                        corners.append(lin(i + off[0], j + off[1], k + off[2]))
                    tets.append(corners)
    return _orient(nodes.astype(np.float64), np.asarray(tets, np.int32))


def egg_shell(hseg: int = 8, vseg: int = 5, radius: float = 1.0,
              thickness: float = 0.3):
    """Spherical shell of prism cells split into tets
    (VolMeshSamples.cpp:132-190)."""
    rings = []
    for v in range(vseg + 1):
        phi = np.deg2rad(v / vseg * 180.0)
        ring = []
        for h in range(hseg):
            th = np.deg2rad(h / hseg * 360.0)
            d = np.array(
                [np.sin(phi) * np.cos(th), np.cos(phi), np.sin(phi) * np.sin(th)]
            )
            ring.append(d)
        rings.append(np.asarray(ring))

    nodes = []
    index = {}
    def nid(v, h, layer):
        key = (v, h, layer)
        if key not in index:
            r = radius if layer == 0 else radius - thickness
            index[key] = len(nodes)
            nodes.append(rings[v][h % hseg] * r)
        return index[key]

    tets = []
    for v in range(vseg):
        for h in range(hseg):
            # Hex cell corners: (v,h),(v,h+1),(v+1,h),(v+1,h+1) x 2 layers.
            c = {}
            for (dv, dh, lay), bit in (
                ((0, 0, 0), 0), ((1, 0, 0), 1), ((0, 1, 0), 2), ((1, 1, 0), 3),
                ((0, 0, 1), 4), ((1, 0, 1), 5), ((0, 1, 1), 6), ((1, 1, 1), 7),
            ):
                c[bit] = nid(v + dv, (h + dh) % hseg, lay)
            # 6-tet split of the hex (indices mirror the Kuhn pattern with
            # bit0 = v-dir, bit1 = h-dir, bit2 = layer).
            for t in range(6):
                tets.append([c[int(T.TET_CORNERS[t, j])] for j in range(4)])

    nodes = np.asarray(nodes, np.float64)
    tets = np.asarray(tets, np.int32)
    # Drop degenerate tets (poles collapse hex cells).
    keep = np.abs(_signed_vols(nodes, tets)) > 1e-12
    return _orient(nodes, tets[keep])


def _signed_vols(nodes, tets):
    a, b, c, d = (nodes[tets[:, i]] for i in range(4))
    return np.einsum("ij,ij->i", b - a, np.cross(c - a, d - a)) / 6.0


def _orient(nodes, tets):
    """Flip tets to positive orientation."""
    v = _signed_vols(nodes, tets)
    flip = v < 0
    tets = tets.copy()
    tets[flip, 1], tets[flip, 2] = tets[flip, 2], tets[flip, 1]
    return nodes, tets



def bottom_nodes(nodes: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """Indices of nodes at the minimum y (typical fixed set)."""
    ymin = nodes[:, 1].min()
    return np.where(nodes[:, 1] <= ymin + tol)[0]


def union_find_components(n_nodes: int, tets: np.ndarray) -> np.ndarray:
    """Per-node component root by a union-find over the tets (the plain
    twin of femcore.components). A node in no tet is its own root."""
    parent = np.arange(n_nodes)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for t in np.asarray(tets, np.int64):
        r = find(t[0])
        for v in t[1:]:
            parent[find(v)] = r
    return np.asarray([find(i) for i in range(n_nodes)])


def bottom_nodes_per_component(nodes: np.ndarray, tets: np.ndarray,
                               tol: float = 1e-3,
                               frac: float = 0.0) -> np.ndarray:
    """Indices anchoring EVERY connected component at its own lowest
    nodes. Anchoring only the global minimum-y plane leaves disjoint
    parts (the ventricle blob is several lobes) entirely unconstrained —
    free fall, unbounded |q|, and a singular K_eff restrained only by
    mass. Components come from femcore.components, in the order of their
    first tet; a node in no tet (one a cut left behind) belongs to none
    and is never anchored."""
    tets = np.asarray(tets, np.int64)
    _, labels = femcore.components(tets, n_nodes=len(nodes))
    comp = np.full(len(nodes), -1, np.int64)
    comp[tets.reshape(-1)] = np.repeat(labels, 4)

    out = []
    for c in np.unique(comp):
        if c < 0:
            continue
        idx = np.where(comp == c)[0]
        ymin, ymax = nodes[idx, 1].min(), nodes[idx, 1].max()
        # frac > 0 anchors the bottom slab of each component's height
        # (slender lobes anchored only at one plane of vertices sag
        # enormously under gravity — not a useful benchmark state).
        cut = ymin + max(tol, frac * (ymax - ymin))
        out.append(idx[nodes[idx, 1] <= cut])
    return np.concatenate(out) if out else np.zeros(0, np.int64)
