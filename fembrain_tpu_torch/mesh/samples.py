"""Anchor sets for tet meshes.

Counterpart of `bottom_nodes` and `bottom_nodes_per_component` in
fembrain_tpu/mesh/samples.py, in numpy on the host (its union-find, not
the JAX package's native one)."""
from __future__ import annotations

import numpy as np


def bottom_nodes(nodes: np.ndarray, tol: float = 1e-6) -> np.ndarray:
    """Indices of nodes at the minimum y (typical fixed set)."""
    ymin = nodes[:, 1].min()
    return np.where(nodes[:, 1] <= ymin + tol)[0]


def bottom_nodes_per_component(nodes: np.ndarray, tets: np.ndarray,
                               tol: float = 1e-3,
                               frac: float = 0.0) -> np.ndarray:
    """Indices anchoring EVERY connected component at its own lowest
    nodes. Anchoring only the global minimum-y plane leaves disjoint
    parts (the ventricle blob is several lobes) entirely unconstrained —
    free fall, unbounded |q|, and a singular K_eff restrained only by
    mass. Components come from a union-find over the tets."""
    tets = np.asarray(tets, np.int64)
    parent = np.arange(len(nodes))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for t in tets:
        r = find(t[0])
        for v in t[1:]:
            parent[find(v)] = r
    comp = np.asarray([find(i) for i in range(len(nodes))])

    out = []
    for c in np.unique(comp):
        idx = np.where(comp == c)[0]
        ymin, ymax = nodes[idx, 1].min(), nodes[idx, 1].max()
        # frac > 0 anchors the bottom slab of each component's height
        # (slender lobes anchored only at one plane of vertices sag
        # enormously under gravity — not a useful benchmark state).
        cut = ymin + max(tol, frac * (ymax - ymin))
        out.append(idx[nodes[idx, 1] <= cut])
    return np.concatenate(out) if out else np.zeros(0, np.int64)
