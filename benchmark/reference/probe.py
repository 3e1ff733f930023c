"""The plain haptic probe: the upstream's AvatarProbe::onTranslate and
Deformable::applyHapticForces (Deformable.cpp:634-706), written from
their semantics.

The probe is an axis-aligned box. Moved to a new centre, it adds every
node inside the box (bounds included) to its contacts, keeping the
position a node had when first seen. On the first move with contacts it
picks its contact face once, sticky until the contact is cleared: of
its six faces (outward normals -x, +x, -y, +y, -z, +z; a face's plane
through the box's lower corner for a minus face, its upper corner for a
plus face) the one of the (vertex, face) pair that minimises
dot(s_face - p, n_face) over every contacted first-seen position p.
Each contact then pushes along that face's normal with FORCECOEFF times
its depth through the face's plane, max(dot(s_face - p, n_face), 0).

A contact's force reaches every node within `radius` - 1 edges of the
tet mesh's node graph (two nodes are joined when a tetrahedron holds
both), scaled by 1 - ring / radius at breadth-first ring `ring`; the
loads of all contacts add up.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

FACE_NORMALS = np.array([[-1.0, 0, 0], [1.0, 0, 0], [0, -1.0, 0],
                         [0, 1.0, 0], [0, 0, -1.0], [0, 0, 1.0]])


class Probe:
    def __init__(self, half_extents, coeff: float):
        self.half = np.asarray(half_extents, np.float64)
        self.coeff = float(coeff)
        self.clear()

    def clear(self) -> None:
        self.seen = {}          # node -> first-seen position
        self.face = -1

    def move(self, centre, positions: np.ndarray):
        """Move to `centre` over node `positions` [N, 3]: the contacts'
        node ids and forces [K, 3], float64."""
        lo = np.asarray(centre, np.float64) - self.half
        hi = np.asarray(centre, np.float64) + self.half
        inside = np.all((positions >= lo) & (positions <= hi), axis=1)
        for i in np.flatnonzero(inside):
            if int(i) not in self.seen:
                self.seen[int(i)] = positions[i].astype(np.float64)
        if not self.seen:
            return np.zeros(0, np.int64), np.zeros((0, 3))
        ids = np.array(list(self.seen), np.int64)
        p = np.stack([self.seen[int(i)] for i in ids])
        planes = np.where(FACE_NORMALS.sum(1)[:, None] < 0, lo, hi)  # [6, 3]
        if self.face < 0:
            d = np.sum((planes[None] - p[:, None]) * FACE_NORMALS[None], -1)
            self.face = int(np.argmin(d) % 6)
        n = FACE_NORMALS[self.face]
        depth = np.maximum((planes[self.face] - p) @ n, 0.0)
        return ids, self.coeff * depth[:, None] * n[None]


def node_graph(tets: np.ndarray, n_nodes: int) -> sp.csr_matrix:
    """The node graph of a tet mesh: [N, N], 1 where a tetrahedron holds
    both nodes."""
    t = np.asarray(tets, np.int64)
    a = np.repeat(t, 4, 1).reshape(-1)
    b = np.tile(t, (1, 4)).reshape(-1)
    off = a != b
    g = sp.coo_matrix((np.ones(int(off.sum())), (a[off], b[off])),
                      (n_nodes, n_nodes)).tocsr()
    g.data[:] = 1.0
    return g


def ring_forces(graph: sp.csr_matrix, ids, forces, radius: int = 5,
                rings: int | None = None) -> np.ndarray:
    """[N, 3] float64 load of contact forces [K, 3] at nodes `ids` spread
    over breadth-first rings 0 .. radius - 1 (`rings` of them when given:
    the fault that drops the outermost)."""
    n = graph.shape[0]
    out = np.zeros((n, 3))
    ids = np.asarray(ids, np.int64)
    if ids.size == 0:
        return out
    front = np.zeros((n, ids.size))
    front[ids, np.arange(ids.size)] = 1.0
    reached = front > 0.0
    f = np.asarray(forces, np.float64)
    for ring in range(radius if rings is None else rings):
        out += (1.0 - ring / float(radius)) * (front @ f)
        front = ((graph @ front) > 0.0) & ~reached
        reached |= front
        front = front.astype(np.float64)
    return out
