"""VolMesh: dynamic-topology tetrahedral mesh database (host side).

Counterpart of fembrain_tpu/mesh/volmesh.py, the port of the reference's
first-party `VolMesh`
(src/deformable/VolMesh.{h,cpp}, entities VolMeshEntities.h:44-81): nodes
with rest+current positions, global edge/face stores with incidence maps,
cells with canonical edge ordering, topology events, `cut_edge`, deferred
garbage collection, quality metrics, disjoint-part extraction, and the
runtime invariant checks the reference wires into its production path
(test_VolMesh.cpp:17-291).

Cutting mutates topology on the host (as in the reference, which rebuilds
the whole FEM stack after a cut — Deformable::syncForceModel); the static
post-cut mesh is then re-uploaded to the device for FEM.

Canonical cell edge order (derived from the reference's cut tables,
TetSubdivider.cpp:21-44 + subedges map :303-304):
    e0=(1,2) e1=(2,3) e2=(1,3) e3=(0,2) e4=(0,3) e5=(0,1)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import femcore

INVALID = 0xFFFFFFFF

# (from, to) node slots for each canonical cell edge.
CELL_EDGES = ((1, 2), (2, 3), (1, 3), (0, 2), (0, 3), (0, 1))
# Node slots of each of the 4 cell faces.
CELL_FACES = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def numpy_edges(cells: np.ndarray, n_nodes: int):
    """(edges [E, 2], cell_edges [T, 6]) in numpy: unique node pairs in
    first-seen order, each oriented as first seen (the plain twin of
    femcore.build_edges)."""
    cells = np.asarray(cells, np.int64)
    pairs = cells[:, np.asarray(CELL_EDGES)]          # [T,6,2]
    flat = pairs.reshape(-1, 2)
    keys = (
        np.minimum(flat[:, 0], flat[:, 1]) * n_nodes
        + np.maximum(flat[:, 0], flat[:, 1])
    )
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return flat[np.sort(first)], rank[inv].reshape(-1, 6)


@dataclass
class Node:
    pos: np.ndarray
    restpos: np.ndarray


@dataclass
class Edge:
    from_: int
    to: int


@dataclass
class Cell:
    nodes: list[int]
    edges: list[int] = field(default_factory=list)
    faces: list[int] = field(default_factory=list)


class VolMesh:
    def __init__(self, nodes: np.ndarray | None = None,
                 cells: np.ndarray | None = None):
        self.nodes: list[Node] = []
        self.edges: list[Edge] = []
        self.faces: list[tuple[int, int, int]] = []
        self.cells: list[Cell | None] = []
        self._edge_map: dict[tuple[int, int], int] = {}
        self._face_map: dict[tuple[int, int, int], int] = {}
        self.incident_edges_per_node: list[set[int]] = []
        self.incident_cells_per_edge: dict[int, set[int]] = {}
        self.incident_cells_per_node: list[set[int]] = []
        self._pending_removal: set[int] = set()
        # Topology event callbacks (reference VolMesh.h:59-74).
        self.on_node_added = None
        self.on_cell_added = None
        self.on_cell_removed = None

        if nodes is not None and cells is not None and len(cells) > 256:
            # Production-scale path: bulk array construction (the host
            # core's edge kernel) — the per-cell Python loop below is
            # fine for fixtures but not for the app's 61k-tet meshes
            # (reference VolMesh is C++, src/deformable/VolMesh.cpp).
            self._bulk_init(
                np.asarray(nodes, np.float64), np.asarray(cells, np.int64)
            )
            return
        if nodes is not None:
            for p in np.asarray(nodes, np.float64):
                self.insert_node(p)
        if cells is not None:
            for c in np.asarray(cells, np.int64):
                self.insert_cell(tuple(int(v) for v in c))

    def _bulk_init(self, nodes: np.ndarray, cells: np.ndarray) -> None:
        self.nodes = [Node(p.copy(), p.copy()) for p in nodes]
        self.incident_edges_per_node = [set() for _ in self.nodes]
        self.incident_cells_per_node = [set() for _ in self.nodes]

        edges, cell_edges = femcore.build_edges(cells)
        edges = edges.astype(np.int64)
        cell_edges = cell_edges.astype(np.int64)

        self.edges = [Edge(int(a), int(b)) for a, b in edges]
        self._edge_map = {
            (min(int(a), int(b)), max(int(a), int(b))): i
            for i, (a, b) in enumerate(edges)
        }
        for i, (a, b) in enumerate(edges):
            self.incident_edges_per_node[int(a)].add(i)
            self.incident_edges_per_node[int(b)].add(i)
        self.incident_cells_per_edge = {i: set() for i in range(len(edges))}

        # Faces: unique sorted triples.
        tris = np.sort(cells[:, np.asarray(CELL_FACES)], axis=-1)  # [T,4,3]
        tflat = tris.reshape(-1, 3)
        keys = (
            tflat[:, 0] * len(self.nodes) + tflat[:, 1]
        ) * len(self.nodes) + tflat[:, 2]
        _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        self.faces = [tuple(int(v) for v in t) for t in tflat[np.sort(first)]]
        self._face_map = {f: i for i, f in enumerate(self.faces)}
        cell_faces = rank[inv].reshape(-1, 4)

        self.cells = [
            Cell(
                nodes=[int(v) for v in cells[t]],
                edges=[int(e) for e in cell_edges[t]],
                faces=[int(f) for f in cell_faces[t]],
            )
            for t in range(len(cells))
        ]
        for t, cell in enumerate(self.cells):
            for e in cell.edges:
                self.incident_cells_per_edge[e].add(t)
            for n in cell.nodes:
                self.incident_cells_per_node[n].add(t)
        if self.on_cell_added:
            for t in range(len(self.cells)):
                self.on_cell_added(t)

    # ----------------------------------------------------------- counts
    def count_nodes(self) -> int:
        return len(self.nodes)

    def count_edges(self) -> int:
        return len(self.edges)

    def count_cells(self) -> int:
        return sum(1 for c in self.cells if c is not None)

    def is_node_index(self, i) -> bool:
        return 0 <= i < len(self.nodes)

    def is_edge_index(self, i) -> bool:
        return 0 <= i < len(self.edges)

    def is_cell_index(self, i) -> bool:
        return 0 <= i < len(self.cells) and self.cells[i] is not None

    # ----------------------------------------------------------- insertion
    def insert_node(self, pos, restpos=None) -> int:
        pos = np.asarray(pos, np.float64).copy()
        rp = pos.copy() if restpos is None else np.asarray(restpos, np.float64).copy()
        self.nodes.append(Node(pos, rp))
        self.incident_edges_per_node.append(set())
        self.incident_cells_per_node.append(set())
        if self.on_node_added:
            self.on_node_added(len(self.nodes) - 1)
        return len(self.nodes) - 1

    def insert_edge(self, a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key in self._edge_map:
            return self._edge_map[key]
        self.edges.append(Edge(a, b))
        idx = len(self.edges) - 1
        self._edge_map[key] = idx
        self.incident_edges_per_node[a].add(idx)
        self.incident_edges_per_node[b].add(idx)
        self.incident_cells_per_edge[idx] = set()
        return idx

    def edge_index(self, a: int, b: int) -> int:
        return self._edge_map.get((min(a, b), max(a, b)), INVALID)

    def edge_exists(self, a: int, b: int) -> bool:
        return self.edge_index(a, b) != INVALID

    def _insert_face(self, tri) -> int:
        key = tuple(sorted(tri))
        if key in self._face_map:
            return self._face_map[key]
        self.faces.append(key)
        idx = len(self.faces) - 1
        self._face_map[key] = idx
        return idx

    def insert_cell(self, nodes4) -> int:
        assert len(set(nodes4)) == 4, "degenerate cell"
        cell = Cell(nodes=list(nodes4))
        for a, b in CELL_EDGES:
            cell.edges.append(self.insert_edge(nodes4[a], nodes4[b]))
        for f in CELL_FACES:
            cell.faces.append(self._insert_face([nodes4[i] for i in f]))
        self.cells.append(cell)
        idx = len(self.cells) - 1
        for e in cell.edges:
            self.incident_cells_per_edge[e].add(idx)
        for n in cell.nodes:
            self.incident_cells_per_node[n].add(idx)
        if self.on_cell_added:
            self.on_cell_added(idx)
        return idx

    # ----------------------------------------------------------- removal/GC
    def schedule_remove_cell(self, idx: int) -> None:
        """Deferred removal (reference schedule_remove_* + GC,
        VolMesh.h:166-190)."""
        if self.is_cell_index(idx):
            self._pending_removal.add(idx)

    def garbage_collection(self) -> None:
        for idx in self._pending_removal:
            cell = self.cells[idx]
            if cell is None:
                continue
            for e in cell.edges:
                self.incident_cells_per_edge.get(e, set()).discard(idx)
            for n in cell.nodes:
                self.incident_cells_per_node[n].discard(idx)
            if self.on_cell_removed:
                self.on_cell_removed(idx)
            self.cells[idx] = None
        self._pending_removal.clear()

    # ----------------------------------------------------------- cutting
    def cut_edge(self, idx_edge: int, distance: float) -> tuple[int, int]:
        """Split an edge into two unconnected halves (reference
        VolMesh::cut_edge, VolMesh.cpp:1624-1662): two coincident new
        nodes at `distance` from the edge's from-node; the old edge is
        rewired (from -> np0) and a new edge (np1 -> to) is added.
        Returns (np0, np1)."""
        e = self.edges[idx_edge]
        p0, p1 = self.nodes[e.from_], self.nodes[e.to]
        d = p1.pos - p0.pos
        dn = d / np.linalg.norm(d)
        dr = p1.restpos - p0.restpos
        drn = dr / np.linalg.norm(dr)
        pos = p0.pos + dn * distance
        rest = p0.restpos + drn * distance
        np0 = self.insert_node(pos, rest)
        np1 = self.insert_node(pos.copy(), rest.copy())

        # Rewire the old edge: from -> np0.
        old_key = (min(e.from_, e.to), max(e.from_, e.to))
        old_to = e.to
        del self._edge_map[old_key]
        self.incident_edges_per_node[old_to].discard(idx_edge)
        e.to = np0
        self._edge_map[(min(e.from_, np0), max(e.from_, np0))] = idx_edge
        self.incident_edges_per_node[np0].add(idx_edge)
        # New edge np1 -> old to.
        self.insert_edge(np1, old_to)
        return np0, np1

    # ----------------------------------------------------------- geometry
    def positions(self) -> np.ndarray:
        return np.asarray([n.pos for n in self.nodes])

    def restpositions(self) -> np.ndarray:
        return np.asarray([n.restpos for n in self.nodes])

    def cells_array(self) -> np.ndarray:
        return np.asarray(
            [c.nodes for c in self.cells if c is not None], np.int32
        ).reshape(-1, 4)

    def displace(self, u: np.ndarray) -> None:
        """pos = restpos + u (reference VolMesh::displace, VolMesh.h:145)."""
        u = np.asarray(u, np.float64).reshape(-1, 3)
        for i, n in enumerate(self.nodes):
            n.pos = n.restpos + u[i]

    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        p = self.positions()
        return p.min(0), p.max(0)

    def cell_volume(self, idx: int) -> float:
        c = self.cells[idx]
        a, b, cc, d = (self.nodes[n].pos for n in c.nodes)
        return float(np.dot(b - a, np.cross(cc - a, d - a)) / 6.0)

    def total_volume(self) -> float:
        return sum(
            abs(self.cell_volume(i))
            for i in range(len(self.cells))
            if self.cells[i] is not None
        )

    def cell_aspect_ratio(self, idx: int) -> float:
        """Longest edge / min height — a standard tet quality metric
        (reference quality metrics VolMesh.h:89-103)."""
        c = self.cells[idx]
        p = np.asarray([self.nodes[n].pos for n in c.nodes])
        emax = max(
            np.linalg.norm(p[a] - p[b]) for a, b in CELL_EDGES
        )
        vol = abs(self.cell_volume(idx))
        amax = max(
            0.5 * np.linalg.norm(np.cross(p[f[1]] - p[f[0]], p[f[2]] - p[f[0]]))
            for f in CELL_FACES
        )
        hmin = 3.0 * vol / amax if amax > 0 else 0.0
        return emax / hmin if hmin > 0 else np.inf

    # ----------------------------------------------------------- queries
    def pick_node(self, origin, direction, radius=0.05) -> int:
        """Ray-pick the nearest node within `radius` of the ray
        (reference VolMesh.h:236)."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        best, best_t = -1, np.inf
        for i, n in enumerate(self.nodes):
            w = n.pos - o
            t = float(np.dot(w, d))
            if t < 0:
                continue
            dist = np.linalg.norm(w - t * d)
            if dist < radius and t < best_t:
                best, best_t = i, t
        return best

    def disjoint_parts(self) -> list[list[int]]:
        """Connected components of live cells by shared nodes (reference
        splitParts/convertDisjointPartsToMeshes, CuttableMesh.h:126-135)."""
        live = [i for i in range(len(self.cells)) if self.cells[i] is not None]
        parent = {i: i for i in live}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        by_node: dict[int, int] = {}
        for i in live:
            for n in self.cells[i].nodes:
                if n in by_node:
                    ra, rb = find(by_node[n]), find(i)
                    if ra != rb:
                        parent[ra] = rb
                else:
                    by_node[n] = i
        groups: dict[int, list[int]] = {}
        for i in live:
            groups.setdefault(find(i), []).append(i)
        return list(groups.values())

    def extract_part(self, cell_ids: list[int]) -> "VolMesh":
        """New compact VolMesh from a subset of cells."""
        remap: dict[int, int] = {}
        out = VolMesh()
        for ci in cell_ids:
            cell = self.cells[ci]
            newn = []
            for n in cell.nodes:
                if n not in remap:
                    remap[n] = out.insert_node(
                        self.nodes[n].pos, self.nodes[n].restpos
                    )
                newn.append(remap[n])
            out.insert_cell(newn)
        return out

    # ----------------------------------------------------------- invariants
    def check_invariants(self) -> list[str]:
        """Mesh-invariant suite (reference TestVolMesh::tst_correct_elements
        + tst_unused_mesh_fields, test_VolMesh.cpp:17-291). Returns a list
        of violation strings; empty = PASS. Vectorized (numpy over live
        cells) so it stays wired into the production cut path at 61k-tet
        app scale, as the reference wires TestVolMesh into every cut."""
        errors: list[str] = []
        live = [i for i, c in enumerate(self.cells) if c is not None]
        if not live:
            return errors
        ca = np.asarray([self.cells[i].nodes for i in live], np.int64)
        ce = np.asarray([self.cells[i].edges for i in live], np.int64)
        pos = self.positions()
        n = len(self.nodes)

        # Node validity + duplicates.
        bad_range = (ca < 0) | (ca >= n)
        for r in np.nonzero(bad_range.any(1))[0]:
            errors.append(f"cell {live[r]}: bad node {self.cells[live[r]].nodes}")
        srt = np.sort(ca, 1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(1)
        for r in np.nonzero(dup & ~bad_range.any(1))[0]:
            errors.append(
                f"cell {live[r]}: duplicate nodes {self.cells[live[r]].nodes}"
            )
        ok = ~(bad_range.any(1) | dup)

        # Edge-slot consistency: stored edge endpoints == cell node pair.
        ea = np.asarray([[e.from_, e.to] for e in self.edges], np.int64)
        dup_e = (np.sort(ce, 1)[:, 1:] == np.sort(ce, 1)[:, :-1]).any(1)
        for r in np.nonzero(dup_e)[0]:
            errors.append(f"cell {live[r]}: duplicate edges")
        want = ca[:, np.asarray(CELL_EDGES)]                 # [L,6,2]
        got = ea[ce]                                         # [L,6,2]
        match = (got == want).all(-1) | (got == want[..., ::-1]).all(-1)
        for r, k in zip(*np.nonzero(~match)):
            errors.append(
                f"cell {live[r]}: edge {k} mismatch "
                f"{tuple(got[r, k])} != {set(want[r, k])}"
            )

        # Degenerate volumes (vectorized signed volume).
        p = pos[np.where(ok[:, None], ca, 0)]                # [L,4,3]
        vol = np.abs(
            np.einsum(
                "ij,ij->i",
                p[:, 1] - p[:, 0],
                np.cross(p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]),
            )
            / 6.0
        )
        for r in np.nonzero(ok & (vol < 1e-15))[0]:
            errors.append(f"cell {live[r]}: degenerate volume")
        # Orphans are reported (not fatal in the reference histogram).
        return errors

    def report_info(self) -> dict:
        """tst_report_mesh_info analog."""
        return {
            "nodes": self.count_nodes(),
            "edges": self.count_edges(),
            "faces": len(self.faces),
            "cells": self.count_cells(),
            "volume": self.total_volume(),
        }
