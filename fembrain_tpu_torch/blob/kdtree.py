"""KD-tree over primitive AABBs for ray picking.

Port of the reference's `KDTreeAccel` (src/implicit/KDTree.{h,cpp}:95):
SURFACE-AREA-HEURISTIC build (the reference's scheme — split candidates
at box edges, cost = traversal + child surface-area-weighted
intersection counts, boxes straddling the plane go to both children)
with a median-split fallback (`method="median"`), and nearest-hit ray
traversal. Host-side NumPy: picking is an interaction-path operation
(SketchMachine.select analog), not a render-path one.

Counterpart of fembrain_tpu/blob/kdtree.py, with the reference's build as
it is: the SAH split's children keep a box only when it reaches strictly
past the split plane (`los < split`, `his > split`), so a box of zero
extent on the split axis that lies on the plane goes to neither child and
can no longer be picked (a known fault of the reference, kept so that
both packages pick the same boxes).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# SAH constants (relative cost of a traversal step vs a box test).
_SAH_TRAV = 0.125
_SAH_ISECT = 1.0


@dataclass
class _Node:
    lo: np.ndarray
    hi: np.ndarray
    axis: int = -1
    split: float = 0.0
    left: "_Node | None" = None
    right: "_Node | None" = None
    items: list[int] | None = None  # leaf


def _ray_box_t(o, inv_d, lo, hi):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tmin = np.max(np.minimum(t0, t1))
    tmax = np.min(np.maximum(t0, t1))
    if tmax < max(tmin, 0.0):
        return None
    return max(tmin, 0.0)


def _surface_area(lo, hi) -> float:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


class KDTree:
    def __init__(self, boxes: list[tuple[np.ndarray, np.ndarray]],
                 leaf_size: int = 4, max_depth: int = 16,
                 method: str = "sah"):
        self.los = np.asarray([b[0] for b in boxes], np.float64)
        self.his = np.asarray([b[1] for b in boxes], np.float64)
        self.leaf_size = leaf_size
        self.method = method
        self.box_tests = 0  # pick() instrumentation (tests/benchmarks)
        items = list(range(len(boxes)))
        self.root = self._build(items, 0, max_depth)

    def _bounds(self, items):
        return self.los[items].min(0), self.his[items].max(0)

    def _sah_split(self, items, lo, hi):
        """Best (axis, split, left, right) by the surface-area
        heuristic, or None if a leaf is cheaper (KDTree.h:95 scheme):
        candidates at item box edges; straddling boxes duplicate into
        both children."""
        ilos = self.los[items]
        ihis = self.his[items]
        n = len(items)
        sa_p = _surface_area(lo, hi)
        if sa_p <= 0.0:
            return None
        best = (_SAH_ISECT * n, None)  # leaf cost baseline
        for axis in range(3):
            edges = np.unique(
                np.concatenate([ilos[:, axis], ihis[:, axis]])
            )
            edges = edges[(edges > lo[axis]) & (edges < hi[axis])]
            for split in edges:
                nl = int(np.sum(ilos[:, axis] < split))
                nr = int(np.sum(ihis[:, axis] > split))
                l_hi = hi.copy()
                l_hi[axis] = split
                r_lo = lo.copy()
                r_lo[axis] = split
                cost = _SAH_TRAV + _SAH_ISECT * (
                    nl * _surface_area(lo, l_hi)
                    + nr * _surface_area(r_lo, hi)
                ) / sa_p
                if cost < best[0]:
                    best = (cost, (axis, float(split)))
        if best[1] is None:
            return None
        axis, split = best[1]
        left = [i for i in items if self.los[i, axis] < split]
        right = [i for i in items if self.his[i, axis] > split]
        if not left or not right or (
            len(left) == len(items) and len(right) == len(items)
        ):
            return None
        return axis, split, left, right

    def _median_split(self, items, lo, hi):
        centers = 0.5 * (self.los[items] + self.his[items])
        axis = int(np.argmax(hi - lo))
        split = float(np.median(centers[:, axis]))
        left = [
            i for i in items
            if 0.5 * (self.los[i, axis] + self.his[i, axis]) <= split
        ]
        right = [i for i in items if i not in set(left)]
        if not left or not right:
            return None
        return axis, split, left, right

    def _build(self, items, depth, max_depth) -> _Node:
        lo, hi = self._bounds(items)
        node = _Node(lo=lo, hi=hi)
        if len(items) <= self.leaf_size or depth >= max_depth:
            node.items = items
            return node
        split = (
            self._sah_split(items, lo, hi)
            if self.method == "sah"
            else self._median_split(items, lo, hi)
        )
        if split is None:
            node.items = items
            return node
        axis, pos, left, right = split
        node.axis, node.split = axis, pos
        node.left = self._build(left, depth + 1, max_depth)
        node.right = self._build(right, depth + 1, max_depth)
        return node

    def pick(self, origin, direction) -> int:
        """Index of the nearest box hit by the ray, or -1."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        inv = 1.0 / np.where(np.abs(d) < 1e-12, np.copysign(1e-12, d + 1e-15), d)
        best = [-1, np.inf]
        self.box_tests = 0

        def visit(node: _Node):
            t = _ray_box_t(o, inv, node.lo, node.hi)
            if t is None or t >= best[1]:
                return
            if node.items is not None:
                self.box_tests += len(node.items)
                for i in node.items:
                    ti = _ray_box_t(o, inv, self.los[i], self.his[i])
                    if ti is not None and ti < best[1]:
                        best[0], best[1] = i, ti
                return
            # Front-to-back: visit the child containing/facing the ray
            # origin first so the far child prunes against a best-t.
            near_left = o[node.axis] < node.split or (
                o[node.axis] == node.split and d[node.axis] < 0.0
            )
            first, second = (
                (node.left, node.right) if near_left
                else (node.right, node.left)
            )
            visit(first)
            visit(second)

        visit(self.root)
        return best[0]

    def sah_cost(self) -> float:
        """The tree's expected traversal cost under the SAH model
        (sum over nodes of SA-weighted traversal/intersection work) —
        the objective the SAH build minimizes."""
        root_sa = max(_surface_area(self.root.lo, self.root.hi), 1e-12)

        def cost(node: _Node) -> float:
            w = _surface_area(node.lo, node.hi) / root_sa
            if node.items is not None:
                return w * _SAH_ISECT * len(node.items)
            return w * _SAH_TRAV + cost(node.left) + cost(node.right)

        return cost(self.root)
