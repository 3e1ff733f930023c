"""Deformable body orchestration: gravity, haptic ring forces, implicit
solve, ground-plane collision, and surface coupling.

PyTorch counterpart of fembrain_tpu/fem/deformable.py (the reference
`Deformable` node's per-frame loop, src/deformable/Deformable.cpp:318-420,
with the solver stack of `syncForceModel`, :127-220). The whole physics
step is one function over static-topology tensors.

Divergence note: the reference's collision response applies the normal-
velocity reflection to EVERY node each frame (Deformable.cpp:347-400);
here it is applied only to penetrating nodes (same constants: restitution
0.4, projection onto the plane), which is the evident intent.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import femcore
from ..utils.profiler import span
from . import integrator as integ
from .integrator import FemState
from .tetmesh import FemMesh

# Reference defaults: gravity -1e4 on y DOFs (Deformable.cpp:330-338),
# haptic neighborhood radius 5 rings (Deformable.h:41).
DEFAULT_GRAVITY = -10000.0
DEFAULT_HAPTIC_RADIUS = 5
GROUND_RESTITUTION = 0.4


@dataclasses.dataclass(frozen=True)
class StepStats:
    cg_iters: int
    n_collided: torch.Tensor   # scalar count, on the device


def node_adjacency(tets: np.ndarray, n_nodes: int) -> list[np.ndarray]:
    """Sorted neighbor arrays per node from tet connectivity (the plain
    twin of femcore.NativeAdjacency)."""
    t = np.asarray(tets, np.int64)
    i, j = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    off = i != j
    pairs = np.unique(
        np.stack([t[:, i[off]].reshape(-1), t[:, j[off]].reshape(-1)], 1),
        axis=0)
    starts = np.searchsorted(pairs[:, 0], np.arange(n_nodes + 1))
    return [pairs[starts[n] : starts[n + 1], 1].astype(np.int32)
            for n in range(n_nodes)]


def haptic_ring_forces(
    adjacency: list[np.ndarray],
    n_nodes: int,
    contact_idx: np.ndarray,
    contact_force: np.ndarray,
    radius: int = DEFAULT_HAPTIC_RADIUS,
) -> np.ndarray:
    """Propagate contact forces over BFS rings with linear falloff
    (reference Deformable::applyHapticForces, Deformable.cpp:634-706); the
    plain twin of femcore.NativeAdjacency.ring_forces."""
    f = np.zeros((n_nodes, 3))
    for idx, force in zip(np.asarray(contact_idx), np.asarray(contact_force)):
        dist = {int(idx): 0}
        frontier = [int(idx)]
        for ring in range(1, radius):
            nxt = []
            for u in frontier:
                for v in adjacency[u]:
                    v = int(v)
                    if v not in dist:
                        dist[v] = ring
                        nxt.append(v)
            frontier = nxt
            if not frontier:
                break
        for node, ring in dist.items():
            f[node] += force * (1.0 - ring / float(radius))
    return f


def step(
    mesh: FemMesh,
    state: FemState,
    f_haptic: torch.Tensor,
    *,
    h: float,
    gravity: float,
    ground_y: float | None,
    damping_mass: float,
    damping_stiffness: float,
    cg_max_iters: int,
) -> tuple[FemState, StepStats]:
    """One full physics frame (pure function)."""
    f_ext = f_haptic
    if gravity:
        g = torch.zeros_like(f_ext)
        g[:, 1] = gravity
        f_ext = f_ext + g

    new_state, cg_iters = integ.timestep(
        mesh,
        state,
        f_ext,
        h=h,
        damping_mass=damping_mass,
        damping_stiffness=damping_stiffness,
        cg_max_iters=cg_max_iters,
    )

    n_collided = torch.zeros((), dtype=torch.int32, device=mesh.rest.device)
    if ground_y is not None:
        q, v = new_state.q, new_state.qvel
        pos_y = mesh.rest[:, 1] + q[:, 1]
        pen = pos_y <= ground_y
        n_collided = torch.sum(pen.to(torch.int32))
        # Project penetrating nodes to the plane; reflect+damp their
        # normal velocity (restitution 0.4, Deformable.cpp:372-396).
        qy = torch.where(pen, ground_y - mesh.rest[:, 1], q[:, 1])
        vy = torch.where(pen, -GROUND_RESTITUTION * v[:, 1], v[:, 1])
        q = torch.stack([q[:, 0], qy, q[:, 2]], 1)
        v = torch.stack([v[:, 0], vy, v[:, 2]], 1)
        new_state = FemState(q=q, qvel=v, dv=new_state.dv)

    return new_state, StepStats(cg_iters=cg_iters, n_collided=n_collided)


class Deformable:
    """Host-side handle around the physics step (the analog of the
    reference's Deformable scene node). Lives on the mesh's device."""

    def __init__(
        self,
        mesh: FemMesh,
        h: float = integ.DEFAULT_TIMESTEP,
        gravity: float = DEFAULT_GRAVITY,
        ground_y: float | None = None,
        damping_mass: float = integ.DEFAULT_DAMPING_MASS,
        damping_stiffness: float = integ.DEFAULT_DAMPING_STIFFNESS,
        cg_max_iters: int = integ.CG_MAX_ITERS,
    ):
        self.mesh = mesh
        self.h = h
        self.state = FemState.rest(mesh)
        # Ring forces from the host core (csrc/femcore.cpp), as the
        # reference's Deformable takes them when its core builds.
        self._native_adj = femcore.NativeAdjacency(mesh.tets.cpu().numpy(),
                                                   mesh.n_nodes)
        self._stats: StepStats | None = None
        self._kw = dict(
            h=h, gravity=gravity, ground_y=ground_y,
            damping_mass=damping_mass, damping_stiffness=damping_stiffness,
            cg_max_iters=cg_max_iters,
        )

    def timestep(self, f_haptic=None) -> FemState:
        rest = self.mesh.rest
        f = (
            torch.zeros_like(rest)
            if f_haptic is None
            else torch.as_tensor(f_haptic, dtype=rest.dtype,
                                 device=rest.device)
        )
        self.state, self._stats = step(self.mesh, self.state, f, **self._kw)
        return self.state

    def haptic_forces(self, contact_idx, contact_force,
                      radius=DEFAULT_HAPTIC_RADIUS) -> np.ndarray:
        return self._native_adj.ring_forces(contact_idx, contact_force,
                                            radius)

    def probe_forces(self, probe, pos, stats: dict | None = None,
                     state: FemState | None = None) -> torch.Tensor:
        """The load [N, 3] that the probe moved to `pos` puts on the
        tissue, on the mesh's device: the frame's haptic load (the
        reference's AvatarProbe::onTranslate, then applyHapticForces,
        Deformable.cpp:634-706). Reads the node positions of `state` (the
        body's own when None) to the host once, moves the probe there
        (its sticky contact face and first-seen contact positions carry
        over from frame to frame until `probe.clear_contact()`), spreads
        the contact forces over DEFAULT_HAPTIC_RADIUS rings on the host
        core and copies the load back. `stats`, if given, receives
        "contacts" (the probe's contacted nodes), "ring_nodes" (nodes the
        load reaches) and "host_ms" (the whole call on the host clock)."""
        t0 = time.perf_counter()
        rest = self.mesh.rest
        q = (self.state if state is None else state).q
        with span("probe.contact"):
            nodes = (rest + q).cpu().numpy().astype(np.float64)
            idx, forces = probe.move_to(pos, nodes)
        with span("probe.rings"):
            f = (self.haptic_forces(idx, forces) if len(idx)
                 else np.zeros((self.mesh.n_nodes, 3)))
            load = torch.as_tensor(f, dtype=rest.dtype).to(rest.device)
        if stats is not None:
            stats["contacts"] = int(len(idx))
            stats["ring_nodes"] = int(np.count_nonzero(np.any(f != 0.0, 1)))
            stats["host_ms"] = (time.perf_counter() - t0) * 1e3
        return load

    def reset(self) -> None:
        """Reference resetDeformations -> ResetToRest (Deformable.cpp:629-632)."""
        self.state = FemState.rest(self.mesh)

    @property
    def positions(self) -> torch.Tensor:
        return self.mesh.rest + self.state.q

    def stats(self) -> dict:
        s = self._stats
        if s is None:
            return {}
        return {
            "cg_iters": int(s.cg_iters),
            "n_collided": int(s.n_collided),
        }


def couple_surface_displacements(
    surface_edge_nodes: torch.Tensor,  # [V, 2] grid linear ids
    surface_edge_t: torch.Tensor,      # [V]
    grid_to_node: torch.Tensor,        # [G] tet-node id or -1
    u: torch.Tensor,                   # [N, 3] tet-node displacements
) -> torch.Tensor:
    """Barycentric transfer of FEM displacements onto polygonized surface
    vertices (replaces the reference's by-index ApplyVertexDeformations,
    OclPolygonizer.cpp:1543-1596 + Polygonizer.cl:1417-1426: each surface
    vertex lies on a tet edge at parameter t, so its displacement is the
    exact interpolation of the two incident node displacements)."""
    na = grid_to_node[surface_edge_nodes[:, 0].long()].long()
    nb = grid_to_node[surface_edge_nodes[:, 1].long()].long()
    ua = torch.where(na[:, None] >= 0, u[torch.clamp(na, min=0)], 0.0)
    ub = torch.where(nb[:, None] >= 0, u[torch.clamp(nb, min=0)], 0.0)
    t = surface_edge_t[:, None]
    return (1.0 - t) * ua + t * ub
