"""Partitioned-node FEM: halo exchange instead of full replication.

PyTorch counterpart of fembrain_tpu/fem/partitioned.py. fem.sharded
replicates the nodal state and all-reduces the full [N, 3] assembly every
CG iteration; here NODES are partitioned (a 1-D spatial split, contiguous
renumbering), each rank owns its node block plus the tetrahedra anchored
there, and the only communication of a CG iteration is a boundary-layer
halo exchange with the neighbours: rows go left (one shift), halo
contributions come back (one shift), and two scalar all_reduces give the
CG dots. Communication scales with the partition boundary, not with N.

Topology invariant (checked at build): with nodes sorted along the split
axis and tets assigned to their minimum corner's partition, every corner
a partition does not own belongs to the NEXT partition. The host builds
the partition once (`build_partitioned`); each rank keeps its own block of
the reference's stacked [D, ...] layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel import sharding as sh
from . import corotational as co
from . import integrator as integ
from .tetmesh import FemMesh, build_fem_mesh

NODE_AXIS = "nodes"


@dataclasses.dataclass(frozen=True)
class PartFemMesh:
    """One rank's block of the partitioned FEM arrays (the reference
    stacks them [D, ...]). 'ext' = owned rows followed by halo rows
    (received from the right neighbour); tets index into that extended
    local space."""

    rest_ext: torch.Tensor    # [Nl+H, 3]
    tets: torch.Tensor        # [Tl, 4] extended-local indices
    inv_dm: torch.Tensor      # [Tl, 3, 3]
    ke: torch.Tensor          # [Tl, 12, 12]
    mass: torch.Tensor        # [Nl]
    free_ext: torch.Tensor    # [Nl+H] bool (owned + halo free mask)
    send_idx: torch.Tensor    # [H] rows THIS rank sends to its LEFT
    perm: torch.Tensor        # [N] partition slot -> original node id
    n_parts: int = 1
    n_local: int = 0
    n_halo: int = 0
    n_nodes: int = 0
    part: int = 0             # the block this rank holds

    @property
    def halo_bytes_per_exchange(self) -> int:
        """Per-iteration communication volume (one direction)."""
        return self.n_parts * self.n_halo * 3 * 4


def _rcm_order(n: int, tets: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of the tet-mesh node graph.

    Bandwidth-minimizing fallback for meshes where no coordinate sort
    keeps every tet within two adjacent partitions (e.g. after
    cut-induced re-tessellation shuffles node ids)."""
    # CSR adjacency from tet edges.
    pairs = []
    for a in range(4):
        for b in range(a + 1, 4):
            pairs.append(tets[:, [a, b]])
    e = np.concatenate(pairs, 0)
    e = np.concatenate([e, e[:, ::-1]], 0)
    e = np.unique(e, axis=0)
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, e[:, 0] + 1, 1)
    indptr = np.cumsum(indptr)
    indices = e[np.argsort(e[:, 0], kind="stable"), 1]
    deg = np.diff(indptr)

    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    # Process components from lowest-degree unvisited seeds.
    seeds = np.argsort(deg, kind="stable")
    for s in seeds:
        if visited[s]:
            continue
        visited[s] = True
        order[pos] = s
        head, pos = pos, pos + 1
        while head < pos:
            v = order[head]
            head += 1
            nbr = indices[indptr[v]:indptr[v + 1]]
            nbr = nbr[~visited[nbr]]
            nbr = nbr[np.argsort(deg[nbr], kind="stable")]
            visited[nbr] = True
            order[pos:pos + len(nbr)] = nbr
            pos += len(nbr)
    return order[::-1].copy()  # reverse CM


def _split_ok(stets: np.ndarray, n_local: int, n_parts: int) -> bool:
    """Every tet must fit inside its min-corner partition plus the next
    one (the halo-exchange topology invariant)."""
    p_min = np.minimum(stets.min(1) // n_local, n_parts - 1)
    return bool(np.all(stets.max(1) < (p_min + 2) * n_local))


def build_partitioned(nodes: np.ndarray, tets: np.ndarray, n_parts: int,
                      fixed: np.ndarray | None = None,
                      axis: int | None = None, *, part: int | None = None,
                      device=None, **material) -> PartFemMesh:
    """Partition a tet mesh for node-split solving (host numpy, as the
    reference) and return block `part` (default: this process's rank, 0
    without a process group) on `device` (the card when None).

    Orders nodes so each tet spans at most two ADJACENT contiguous blocks
    (the halo topology invariant): tries coordinate sorts along each axis
    (longest extent first; `axis` forces one) and falls back to a reverse
    Cuthill–McKee ordering for meshes no coordinate sort can split (e.g.
    after cutting re-tessellates the topology). Splits into n_parts
    blocks (padded with immovable dummy nodes), assigns each tet to its
    minimum corner's partition, and builds the halo index maps. Raises
    ValueError if even RCM cannot satisfy the invariant (then n_parts is
    too large for this mesh)."""
    from .. import default_device

    device = default_device() if device is None else device
    if part is None:
        part = torch.distributed.get_rank() if (
            torch.distributed.is_initialized()) else 0
    nodes = np.asarray(nodes, np.float64)
    tets = np.asarray(tets, np.int64)
    n = len(nodes)
    n_local = -(-n // n_parts)

    if axis is not None:
        candidates = [np.argsort(nodes[:, axis], kind="stable")]
    else:
        # Longest spatial extent first: fewest nodes per cross-section,
        # so the contiguous split has the smallest boundary.
        spans = nodes.max(0) - nodes.min(0)
        candidates = [
            np.argsort(nodes[:, a], kind="stable")
            for a in np.argsort(-spans)
        ]
    candidates.append(None)  # RCM sentinel (built lazily — O(E) work)

    order = None
    for cand in candidates:
        if cand is None:
            cand = _rcm_order(n, tets)
        inv = np.empty(n, np.int64)
        inv[cand] = np.arange(n)
        if n_parts == 1 or _split_ok(inv[tets], n_local, n_parts):
            order = cand
            break
    if order is None:
        raise ValueError(
            f"no node ordering (coordinate sorts or RCM) keeps every tet "
            f"within adjacent partitions at n_parts={n_parts}; "
            f"reduce n_parts for this mesh"
        )
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    snodes = nodes[order]
    stets = inv[tets]

    fixed_mask = np.zeros(n, bool)
    if fixed is not None:
        fixed_mask[np.asarray(fixed, np.int64)] = True
    sfixed = fixed_mask[order]

    n_pad = n_parts * n_local
    if n_pad > n:  # dummy fixed nodes, never referenced
        pad = n_pad - n
        snodes = np.concatenate([snodes, np.zeros((pad, 3))])
        sfixed = np.concatenate([sfixed, np.ones(pad, bool)])

    part_of = np.minimum(stets.min(1) // n_local, n_parts - 1)

    # Element matrices in the sorted frame (shared precompute).
    ref = build_fem_mesh(snodes, stets, fixed=np.nonzero(sfixed)[0],
                         device="cpu", **material)
    ke = ref.ke.numpy()
    inv_dm = ref.inv_dm.numpy()
    mass = ref.mass.numpy()  # [n_pad] (snodes already padded)

    # Per-partition tet lists + halo maps.
    tl = max(int((part_of == p).sum()) for p in range(n_parts))
    halos: list[np.ndarray] = []
    for p in range(n_parts):
        lo, hi = p * n_local, (p + 1) * n_local
        pt = stets[part_of == p]
        out_ids = np.unique(pt[(pt < lo) | (pt >= hi)])
        if out_ids.size and (
            out_ids.min() < lo or out_ids.max() >= hi + n_local
        ):
            raise ValueError(
                f"partition {p}: tets span non-adjacent partitions "
                f"(n_parts={n_parts} too large for this mesh)"
            )
        halos.append(out_ids)
    H = max((h.size for h in halos), default=0)
    H = max(H, 1)  # keep shapes non-degenerate

    p = part
    lo, hi = p * n_local, (p + 1) * n_local
    sel = part_of == p
    pt = stets[sel]
    k = pt.shape[0]
    halo = halos[p]  # global ids owned by p+1, needed by p
    # extended-local remap: owned -> id-lo, halo -> n_local + rank
    ext_of = {int(g): n_local + r for r, g in enumerate(halo)}
    tets_l = np.zeros((tl, 4), np.int32)
    ke_l = np.zeros((tl, 12, 12), np.float32)
    invdm_l = np.tile(np.eye(3, dtype=np.float32), (tl, 1, 1))
    send_idx = np.zeros(H, np.int32)
    free_ext = np.zeros(n_local + H, bool)
    rest_ext = np.zeros((n_local + H, 3), np.float32)
    loc = np.where(
        (pt >= lo) & (pt < hi),
        pt - lo,
        np.vectorize(lambda g: ext_of.get(int(g), 0))(pt)
        if pt.size else pt,
    )
    tets_l[:k] = loc
    ke_l[:k] = ke[sel]
    invdm_l[:k] = inv_dm[sel]
    rest_ext[:n_local] = snodes[lo:hi]
    free_ext[:n_local] = ~sfixed[lo:hi]
    rest_ext[n_local : n_local + halo.size] = snodes[halo]
    free_ext[n_local : n_local + halo.size] = ~sfixed[halo]
    # This rank SENDS its left neighbour's halo rows (its local ids).
    if p > 0 and halos[p - 1].size:
        left = halos[p - 1]
        send_idx[: left.size] = (left - lo).astype(np.int32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return PartFemMesh(
        rest_ext=dev(rest_ext),
        tets=dev(tets_l),
        inv_dm=dev(invdm_l),
        ke=dev(ke_l),
        mass=dev(mass.reshape(n_parts, n_local)[p].astype(np.float32)),
        free_ext=dev(free_ext),
        send_idx=dev(send_idx),
        perm=dev(order.astype(np.int32)),
        n_parts=n_parts,
        n_local=n_local,
        n_halo=H,
        n_nodes=n,
        part=p,
    )


def to_partition_order(pm: PartFemMesh, arr: torch.Tensor) -> torch.Tensor:
    """[N, 3] in original node ids -> [D, Nl, 3] partition layout (all
    ranks' blocks; rank r holds [r])."""
    pad = pm.n_parts * pm.n_local - pm.n_nodes
    a = arr[pm.perm.to(arr.device).long()]
    if pad:
        a = torch.cat([a, a.new_zeros((pad, 3))])
    return a.reshape(pm.n_parts, pm.n_local, 3)


def from_partition_order(pm: PartFemMesh, arr: torch.Tensor) -> torch.Tensor:
    """[D, Nl, 3] partition layout (the ranks' blocks stacked) -> [N, 3]
    original node ids."""
    flat = arr.reshape(-1, 3)[: pm.n_nodes]
    return torch.zeros_like(flat).index_copy(
        0, pm.perm.to(arr.device).long(), flat)


def partitioned_timestep(
    pm: PartFemMesh,
    device_mesh,
    q: torch.Tensor,            # [Nl, 3] this rank's block
    qvel: torch.Tensor,
    f_ext: torch.Tensor,
    h: float = integ.DEFAULT_TIMESTEP,
    damping_mass: float = integ.DEFAULT_DAMPING_MASS,
    damping_stiffness: float = integ.DEFAULT_DAMPING_STIFFNESS,
    cg_tol: float = integ.CG_TOL,
    cg_max_iters: int = integ.CG_MAX_ITERS,
    dv: torch.Tensor | None = None,
    differentiable: bool = False,
):
    """One implicit step, node-partitioned, on this rank's block of the
    partition layout. Semantics of integrator.timestep (tested equal);
    a CG iteration communicates two H-row shifts and two scalar
    all_reduces instead of a full [N, 3] sum.

    dv ([Nl, 3], the previous step's velocity delta) warm-starts CG as
    integrator.timestep's FemState.dv does: the stopping rule is relative
    to |b|, so the warm start cuts iterations. differentiable=True solves
    cold through integrator.symmetric_solve with the distributed matvec
    and solve (the halo shifts are linear, and their backward is the
    reverse shift), so reverse mode runs through the split step; the
    count is then -1. Returns (q', qvel', dv', cg_iters)."""
    group = device_mesh.get_group()
    if sh.shard_index(device_mesh)[1] != pm.part:
        raise ValueError(f"rank holds block {pm.part}, mesh says "
                         f"{sh.shard_index(device_mesh)[1]}")
    Nl = pm.n_local
    send_idx = pm.send_idx.long()
    free = pm.free_ext[:Nl, None]
    free_e = pm.free_ext[:, None]
    m = pm.mass[:, None]
    if dv is None:
        dv = torch.zeros_like(q)

    def exchange(v):
        """Owned rows [Nl,3] -> extended [Nl+H,3] with the halo from the
        right neighbour (rows it owns that our tets reference)."""
        halo = sh.shift(v[send_idx], -1, group)
        return torch.cat([v, halo], 0)

    def collect(ext):
        """Extended contributions -> owned rows: the halo part goes back
        to its owner (the right neighbour), added at its send rows."""
        recv = sh.shift(ext[Nl:], 1, group)
        return ext[:Nl].index_add(0, send_idx, recv)

    lm = FemMesh(
        rest=pm.rest_ext, tets=pm.tets.long(), inv_dm=pm.inv_dm,
        volume=pm.rest_ext.new_zeros(pm.tets.shape[0]), ke=pm.ke,
        mass=pm.rest_ext.new_zeros(pm.rest_ext.shape[0]),
        fixed=~pm.free_ext, node_gather=None,
        n_nodes=pm.rest_ext.shape[0], n_tets=pm.tets.shape[0],
    )

    q_ext = exchange(q)
    qvel_ext = exchange(qvel)
    _, R = co.element_kinematics(lm, q_ext)
    krot = co.rotated_stiffness(lm, R)
    f_int = collect(co.internal_forces(lm, q_ext, R))
    kq = collect(co.stiffness_apply_pre(lm, krot, qvel_ext))

    residual = -h * (
        (h + damping_stiffness) * kq
        + damping_mass * m * qvel
        + f_int
        - f_ext
    )
    residual = torch.where(free, residual, 0.0)

    mass_coef = 1.0 + h * damping_mass
    stiff_coef = h * damping_stiffness + h * h

    def operator(v, krot_, m_):
        vf = torch.where(free, v, 0.0)
        ve = torch.where(free_e, exchange(vf), 0.0)
        out = mass_coef * m_ * vf + stiff_coef * collect(
            co.stiffness_apply_pre(lm, krot_, ve)
        )
        return torch.where(free, out, v)

    with torch.no_grad():
        eye = torch.eye(3, dtype=residual.dtype, device=residual.device)
        # collect() is width-agnostic: block rows travel as [*, 9].
        blk = collect(co.stiffness_blocks(lm, krot).reshape(-1, 9))
        blocks = (mass_coef * m)[..., None] * eye + stiff_coef * (
            blk.reshape(Nl, 3, 3))
        inv_blocks = co._inv3(torch.where(free[..., None], blocks, eye))

    def prec(r):
        return (inv_blocks @ r[..., None])[..., 0]

    def pdot(a, b):
        return sh.all_reduce(torch.sum(a * b), group)

    def run_pcg(mv, b, x0=None):
        """PCG with distributed dots (mirrors integrator.pcg); the loop
        test reads the all-reduced r.z on the host once an iteration, the
        same value on every rank."""
        thresh = float((cg_tol * cg_tol) * pdot(b, prec(b)))
        if x0 is None:
            x = torch.zeros_like(b)
            r = b
        else:
            x = x0
            r = b - mv(x0)
        z = prec(r)
        p = z
        rz = pdot(r, z)
        it = 0
        while it < cg_max_iters and float(rz) > thresh:
            ap = mv(p)
            alpha = rz / torch.clamp(pdot(p, ap), min=1e-30)
            x = x + alpha * p
            r = r - alpha * ap
            z = prec(r)
            rz_new = pdot(r, z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            p = z + beta * p
            rz = rz_new
            it += 1
        return x, it

    if differentiable:
        # No warm start: the adjoint solve reuses `run_pcg`, where the
        # primal guess would be wrong.
        dv_new = integ.symmetric_solve(operator, residual, (krot, m),
                                       run_pcg)
        it = -1
    else:
        dv_new, it = run_pcg(lambda v: operator(v, krot, m), residual,
                             torch.where(free, dv, 0.0))

    qvel_new = torch.where(free, qvel + dv_new, 0.0)
    q_new = torch.where(free, q + h * qvel_new, 0.0)
    return q_new, qvel_new, dv_new, it
