"""Polygonization (marching tetrahedra) and embedded tetrahedral mesh
extraction on a voxel grid.

PyTorch counterpart of fembrain_tpu/mesh/polygonize.py (the reference's
marching-cubes pipeline, data/opencl/Polygonizer.cl:1215-1670, and its
voxel tetrahedralizer, data/opencl/Tetrahedralizer.cl:3-132). Marching
tetrahedra over the Kuhn 6-tet split (mesh.tables) give the render surface
and the FEM tet mesh from one decomposition, so every surface vertex lies
on a tet edge and carries its exact barycentric embedding
(`edge_nodes`, `edge_t`). Compaction is a prefix sum (torch.cumsum) on the
scene's device; outputs have fixed capacity, and the surface's counts stay
on the device until `check_capacity` reads them. Vertex positions and
normals are differentiable in the scene's parameters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..blob.scene import Scene
from ..blob.types import DEFAULT_CELL_SIZE, ISO_VALUE
from ..ops.field import field, vertex_attributes
from . import tables as T


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Host-side (static) voxel grid: origin, vertex dims, cell size."""

    lo: tuple[float, float, float]
    dims: tuple[int, int, int]  # number of grid VERTICES per axis
    cellsize: float

    @property
    def n_vertices(self) -> int:
        x, y, z = self.dims
        return x * y * z

    @property
    def n_cells(self) -> int:
        x, y, z = self.dims
        return (x - 1) * (y - 1) * (z - 1)


def grid_for_scene(
    scene: Scene, cellsize: float = DEFAULT_CELL_SIZE, margin: float = 0.1
) -> GridSpec:
    """Grid covering the scene AABB (reference OclPolygonizer.cpp:1363-1379)."""
    lo = scene.bbox_lo.detach().cpu().numpy() - margin
    hi = scene.bbox_hi.detach().cpu().numpy() + margin
    dims = tuple(int(d) for d in np.maximum(np.ceil((hi - lo) / cellsize) + 1, 2))
    return GridSpec(tuple(float(v) for v in lo), dims, float(cellsize))


@dataclasses.dataclass(frozen=True)
class SurfaceMesh:
    """Fixed-capacity triangle mesh with per-vertex attributes and the
    barycentric edge embedding used for FEM coupling."""

    verts: torch.Tensor        # [Vcap, 3]
    normals: torch.Tensor      # [Vcap, 3]
    colors: torch.Tensor       # [Vcap, 4]
    tris: torch.Tensor         # [Tcap, 3] int32 vertex indices
    n_verts: torch.Tensor      # scalar i32, on the device
    n_tris: torch.Tensor       # scalar i32, on the device
    edge_nodes: torch.Tensor   # [Vcap, 2] int32 grid-vertex linear ids (a, b)
    edge_t: torch.Tensor       # [Vcap] interpolation parameter along (a, b)


@dataclasses.dataclass(frozen=True)
class TetMesh:
    """Fixed-capacity embedded tetrahedral mesh (6 tets per active voxel)."""

    nodes: torch.Tensor         # [Ncap, 3] rest positions
    tets: torch.Tensor          # [TetCap, 4] node indices
    n_nodes: int
    n_tets: int
    grid_to_node: torch.Tensor  # [n_grid_vertices] node id or -1
    # [CX,CY,CZ] bool, the cells whose 6 Kuhn tets are in `tets` — the
    # structured view that fem.grid_fem builds its stencil solver from.
    cell_mask: torch.Tensor | None = None


class CapacityError(RuntimeError):
    """A fixed-capacity mesh extraction overflowed its caps: the returned
    arrays dropped entries and must not be used."""


def _grid_points(grid: GridSpec, device) -> torch.Tensor:
    X, Y, Z = grid.dims
    ii, jj, kk = torch.meshgrid(
        *(torch.arange(d, device=device, dtype=torch.float32) for d in (X, Y, Z)),
        indexing="ij",
    )
    lo = torch.tensor(grid.lo, dtype=torch.float32, device=device)
    return lo + torch.stack([ii, jj, kk], -1) * grid.cellsize


def _lin(grid: GridSpec, i, j, k):
    X, Y, Z = grid.dims
    return (i * Y + j) * Z + k


def _shift(a: torch.Tensor, off, fill) -> torch.Tensor:
    """a[v + off] on a 3-D grid (off >= 0 per axis), `fill` outside."""
    ox, oy, oz = int(off[0]), int(off[1]), int(off[2])
    x, y, z = a.shape[:3]
    b = torch.nn.functional.pad(a, (0, oz, 0, oy, 0, ox), value=fill)
    return b[ox : ox + x, oy : oy + y, oz : oz + z]


def _drop_set(cap: int, dst: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """zeros([cap, ...]) with rows written at dst; dst == cap (and beyond)
    lands in one dump row that is sliced off."""
    out = rows.new_zeros((cap + 1,) + rows.shape[1:])
    return out.index_put((torch.clamp(dst, max=cap),), rows)[:cap]


def polygonize(scene: Scene, grid: GridSpec, vcap: int, tcap: int,
               iso: float = ISO_VALUE) -> SurfaceMesh:
    """Extract the iso-surface triangle mesh on the scene's device, at
    fixed capacity (vcap vertices, tcap triangles): entries beyond the
    caps are dropped, so pass the result to `check_capacity`."""
    dev = scene.prim_pos.device
    X, Y, Z = grid.dims
    h = grid.cellsize
    pts = _grid_points(grid, dev)                          # [X,Y,Z,3]
    F = field(scene, pts.reshape(-1, 3)).reshape(X, Y, Z)
    inside = F >= iso

    # ---- edge table: 7 direction masks per grid vertex ------------------
    ii, jj, kk = torch.meshgrid(
        *(torch.arange(d, device=dev) for d in (X, Y, Z)), indexing="ij"
    )
    crossed_list, fb_list = [], []
    for m in range(1, 8):
        off = T.DIR_OFFSET[m]
        valid = torch.ones((X, Y, Z), dtype=torch.bool, device=dev)
        if off[0]:
            valid = valid & (ii < X - 1)
        if off[1]:
            valid = valid & (jj < Y - 1)
        if off[2]:
            valid = valid & (kk < Z - 1)
        crossed_list.append((inside != _shift(inside, off, False)) & valid)
        fb_list.append(_shift(F, off, 1e9))
    crossed = torch.stack(crossed_list, -1)                # [X,Y,Z,7]
    Fb = torch.stack(fb_list, -1)

    flat_crossed = crossed.reshape(-1)
    vid = torch.cumsum(flat_crossed, 0, dtype=torch.int32) - 1
    n_verts = vid[-1] + 1

    # ---- vertex positions: linear root on each crossed edge -------------
    fa = F[..., None]
    denom = Fb - fa
    t = (iso - fa) / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    t = torch.clamp(t, 0.0, 1.0)                           # [X,Y,Z,7]
    offs_i = torch.as_tensor(T.DIR_OFFSET[1:8], device=dev)       # [7,3]
    offs = offs_i.to(torch.float32) * h
    pos = pts[..., None, :] + t[..., None] * offs          # [X,Y,Z,7,3]

    dst = torch.where(flat_crossed, vid, vcap).long()
    verts = _drop_set(vcap, dst, pos.reshape(-1, 3))
    edge_t = _drop_set(vcap, dst, t.reshape(-1))

    # Edge endpoints (grid linear ids) for FEM barycentric coupling.
    lin_a = _lin(grid, ii, jj, kk)[..., None]
    lin_b = _lin(grid, ii[..., None] + offs_i[:, 0], jj[..., None] + offs_i[:, 1],
                 kk[..., None] + offs_i[:, 2])
    ab = torch.stack([lin_a.expand_as(lin_b).reshape(-1), lin_b.reshape(-1)],
                     -1).to(torch.int32)
    edge_nodes = _drop_set(vcap, dst, ab)

    # ---- per-vertex attributes: one primitive pass for field, gradient
    # (normals) and colours.
    _, g, colors = vertex_attributes(scene, verts)
    normals = -g * torch.rsqrt(
        torch.clamp(torch.sum(g * g, -1, keepdim=True), min=1e-24)
    )

    # ---- triangle emission: marching tets over the Kuhn split -----------
    CX, CY, CZ = X - 1, Y - 1, Z - 1
    corner_in = [
        _shift(inside, T.CORNER_OFFSET[b], False)[:CX, :CY, :CZ]
        for b in range(8)
    ]
    ci, cj, ck = ii[:CX, :CY, :CZ], jj[:CX, :CY, :CZ], kk[:CX, :CY, :CZ]
    tri_count_tbl = torch.as_tensor(T.TRI_COUNT, device=dev)       # [6,16]
    tri_table = torch.as_tensor(T.TRI_TABLE, device=dev)           # [6,16,2,3]
    edge_base = torch.as_tensor(T.TET_EDGE_BASE, device=dev)       # [6,6]
    edge_dir = torch.as_tensor(T.TET_EDGE_DIR, device=dev)         # [6,6]
    corner_off = torch.as_tensor(T.CORNER_OFFSET, device=dev)      # [8,3]

    cases = torch.stack([
        sum(corner_in[int(T.TET_CORNERS[k, j])].long() << j for j in range(4))
        for k in range(6)
    ], -1)                                                  # [CX,CY,CZ,6]
    ntri = tri_count_tbl.long()[torch.arange(6, device=dev), cases]
    flat_ntri = ntri.reshape(-1)
    tri_start = (torch.cumsum(flat_ntri, 0) - flat_ntri).reshape(CX, CY, CZ, 6)
    n_tris = torch.sum(flat_ntri)

    tris = torch.zeros((tcap + 1, 3), dtype=torch.int32, device=dev)
    for k in range(6):
        case_k = cases[..., k]
        for s_ in range(2):
            emit = s_ < ntri[..., k]
            tri_edges = tri_table[k, case_k, s_].long()    # [CX,CY,CZ,3]
            tri_idx = []
            for v in range(3):
                e = tri_edges[..., v]
                boff = corner_off[edge_base[k, e].long()]  # [...,3]
                lin_v = _lin(grid, ci + boff[..., 0], cj + boff[..., 1],
                             ck + boff[..., 2])
                slot = lin_v * 7 + (edge_dir[k, e].long() - 1)
                tri_idx.append(vid[slot.reshape(-1)])
            dst_t = torch.where(emit.reshape(-1),
                                tri_start[..., k].reshape(-1) + s_, tcap)
            tris = tris.index_put((torch.clamp(dst_t, max=tcap),),
                                  torch.stack(tri_idx, -1))
    return SurfaceMesh(
        verts=verts, normals=normals, colors=colors, tris=tris[:tcap],
        n_verts=n_verts.to(torch.int32), n_tris=n_tris.to(torch.int32),
        edge_nodes=edge_nodes, edge_t=edge_t,
    )


def default_caps(grid: GridSpec) -> tuple[int, int]:
    """Vertex/triangle capacity heuristic: the surface scales with the
    grid's largest slice, with headroom (reference bounds MPUs at 512/8^3
    cells, src/implicit/Polygonizer.h:80-81)."""
    X, Y, Z = grid.dims
    per_slice = max(X * Y, Y * Z, X * Z)
    vcap = int(min(7 * X * Y * Z, 24 * per_slice))
    return vcap, 2 * vcap


def check_capacity(mesh) -> None:
    """Raise CapacityError if a SurfaceMesh's or TetMesh's true counts
    exceed its array capacities (the arrays then dropped entries). Reads
    the surface's two counts from the device: call it once per mesh,
    outside any hot loop."""
    if isinstance(mesh, SurfaceMesh):
        nv, nt = int(mesh.n_verts), int(mesh.n_tris)
        vcap, tcap = mesh.verts.shape[0], mesh.tris.shape[0]
        if nv > vcap or nt > tcap:
            raise CapacityError(
                f"surface overflow: {nv} verts (cap {vcap}), "
                f"{nt} tris (cap {tcap})"
            )
    elif isinstance(mesh, TetMesh):
        ncap, tetcap = mesh.nodes.shape[0], mesh.tets.shape[0]
        if mesh.n_nodes > ncap or mesh.n_tets > tetcap:
            raise CapacityError(
                f"tet-mesh overflow: {mesh.n_nodes} nodes (cap {ncap}), "
                f"{mesh.n_tets} tets (cap {tetcap})"
            )
    else:
        raise TypeError(f"unknown mesh type {type(mesh)!r}")


def extract_tet_mesh(scene: Scene, grid: GridSpec, ncap: int, tetcap: int,
                     iso: float = ISO_VALUE) -> TetMesh:
    """Embedded tet mesh: 6 Kuhn tets for every voxel with any inside
    corner, on the scene's device. Raises CapacityError when the mesh
    does not fit in (ncap, tetcap)."""
    dev = scene.prim_pos.device
    X, Y, Z = grid.dims
    pts = _grid_points(grid, dev)
    F = field(scene, pts.reshape(-1, 3)).reshape(X, Y, Z)
    inside = F >= iso

    CX, CY, CZ = X - 1, Y - 1, Z - 1
    used_cell = torch.zeros((CX, CY, CZ), dtype=torch.bool, device=dev)
    for b in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
        used_cell |= inside[ox : ox + CX, oy : oy + CY, oz : oz + CZ]

    # A grid vertex is a node if any of its (up to 8) incident cells is
    # used: node v is corner b of cell v - offset(b).
    used_pad = torch.nn.functional.pad(used_cell, (1, 1, 1, 1, 1, 1))
    node_used = torch.zeros((X, Y, Z), dtype=torch.bool, device=dev)
    for b in range(8):
        ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[b])
        node_used |= used_pad[1 - ox : 1 - ox + X, 1 - oy : 1 - oy + Y,
                              1 - oz : 1 - oz + Z]

    flat_used = node_used.reshape(-1)
    nid = torch.cumsum(flat_used.to(torch.int32), 0, dtype=torch.int32) - 1
    n_nodes = int(flat_used.sum())
    grid_to_node = torch.where(flat_used, nid, -1)
    flat_uc = used_cell.reshape(-1)
    cell_rank = torch.cumsum(flat_uc.to(torch.int32), 0, dtype=torch.int32) - 1
    n_tets = int(flat_uc.sum()) * 6
    if n_nodes > ncap or n_tets > tetcap:
        raise CapacityError(
            f"tet-mesh overflow: {n_nodes} nodes (cap {ncap}), "
            f"{n_tets} tets (cap {tetcap})"
        )

    nodes = torch.zeros((ncap, 3), dtype=torch.float32, device=dev)
    nodes[nid[flat_used].long()] = pts.reshape(-1, 3)[flat_used]

    ci, cj, ck = torch.meshgrid(
        *(torch.arange(d, device=dev) for d in (CX, CY, CZ)), indexing="ij"
    )
    tets = torch.zeros((tetcap, 4), dtype=torch.int32, device=dev)
    dst = cell_rank[flat_uc].long() * 6
    for k in range(6):
        corner_ids = []
        for j in range(4):
            ox, oy, oz = (int(v) for v in T.CORNER_OFFSET[T.TET_CORNERS[k, j]])
            lin_v = _lin(grid, ci + ox, cj + oy, ck + oz).reshape(-1)
            corner_ids.append(nid[lin_v])
        tets[dst + k] = torch.stack(corner_ids, -1)[flat_uc]

    return TetMesh(
        nodes=nodes,
        tets=tets,
        n_nodes=n_nodes,
        n_tets=n_tets,
        grid_to_node=grid_to_node,
        cell_mask=used_cell,
    )
