"""The deployment of the brain.sim probe configuration: the program's
scene, tet mesh, unstructured FEM (`FemMesh` and `Deformable`) and
displacement interpolant, built through the port's own entry points, and
what the benchmark makes itself and hands to both the program and the
reference: the anchors, the camera's rays and the probe's contact sites.

The anchors are the grid configurations' (the bottom `anchor_frac` of
each connected part, from the reference's grid); the reference's step
runs on the program's tet mesh, its interpolant on the same nodes. A
contact site is a boundary node of the tet mesh, not anchored, whose
outward normal (the area-weighted mean of its boundary faces' normals)
faces the camera: cos(normal, node to eye) at least SITE_MIN_COS.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from harness import brain
from reference import fem as rfem
from reference import interp as rinterp
from reference import probe as rprobe
from reference import scene as rscene
from reference.field import Precision
from reference.tetfem import TetStep

SITE_MIN_COS = 0.5
# The grid spacing of the bound on |u| (SimDeployment.disp_bounds).
BOUND_SPACING = 0.1


@dataclasses.dataclass
class SimDeployment(brain.Deployment):
    fem: object = None        # the program's FemMesh
    body: object = None       # its Deformable
    nodes: np.ndarray = None  # [N, 3] float32 rest positions
    tets: np.ndarray = None   # [T, 4]
    fixed: np.ndarray = None  # [N] bool anchors
    sites: np.ndarray = None  # [S] node ids of the contact sites
    normals: np.ndarray = None  # [S, 3] their outward unit normals
    graph: object = None      # the reference's node graph
    bound_grid: tuple = None  # disp_bounds' grid, distances and radius

    def ref_step(self, prec: Precision, tol: float = 1e-10,
                 max_iters: int = 10_000) -> TetStep:
        c = self.config
        return TetStep(self.nodes, self.tets, self.fixed, c["E"], c["nu"],
                       c["rho"], c["h"], c["damping_mass"],
                       c["damping_stiffness"], self.device, prec, tol,
                       max_iters)

    def ref_probe(self) -> rprobe.Probe:
        c = self.config
        return rprobe.Probe(np.full(3, c["probe_half_extent"]),
                            c["force_coeff"])

    def positions(self, q: torch.Tensor) -> np.ndarray:
        """The program's node positions at state q [N, 3], float64."""
        return (torch.as_tensor(self.nodes) + q.detach().cpu()).double() \
            .numpy()

    def disp_bounds(self, qs) -> np.ndarray:
        """[F] a certified bound on |u| over the box of the primitives'
        supports for each of the states qs ([N, 3] or [N * 3] each), from
        the reference's interpolant in float64: the largest |u| at the
        points of a grid over the box, spaced at most BOUND_SPACING, plus
        L times the grid's covering radius, L = sum |w_k| + |B|_F bounding
        |grad u| (the kernel |x - c| has a unit gradient). The box holds
        every point where the rest field is not zero, so a trace whose
        bracket inflation `max_disp` lies above the bound reaches every
        deformed surface point and every primitive's deformed support."""
        ri = self.ref_interp
        m = len(ri.center_nodes)
        dev = self.ref_cgi.device
        if self.bound_grid is None:
            lo = self.ref_scene.box_lo.min(0).astype(np.float64)
            hi = self.ref_scene.box_hi.max(0).astype(np.float64)
            n = np.ceil((hi - lo) / BOUND_SPACING).astype(int) + 1
            axes = [np.linspace(lo[i], hi[i], n[i]) for i in range(3)]
            pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
            pts = torch.as_tensor(pts.reshape(-1, 3), device=dev)
            c = torch.as_tensor(ri.centers, dtype=torch.float64, device=dev)
            self.bound_grid = (pts, torch.cdist(pts, c),
                               0.5 * float(np.linalg.norm((hi - lo)
                                                          / (n - 1))))
        pts, dist, radius = self.bound_grid
        a = torch.as_tensor(ri.a_inv, dtype=torch.float64, device=dev)[:, :m]
        out = []
        for q in qs:
            u_c = q.detach().reshape(-1, 3)[self.ref_cgi].double()
            w = a @ u_c
            L = (torch.sum(torch.linalg.norm(w[:m], dim=1))
                 + torch.linalg.norm(w[m + 1:]))
            u = dist @ w[:m] + w[m] + pts @ w[m + 1:]
            out.append(torch.linalg.norm(u, dim=1).max() + L * radius)
        return torch.stack(out).cpu().numpy()


def boundary_normals(nodes: np.ndarray, tets: np.ndarray):
    """(boundary node ids, their outward unit normals): a face held by
    one tetrahedron is on the boundary; its normal points away from the
    tetrahedron's fourth corner."""
    t = np.asarray(tets, np.int64)
    faces = np.concatenate([t[:, [1, 2, 3]], t[:, [0, 2, 3]],
                            t[:, [0, 1, 3]], t[:, [0, 1, 2]]])
    other = np.concatenate([t[:, 0], t[:, 1], t[:, 2], t[:, 3]])
    _, inv, count = np.unique(np.sort(faces, 1), axis=0,
                              return_inverse=True, return_counts=True)
    once = count[inv.reshape(-1)] == 1
    f, o = faces[once], other[once]
    x = np.asarray(nodes, np.float64)
    n = np.cross(x[f[:, 1]] - x[f[:, 0]], x[f[:, 2]] - x[f[:, 0]])
    n *= np.where(np.sum(n * (x[o] - x[f[:, 0]]), 1) > 0, -1.0, 1.0)[:, None]
    acc = np.zeros_like(x)
    for k in range(3):
        np.add.at(acc, f[:, k], n)
    ids = np.unique(f)
    nn = acc[ids]
    return ids, nn / np.linalg.norm(nn, axis=1, keepdims=True)


def load(root: Path, config: dict, device, roll: float) -> SimDeployment:
    """Build the deployment; `roll` is the camera's, which the contact
    sites face."""
    from fembrain_tpu_torch.blob.reader import load_blob
    from fembrain_tpu_torch.fem.deformable import Deformable
    from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
    from fembrain_tpu_torch.mesh.polygonize import (
        extract_tet_mesh, grid_for_scene,
    )
    from fembrain_tpu_torch.render.deformed import build_disp_interp

    c, dev = config, torch.device(device)
    path = root / c["scene"]
    sdef = load_blob(path)
    sdef.flatten_instances()
    dep = SimDeployment(config=c, device=dev, scene=sdef.pack(device=dev),
                        ref_scene=rscene.load(path))
    ref = rfem.make_grid(dep.ref_scene, c["cellsize"], c["anchor_frac"],
                         c["rho"], dev)
    grid = grid_for_scene(dep.scene, cellsize=c["cellsize"])
    tm = extract_tet_mesh(dep.scene, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    mask = np.zeros(tuple(d - 1 for d in ref.dims), bool)
    mask[tuple(ref.cells.T)] = True
    if tuple(grid.dims) != tuple(ref.dims) or not np.array_equal(
            tm.cell_mask.cpu().numpy(), mask):
        raise RuntimeError("the program's tet mesh differs from the "
                           "reference's cells")
    g2n = tm.grid_to_node.cpu().numpy()
    n2g = np.flatnonzero(g2n >= 0)
    nodes = tm.nodes[: tm.n_nodes].cpu().numpy()
    tets = tm.tets[: tm.n_tets].cpu().numpy()
    fixed = ref.fixed.reshape(-1)[n2g]
    dep.fem = build_fem_mesh(nodes, tets, fixed=fixed, E=c["E"], nu=c["nu"],
                             rho=c["rho"], device=dev)
    dep.body = Deformable(dep.fem, h=c["h"], gravity=0.0, ground_y=None,
                          damping_mass=c["damping_mass"],
                          damping_stiffness=c["damping_stiffness"],
                          cg_max_iters=c["cg_max_iters"])
    dep.interp = build_disp_interp(nodes, n_centers=c["n_centers"],
                                   kernel=c["interpolant"], device=dev)
    dep.nodes, dep.tets, dep.fixed = nodes, tets, fixed
    flat_active = np.flatnonzero(ref.active.reshape(-1))
    ri = rinterp.build(ref.points.reshape(-1, 3)[flat_active],
                       c["interpolant"], c["n_centers"])
    dep.ref_interp = ri
    dep.ref_cgi = torch.as_tensor(g2n[flat_active[ri.center_nodes]]
                                  .astype(np.int64), device=dev)
    ids, nrm = boundary_normals(nodes, tets)
    r, t, z = np.deg2rad(roll), np.deg2rad(c["tilt_deg"]), c["zoom"]
    eye = z * np.array([np.cos(t) * np.sin(r), np.sin(t),
                        np.cos(t) * np.cos(r)])
    to_eye = eye[None] - nodes[ids]
    cos = np.sum(nrm * to_eye, 1) / np.linalg.norm(to_eye, axis=1)
    keep = (cos >= SITE_MIN_COS) & ~fixed[ids]
    dep.sites, dep.normals = ids[keep], nrm[keep]
    dep.graph = rprobe.node_graph(tets, len(nodes))
    return dep
