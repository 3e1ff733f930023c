"""The deployment of a brain configuration: the program's scene, tet
mesh, grid FEM and displacement interpolant, built through the port's
own entry points, and what the benchmark makes itself and hands to both
the program and the reference: the anchors, the gravity load and the
camera rays.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from reference import fem as rfem
from reference import interp as rinterp
from reference import scene as rscene
from reference import trace as rtrace
from reference.field import Precision


@dataclasses.dataclass
class Deployment:
    config: dict
    device: torch.device
    scene: object            # the program's packed scene
    ref_scene: rscene.RefScene
    grid: object = None      # the program's GridSpec
    gf: object = None        # the program's GridFem
    interp: object = None    # the program's DispInterp
    cgi: torch.Tensor = None  # its centres' flat grid indices
    f_ext: torch.Tensor = None  # [X, Y, Z, 3] the load, made here
    ref_grid: rfem.Grid = None
    ref_interp: rinterp.Interp = None
    ref_cgi: torch.Tensor = None  # the reference centres' flat grid indices

    def rays(self, roll: float):
        c = self.config
        return rtrace.orbit_rays(roll, c["tilt_deg"], c["zoom"], c["width"],
                                 c["height"], self.device)

    @property
    def image_hw(self):
        return (self.config["height"], self.config["width"])

    def ref_step(self, prec: Precision) -> rfem.Step:
        c = self.config
        return rfem.Step(self.ref_grid, c["E"], c["nu"], c["h"],
                         c["damping_mass"], c["damping_stiffness"],
                         self.device, prec)

    def ref_disp(self, q_flat: torch.Tensor, prec: Precision):
        """The reference's displacement of the frame whose grid state is
        `q_flat` [n, 3]: weights at its own centres, then the trace's
        inputs."""
        c = self.config
        u_c = q_flat[self.ref_cgi]
        w = rinterp.weights(self.ref_interp, u_c, prec)
        if self.ref_interp.kind == "wendland":
            return rinterp.wendland_disp(self.ref_interp, w, c["k_refresh"],
                                         prec)
        return rinterp.biharmonic_disp(self.ref_interp, w, c["max_disp"],
                                       c["fp_iters"], prec)


def load(root: Path, config: dict, device, fem: bool) -> Deployment:
    """Build the deployment; without `fem`, the scene alone."""
    from fembrain_tpu_torch.blob.reader import load_blob

    path = root / config["scene"]
    sdef = load_blob(path)
    sdef.flatten_instances()
    dep = Deployment(config=config, device=torch.device(device),
                     scene=sdef.pack(device=device),
                     ref_scene=rscene.load(path))
    if fem:
        _build_fem(dep)
    return dep


def _build_fem(dep: Deployment) -> None:
    from fembrain_tpu_torch.fem import grid_fem as gfm
    from fembrain_tpu_torch.mesh.polygonize import (
        extract_tet_mesh, grid_for_scene,
    )
    from fembrain_tpu_torch.render.deformed import build_disp_interp

    c, dev = dep.config, dep.device
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
    n2g = gfm.node_to_grid_index(tm)
    gf = gfm.grid_fem_from_tetmesh(
        grid, tm, fixed_nodes=ref.fixed.reshape(-1)[n2g], E=c["E"],
        nu=c["nu"], rho=c["rho"], device=dev)
    nodes = tm.nodes[: tm.n_nodes].cpu().numpy()
    kw = {"sigma_fill": c["sigma_fill"]} if c["interpolant"] == "wendland" \
        else {}
    interp = build_disp_interp(nodes, n_centers=c["n_centers"],
                               kernel=c["interpolant"], device=dev, **kw)
    load_ = np.zeros((*ref.dims, 3), np.float32)
    load_[..., 1] = c["gravity"] * ref.mass
    ref_nodes = ref.points.reshape(-1, 3)[ref.active.reshape(-1)]
    ri = rinterp.build(ref_nodes, c["interpolant"], c["n_centers"],
                       c.get("sigma_fill", 3.0))
    flat_active = np.flatnonzero(ref.active.reshape(-1))
    dep.grid, dep.gf, dep.interp = grid, gf, interp
    dep.cgi = torch.as_tensor(
        n2g[interp.center_nodes.cpu().numpy()].astype(np.int64), device=dev)
    dep.f_ext = torch.as_tensor(load_, device=dev)
    dep.ref_grid, dep.ref_interp = ref, ri
    dep.ref_cgi = torch.as_tensor(flat_active[ri.center_nodes], device=dev)
