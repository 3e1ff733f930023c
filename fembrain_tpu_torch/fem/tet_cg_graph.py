"""The unstructured step's forward PCG replayed as CUDA graphs.

`integrator.timestep` on a CUDA tensor solves its warm-started forward
system through `GraphedTetCg`: the grid solver's two graphs
(fem.grid_fem.GraphedCg: the prologue, `pcg_start` and the threshold,
and one iteration, `pcg_update`) captured over static buffers on the tet
mesh's operator and block-Jacobi preconditioner. A solve copies this
step's right side, warm start, rotated element stiffness and inverted
diagonal blocks in, then replays one graph an iteration and reads z.r
until pcg's own stopping rule holds: pcg's kernels, iterates and count,
with one launch an iteration from the host instead of about thirty.
Captures and replays count in `grid_fem.CG_GRAPH`.
"""
from __future__ import annotations

import collections

import torch

from ..utils.profiler import span
from .grid_fem import GraphedCg
from .integrator import _block_jacobi, _operator, pcg_start, with_long_indices
from .tetmesh import FemMesh

# The graphed solves by tet_cg_key, least recently used first.
_CACHE: collections.OrderedDict = collections.OrderedDict()
_CACHE_SIZE = 4


def tet_cg_key(mesh: FemMesh, mass_coef, stiff_coef, b, krot, inv_blocks,
               warm) -> tuple:
    """What a graphed solve is captured for: the mesh by the identity of
    the arrays the operator reads (tets, node_gather, mass, fixed), the
    step's coefficients, whether CG starts warm, and the memory layouts
    (strides) of b, krot and inv_blocks, which fix the order in which
    pcg's products and dots sum. Not the FemMesh: a frame that scales its
    stiffness (`dataclasses.replace(mesh, ke=...)`) keeps all of these,
    and the solve copies krot and inv_blocks in."""
    arrays = (mesh.tets, mesh.node_gather, mesh.mass, mesh.fixed)
    return (tuple(id(a) for a in arrays), mesh.n_nodes, b.dtype, b.device,
            float(mass_coef), float(stiff_coef), bool(warm), b.stride(),
            krot.stride(), inv_blocks.stride())


def graphed_tet_cg(mesh: FemMesh, mass_coef, stiff_coef, b, krot,
                   inv_blocks, warm) -> "GraphedTetCg":
    """The cached graphed solve of `tet_cg_key`, built and, on a CUDA
    device, captured at first use."""
    key = tet_cg_key(mesh, mass_coef, stiff_coef, b, krot, inv_blocks, warm)
    cg = _CACHE.get(key)
    if cg is None:
        with span("fem.cg_capture"):
            cg = GraphedTetCg(mesh, mass_coef, stiff_coef, b, krot,
                              inv_blocks, warm)
        _CACHE[key] = cg
        if len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    _CACHE.move_to_end(key)
    return cg


class GraphedTetCg(GraphedCg):
    """GraphedCg's bodies, capture, replay and solve on the tet mesh's
    step. Its per-step slots hold the unstructured step's parameters:
    `ke` the rotated element stiffness K_rot [T, 12, 12] that the
    operator applies, `R` the inverted 3x3 diagonal blocks of K_eff
    [N, 3, 3] that precondition, so `solve(b, krot, inv_blocks, x0, ...)`
    copies both in. The mesh's arrays (held, so their identities in the
    key stay theirs) and masses are static; nothing here takes a
    gradient."""

    def __init__(self, mesh: FemMesh, mass_coef, stiff_coef, b, krot,
                 inv_blocks, warm):
        self.arrays = (mesh.tets, mesh.node_gather, mesh.mass, mesh.fixed)
        mesh = with_long_indices(mesh)
        free = ~mesh.fixed[:, None]
        self.m = mesh.mass.detach()[:, None]
        self.b = torch.zeros_like(b)
        self.x0 = torch.zeros_like(b) if warm else None
        self.ke = torch.zeros_like(krot)
        self.R = torch.zeros_like(inv_blocks)
        self.tol2 = b.new_zeros(())
        self.head = b.new_zeros(2)    # threshold and z.r after the prologue
        self.rz = self.head[1]
        operator = _operator(mesh, free, mass_coef, stiff_coef)
        self.matvec = lambda v: operator(v, self.ke, self.m)
        self.prec = _block_jacobi(self.R)
        _, x, r, p, _ = pcg_start(self.matvec, self.b, self.prec, self.x0)
        self.x, self.r, self.p = (torch.zeros_like(t) for t in (x, r, p))
        self.bodies = (self._prologue, self._iteration)
        self.graphs = self._capture() if b.is_cuda else None
