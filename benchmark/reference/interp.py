"""The plain displacement interpolant of the coupled frame.

Centres are FEM nodes picked by farthest-point sampling from node 0
(float64 distances between the float32 node positions). The Wendland
interpolant orders them by the Morton code of their positions, takes the
support sigma = sigma_fill * max(fill distance, median nearest-centre
spacing) and interpolates the centres' displacements exactly with
phi(t) = (1 - t)^4 (4 t + 1), t = min(r / sigma, 1): w = Phi^-1 u_c. The
biharmonic one keeps the pick order and solves the saddle system of
phi(r) = r with an affine tail.

`wendland_disp` and `biharmonic_disp` give the deformed trace what it
reads of a frame's displacement: the weights and the step bounds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .field import Precision
from .trace import CEN_BLOCK, Biharmonic, Wendland

WENDLAND_DPHI_MAX = 2.109375


@dataclasses.dataclass
class Interp:
    kind: str
    center_nodes: np.ndarray   # [M] indices into the node array
    centers: np.ndarray        # [M, 3] float64 (from float32 positions)
    sigma: float
    fill: float
    a_inv: np.ndarray          # [M+4, M+4] float64


def _morton_order(pts) -> np.ndarray:
    lo = pts.min(0)
    span = np.maximum(pts.max(0) - lo, 1e-9)
    q = np.clip((pts - lo) / span * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def adaptive_centers(n_nodes: int) -> int:
    m = int(16 * round(n_nodes ** (1.0 / 3.0) / 3.0))
    return max(64, min(512, (m + 7) // 8 * 8))


def build(nodes: np.ndarray, kind: str, n_centers: int | None,
          sigma_fill: float = 3.0) -> Interp:
    nodes = np.asarray(nodes, np.float64)
    m = min(n_centers or adaptive_centers(len(nodes)), len(nodes))
    sel = [0]
    d = np.linalg.norm(nodes - nodes[0], axis=-1)
    for _ in range(m - 1):
        i = int(np.argmax(d))
        sel.append(i)
        d = np.minimum(d, np.linalg.norm(nodes - nodes[i], axis=-1))
    idx = np.asarray(sel, np.int64)
    fill = float(np.max(d))
    if kind == "wendland":
        idx = idx[_morton_order(nodes[idx])]
    c = nodes[idx]
    dist = np.linalg.norm(c[:, None] - c[None], axis=-1)
    a = np.zeros((m + 4, m + 4))
    sigma = 0.0
    if kind == "wendland":
        pair = dist + np.diag(np.full(m, np.inf))
        sigma = sigma_fill * max(fill, float(np.median(pair.min(1))), 1e-6)
        t = np.minimum(dist / sigma, 1.0)
        phi = (1.0 - t) ** 4 * (4.0 * t + 1.0)
        a[:m, :m] = np.linalg.inv(phi + 1e-9 * np.eye(m))
    else:
        p = np.concatenate([np.ones((m, 1)), c], 1)
        a[:m, :m] = dist + 1e-9 * np.eye(m)
        a[:m, m:] = p
        a[m:, :m] = p.T
        a = np.linalg.inv(a)
    return Interp(kind=kind, center_nodes=idx, centers=c, sigma=sigma,
                  fill=fill, a_inv=a)


def weights(interp: Interp, u_c: torch.Tensor, prec: Precision):
    """[M+4, 3] weights from the centres' displacements [M, 3]."""
    rhs = torch.cat([u_c, u_c.new_zeros((4, 3))], 0)
    a = torch.as_tensor(interp.a_inv, dtype=u_c.dtype, device=u_c.device)
    return prec.mm(a, rhs)


def _phi(interp, d):
    t = torch.clamp(d * (1.0 / interp.sigma), max=1.0)
    omt = 1.0 - t
    o2 = omt * omt
    return o2 * o2 * (4.0 * t + 1.0)


def wendland_disp(interp: Interp, w: torch.Tensor, k_refresh: int,
                  prec: Precision) -> Wendland:
    """The Wendland frame's trace inputs: centres padded to blocks of 32
    (pad rows at 1e6, zero weights), |u| and |grad u| sampled at the
    centres and maximised per block, and the frame's displacement bound
    1.15 max|u(c)| + max|grad u(c)| fill."""
    m = interp.centers.shape[0]
    mp = -(-m // CEN_BLOCK) * CEN_BLOCK
    dev = w.device
    c = torch.as_tensor(interp.centers, dtype=torch.float32, device=dev)
    wk = w[:m].float()
    diff = c[:, None] - c[None]
    d = torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=1e-24))
    u_c = prec.mm(_phi(interp, d), wk) + w[m].float() + prec.mm(
        c, w[m + 1:].float())
    s = 1.0 / interp.sigma
    t = torch.clamp(d * s, max=1.0)
    omt = 1.0 - t
    dphi = -20.0 * omt * omt * omt * (s * s)
    g_c = torch.einsum("jka,kb->jab", diff * dphi[..., None], wk) + w[m + 1:].float()
    un = torch.sqrt(torch.sum(u_c * u_c, -1))
    gn = torch.sqrt(torch.sum(g_c * g_c, (-2, -1)))

    def pad(v, fill):
        return torch.cat([v, v.new_full((mp - m, *v.shape[1:]), fill)], 0)

    bu = pad(un, 0.0).reshape(-1, CEN_BLOCK).amax(1)
    bg = pad(gn, 0.0).reshape(-1, CEN_BLOCK).amax(1)
    fill = torch.tensor(interp.fill, dtype=torch.float32, device=dev)
    return Wendland(
        centers=pad(c, 1e6), w=pad(wk, 0.0), waff=w[m:].T.float(),
        bu=bu, bg=bg, bfr=torch.sqrt(torch.sum(w[m + 1:].float() ** 2)),
        max_disp=1.15 * torch.amax(bu) + torch.amax(bg) * fill,
        sigma=float(interp.sigma), k_refresh=k_refresh)


def biharmonic_disp(interp: Interp, w: torch.Tensor, max_disp: float,
                    fp_iters: int, prec: Precision) -> Biharmonic:
    """The biharmonic frame's trace inputs with the certified global step
    factors: shrink = clamp(1 - L, 0, 1), L = sum |w_k| + |B|_F, and
    slack = 2 (max |u(c)| + L fill)."""
    m = interp.centers.shape[0]
    dev = w.device
    c = torch.as_tensor(interp.centers, dtype=torch.float32, device=dev)
    wf = w.float()
    L = torch.sum(torch.sqrt(torch.sum(wf[:m] ** 2, -1))) + torch.sqrt(
        torch.sum(wf[m + 1:] ** 2))
    d = torch.sqrt(torch.clamp(torch.sum((c[:, None] - c[None]) ** 2, -1),
                               min=1e-24))
    u_c = prec.mm(d, wf[:m]) + wf[m] + prec.mm(c, wf[m + 1:])
    slack = 2.0 * (torch.amax(torch.sqrt(torch.sum(u_c ** 2, -1)))
                   + L * float(np.float32(interp.fill)))
    return Biharmonic(centers=c, w=wf[:m], waff=wf[m:].T.contiguous(),
                      shrink=torch.clamp(1.0 - L, 0.0, 1.0), slack=slack,
                      max_disp=float(max_disp), fp_iters=fp_iters)
