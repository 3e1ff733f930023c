"""The plain field of a `RefScene`, its gradient, and the TF32 control.

The control rounds the operands of every matrix product to TF32 (a
10-bit mantissa, round to nearest even) and keeps float32 sums: what a
float32 matrix product on the H100's tensor cores computes. Products are
marked with `mm`, so the reference and its control are one code.
"""
from __future__ import annotations

import numpy as np
import torch

from .scene import POINT, RefScene

CHUNK = 1 << 17   # points per block of the [points, prims] temporaries


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties to even);
    gradients pass through the rounding unchanged."""
    if x.dtype != torch.float32:
        return x
    b = x.detach().contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach()) if x.requires_grad else r


class Precision:
    """How products are computed: `control` rounds their operands to
    TF32; `dtype` is the reference's float type."""

    def __init__(self, control: bool = False, dtype=torch.float32):
        self.control = control
        self.dtype = dtype

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control:
            a, b = tf32(a.float()), tf32(b.float())
        return a @ b


class Field:
    """f(p) = sum_i (1 - d_i^2)^3_+ on the device, float32 tables."""

    def __init__(self, scene: RefScene, device, prec: Precision):
        self.prec = prec
        dt = prec.dtype
        # [4, 3, P]: world -> local as a product of [x y z 1] with it.
        self.m = torch.as_tensor(np.transpose(scene.bwd, (2, 1, 0)).copy(),
                                 dtype=dt, device=device)   # [4, 3, P]
        self.pos = torch.as_tensor(scene.pos.T, dtype=dt, device=device)
        self.axis = torch.as_tensor(scene.axis.T, dtype=dt, device=device)
        self.radius = torch.as_tensor(scene.radius, dtype=dt, device=device)
        self.height = torch.as_tensor(scene.height, dtype=dt, device=device)
        self.is_point = torch.tensor([k == POINT for k in scene.kind],
                                     device=device)
        self.box_lo = torch.as_tensor(scene.box_lo, device=device)
        self.box_hi = torch.as_tensor(scene.box_hi, device=device)
        self.types = tuple(scene.kind)

    def local(self, p: torch.Tensor):
        """[N, 3] -> three [N, P] local coordinates."""
        ph = torch.cat([p, torch.ones_like(p[:, :1])], 1)       # [N, 4]
        m = self.m.reshape(4, -1)
        loc = self.prec.mm(ph.to(m.dtype), m).reshape(p.shape[0], 3, -1)
        return loc[:, 0], loc[:, 1], loc[:, 2]

    def prims(self, p: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> [N, P] primitive fields."""
        x, y, z = self.local(p)
        dx, dy, dz = (x - self.pos[0], y - self.pos[1], z - self.pos[2])
        pp = dx * dx + dy * dy + dz * dz
        along = dx * self.axis[0] + dy * self.axis[1] + dz * self.axis[2]
        radial = torch.clamp(torch.sqrt(torch.clamp(pp - along * along,
                                                    min=1e-20))
                             - self.radius, min=0.0)
        along = torch.where(along > 0.0,
                            torch.clamp(along - self.height, min=0.0), along)
        d2 = torch.where(self.is_point, pp, radial * radial + along * along)
        t = torch.clamp(1.0 - d2, min=0.0)
        return t * t * t

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        """[N, 3] -> [N] field, in blocks of CHUNK points."""
        if p.shape[0] <= CHUNK:
            return self.prims(p).sum(-1)
        return torch.cat([self.prims(p[i:i + CHUNK]).sum(-1)
                          for i in range(0, p.shape[0], CHUNK)])

    def in_reach(self, p: torch.Tensor, need: torch.Tensor):
        """Per primitive kind, the (needed point, primitive) pairs whose
        support box holds the point: {kind: count}."""
        out = {}
        for i in range(0, p.shape[0], CHUNK):
            q, nd = p[i:i + CHUNK], need[i:i + CHUNK]
            inside = nd[:, None] & torch.all(
                (q[:, None] >= self.box_lo[None]) & (q[:, None] <= self.box_hi[None]),
                -1)
            per = inside.sum(0)
            for kind in set(self.types):
                sel = torch.tensor([k == kind for k in self.types],
                                   device=p.device)
                out[kind] = out.get(kind, 0) + int(per[sel].sum())
        return out
