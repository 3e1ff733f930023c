"""Mass-spring system (reference `MassSpringSystem` / SpringDumble demo,
src/deformable/MassSpringSystem.h:15-50): point masses + Hookean springs
with symplectic Euler integration, vectorized over springs.

Counterpart of fembrain_tpu/fem/mass_spring.py in PyTorch: the step runs
on the device of the system it is given."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device


@dataclasses.dataclass(frozen=True)
class MassSpring:
    pos: torch.Tensor        # [N, 3]
    vel: torch.Tensor        # [N, 3]
    mass: torch.Tensor       # [N]
    springs: torch.Tensor    # [S, 2] endpoint indices
    rest_len: torch.Tensor   # [S]
    k: torch.Tensor          # [S] stiffness
    fixed: torch.Tensor      # [N] bool


def make_dumbbell(separation=2.0, k=50.0, mass=1.0,
                  device=None) -> MassSpring:
    """The reference's two-mass SpringDumble, in float32 on `device` (the
    card when None)."""
    device = default_device() if device is None else device
    pos = np.array([[-separation / 2, 0, 0], [separation / 2, 0, 0]])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return MassSpring(
        pos=f32(pos),
        vel=f32(np.zeros((2, 3))),
        mass=f32(np.full(2, mass)),
        springs=torch.tensor([[0, 1]], dtype=torch.int32, device=device),
        rest_len=f32([separation]),
        k=f32([k]),
        fixed=torch.zeros(2, dtype=torch.bool, device=device),
    )


def step_mass_spring(ms: MassSpring, dt: float = 1 / 60,
                     gravity: float = 0.0, damping: float = 0.02) -> MassSpring:
    ia = ms.springs[:, 0].long()
    ib = ms.springs[:, 1].long()
    a = ms.pos[ia]
    b = ms.pos[ib]
    d = b - a
    length = torch.linalg.norm(d, dim=-1, keepdim=True)
    dirn = d / torch.clamp(length, min=1e-12)
    fs = ms.k[:, None] * (length - ms.rest_len[:, None]) * dirn  # on a, toward b
    # Springs sharing an endpoint add up (index_add_, as .at[].add does).
    force = torch.zeros_like(ms.pos).index_add_(0, ia, fs)
    force = force.index_add_(0, ib, -fs)
    g = torch.tensor([0.0, gravity, 0.0], dtype=ms.pos.dtype,
                     device=ms.pos.device)
    force = force + g * ms.mass[:, None]
    acc = force / ms.mass[:, None]
    vel = (ms.vel + dt * acc) * (1.0 - damping)
    vel = torch.where(ms.fixed[:, None], 0.0, vel)
    pos = ms.pos + dt * vel
    return dataclasses.replace(ms, pos=pos, vel=vel)
