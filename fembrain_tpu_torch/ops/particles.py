"""Particle system demo (reference `Particles` + ParticleSystem.cl:1-46):
position/velocity integration with gravity and box bounce, as one step
over particle arrays.

Counterpart of fembrain_tpu/ops/particles.py in PyTorch. The initial
state comes from a `torch.Generator` seeded with `seed` on the CPU and is
then moved to the device, so it is the same on every device (it is not
the JAX package's `jax.random` state); the step runs on the state's
device."""
from __future__ import annotations

import dataclasses

import torch

from .. import default_device


@dataclasses.dataclass(frozen=True)
class ParticleState:
    pos: torch.Tensor   # [N, 3]
    vel: torch.Tensor   # [N, 3]
    age: torch.Tensor   # [N]


def init_particles(n: int, seed: int = 0, box=1.0,
                   device=None) -> ParticleState:
    """n particles uniform in the box, with normal velocities of scale
    0.1, on `device` (the card when None)."""
    device = default_device() if device is None else device
    gen = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 3), generator=gen) * (2 * box) - box
    vel = torch.randn((n, 3), generator=gen) * 0.1
    return ParticleState(pos=pos.to(device), vel=vel.to(device),
                         age=torch.zeros(n, device=device))


def step_particles(state: ParticleState, dt: float = 1 / 60,
                   gravity: float = -9.8, box: float = 1.0,
                   restitution: float = 0.8) -> ParticleState:
    g = torch.tensor([0.0, gravity, 0.0], dtype=state.vel.dtype,
                     device=state.vel.device)
    vel = state.vel + g * dt
    pos = state.pos + vel * dt
    # Box bounce.
    below = pos < -box
    above = pos > box
    vel = torch.where(below | above, -restitution * vel, vel)
    pos = torch.clamp(pos, -box, box)
    return ParticleState(pos=pos, vel=vel, age=state.age + dt)
