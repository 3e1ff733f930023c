"""The one generator of every traffic mix: what a run sends, from the
mix's parameters and the run's seed.

A mix is a JSON file of parameters under benchmark/traffic/. Every seed
gets the same amount and shape of work, laid out differently: a seeded
offset of the camera's roll, and seeded choices of which frames or steps
the check compares and of the loss's per-pixel weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Schedule:
    roll0: float                 # degrees, the seeded offset
    frames_per_episode: int      # frames (or steps) before the state resets
    roll_step_frame: float       # degrees a frame within an episode
    roll_step_episode: float     # degrees an episode
    check: tuple                 # (episode, frame) pairs the check compares
    trace_frames: tuple          # frames of episode 0 the profiler records
    seed: int

    def roll(self, episode: int, frame: int) -> float:
        return (self.roll0 + self.roll_step_episode * episode
                + self.roll_step_frame * frame) % 360.0

    def generator(self, device, stream: int = 0) -> torch.Generator:
        """A torch generator on `device` for the seed's stream `stream`."""
        g = torch.Generator(device=device)
        g.manual_seed((self.seed * 1_000_003 + stream) % (1 << 63))
        return g


def schedule(mix: dict, seed: int) -> Schedule:
    """The run's schedule. `check_frames` frames are compared: the first
    frame of the window when `check_first` (the start from rest), and
    the rest drawn without repeats from frames 1 .. of episode 0, which
    every window completes. A mix with `roll_deg` keeps its camera
    there."""
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
    f = int(mix["frames_per_episode"])
    n = int(mix["check_frames"])
    first = bool(mix.get("check_first", False))
    lo = int(mix.get("check_from", 1 if first else 0))
    pool = np.arange(lo, f)
    drawn = rng.choice(pool, size=max(n - int(first), 0), replace=False)
    picks = ([0] if first else []) + sorted(int(k) for k in drawn)
    t0 = int(mix.get("trace_from", 0))
    roll0 = float(rng.uniform(0.0, 360.0))
    return Schedule(
        roll0=float(mix.get("roll_deg", roll0)),
        frames_per_episode=f,
        roll_step_frame=float(mix.get("roll_step_frame_deg", 0.0)),
        roll_step_episode=float(mix.get("roll_step_episode_deg", 0.0)),
        check=tuple((0, k) for k in picks),
        trace_frames=tuple(range(t0, t0 + int(mix["trace_frames"]))),
        seed=int(seed),
    )
