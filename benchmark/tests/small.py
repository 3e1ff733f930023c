"""A benchmark cell shrunk to what a CPU test can run: the brain at
cellsize 0.35 (855 nodes), 64 centres, a 96 x 64 image (192 x 108 for
the frame cells), episodes of 4 frames and one pass of the window."""
from __future__ import annotations

import time

import torch

from harness import bench

SMALL_CONFIG = {"cellsize": 0.35, "n_centers": 64, "width": 96,
                "height": 64}
SMALL_TRAFFIC = {"frames_per_episode": 4, "warm_frames": 1,
                 "check_frames": 3, "trace_frames": 2, "trace_from": 1}
SMALL_TRAIN = {"check_steps": 2, "trace_frames": 1, "trace_from": 0}
# The frames' TF32 control departs most on rays near a silhouette; at
# this size a pose that shows one is needed for it to read above the
# card's limits (on the card every pose shows several).
SMALL_FRAME = {"width": 192, "height": 108}
SMALL_FRAME_TRAFFIC = {"roll_deg": 10.0}


def cell(name: str) -> bench.Cell:
    c = bench.resolve(name)
    c.config = {**c.config, **{k: v for k, v in SMALL_CONFIG.items()
                                if k in c.config or k == "n_centers"}}
    small = SMALL_TRAIN if c.traffic["kind"] == "train_e_fit" \
        else SMALL_TRAFFIC
    c.traffic = {**c.traffic, **small}
    if c.traffic["kind"] != "train_e_fit":
        c.config = {**c.config, **SMALL_FRAME}
        c.traffic = {**c.traffic, **SMALL_FRAME_TRAFFIC}
    return c


def run(c: bench.Cell, seed: int, trace: int = 0, frame=None):
    """One run on the CPU, its window a single episode; `frame(program
    frame) -> frame` replaces the timed path's frame."""
    kind = bench.kind_module(c)
    if frame is not None:
        kind.program_frame = frame(kind.program_frame)
    return kind.run(c, seed, 1e-3, trace, torch.device("cpu"),
                    time.perf_counter())
