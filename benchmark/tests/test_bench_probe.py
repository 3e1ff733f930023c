"""The probe cell (brain-sim.probe) at a CPU test's size: a sound run is
correct, the TF32 control and each fault are not, the run's bound on |u|
covers every frame of its window and is held to the configuration's
`max_disp`, and the reference's probe and rings keep to the upstream's
semantics on a hand-made case."""
import json

import numpy as np
import pytest
import torch

import probe_readings
import small
from harness import bench, runtime, sim
from harness.traffic import schedule
from reference import probe as rprobe

SEED = 2**31 + 7
NAME = "brain-sim.probe"
# Episodes of 8 frames at this size: 0.06 a frame, so the box reaches
# the tissue in the first frames and pushes for 5 before it slides.
SMALL_PROBE = {"frames_per_episode": 8, "push_frames": 5, "step": 0.06}


@pytest.fixture(scope="module")
def cell():
    c = small.cell(NAME)
    c.traffic = {**c.traffic, **SMALL_PROBE}
    return c


@pytest.fixture(scope="module")
def dep(cell):
    return sim.load(cell.root, cell.config, "cpu",
                    schedule(cell.traffic, SEED).roll(0, 0))


def run(cell, dep, kind=None):
    kind = kind or bench.kind_module(cell)
    return kind.run(cell, SEED, 1e-3, 0, torch.device("cpu"), 0.0,
                    dep=dep)["compared"]


def watched(kind):
    """(kind, the states after each of its program frames, as they run)."""
    frame, seen = kind.program_frame, []

    def record(dep_, *args):
        out = frame(dep_, *args)
        seen.append(out[2].q)
        return out

    kind.program_frame = record
    return kind, seen


def test_sound_run_is_correct(cell, dep):
    compared = run(cell, dep)
    ok, checks = runtime.judge(compared, cell.limits)
    assert ok, checks
    assert compared["probe_force_gap"] <= 1e-6


def test_control_is_not_correct(cell, dep):
    r = probe_readings.control_readings(cell, bench.kind_module(cell), dep,
                                        SEED)
    ok, checks = runtime.judge(r, cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("fault", probe_readings.FAULTS)
def test_fault_is_not_correct(cell, dep, fault):
    kind = bench.kind_module(cell)
    probe_readings.plant(dep, kind, fault)
    try:
        compared = run(cell, dep, kind)
    finally:
        probe_readings.unplant(dep)
    ok, checks = runtime.judge(compared, cell.limits)
    assert not ok, checks


def test_bound_covers_every_frame_of_the_window(cell, dep):
    """The run's `disp_bound` is the largest over all the frames of its
    window of the bound for the state after the frame, not over the
    checked frames alone."""
    kind, seen = watched(bench.kind_module(cell))
    bound = run(cell, dep, kind)["disp_bound"]
    warm, frames = (cell.traffic[k] for k in ("warm_frames",
                                               "frames_per_episode"))
    assert len(seen) == warm + frames
    each = [float(dep.disp_bounds([q])[0]) for q in seen[warm:]]
    assert bound == pytest.approx(max(each), rel=1e-12)


def test_bound_dominates_the_displacement_in_the_box(cell, dep):
    """At random points of the primitives' support box, |u| through the
    reference's interpolant stays under the bound of a pushed state."""
    from reference import interp as rinterp
    from reference.field import Precision

    kind, seen = watched(bench.kind_module(cell))
    run(cell, dep, kind)
    q = seen[-1].reshape(-1, 3)
    bound = float(dep.disp_bounds([q])[0])
    ri = dep.ref_interp
    m = len(ri.center_nodes)
    w = rinterp.weights(ri, q[dep.ref_cgi].double(),
                        Precision(dtype=torch.float64))
    lo = dep.ref_scene.box_lo.min(0).astype(np.float64)
    hi = dep.ref_scene.box_hi.max(0).astype(np.float64)
    x = torch.as_tensor(np.random.default_rng(SEED).uniform(
        lo, hi, (50_000, 3)))
    c = torch.as_tensor(ri.centers, dtype=torch.float64)
    u = torch.cdist(x, c) @ w[:m] + w[m] + x @ w[m + 1:]
    u_max = float(torch.linalg.norm(u, dim=1).max())
    assert 0.0 < u_max <= bound


def test_bound_is_held_to_max_disp(cell):
    """The check's limit on the bound is the configuration's `max_disp`,
    and a run whose bound passes it is not correct."""
    limits = json.loads((cell.root / "benchmark/checks"
                         / f"{NAME}.json").read_text())
    assert limits["disp_bound"] == cell.config["max_disp"]
    sound = {k: 0 for k in limits}
    assert runtime.judge(sound, limits)[0]
    over = {**sound, "disp_bound": cell.config["max_disp"] * 1.001}
    assert not runtime.judge(over, limits)[0]


def test_probe_keeps_first_seen_positions_and_its_face():
    """A box coming down onto two nodes picks its bottom face, pushes by
    depth below the face from where a node was first seen, and keeps
    both once the box has moved on."""
    p = rprobe.Probe(np.full(3, 0.5), 100.0)
    pos = np.array([[0.0, 0.0, 0.0], [0.3, 0.1, 0.0], [5.0, 5.0, 5.0]])
    ids, f = p.move([0.0, 0.45, 0.0], pos)
    assert ids.tolist() == [0, 1] and p.face == 2
    np.testing.assert_allclose(f, [[0, -5.0, 0], [0, -15.0, 0]])
    moved = pos + [0.0, -1.0, 0.0]
    ids, f = p.move([0.0, 0.35, 0.0], moved)
    assert ids.tolist() == [0, 1] and p.face == 2
    np.testing.assert_allclose(f, [[0, -15.0, 0], [0, -25.0, 0]])


def test_rings_fall_off_linearly():
    """On a chain of tetrahedra a contact's force reaches itself and four
    rings at 1, 0.8, 0.6, 0.4 and 0.2 of itself; the fault drops the
    last."""
    tets = np.array([[i, i + 1, i + 2, i + 3] for i in range(0, 24, 3)])
    g = rprobe.node_graph(tets, 27)
    f = rprobe.ring_forces(g, [0], [[0.0, 10.0, 0.0]], 5)
    assert f[:, 1].tolist() == pytest.approx(
        [10.0] + [8.0] * 3 + [6.0] * 3 + [4.0] * 3 + [2.0] * 3 + [0.0] * 14)
    drop = rprobe.ring_forces(g, [0], [[0.0, 10.0, 0.0]], 5, rings=4)
    assert drop[:, 1].tolist() == f[:, 1].tolist()[:10] + [0.0] * 17
