"""The comparison that decides `correct`: sound runs pass it, the TF32
control and each fault a cell can have fail it (CPU, test size)."""
import pytest
import torch

import small
from harness import bench, brain, control, runtime
from harness.traffic import schedule

SEED = 2**31 + 7
FAULTS = {
    "brain-grid-k4.gravity": control.FAULTS,
    "brain-grid.orbit-rest": ("half_dropped", "answer_altered"),
    "brain-grid-train.e-fit": control.FAULTS,
}


def judged(c, res):
    return runtime.judge(res["compared"], c.limits)


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_sound_run_is_correct(name):
    c = small.cell(name)
    ok, checks = judged(c, small.run(c, SEED))
    assert ok, checks


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_control_is_not_correct(name):
    c = small.cell(name)
    kind = bench.kind_module(c)
    if c.traffic["kind"] == "train_e_fit":
        dep = brain.load(c.root, c.config, "cpu", fem=True)
        sch = schedule(c.traffic, SEED)
        ro, rd = dep.rays(sch.roll(0, 0))
        pix_w = kind.pixel_weights(dep, sch, c.traffic)
        first, scale = control.train_steps(kind, dep, c.traffic, pix_w, ro,
                                           rd, c.traffic["check_steps"])
        compared = kind.judge(dep, c.traffic, pix_w, ro, rd, first, scale)
    else:
        frame = (control.coupled_frame if c.traffic["kind"]
                 == "coupled_episodes" else control.rest_frame)
        compared = small.run(c, SEED, frame=lambda _: frame)["compared"]
    ok, checks = runtime.judge(compared, c.limits)
    assert not ok, checks


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(FAULTS)
                                        for f in FAULTS[n]])
def test_fault_is_not_correct(name, fault):
    c = small.cell(name)
    kind = bench.kind_module(c)
    control.plant(kind, fault)
    res = kind.run(c, SEED, 1e-3, 0, torch.device("cpu"), 0.0)
    ok, checks = judged(c, res)
    assert not ok, checks


def test_a_later_crossing_of_the_surface_is_a_gap_ray():
    """An answer on the surface but at another crossing of it reads no
    surface gap; the gap-ray count catches it."""
    t_ref = torch.tensor([5.0, 6.0, 7.0, 8.0])
    hit = torch.ones(4, dtype=torch.bool)
    t = t_ref.clone()
    t[2] = 7.6
    r = runtime.trace_gap(t, hit, t_ref, hit, torch.full((4,), 0.05),
                          torch.zeros(4))
    assert r["trace_surface_gap"] == 0.0
    assert r["trace_gap_rays"] == 1 and r["trace_hit_flips"] == 0
