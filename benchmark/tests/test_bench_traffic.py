"""The traffic generator repeats exactly for a seed and differs across
seeds; so do the rays and the weights drawn from it."""
import json

import pytest
import torch

from harness import bench, traffic
from reference import trace as rtrace

MIXES = sorted(p.stem for p in (bench.HERE / "traffic").glob("*.json"))
BIG = 2**31 + 12345


@pytest.mark.parametrize("mix", MIXES)
def test_schedule_repeats_for_a_seed(mix):
    spec = json.loads((bench.HERE / "traffic" / f"{mix}.json").read_text())
    a, b = traffic.schedule(spec, BIG), traffic.schedule(spec, BIG)
    assert a == b
    c = traffic.schedule(spec, BIG + 1)
    if "roll_deg" not in spec:
        assert a.roll0 != c.roll0
    assert len(a.check) == len(c.check) == spec["check_frames"]
    assert a.frames_per_episode == c.frames_per_episode
    ga, gc = a.generator("cpu"), c.generator("cpu")
    x = torch.rand(8, generator=ga)
    assert torch.equal(x, torch.rand(8, generator=a.generator("cpu")))
    assert not torch.equal(x, torch.rand(8, generator=gc))


def test_rays_follow_the_roll():
    r1 = rtrace.orbit_rays(10.0, 20.0, 8.0, 32, 16, "cpu")
    r2 = rtrace.orbit_rays(10.0, 20.0, 8.0, 32, 16, "cpu")
    r3 = rtrace.orbit_rays(13.0, 20.0, 8.0, 32, 16, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))
    assert not torch.equal(r1[0], r3[0])
