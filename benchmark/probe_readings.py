"""The readings that the limits of a probe cell's check are set from, in
one process on the card: the program's on many seeds, the TF32
control's and each fault's on a few. Not run by the benchmark's own
runs.

    python3 benchmark/probe_readings.py --workload brain-sim.probe \
        --seeds 1,2,3 --control-seeds 4,5,6 [--faults 7]

Each program or fault reading is one run's check over a window of one
episode. The faults are harness/control.py's (a state unchanged, half of
the rays left out, one answer altered), `rings_dropped`: the program's
ring forces without their outermost ring, and `gravity_left_on`: the
program's step under its load plus gravity on the lumped masses, as a
body built without the deployment's GRAVITY=0 would step. The control
puts the reference in the program's place, its products in TF32: the
reference probe, the reference step (PCG at the configuration's tol and
iteration cap) and the reference trace, over the same episode up to its
last checked frame. Every reading gives `disp_bound`, the largest over
its frames of the certified bound on |u| that the program's `max_disp`
has to cover (SimDeployment.disp_bounds). One JSON line per reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import bench, control, sim  # noqa: E402
from harness.traffic import schedule  # noqa: E402
from reference import probe as rprobe  # noqa: E402
from reference import trace as rtrace  # noqa: E402

FAULTS = (*control.FAULTS, "rings_dropped", "gravity_left_on")
GRAVITY = 9.81


def seeds(s):
    return [int(v) for v in s.split(",")] if s else []


def rings_dropped(dep):
    """The body's ring forces without their outermost ring."""
    c = dep.config

    def forces(idx, force, radius=c["haptic_radius"]):
        return rprobe.ring_forces(dep.graph, idx, force, radius,
                                  rings=radius - 1)

    return forces


def gravity_left_on(frame):
    """`frame` (the kind's program_frame) stepping under its load plus
    gravity, -GRAVITY along y on each node's lumped mass."""
    def broken(dep, state, f, *args):
        g = torch.zeros_like(f)
        g[:, 1] = -GRAVITY * dep.fem.mass.to(f.dtype)
        return frame(dep, state, f + g, *args)

    return broken


def plant(dep, kind, fault: str) -> None:
    """Plant `fault` in the program's probe frame (`kind`'s module)."""
    if fault == "rings_dropped":
        dep.body.haptic_forces = rings_dropped(dep)
    elif fault == "gravity_left_on":
        kind.program_frame = gravity_left_on(kind.program_frame)
    else:
        control.plant(kind, fault)


def unplant(dep) -> None:
    """Take `rings_dropped` off the body (a kind's module is reloaded by
    bench.kind_module)."""
    vars(dep.body).pop("haptic_forces", None)


def control_readings(cell, kind, dep, seed):
    """The control's episode 0 up to its last checked frame, judged."""
    c, mix = dep.config, cell.traffic
    sch = schedule(mix, seed)
    last = max(k for _, k in sch.check)
    path = kind.probe_path(dep, mix, seed, 0)
    step = dep.ref_step(control.TF32, c["cg_tol"], c["cg_max_iters"])
    probe = dep.ref_probe()
    ro, rd = dep.rays(sch.roll(0, 0))
    z = torch.zeros_like(dep.fem.rest)
    st = control.State(z, z, z)
    history, kept, after = [], [], []
    for k in range(last + 1):
        ids, fc = probe.move(path[k], dep.positions(st.q))
        f = torch.as_tensor(rprobe.ring_forces(dep.graph, ids, fc,
                                               c["haptic_radius"]),
                            dtype=torch.float32, device=dep.device)
        st2 = control.State(*step.step(st.q, st.qvel, f))
        history.append((path[k], st.q))
        after.append(st2.q)
        if (0, k) in sch.check:
            t, hit = rtrace.trace_image(
                dep.ref_scene, ro, rd, *dep.image_hw,
                disp=dep.ref_disp(st2.q, control.TF32), prec=control.TF32)
            kept.append(dict(q0=st.q, v0=st.qvel, q1=st2.q, v1=st2.qvel,
                             f=f, contacts=ids, t=t, hit=hit,
                             roll=sch.roll(0, 0), frame=k))
        st = st2
    return {**kind.judge_frames(dep, history, kept),
            "disp_bound": float(dep.disp_bounds(after).max())}


def program_readings(cell, kind, dep, seed, dev):
    """One run's check over one episode."""
    return kind.run(cell, seed, 1e-3, 0, dev, time.perf_counter(),
                    dep=dep)["compared"]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    a = p.parse_args()
    cell = bench.resolve(a.workload)
    dev = torch.device("cuda", 0)
    dep = sim.load(cell.root, cell.config, dev,
                   schedule(cell.traffic, 0).roll(0, 0))
    jobs = [("program", s, None) for s in seeds(a.seeds)]
    jobs += [(f, s, f) for s in seeds(a.faults) for f in FAULTS]
    jobs += [("control", s, None) for s in seeds(a.control_seeds)]
    for who, s, fault in jobs:
        t0 = time.perf_counter()
        kind = bench.kind_module(cell)
        if who == "control":
            r = control_readings(cell, kind, dep, s)
        else:
            if fault is not None:
                plant(dep, kind, fault)
            r = program_readings(cell, kind, dep, s, dev)
            unplant(dep)
        print(json.dumps({"workload": cell.name, "who": who, "seed": s,
                          **r, "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
