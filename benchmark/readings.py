"""The readings that the limits of a cell's check are set from, in one
process: the program's on many seeds, the TF32 control's and each
fault's on a few. Not run by the benchmark's own runs.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--faults 7,8,9]

Each program or fault reading is one run's check over a window of one
episode; the control replaces the program with the reference in TF32
and runs the same episode up to its last checked frame. One JSON line
per reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import bench, brain, control  # noqa: E402
from harness.traffic import schedule  # noqa: E402


def seeds(s):
    return [int(v) for v in s.split(",")] if s else []


def control_readings(cell, kind, dep, seed):
    sch = schedule(cell.traffic, seed)
    kept = []
    if cell.traffic["kind"] == "train_e_fit":
        mix = cell.traffic
        ro, rd = dep.rays(sch.roll(0, 0))
        pix_w = kind.pixel_weights(dep, sch, mix)
        first, scale = control.train_steps(kind, dep, mix, pix_w, ro, rd,
                                           int(mix["check_steps"]))
        return kind.judge(dep, mix, pix_w, ro, rd, first, scale)
    last = max(k for _, k in sch.check)
    if cell.traffic["kind"] == "coupled_episodes":
        ro, rd = dep.rays(sch.roll(0, 0))
        st = dep.gf.rest_state()
        for k in range(last + 1):
            st2 = control.State(*control.coupled_frame_state(dep, st))
            if (0, k) in sch.check:
                t, hit = control.coupled_trace(dep, st2, ro, rd)
                kept.append(dict(q0=st.q, v0=st.qvel, q1=st2.q, v1=st2.qvel,
                                 t=t, hit=hit, roll=sch.roll(0, 0), frame=k))
            st = st2
    else:
        for _, k in sch.check:
            roll = sch.roll(0, k)
            t, hit = control.rest_frame(dep, *dep.rays(roll))
            kept.append(dict(t=t, hit=hit, roll=roll, frame=k))
    return kind.judge_frames(dep, kept)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    a = p.parse_args()
    import torch

    cell = bench.resolve(a.workload)
    dev = torch.device("cuda", 0)
    kind = bench.kind_module(cell)
    dep = brain.load(cell.root, cell.config, dev,
                     fem=cell.traffic["kind"] != "orbit_rest")
    faults = [f for f in control.FAULTS
              if f != "state_unchanged" or dep.gf is not None]
    jobs = [("program", s, None) for s in seeds(a.seeds)]
    jobs += [(f, s, f) for s in seeds(a.faults) for f in faults]
    jobs += [("control", s, None) for s in seeds(a.control_seeds)]
    for who, s, fault in jobs:
        t0 = time.perf_counter()
        kind = bench.kind_module(cell)
        if who == "control":
            r = control_readings(cell, kind, dep, s)
        else:
            if fault is not None:
                control.plant(kind, fault)
            r = kind.run(cell, s, 1e-3, 0, dev, time.perf_counter(),
                         dep=dep)["compared"]
        print(json.dumps({"workload": cell.name, "who": who, "seed": s,
                          **r, "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
