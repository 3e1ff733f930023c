"""The untouched tissue seen by an orbiting camera: `trace_tiles_image`
frames of the rest scene back to back, the roll advancing a fixed step
a frame. An episode is one revolution; the window runs whole episodes
until `--seconds` have passed. No FEM is built.

The check traces a seeded sample of the first revolution's frames with
the reference march and compares t and hit.
"""
from __future__ import annotations

import time

import torch

from harness import brain, runtime
from harness.traffic import schedule
from reference import trace as rtrace

KERNELS = {"k1": runtime.additive_kernel(0)}


def program_frame(dep, ro, rd):
    from fembrain_tpu_torch.render import tile_trace

    return tile_trace.trace_tiles_image(dep.scene, ro, rd, *dep.image_hw)


def judge_frames(dep, frames) -> dict:
    """Readings of the checked frames (t, hit, roll each) against the
    reference's trace of the same rays (runtime.trace_gap)."""
    out = {"trace_surface_gap": 0.0, "trace_gap_rays": 0,
           "trace_hit_flips": 0, "trace_field_gap": 0.0, "trace_max_dt": 0.0}
    for fr in frames:
        ro, rd = dep.rays(fr["roll"])
        ref = rtrace.trace_image(dep.ref_scene, ro, rd, *dep.image_hw,
                                 slope=True)
        resid = rtrace.surface_residual(dep.ref_scene, ro, rd, fr["t"],
                                        fr["hit"])
        r = runtime.trace_gap(fr["t"], fr["hit"], *ref, resid)
        runtime.note(fr, r)
        out = runtime.worst(out, r)
    return out


def run(cell, seed, seconds, trace, device, t_start, dep=None):
    dep = dep or brain.load(cell.root, cell.config, device, fem=False)
    sch = schedule(cell.traffic, seed)
    F = sch.frames_per_episode
    keep = set(sch.check)
    for k in range(int(cell.traffic["warm_frames"])):
        program_frame(dep, *dep.rays(sch.roll(0, k)))
    runtime.sync(device)
    setup_s = time.perf_counter() - t_start

    win = runtime.Window()
    prof = runtime.Profiled(device) if trace else None
    kept = []
    win.start = time.perf_counter()
    e = 0
    while True:
        for k in range(F):
            roll = sch.roll(e, k)
            ro, rd = dep.rays(roll)
            if prof is not None and e == 0 and k == sch.trace_frames[0]:
                prof.open()
            a = time.perf_counter()
            t, hit = program_frame(dep, ro, rd)
            runtime.sync(device)
            b = time.perf_counter()
            win.latencies.append(b - a)
            if prof is not None and e == 0 and k == sch.trace_frames[-1]:
                prof.close()
            if (e, k) in keep:
                kept.append(dict(t=t, hit=hit, roll=roll, frame=k))
        e += 1
        win.end = b
        if win.end - win.start >= seconds:
            break
    dev_info = runtime.device_info(device, cell.chips)
    result = {"attempted": len(win.latencies), "failed": 0}
    if trace:
        work = rtrace.Work()
        ro, rd = dep.rays(sch.roll(0, sch.trace_frames[0]))
        rtrace.trace_image(dep.ref_scene, ro, rd, *dep.image_hw, work=work)
        bound = {"k1": work.bound_s(runtime.PEAK_FP32_FLOPS,
                                    runtime.PEAK_BYTES_PER_S)}
        readings, breakdown = runtime.readings(
            prof, len(sch.trace_frames), {}, bound, KERNELS)
        dev_info.update(busy_s=readings.busy_s, window_s=readings.window_s)
        result.update(readings=readings, breakdown=breakdown)
    else:
        result["e2e"] = {"rest_frame_ms": win.frame_ms(),
                         "rest_frame_ms_p90": win.p90_ms(),
                         "setup_s": setup_s}
    result["device"] = dev_info
    result["compared"] = judge_frames(dep, kept)
    return result
