"""Episodes of coupled frames: each episode starts the tissue from rest
under gravity and renders `frames_per_episode` frames of
`coupled_step_grid_fast` (FEM step, coupling weights, deformed trace:
K2 for a Wendland interpolant, K4 for a biharmonic one) back to back,
the camera at the episode's roll. The window runs whole
episodes until `--seconds` have passed, so every run does the same
frames in the same proportions.

The check compares a seeded sample of episode 0's frames (its first, the
start from rest, among them) with the reference: the FEM step from the
program's state before the frame (the reference follows the program's
state from frame to frame), and the trace of the program's state after
it by the reference's own interpolant and march.
"""
from __future__ import annotations

import time

import torch

from harness import brain, runtime
from harness.traffic import schedule
from reference import trace as rtrace
from reference.field import Precision

KERNELS = {"k2": runtime.additive_kernel(1), "k4": runtime.additive_kernel(2)}
# From this frame of an episode on, the tissue is near its sag under
# gravity and the warm-started solve reads two orders below the first
# frames' (frame 4: 1.9e-4, frame 2: 8e-3): those frames are held to a
# limit of their own, `fem_err_settled`.
SETTLED_FROM = 4


def program_frame(dep, state, ro, rd, stats):
    """One frame through the program's entry point."""
    from fembrain_tpu_torch.render import deformed

    c = dep.config
    return deformed.coupled_step_grid_fast(
        dep.scene, dep.gf, dep.interp, dep.cgi, state, dep.f_ext, ro, rd,
        h=c["h"], image_hw=dep.image_hw, cg_tol=c["cg_tol"],
        max_disp=c.get("max_disp", 0.5), fp_iters=c.get("fp_iters", 2),
        k_refresh=c.get("k_refresh", 0), solve_stats=stats)


def flat(x):
    return x.reshape(-1, 3).double()


def judge_frames(dep, frames) -> dict:
    """Readings of the checked frames, each a dict with q0, v0 (before),
    q1, v1 (after, [X, Y, Z, 3]), t, hit (row-major) and roll: the
    step's error (the larger of its solve's relative energy-norm error
    and its update's relative gap: `fem_err` before frame SETTLED_FROM,
    `fem_err_settled` from it on), and the trace against the
    reference's trace of the program's state after the step
    (runtime.trace_gap)."""
    step = dep.ref_step(Precision(dtype=torch.float64))
    f_ext = flat(dep.f_ext)
    out = {"fem_err": 0.0, "fem_err_settled": 0.0, "fem_energy_err": 0.0,
           "fem_update_err": 0.0, "trace_surface_gap": 0.0,
           "trace_gap_rays": 0, "trace_hit_flips": 0,
           "trace_field_gap": 0.0, "trace_max_dt": 0.0}
    for fr in frames:
        r = step_readings(step, fr, f_ext)
        ro, rd = dep.rays(fr["roll"])
        disp = dep.ref_disp(fr["q1"].reshape(-1, 3), Precision())
        ref = rtrace.trace_image(dep.ref_scene, ro, rd, *dep.image_hw,
                                 disp=disp, slope=True)
        resid = rtrace.surface_residual(dep.ref_scene, ro, rd, fr["t"],
                                        fr["hit"], disp)
        err = max(r["fem_energy_err"], r["fem_update_err"])
        which = "fem_err" if fr["frame"] < SETTLED_FROM else "fem_err_settled"
        r = {which: err, **r,
             **runtime.trace_gap(fr["t"], fr["hit"], *ref, resid)}
        runtime.note(fr, r)
        out = runtime.worst(out, r)
    return out


def step_readings(step, fr, f_ext):
    from reference.fem import judge_step

    return judge_step(step, flat(fr["q0"]), flat(fr["v0"]), flat(fr["q1"]),
                      flat(fr["v1"]), f_ext)


def run(cell, seed, seconds, trace, device, t_start, dep=None):
    dep = dep or brain.load(cell.root, cell.config, device, fem=True)
    sch = schedule(cell.traffic, seed)
    F = sch.frames_per_episode
    keep = set(sch.check)
    # Warm-up: the first frames of an episode, from rest.
    ro, rd = dep.rays(sch.roll(0, 0))
    st = dep.gf.rest_state()
    for _ in range(int(cell.traffic["warm_frames"])):
        _, _, st = program_frame(dep, st, ro, rd, {})
    runtime.sync(device)
    del st
    setup_s = time.perf_counter() - t_start

    win = runtime.Window()
    prof = runtime.Profiled(device) if trace else None
    kept, iters, first_traced = [], [], None
    win.start = time.perf_counter()
    e = 0
    while True:
        ro, rd = dep.rays(sch.roll(e, 0))
        st = dep.gf.rest_state()
        for k in range(F):
            if prof is not None and e == 0 and k == sch.trace_frames[0]:
                prof.open()
            stats = {}
            a = time.perf_counter()
            t, hit, st2 = program_frame(dep, st, ro, rd, stats)
            runtime.sync(device)
            b = time.perf_counter()
            win.latencies.append(b - a)
            iters.append(stats.get("forward_iters"))
            if prof is not None and e == 0 and k == sch.trace_frames[-1]:
                prof.close()
            if e == 0 and k == sch.trace_frames[0]:
                first_traced = st2.q
            if (e, k) in keep:
                kept.append(dict(q0=st.q, v0=st.qvel, q1=st2.q, v1=st2.qvel,
                                 t=t, hit=hit, roll=sch.roll(e, 0), frame=k))
            st = st2
        e += 1
        win.end = b
        if win.end - win.start >= seconds:
            break
    dev_info = runtime.device_info(device, cell.chips)
    del st, st2, t, hit
    result = {"attempted": len(win.latencies), "failed": 0}
    if trace:
        bound = {}
        work = rtrace.Work()
        disp = dep.ref_disp(flat(first_traced), Precision())
        rtrace.trace_image(dep.ref_scene, *dep.rays(sch.roll(0, 0)),
                           *dep.image_hw, disp=disp, work=work)
        tag = "k2" if dep.config["interpolant"] == "wendland" else "k4"
        bound[tag] = work.bound_s(runtime.PEAK_FP32_FLOPS,
                                  runtime.PEAK_BYTES_PER_S)
        readings, breakdown = runtime.readings(
            prof, len(sch.trace_frames), {"forward_iters": iters}, bound,
            KERNELS)
        dev_info.update(busy_s=readings.busy_s, window_s=readings.window_s)
        result.update(readings=readings, breakdown=breakdown)
    else:
        result["e2e"] = {"frame_ms": win.frame_ms(),
                         "frame_ms_p90": win.p90_ms(), "setup_s": setup_s}
    result["device"] = dev_info
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    result["compared"] = judge_frames(dep, kept)
    return result
