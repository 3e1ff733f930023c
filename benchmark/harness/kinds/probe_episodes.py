"""Episodes of probe frames on the unstructured FEM: a surgeon pushes the
tissue with the haptic probe, as brain.sim deploys it. Each episode
starts the tissue from rest with the probe's contact cleared, and runs
`frames_per_episode` frames back to back, each the probe stage
(`Deformable.probe_forces`: the node positions read to the host, the
box contact, the ring forces over the tet mesh's node graph on the host
core, the load copied back) and then the coupled frame
`coupled_step_fast` (the unstructured corotational step, warm-started
PCG at the configuration's `cg_tol`, the coupling weights and the K4
trace), the camera fixed at the mix's roll. The window runs whole
episodes until `--seconds` have passed, so every run does the same
frames in the same proportions.

An episode's probe path comes from the seed: a contact site among the
sites the deployment offers (boundary nodes facing the camera), the
probe box's centre first placed so that its nearest point lies
`start_gap` outside the site's tangent plane, then moved `step` a frame
inward along the site's outward normal for `push_frames` frames, then
`step` a frame along a seeded tangent direction for the rest.

The check compares a seeded sample of episode 0's frames (its first
among them) with the reference, which follows the program's state from
frame to frame: the reference probe, moved along the same path over the
program's node positions before each frame, against the program's
contacts (`probe_contact_flips`, nodes in one contact set and not the
other) and load (`probe_force_gap`, the largest |f - f*| over max |f*|);
the reference's step from the program's state under the program's load
(`fem_err`: reference.tetfem.judge_step's larger reading under a load,
`fem_unloaded_gap` under none);
and the reference's trace of the program's state after the step,
through the reference's interpolant (runtime.trace_gap). Both traces
inflate their brackets by the configuration's `max_disp`, so the run
also reads `disp_bound`, the largest over every frame of the window of
a certified bound on |u| through the reference's interpolant for the
program's state after the frame (SimDeployment.disp_bounds), which the
check holds to `max_disp`: a frame whose tissue may move further than
the brackets reach makes the run not correct. The window keeps each
frame's state, and the bounds are read after it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fembrain_tpu_torch.fem.avatars import AvatarProbe
from fembrain_tpu_torch.fem.deformable import Deformable
from fembrain_tpu_torch.render import deformed
from harness import runtime, sim
from harness.traffic import schedule
from reference import probe as rprobe
from reference import trace as rtrace
from reference.field import Precision
from reference.tetfem import judge_step

# Fails at once, before any set-up, where the port has no probe stage.
if not hasattr(Deformable, "probe_forces"):
    raise ImportError("the port has no Deformable.probe_forces")

KERNELS = {"k4": runtime.additive_kernel(2)}


def probe_path(dep, mix, seed: int, episode: int) -> np.ndarray:
    """[F, 3] the probe box's centre at each frame of an episode."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed), 1, int(episode)]))
    i = int(rng.integers(len(dep.sites)))
    site = dep.nodes[dep.sites[i]].astype(np.float64)
    n = dep.normals[i]
    reach = dep.config["probe_half_extent"] * np.sum(np.abs(n))
    start = site + (mix["start_gap"] + reach) * n
    u = np.cross(n, np.eye(3)[np.argmin(np.abs(n))])
    u /= np.linalg.norm(u)
    phi = rng.uniform(0.0, 2.0 * np.pi)
    tangent = np.cos(phi) * u + np.sin(phi) * np.cross(n, u)
    k = np.arange(int(mix["frames_per_episode"])) + 1
    push = int(mix["push_frames"])
    depth = mix["step"] * np.minimum(k, push)
    slide = mix["step"] * np.maximum(k - push, 0)
    return start - depth[:, None] * n + slide[:, None] * tangent


def new_probe(dep, centre) -> AvatarProbe:
    c = dep.config
    return AvatarProbe(half_extents=np.full(3, c["probe_half_extent"]),
                       force_coeff=c["force_coeff"],
                       pos=np.asarray(centre, np.float64))


def probe_frame(dep, probe, centre, state, stats):
    """The probe stage through the program's entry point: the load."""
    return dep.body.probe_forces(probe, centre, stats, state=state)


def program_frame(dep, state, f, ro, rd, stats):
    """One coupled frame under load f through the program's entry point."""
    c = dep.config
    return deformed.coupled_step_fast(
        dep.scene, dep.fem, dep.interp, state, f, ro, rd, h=c["h"],
        image_hw=dep.image_hw, cg_tol=c["cg_tol"], max_disp=c["max_disp"],
        fp_iters=c["fp_iters"], solve_stats=stats)


def _ratio(num: float, den: float) -> float:
    return 0.0 if num == 0.0 else num / den if den > 0.0 else float("inf")


def judge_frames(dep, history, frames) -> dict:
    """Readings of the checked frames. `history` is episode 0's (probe
    centre, the program's q before the frame) of frames 0 .. the last
    checked; each of `frames` a dict with frame, q0, v0 (before), q1, v1
    (after), f (the program's load), contacts (its probe's contacted
    nodes), t, hit (row-major) and roll."""
    c = dep.config
    step = dep.ref_step(Precision(dtype=torch.float64))
    probe = dep.ref_probe()
    by_frame = {fr["frame"]: fr for fr in frames}
    out = {"fem_err": 0.0, "fem_energy_err": 0.0, "fem_update_err": 0.0,
           "fem_unloaded_gap": 0.0, "probe_force_gap": 0.0,
           "probe_contact_flips": 0, "trace_surface_gap": 0.0,
           "trace_gap_rays": 0,
           "trace_hit_flips": 0, "trace_field_gap": 0.0,
           "trace_max_dt": 0.0}
    for k, (centre, q_before) in enumerate(history):
        ids, fc = probe.move(centre, dep.positions(q_before))
        fr = by_frame.get(k)
        if fr is None:
            continue
        f_ref = rprobe.ring_forces(dep.graph, ids, fc, c["haptic_radius"])
        f = fr["f"].detach().double().cpu().numpy()
        r = {"probe_force_gap": _ratio(float(np.abs(f - f_ref).max()),
                                       float(np.abs(f_ref).max())),
             "probe_contact_flips": len(set(ids.tolist())
                                        ^ set(fr["contacts"].tolist()))}
        r.update(judge_step(step, *(x.detach().double().reshape(-1, 3)
                                    for x in (fr["q0"], fr["v0"], fr["q1"],
                                              fr["v1"], fr["f"]))))
        r["fem_err"] = max(r["fem_energy_err"], r["fem_update_err"])
        ro, rd = dep.rays(fr["roll"])
        disp = dep.ref_disp(fr["q1"].reshape(-1, 3), Precision())
        ref = rtrace.trace_image(dep.ref_scene, ro, rd, *dep.image_hw,
                                 disp=disp, slope=True)
        resid = rtrace.surface_residual(dep.ref_scene, ro, rd, fr["t"],
                                        fr["hit"], disp)
        r.update(runtime.trace_gap(fr["t"], fr["hit"], *ref, resid))
        runtime.note(fr, r)
        out = runtime.worst(out, r)
    return out


def run(cell, seed, seconds, trace, device, t_start, dep=None):
    mix = cell.traffic
    sch = schedule(mix, seed)
    dep = dep or sim.load(cell.root, cell.config, device, sch.roll(0, 0))
    F = sch.frames_per_episode
    keep = set(sch.check)
    last = max(k for _, k in sch.check)
    ro, rd = dep.rays(sch.roll(0, 0))
    # Warm-up: the first frames of episode 0, from rest.
    path = probe_path(dep, mix, seed, 0)
    probe = new_probe(dep, path[0])
    dep.body.reset()
    st = dep.body.state
    for k in range(int(mix["warm_frames"])):
        f = probe_frame(dep, probe, path[k], st, {})
        _, _, st = program_frame(dep, st, f, ro, rd, {})
    runtime.sync(device)
    del st
    setup_s = time.perf_counter() - t_start

    win = runtime.Window()
    prof = runtime.Profiled(device) if trace else None
    kept, history, first_traced, window_q = [], [], None, []
    counters = {"forward_iters": [], "probe_host_ms": []}
    win.start = time.perf_counter()
    e = 0
    while True:
        path = probe_path(dep, mix, seed, e)
        probe = new_probe(dep, path[0])
        dep.body.reset()
        st = dep.body.state
        for k in range(F):
            if prof is not None and e == 0 and k == sch.trace_frames[0]:
                prof.open()
            stats = {}
            a = time.perf_counter()
            f = probe_frame(dep, probe, path[k], st, stats)
            t, hit, st2 = program_frame(dep, st, f, ro, rd, stats)
            runtime.sync(device)
            b = time.perf_counter()
            win.latencies.append(b - a)
            counters["forward_iters"].append(stats.get("forward_iters"))
            counters["probe_host_ms"].append(stats.get("host_ms"))
            if prof is not None and e == 0 and k == sch.trace_frames[-1]:
                prof.close()
            window_q.append(st2.q)
            if e == 0 and k == sch.trace_frames[0]:
                first_traced = st2.q
            if e == 0 and k <= last:
                history.append((path[k], st.q))
            if (e, k) in keep:
                kept.append(dict(q0=st.q, v0=st.qvel, q1=st2.q, v1=st2.qvel,
                                 f=f, contacts=probe.contact_nodes, t=t,
                                 hit=hit, roll=sch.roll(e, 0), frame=k))
            st = st2
        e += 1
        win.end = b
        if win.end - win.start >= seconds:
            break
    dev_info = runtime.device_info(device, cell.chips)
    del st, st2, t, hit
    result = {"attempted": len(win.latencies), "failed": 0}
    if trace:
        work = rtrace.Work()
        disp = dep.ref_disp(first_traced.reshape(-1, 3), Precision())
        rtrace.trace_image(dep.ref_scene, ro, rd, *dep.image_hw, disp=disp,
                           work=work)
        bound = {"k4": work.bound_s(runtime.PEAK_FP32_FLOPS,
                                    runtime.PEAK_BYTES_PER_S)}
        readings, breakdown = runtime.readings(
            prof, len(sch.trace_frames), counters, bound, KERNELS)
        dev_info.update(busy_s=readings.busy_s, window_s=readings.window_s)
        result.update(readings=readings, breakdown=breakdown)
    else:
        result["e2e"] = {"frame_ms": win.frame_ms(),
                         "frame_ms_p90": win.p90_ms(), "setup_s": setup_s}
    result["device"] = dev_info
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    bound = float(dep.disp_bounds(window_q).max())
    del window_q
    result["compared"] = {**judge_frames(dep, history, kept),
                          "disp_bound": bound}
    return result
