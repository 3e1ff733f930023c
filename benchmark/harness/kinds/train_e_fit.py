"""Training steps that fit the tissue's stiffness scale (Young's modulus)
to an image: each step renders one differentiable coupled frame from rest
under gravity (`coupled_step_grid_fast(differentiable=True)`: FEM solve
and its adjoint, biharmonic weights, K4 and the implicit-differentiation
correction), takes the loss sum over hit pixels of a seeded weight times
the depth t, back-propagates to the scale and steps it by gradient
descent, each step clipped to `clip` of the scale and the scale kept in
`scale_range`. Set-up builds the step and drives it through its first
`check_steps` steps, which the reference follows; the window then runs
steps back to back until `--seconds` have passed. The window's first
step is compared too: the reference takes it from the program's scale.
"""
from __future__ import annotations

import time

import torch

from harness import brain, runtime
from harness.traffic import schedule
from reference import fem as rfem
from reference import trace as rtrace
from reference import train as rtrain
from reference.field import Precision

KERNELS = {"k4": runtime.additive_kernel(2)}


class TrainStep:
    """The program's training step and its state: the stiffness scale."""

    def __init__(self, dep, mix, pix_w, ro, rd):
        self.dep, self.mix, self.pix_w = dep, mix, pix_w
        self.ro, self.rd = ro, rd
        self.scale = torch.tensor(1.0, device=ro.device)

    def __call__(self, stats):
        """One step; returns (loss, gradient, t, hit, state after)."""
        scale = self.scale.clone().requires_grad_(True)
        t, hit, st = coupled_frame(self.dep, scale, self.ro, self.rd, stats)
        loss = torch.sum(torch.where(hit, self.pix_w * t, 0.0))
        loss.backward()
        g = scale.grad
        with torch.no_grad():
            self.scale = update(self.scale, g, self.mix)
        return loss.detach(), g.detach(), t.detach(), hit, st


def coupled_frame(dep, scale, ro, rd, stats):
    """The differentiable frame through the program's entry point."""
    from fembrain_tpu_torch.render import deformed

    c = dep.config
    return deformed.coupled_step_grid_fast(
        dep.scene, dep.gf, dep.interp, dep.cgi, dep.gf.rest_state(),
        dep.f_ext, ro, rd, h=c["h"], E_scale=scale, image_hw=dep.image_hw,
        differentiable=True, cg_tol=c["cg_tol"], max_disp=c["max_disp"],
        fp_iters=c["fp_iters"], solve_stats=stats)


def update(scale, g, mix):
    """The step's gradient descent on the scale (rtrain.update's rule)."""
    return rtrain.update(scale, g, mix)


def pixel_weights(dep, sch, mix):
    lo, hi = mix["pixel_weight_range"]
    g = sch.generator(dep.device, stream=1)
    n = dep.config["width"] * dep.config["height"]
    return lo + (hi - lo) * torch.rand(n, generator=g, device=dep.device)


def program_frame(step: TrainStep, stats):
    return step(stats)


def reference_steps(dep, mix, pix_w, ro, rd, n, prec, fem_prec):
    """The reference's first `n` steps from scale 1: per step its result,
    and its scale after the last."""
    s, out = 1.0, []
    for _ in range(n):
        r = rtrain.step(dep, s, pix_w, ro, rd, prec, fem_prec)
        out.append(r)
        s = float(rtrain.update(torch.tensor(s, dtype=torch.float64),
                                torch.tensor(r["grad"], dtype=torch.float64),
                                mix))
    return out, s


def gap(p: float, r: float) -> float:
    return abs(p - r) / abs(r)


def judge(dep, mix, pix_w, ro, rd, first, scale_after, window=None) -> dict:
    """Readings of the program's first steps (`first`: loss, grad, t,
    hit, q, v of each; `scale_after` its scale after them) against the
    reference's: the relative gap of each step's loss (largest), of the
    first gradient, and of the scale's change over the steps; and for
    the first step's frame the FEM step's error and the trace against
    the reference's (runtime.trace_gap). `window` (loss and grad of the
    window's first step, taken from `scale_after`) joins the loss and
    gradient gaps, against the reference's step from the same scale."""
    ref, s_ref = reference_steps(dep, mix, pix_w, ro, rd, len(first),
                                 Precision(), Precision(dtype=torch.float64))
    loss_gap = max(gap(p["loss"], r["loss"]) for p, r in zip(first, ref))
    grad_gap = gap(first[0]["grad"], ref[0]["grad"])
    if window is not None:
        rw = rtrain.step(dep, scale_after, pix_w, ro, rd, Precision(),
                         Precision(dtype=torch.float64))
        loss_gap = max(loss_gap, gap(window["loss"], rw["loss"]))
        grad_gap = max(grad_gap, gap(window["grad"], rw["grad"]))
        runtime.note({"frame": len(first)},
                     {"loss": window["loss"], "ref_loss": rw["loss"],
                      "grad": window["grad"], "ref_grad": rw["grad"]})
        del rw
    change = abs(s_ref - 1.0)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap,
           "scale_change_gap": abs(abs(scale_after - 1.0) - change)
           / max(change, 1e-12)}
    p, r = first[0], ref[0]
    step = dep.ref_step(Precision(dtype=torch.float64))
    z = torch.zeros_like(r["q"])
    fem = rfem.judge_step(step, z, z, p["q"].reshape(-1, 3).double(),
                          p["v"].reshape(-1, 3).double(),
                          dep.f_ext.reshape(-1, 3).double())
    out["fem_err"] = max(fem["fem_energy_err"], fem["fem_update_err"])
    c = dep.config
    disp = rtrain.biharmonic_disp(dep.ref_interp, r["w"], c["max_disp"],
                                  c["fp_iters"], Precision())
    resid = rtrace.surface_residual(dep.ref_scene, ro, rd, p["t"], p["hit"],
                                    disp)
    out.update(runtime.trace_gap(p["t"], p["hit"], r["t"], r["hit"],
                                 r["rise"], resid))
    for k, (pp, rr) in enumerate(zip(first, ref)):
        runtime.note({"frame": k}, {"loss": pp["loss"], "ref_loss": rr["loss"],
                                    "grad": pp["grad"], "ref_grad": rr["grad"]})
    runtime.note({"frame": 0}, out)
    return out


def run(cell, seed, seconds, trace, device, t_start, dep=None):
    dep = dep or brain.load(cell.root, cell.config, device, fem=True)
    mix = cell.traffic
    sch = schedule(mix, seed)
    ro, rd = dep.rays(sch.roll(0, 0))
    pix_w = pixel_weights(dep, sch, mix)
    train = TrainStep(dep, mix, pix_w, ro, rd)
    first = []
    for _ in range(int(mix["check_steps"])):
        stats = {}
        loss, g, t, hit, st = program_frame(train, stats)
        first.append(dict(loss=float(loss), grad=float(g), t=t, hit=hit,
                          q=st.q.detach(), v=st.qvel.detach()))
    scale_after = float(train.scale)
    runtime.sync(device)
    setup_s = time.perf_counter() - t_start

    win = runtime.Window()
    prof = runtime.Profiled(device) if trace else None
    fwd, adj, traced_q, win0 = [], [], None, None
    win.start = time.perf_counter()
    k = 0
    while True:
        if prof is not None and k == sch.trace_frames[0]:
            prof.open()
        stats = {}
        a = time.perf_counter()
        out = program_frame(train, stats)
        runtime.sync(device)
        b = time.perf_counter()
        win.latencies.append(b - a)
        fwd.append(stats.get("forward_iters"))
        adj.append(stats.get("adjoint_iters"))
        if prof is not None and k == sch.trace_frames[-1]:
            prof.close()
        if k == sch.trace_frames[0]:
            traced_q = out[4].q.detach()
        if k == 0:
            win0 = out[:2]
        k += 1
        win.end = b
        if win.end - win.start >= seconds and (
                prof is None or k > sch.trace_frames[-1]):
            break
    dev_info = runtime.device_info(device, cell.chips)
    result = {"attempted": len(win.latencies), "failed": 0}
    if trace:
        work = rtrace.Work()
        c = dep.config
        q = traced_q.reshape(-1, 3)
        w = rtrain.weights(dep.ref_interp, q[dep.ref_cgi].float(),
                           Precision())
        disp = rtrain.biharmonic_disp(dep.ref_interp, w, c["max_disp"],
                                      c["fp_iters"], Precision())
        rtrace.trace_image(dep.ref_scene, ro, rd, *dep.image_hw, disp=disp,
                           work=work)
        bound = {"k4": work.bound_s(runtime.PEAK_FP32_FLOPS,
                                    runtime.PEAK_BYTES_PER_S)}
        readings, breakdown = runtime.readings(
            prof, len(sch.trace_frames),
            {"forward_iters": fwd, "adjoint_iters": adj}, bound, KERNELS)
        dev_info.update(busy_s=readings.busy_s, window_s=readings.window_s)
        result.update(readings=readings, breakdown=breakdown)
    else:
        result["e2e"] = {"train_step_ms": win.frame_ms(), "setup_s": setup_s}
    result["device"] = dev_info
    del train, out
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    window = {"loss": float(win0[0]), "grad": float(win0[1])}
    result["compared"] = judge(dep, mix, pix_w, ro, rd, first, scale_after,
                               window)
    return result
