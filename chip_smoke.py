#!/usr/bin/env python3
"""Drive the PyTorch port's coupled render+deform frame, its training
path and its simulation frame once on one CUDA card, through its
hand-written kernels.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. torch / CUDA versions, the card's name and power limit;
  2. build the CUDA kernels from fembrain_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card, at
     480x270 and 1920x1080 (K1 rest trace on brain; K2 Wendland and K4
     biharmonic deformed traces after a 40-step FEM settle; K3 general
     trace on the brain resection, and on a twisted blend at 480x270), and
     time each at 1920x1080 beside its bound: the plain version counts the
     work these inputs need (tile_trace.WorkCount), the bound is the
     larger of its flops over the H100's fp32 peak and the bytes these
     rays need (tile_trace.ray_bytes) over its memory rate, and the
     kernel's counting build gives the share of lanes that were busy; K3
     is held against its plain version without the per-tile live list.
     Beside the bound, what each kernel pays: its time on the same grid
     with every ray dead (empty grid) and with no march and no refinement
     (entry only), the live tiles and patches, the prims, pull-back lanes
     and centers its culls let run against those the work needs, held to
     the plain version's count of the same, the SM clock under load, and
     K2's build for two CTAs an SM beside the shipped one for three;
  4. with the launch counters at 0, run the main path at 1920x1080: load
     and pack brain.blob, extract the tet mesh (cellsize 0.14), build the
     grid FEM and the 256-center Wendland interpolant, settle 40 steps,
     trace 10 rest frames (K1), cold then warm, and 10 coupled frames
     (K2); check the counters, hits, finiteness and the FEM sag, and print
     stage times;
  5. with the launch counters at 0 again, the training path at 1920x1080:
     (a) trace_fast on the brain resection (K3) and the gradient of the
     summed hit depth with respect to the prim positions; (b) from the
     settled brain, one differentiable coupled frame with the 112-center
     biharmonic interpolant (K4) and the gradient with respect to Young's
     modulus, with CG iterations, times and peak memory, each run twice
     (first and warm call); (c) that
     E-gradient against central finite differences at a small size
     (cellsize 0.35, 64 centers, 24x18 rays, one step from rest).
  6. with the launch counters at 0 again, the simulation frame on brain at
     the width of data/models/brain.sim (cellsize 0.14): polygonize the
     surface and extract the tet mesh, build the unstructured FEM mesh
     and a `Deformable`, step it under gravity and then under a haptic
     push at the top of the surface (CG iterations, ms and device kernel
     launches per step), move the surface vertices with the FEM
     displacements, run coupled frames through `coupled_step_fast` at
     1920x1080 (a 256-center Wendland interpolant: K2) and one
     differentiable one (the biharmonic interpolant: K4) with its
     E-gradient, shade K1's hits at 1920x1080, render the rest and the
     deformed tissue densely at 400x300, and evaluate and trace a scene
     of more than 96 ops (which takes no kernel).
Phases 4 to 6 also count the frames and steps they drive, and each
kernel's launches per step come from that, path by path: launches over
steps, held to 1. Then one JSON line with the kernels (`launches` is the
sum over the counted paths, `launches_by_path` the parts), the card line,
and the result line.
It needs a CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

WIDTH, HEIGHT = 1920, 1080
SMALL = (480, 270)
CELLSIZE = 0.14
N_CENTERS = 256
SIGMA_FILL = 2.5
K_REFRESH = 4       # the brain's refresh cycle in the reference bench
CG_TOL = 1e-2       # forward-rendering CG tolerance of the coupled frame
SETTLE_STEPS = 40
N_FRAMES = 10
MAX_DISP = 0.5      # static bracket inflation of the biharmonic trace
# The E-gradient check at the size of the reference's (bench.py:683-718).
FD_CELLSIZE, FD_CENTERS, FD_RAYS, FD_FORCE = 0.35, 64, (24, 18), -200.0
FD_MAX_REL = 0.05
# The simulation frame: per-node gravity force of the Deformable, the
# haptic push (brain.sim's FORCECOEFF) and the steps and frames driven.
SIM_GRAVITY = -1000.0
SIM_PUSH = (0.0, -5000.0, 0.0)
SIM_GRAVITY_STEPS, SIM_PUSH_STEPS, SIM_FRAMES = 5, 5, 5
SIM_IMAGE = (400, 300)     # the app's default frame, marched densely
SIM_DEEP_RAYS = (64, 48)   # the scene of more than 96 ops
# Kernel against plain version: (hit agreement, max |dt|, median |dt|).
THRESHOLDS = {
    "trace_additive_rest": (0.999, 1e-4, None),
    "trace_additive_wendland": (0.995, 5e-2, 5e-3),
    "trace_general": (0.999, 1e-4, None),
    "trace_additive_biharmonic": (0.995, 1e-3, None),
}
# Published peaks of the H100 SXM: fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
MAX_BOUND_SHARE = 1.05   # a kernel cannot beat its bound; 5% for the clock
RUN_COUNT_TOL = 0.01     # kernel's run counters against the plain version's
LAUNCHES_PER_STEP = 1    # what every path is held to
LIBRARY = "none: no single PyTorch call computes a sphere trace"
KERNELS = (  # name, source, the TPU kernel it replaces
    ("trace_additive_rest", "fembrain_tpu_torch/csrc/trace_additive.cu",
     "fembrain_tpu/render/pallas_trace.py:349"),
    ("trace_additive_wendland", "fembrain_tpu_torch/csrc/trace_additive.cu",
     "fembrain_tpu/render/pallas_trace.py:497"),
    ("trace_general", "fembrain_tpu_torch/csrc/trace_general.cu",
     "fembrain_tpu/render/pallas_trace.py:267"),
    ("trace_additive_biharmonic", "fembrain_tpu_torch/csrc/trace_additive.cu",
     "fembrain_tpu/render/pallas_trace.py:692"),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reports now (read right after a timed run,
    while the card still holds its clock under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0].split()[0])


def sync_ms(fn, reps: int = 1):
    """Mean milliseconds of `fn()` over `reps` calls, host clock around a
    synchronised run; returns (ms, last result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def event_ms(fn, reps: int):
    """Mean device milliseconds of `fn()` from CUDA events, after one
    warm-up call. A few large matrix products go first, so that the host
    has queued every launch before the card reaches the first event: a
    kernel shorter than its wrapper's host time is then still timed on the
    card."""
    import torch

    fn()
    busy = torch.ones(4096, 4096, device="cuda")
    for _ in range(4):
        busy @ busy
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def load_scene(root: Path, device):
    from fembrain_tpu_torch.blob.reader import load_blob

    sdef = load_blob(root / "data" / "models" / "blobtree" / "brain.blob")
    sdef.flatten_instances()
    return sdef.pack(device=device)


def fem_setup(scene, cellsize, device, n_centers, kernel, force):
    """Tet mesh, anchors, grid FEM, displacement interpolant and gravity
    f_ext = force * mass for `scene`."""
    import numpy as np
    import torch

    from fembrain_tpu_torch.fem import grid_fem as gfm
    from fembrain_tpu_torch.mesh.polygonize import (
        extract_tet_mesh, grid_for_scene,
    )
    from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component
    from fembrain_tpu_torch.render.deformed import build_disp_interp

    grid = grid_for_scene(scene, cellsize=cellsize)
    tm = extract_tet_mesh(scene, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    nodes = tm.nodes[: tm.n_nodes].cpu().numpy()
    tets = tm.tets[: tm.n_tets].cpu().numpy()
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    gf = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed,
                                   device=device)
    kw = {"sigma_fill": SIGMA_FILL} if kernel == "wendland" else {}
    interp = build_disp_interp(nodes, n_centers=n_centers, fixed=fixed,
                               kernel=kernel, device=device, **kw)
    n2g = gfm.node_to_grid_index(tm)
    f_ext = np.zeros((int(np.prod(grid.dims)), 3), np.float32)
    f_ext[n2g, 1] = force * gf.mass.cpu().numpy().reshape(-1)[n2g]
    return dict(
        grid=grid, tm=tm, nodes=nodes, fixed=fixed, gf=gf, interp=interp,
        n2g=n2g, cgi=center_grid_index(interp, n2g, device),
        f_ext=torch.as_tensor(f_ext.reshape(*grid.dims, 3), device=device),
    )


def center_grid_index(interp, n2g, device):
    import numpy as np
    import torch

    return torch.as_tensor(
        n2g[interp.center_nodes.cpu().numpy()].astype(np.int64),
        device=device)


def build_frame(root: Path, device, log):
    """The main path's set-up: scene, tet mesh, grid FEM, Wendland
    interpolant, external force and the settled FEM state."""
    import torch

    from fembrain_tpu_torch.fem import grid_fem as gfm

    t0 = time.perf_counter()
    scene = load_scene(root, device)
    frame = fem_setup(scene, CELLSIZE, device, N_CENTERS, "wendland", -500.0)
    tm, gf = frame["tm"], frame["gf"]
    log(f"tet mesh: {tm.n_nodes} nodes, {tm.n_tets} tets "
        f"(cellsize {CELLSIZE}, grid {frame['grid'].dims})")
    setup_s = time.perf_counter() - t0
    state = gf.rest_state()
    iters = []
    t0 = time.perf_counter()
    for _ in range(SETTLE_STEPS):
        state, it = gfm.timestep(gf, state, frame["f_ext"])
        iters.append(it)
    torch.cuda.synchronize()
    settle_ms = (time.perf_counter() - t0) * 1e3
    sag = float(state.q[..., 1].min())
    log(f"set-up {setup_s:.3f} s; settle {SETTLE_STEPS} steps "
        f"{settle_ms:.1f} ms (CG iterations {iters[0]}..{iters[-1]}, "
        f"mean {sum(iters) / len(iters):.1f}); sag min q_y {sag:.6f}")
    frame.update(scene=scene, state=state, sag=sag)
    return frame


def biharmonic_frame_spec(frame, state, device, log, tag):
    """The 112-center biharmonic interpolant of a settled frame, its
    weights, and the static bracket inflation that covers the state's
    |u| bound (raised in steps of 0.25 where MAX_DISP does not)."""
    from fembrain_tpu_torch.render.deformed import (
        build_disp_interp, disp_weights_centers, max_disp_bound,
    )

    interp = build_disp_interp(frame["nodes"], fixed=frame["fixed"],
                               device=device)
    cgi = center_grid_index(interp, frame["n2g"], device)
    w = disp_weights_centers(interp, state.q.reshape(-1, 3)[cgi])
    bound = float(max_disp_bound(interp, w,
                                 state.q.reshape(-1, 3)[frame["n2g"]]))
    max_disp = MAX_DISP
    while bound > max_disp:
        max_disp += 0.25
    log(f"biharmonic interpolant: {interp.centers.shape[0]} centers; "
        f"max_disp_bound {bound:.6f}, max_disp {max_disp} {tag}")
    return interp, cgi, w, max_disp, bound


def image_rays(width, height, device, pose=(30.0, 20.0, 8.0)):
    from fembrain_tpu_torch.render.camera import Camera, generate_rays

    ro, rd = generate_rays(Camera.orbit(*pose, device=device), width,
                           height)
    return ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()


def compare(kernel, plain, inp, name, log, label, count=None):
    """Kernel against its plain version on the same inputs; raises when
    outside the kernel's thresholds. The plain version fills `count` with
    the work the inputs need. Returns max |dt| on common hits."""
    import torch

    agree_min, max_allowed, median_allowed = THRESHOLDS[name]
    t_k, h_k = kernel(inp)
    t_p, h_p = plain(inp, count)
    torch.cuda.synchronize()
    hk, hp = h_k > 0.5, h_p > 0.5
    if not bool(torch.isfinite(t_k).all()):
        raise AssertionError(f"{label}: kernel produced non-finite t")
    agree = float((hk == hp).float().mean())
    diff = torch.abs(t_k - t_p)[hk & hp]
    max_d = float(diff.max()) if diff.numel() else 0.0
    med_d = float(diff.median()) if diff.numel() else 0.0
    log(f"{label}: hits kernel {int(hk.sum())} plain {int(hp.sum())}, "
        f"agreement {agree:.6f}, |dt| median {med_d:.3e} max {max_d:.3e}")
    ok = agree > agree_min and max_d < max_allowed
    if median_allowed is not None:
        ok = ok and med_d < median_allowed
    if not ok or int(hk.sum()) == 0:
        raise AssertionError(f"{label}: kernel and plain version disagree")
    return max_d


def bound(name, kernel, inp, count, ms, tag, log):
    """The kernel's lower bound on this card for the work `count` holds,
    its share of the measured time, and the busy-lane share from the
    kernel's counting build. Raises when the share is impossible."""
    import torch

    from fembrain_tpu_torch.render.tile_trace import N_COUNTERS, ray_bytes

    rays = inp.rays.shape[1]
    alive = int((inp.rays[8] > 0).sum())
    n_bytes = ray_bytes(inp.rays)
    flops_ms = count.flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(flops_ms, bytes_ms)
    share = bound_ms / ms
    lanes = torch.zeros(N_COUNTERS, dtype=torch.int64,
                        device=inp.rays.device)
    kernel(inp, lanes)
    torch.cuda.synchronize()
    needed, ran = (int(v) for v in lanes.tolist()[:2])
    log(f"{name} work: {count.lane_evals} needed lane-evals (counting build "
        f"{needed}, lanes of the warp-evals that ran {ran}, busy share "
        f"{needed / max(ran, 1):.4f}), {count.prims_in_reach} prims in reach "
        f"{dict(sorted(count.prim_evals.items()))}, {count.pull_iters} "
        f"pull-back iterations, centers biharmonic "
        f"{count.biharmonic_center_evals} Wendland "
        f"{count.wendland_center_evals}; {count.flops} flops = "
        f"{flops_ms:.4f} ms at {PEAK_FP32_FLOPS / 1e12:g} TFLOP/s, {rays} "
        f"rays of which {alive} start alive = {n_bytes} bytes = "
        f"{bytes_ms:.4f} ms at {PEAK_BYTES_PER_S / 1e12:g} TB/s; "
        f"bound {bound_ms:.4f} ms, share {share:.4f} {tag}")
    if not 0.0 < share <= MAX_BOUND_SHARE:
        raise AssertionError(f"{name}: bound share {share} outside "
                             f"(0, {MAX_BOUND_SHARE}]")
    if abs(needed - count.lane_evals) > 0.01 * count.lane_evals:
        raise AssertionError(f"{name}: the kernel needed {needed} lane-evals, "
                             f"its plain version {count.lane_evals}")
    return dict(
        bound_ms=bound_ms,
        bound_by="operations" if flops_ms >= bytes_ms else "bytes",
        bound_share=share, library_ms=None, library=LIBRARY,
        needed_lane_evals=count.lane_evals,
        busy_lane_share=needed / max(ran, 1),
        **split(name, kernel, inp, count, lanes.tolist(), ms, tag, log),
    )


def split(name, kernel, inp, count, ran, ms, tag, log):
    """What the kernel pays beside its bound: the time of the same grid
    with every ray dead, and with no march and no refinement; live tiles
    and patches; what its culls let run (the counting build's `ran`)
    against what the work needs, held to the plain version's count of the
    same culls; and the SM clock right after the timed runs."""
    from fembrain_tpu_torch.render import tile_trace as tt

    dead = inp.rays.clone()
    dead[8] = 0.0
    empty = dataclasses.replace(inp, rays=dead)
    empty_ms = event_ms(lambda: kernel(empty), 10)
    entry = dataclasses.replace(inp, max_steps=0, bisect_steps=0)
    entry_ms = event_ms(lambda: kernel(entry), 10)
    clock = sm_clock_mhz()
    alive = inp.rays[8] > 0
    n = alive.shape[0]
    live_tiles = int(alive.reshape(-1, inp.tile).any(-1).sum())
    live_patches = int(alive[tt.patch_rays(n, inp.tile, alive.device)]
                       .any(-1).sum())
    _, lanes_run, prims_run, pull_lanes_run, centers_run = ran
    pairs = [("lanes", lanes_run, count.lanes_run),
             ("prims", prims_run, count.prims_run)]
    out = dict(
        empty_grid_ms=empty_ms, entry_only_ms=entry_ms,
        live_tiles=live_tiles, live_patches=live_patches,
        prims_run_per_in_reach=prims_run / max(count.prims_in_reach, 1),
        lane_prims_run=prims_run, sm_clock_mhz=clock,
    )
    if name == "trace_additive_wendland":
        pairs += [("pull-back lanes", pull_lanes_run, count.pull_lanes_run),
                  ("centers", centers_run, count.centers_run)]
        out.update(
            pull_lanes_run_per_needed=pull_lanes_run / count.pull_iters,
            centers_run_per_in_reach=(centers_run
                                      / count.wendland_center_evals),
            lane_centers_run=centers_run,
            # The residency variant kept in the tree: two CTAs an SM.
            ms_two_ctas=event_ms(lambda: kernel(inp, two_ctas=True), 10))
    log(f"{name} split: empty grid {empty_ms:.4f} ms, entry only "
        f"{entry_ms:.4f} ms of {ms:.4f} ms; {live_tiles} live tiles of "
        f"{n // inp.tile}, {live_patches} live patches of {n // 32}; ran "
        + ", ".join(f"{label} {k} (plain version {p})"
                    for label, k, p in pairs)
        + f"; prims run per prim in reach "
        f"{out['prims_run_per_in_reach']:.3f}"
        + (f", pull-back lanes run per needed "
           f"{out['pull_lanes_run_per_needed']:.3f}, centers run per center "
           f"in reach {out['centers_run_per_in_reach']:.3f}"
           if "centers_run_per_in_reach" in out else "")
        + (f"; built for two CTAs an SM {out['ms_two_ctas']:.4f} ms"
           if "ms_two_ctas" in out else "")
        + f"; SM clock {clock:.0f} MHz {tag}")
    for label, k, p in pairs:
        if abs(k - p) > RUN_COUNT_TOL * max(p, 1):
            raise AssertionError(f"{name}: the kernel ran {k} {label}, its "
                                 f"plain version counts {p}")
    return out


def kernel_phase(root, device, params, tag, log):
    """Phase 3: every kernel against its plain version; (results, the
    settled frame)."""
    import torch

    from fembrain_tpu_torch.render import tile_trace as tt
    from fembrain_tpu_torch.render.deformed import (
        biharmonic_spec, disp_weights_centers, march_step_bounds,
        wendland_spec,
    )

    from fembrain_tpu_torch.blob.examples import blend_twist, brain_resection

    tile = tt.TILE
    frame = build_frame(root, device, log)
    scene, state = frame["scene"], frame["state"]
    w_settled = disp_weights_centers(
        frame["interp"], state.q.reshape(-1, 3)[frame["cgi"]])
    spec_w = wendland_spec(frame["interp"], w_settled, k_refresh=K_REFRESH)
    interp_b, _, w_b, max_disp, _ = biharmonic_frame_spec(
        frame, state, device, log, tag)
    spec_b = biharmonic_spec(interp_b, w_b, *march_step_bounds(interp_b, w_b),
                             max_disp=max_disp)
    resection = brain_resection().pack(device=device)
    twist = blend_twist().pack(device=device)
    cases = []
    for size in (SMALL, (WIDTH, HEIGHT)):
        cases += [
            ("trace_additive_rest", size, scene, None, None),
            ("trace_additive_wendland", size, scene, spec_w, None),
            ("trace_additive_biharmonic", size, scene, spec_b, None),
            ("trace_general", size, resection, None, None),
        ]
    cases.append(("trace_general", SMALL, twist, None, (25.0, 20.0, 2.5)))
    plains = {
        "trace_additive_rest": tt.trace_tiles_plain,
        "trace_additive_wendland": tt.trace_tiles_wendland_plain,
        "trace_additive_biharmonic": tt.trace_tiles_biharmonic_plain,
        # Without the per-tile live list, so that a wrong list shows.
        "trace_general": lambda inp, count=None: tt.trace_tiles_general_plain(
            inp, count, use_live=False),
    }
    results = {}
    for name, (width, height), sc, disp, pose in cases:
        ro, rd = image_rays(width, height, device, pose or (30.0, 20.0, 8.0))
        ro_b, rd_b, _ = tt.image_rays_to_blocks(ro, rd, height, width, tile)
        if name == "trace_general":
            inp = tt.prepare_general(sc, ro_b, rd_b, params, tile)
            kernel = tt.trace_general_cuda
        else:
            inp = tt.prepare_tiles(sc, ro_b, rd_b, params, tile, disp)
            kernel = tt.trace_additive_cuda
        label = f"{name} {width}x{height}" + (" twist" if pose else "")
        full = (width, height) == (WIDTH, HEIGHT)
        count = tt.WorkCount() if full else None
        max_d = compare(kernel, plains[name], inp, name, log, label, count)
        if full:
            ms = event_ms(lambda: kernel(inp), 10)
            plain_ms, _ = sync_ms(lambda: plains[name](inp))
            log(f"{name} {width}x{height}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms {tag}")
            results[name] = dict(
                max_abs_err=max_d, ms=ms, plain_ms=plain_ms,
                **bound(name, kernel, inp, count, ms, tag, log))
        del inp
        torch.cuda.empty_cache()
    return results


def main_path_phase(root, device, params, tag, log):
    """Phase 4: the main path (rest and coupled frames), counted; returns
    (launches, steps driven per kernel, frame)."""
    import torch

    from fembrain_tpu_torch.fem import grid_fem as gfm
    from fembrain_tpu_torch.render import tile_trace as tt
    from fembrain_tpu_torch.render.deformed import (
        coupled_step_grid_fast, disp_weights_centers, trace_deformed_rbf_fast,
    )

    tt.reset_launch_counts()
    t_main = time.perf_counter()
    frame = build_frame(root, device, log)
    scene, gf, interp = frame["scene"], frame["gf"], frame["interp"]
    cgi, f_ext, st0 = frame["cgi"], frame["f_ext"], frame["state"]
    ro, rd = image_rays(WIDTH, HEIGHT, device)
    hw = (HEIGHT, WIDTH)

    rest_ms, (t_rest, hit_rest) = sync_ms(
        lambda: tt.trace_tiles_image(scene, ro, rd, HEIGHT, WIDTH, params),
        reps=N_FRAMES,
    )
    # The same frame warm, then its host side and its kernel on their own.
    warm_ms, _ = sync_ms(
        lambda: tt.trace_tiles_image(scene, ro, rd, HEIGHT, WIDTH, params),
        reps=N_FRAMES,
    )
    ro_b, rd_b, _ = tt.image_rays_to_blocks(ro, rd, HEIGHT, WIDTH)
    prepare_ms, rest_inp = sync_ms(
        lambda: tt.prepare_tiles(scene, ro_b, rd_b, params), reps=N_FRAMES)
    run_ms, _ = sync_ms(lambda: tt.run_tiles(rest_inp), reps=N_FRAMES)
    del rest_inp
    state = st0
    cg_iters = []

    def coupled():
        nonlocal state
        t, hit, state, it = coupled_step_grid_fast(
            scene, gf, interp, cgi, state, f_ext, ro, rd, params=params,
            image_hw=hw, cg_tol=CG_TOL, k_refresh=K_REFRESH,
        )
        cg_iters.append(it)
        return t, hit

    frame_ms, (t_def, hit_def) = sync_ms(coupled, reps=N_FRAMES)

    # Stage split, each stage run on its own from the settled state.
    fem_state = st0

    def fem_only():
        nonlocal fem_state
        fem_state, _ = gfm.timestep(gf, fem_state, f_ext, cg_tol=CG_TOL)
        return fem_state

    fem_ms, st1 = sync_ms(fem_only, reps=N_FRAMES)
    rbf_ms, w1 = sync_ms(
        lambda: disp_weights_centers(interp, st1.q.reshape(-1, 3)[cgi]),
        reps=N_FRAMES,
    )
    trace_ms, _ = sync_ms(
        lambda: trace_deformed_rbf_fast(scene, interp, w1, ro, rd, params,
                                        image_hw=hw, need_grads=False,
                                        k_refresh=K_REFRESH),
        reps=N_FRAMES,
    )
    main_s = time.perf_counter() - t_main
    launches = dict(tt.LAUNCHES)
    # Two sets of N_FRAMES rest frames and N_FRAMES kernel runs of the
    # rest split; N_FRAMES coupled frames and as many trace stages of the
    # coupled split.
    steps = {"trace_additive_rest": 3 * N_FRAMES,
             "trace_additive_wendland": len(cg_iters) + N_FRAMES}

    log(f"launches in the main path: {launches}, steps {steps}")
    for name in ("trace_additive_rest", "trace_additive_wendland"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    n_rest, n_def = int(hit_rest.sum()), int(hit_def.sum())
    for label, t, hit in (("rest", t_rest, hit_rest),
                          ("coupled", t_def, hit_def)):
        if t.shape != (WIDTH * HEIGHT,) or hit.shape != (WIDTH * HEIGHT,):
            raise AssertionError(f"{label} frame has shape {tuple(t.shape)}")
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label} frame has non-finite t")
    if n_rest <= 0 or n_def <= 0:
        raise AssertionError(f"no hits: rest {n_rest}, coupled {n_def}")
    sag = float(state.q[..., 1].min())
    if not sag < 0.0 or frame["sag"] >= 0.0:
        raise AssertionError(f"FEM state did not sag (min q_y {sag})")
    log(f"hits at {WIDTH}x{HEIGHT}: rest {n_rest}, coupled {n_def}; "
        f"coupled-frame CG iterations {cg_iters}; sag min q_y {sag:.6f}")
    rays = WIDTH * HEIGHT
    log(f"rest trace {WIDTH}x{HEIGHT}: {rest_ms:.3f} ms/frame, "
        f"{rays / rest_ms * 1e3:.1f} rays/s; warm {warm_ms:.3f} ms/frame, "
        f"of it prepare_tiles {prepare_ms:.3f} ms, the kernel with its "
        f"wrapper {run_ms:.3f} ms {tag}")
    log(f"coupled frame {WIDTH}x{HEIGHT}: {frame_ms:.3f} ms/frame, "
        f"{1e3 / frame_ms:.3f} fps {tag}")
    log(f"coupled split: fem {fem_ms:.3f} ms, rbf {rbf_ms:.3f} ms, "
        f"trace {trace_ms:.3f} ms {tag}")
    log(f"main path total {main_s:.1f} s")
    return launches, steps, frame


def _check_grad(label, g):
    import torch

    if not bool(torch.isfinite(g).all()) or float(torch.abs(g).max()) == 0.0:
        raise AssertionError(f"{label}: gradient not finite and non-zero")


def training_phase(root, device, params, frame, tag, log):
    """Phase 5: the training path at 1920x1080, counted; returns
    (launches, steps driven per kernel)."""
    import torch

    from fembrain_tpu_torch.render import tile_trace as tt
    from fembrain_tpu_torch.render.deformed import (
        coupled_step_grid_fast, disp_weights_centers, max_disp_bound,
    )

    from fembrain_tpu_torch.blob.examples import brain_resection

    resection = brain_resection().pack(device=device)
    scene, gf, st0 = frame["scene"], frame["gf"], frame["state"]
    interp_b, cgi_b, _, max_disp, _ = biharmonic_frame_spec(
        frame, st0, device, log, tag)
    ro, rd = image_rays(WIDTH, HEIGHT, device)
    # Block-coherent ray order for trace_fast (the loss is order-free).
    ro_b, rd_b, _ = tt.image_rays_to_blocks(ro, rd, HEIGHT, WIDTH)
    hw = (HEIGHT, WIDTH)
    torch.cuda.empty_cache()

    tt.reset_launch_counts()
    steps = {"trace_general": 0, "trace_additive_biharmonic": 0}
    # Each step runs twice: the first call in a process also pays CUDA's
    # lazy loading of the autograd kernels it meets; the second is warm.
    # (a) trace_fast on the brain resection, d loss / d prim_pos.
    for run in ("first", "warm"):
        pos = resection.prim_pos.clone().requires_grad_(True)
        sc = dataclasses.replace(resection, prim_pos=pos)
        fwd_ms, (t, hit) = sync_ms(
            lambda: tt.trace_fast(sc, ro_b, rd_b, params))
        steps["trace_general"] += 1
        loss = torch.sum(torch.where(hit, t, 0.0))
        bwd_ms, _ = sync_ms(loss.backward)
        _check_grad("trace_fast prim_pos", pos.grad)
        log(f"(a) trace_fast brain resection {WIDTH}x{HEIGHT}, {run} call: "
            f"{int(hit.sum())} hits, loss {float(loss.detach()):.4f}, "
            f"|d/dpos| max {float(pos.grad.abs().max()):.6f}; forward "
            f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms {tag}")
        del t, hit, loss, pos, sc
    torch.cuda.empty_cache()

    # (b) one differentiable coupled frame from the settled brain, dE.
    for run in ("first", "warm"):
        e_scale = torch.tensor(1.0, device=device, requires_grad=True)
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        fwd_ms, (t, hit, st1, _) = sync_ms(lambda: coupled_step_grid_fast(
            scene, gf, interp_b, cgi_b, st0, frame["f_ext"], ro, rd,
            E_scale=e_scale, params=params, image_hw=hw, differentiable=True,
            max_disp=max_disp, solve_stats=stats))
        steps["trace_additive_biharmonic"] += 1
        loss = torch.sum(torch.where(hit, t, 0.0))
        bwd_ms, _ = sync_ms(loss.backward)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        _check_grad("coupled frame E_scale", e_scale.grad)
        with torch.no_grad():
            w1 = disp_weights_centers(interp_b, st1.q.reshape(-1, 3)[cgi_b])
            bound = float(max_disp_bound(interp_b, w1,
                                         st1.q.reshape(-1, 3)[frame["n2g"]]))
        if bound > max_disp:
            raise AssertionError(f"max_disp_bound {bound} > max_disp "
                                 f"{max_disp}")
        log(f"(b) differentiable coupled frame {WIDTH}x{HEIGHT}, {run} "
            f"call: {int(hit.sum())} hits, loss {float(loss.detach()):.4f}, "
            f"dloss/dE {float(e_scale.grad):.6f}; CG iterations forward "
            f"{stats['forward_iters']}, adjoint {stats['adjoint_iters']}; "
            f"max_disp_bound {bound:.6f} <= max_disp {max_disp}; forward "
            f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, peak memory "
            f"{peak_gb:.3f} GiB {tag}")
        del t, hit, loss, st1
    launches = dict(tt.LAUNCHES)
    log(f"launches in the training path: {launches}, steps {steps}")
    for name in ("trace_general", "trace_additive_biharmonic"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the training "
                                 "path")
    torch.cuda.empty_cache()

    # (c) the E-gradient against central differences at a small size.
    small = fem_setup(scene, FD_CELLSIZE, device, FD_CENTERS, "biharmonic",
                      FD_FORCE)
    ro_s, rd_s = image_rays(*FD_RAYS, device)

    def fd_frame(e):
        return coupled_step_grid_fast(
            scene, small["gf"], small["interp"], small["cgi"],
            small["gf"].rest_state(), small["f_ext"], ro_s, rd_s,
            E_scale=e, params=params, differentiable=True)

    e_scale = torch.tensor(1.0, device=device, requires_grad=True)
    t, hit0, _, _ = fd_frame(e_scale)
    torch.sum(torch.where(hit0, t, 0.0)).backward()
    g = float(e_scale.grad)

    def fd_loss(e):
        with torch.no_grad():
            t, _, _, _ = fd_frame(torch.tensor(e, device=device))
        return float(torch.sum(torch.where(hit0, t, 0.0)))

    l0 = fd_loss(1.0)
    sigma = abs(fd_loss(1.0 + 1e-6) - l0)
    eps = min(max(100.0 * sigma / max(abs(g), 1e-9), 0.05), 0.3)
    fd = (fd_loss(1.0 + eps) - fd_loss(1.0 - eps)) / (2.0 * eps)
    rel = abs(g - fd) / max(abs(fd), 1e-12)
    log(f"(c) E-gradient f32 on the card, brain cellsize {FD_CELLSIZE}, "
        f"{FD_CENTERS} centers, {FD_RAYS[0]}x{FD_RAYS[1]} rays, "
        f"{int(hit0.sum())} hits: autograd {g:.6f}, FD {fd:.6f} (eps {eps:.3g}"
        f", noise floor {sigma:.3g} on loss {l0:.4f}), relative error "
        f"{rel:.6f} {tag}")
    if not rel < FD_MAX_REL:
        raise AssertionError(f"E-gradient relative error {rel} >= "
                             f"{FD_MAX_REL}")
    return launches, steps


def device_kernels(fn):
    """Device kernels launched by one call of `fn`, counted by
    torch.profiler; None where the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def simulation_frame_phase(root, device, params, tag, log):
    """Phase 6: the simulation frame, counted; returns (launches, steps
    driven per kernel)."""
    import numpy as np
    import torch

    from fembrain_tpu_torch.blob.examples import union_chain_over_100_ops
    from fembrain_tpu_torch.fem.deformable import (
        Deformable, couple_surface_displacements,
    )
    from fembrain_tpu_torch.fem import integrator as integ
    from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
    from fembrain_tpu_torch.mesh.polygonize import (
        check_capacity, default_caps, extract_tet_mesh, grid_for_scene,
        polygonize,
    )
    from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component
    from fembrain_tpu_torch.ops.field import UNROLL_LIMIT, field, field_via
    from fembrain_tpu_torch.render import tile_trace as tt
    from fembrain_tpu_torch.render.camera import Camera
    from fembrain_tpu_torch.render.deformed import (
        build_disp_interp, coupled_step_fast, coupling_telemetry,
        disp_weights, max_disp_bound, render_deformed,
        trace_deformed_rbf_fast,
    )
    from fembrain_tpu_torch.render.sphere_trace import render_image, shade

    tt.reset_launch_counts()
    steps = {"trace_additive_rest": 0, "trace_additive_wendland": 0,
             "trace_additive_biharmonic": 0}
    t_phase = time.perf_counter()

    # 6.1 surface, tet mesh, FEM mesh, Deformable.
    scene = load_scene(root, device)
    grid = grid_for_scene(scene, cellsize=CELLSIZE)
    vcap, tcap = default_caps(grid)
    poly_first_ms, _ = sync_ms(lambda: polygonize(scene, grid, vcap, tcap))
    poly_ms, surface = sync_ms(lambda: polygonize(scene, grid, vcap, tcap))
    check_capacity(surface)
    nv, nt = int(surface.n_verts), int(surface.n_tris)
    tris = surface.tris[:nt].long()
    if nv <= 0 or nt <= 0 or int(tris.max()) >= nv or int(tris.min()) < 0:
        raise AssertionError(f"surface: {nv} verts, {nt} tris, index range "
                             f"[{int(tris.min())}, {int(tris.max())}]")
    edges = torch.cat([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    edges = torch.sort(edges, 1).values
    uniq, per_edge = torch.unique(edges, dim=0, return_counts=True)
    # Closed: every edge has two triangles, but for the rim where the
    # grid's box (the scene's heuristic bounding box plus its margin)
    # cuts the surface off; there an edge has one and lies on the box.
    rim = uniq[per_edge == 1]
    lo = torch.tensor(grid.lo, device=device)
    hi = lo + (torch.tensor(grid.dims, device=device) - 1) * grid.cellsize
    rim_v = surface.verts[rim.reshape(-1)]
    on_box = (torch.minimum((rim_v - lo).abs(), (rim_v - hi).abs())
              .amin(1) < 1e-5)
    n_closed = int((per_edge == 2).sum())
    if (n_closed <= 0 or bool((per_edge > 2).any())
            or not bool(on_box.all())):
        raise AssertionError(
            f"surface is not closed: {n_closed} edges with two triangles, "
            f"{int((per_edge > 2).sum())} with more, {len(rim)} with one of "
            f"which {int((~on_box).sum()) // 2} off the grid's box")
    for label, a in (("verts", surface.verts[:nv]),
                     ("normals", surface.normals[:nv]),
                     ("colors", surface.colors[:nv])):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"surface {label} not finite")
    tet_ms, tm = sync_ms(lambda: extract_tet_mesh(
        scene, grid, ncap=grid.n_vertices, tetcap=grid.n_cells * 6))
    check_capacity(tm)
    nodes = tm.nodes[: tm.n_nodes].cpu().numpy()
    tets = tm.tets[: tm.n_tets].cpu().numpy()
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    t0 = time.perf_counter()
    fem = build_fem_mesh(nodes, tets, fixed=fixed, device=device)
    body = Deformable(fem, gravity=SIM_GRAVITY)
    build_s = time.perf_counter() - t0
    log(f"6.1 surface: {nv} verts, {nt} tris (caps {vcap}, {tcap}), {n_closed} "
        f"closed edges, {len(rim)} rim edges on the grid's box; "
        f"polygonize first call {poly_first_ms:.3f} ms, warm {poly_ms:.3f} "
        f"ms; tet mesh {tm.n_nodes} nodes, {tm.n_tets} tets in {tet_ms:.3f} "
        f"ms; FEM mesh ({len(fixed)} fixed nodes, ke "
        f"{fem.ke.numel() * 4 / 1e6:.1f} MB) + adjacency {build_s:.3f} s "
        f"{tag}")

    # 6.2 steps under gravity, then under a haptic push at the top vertex.
    def timed_steps(n, f_haptic, label):
        rows = []
        for _ in range(n):
            ms, _ = sync_ms(lambda: body.timestep(f_haptic))
            rows.append((ms, body.stats()["cg_iters"]))
        log(f"6.2 {label}: ms per step {[round(m, 1) for m, _ in rows]}, CG "
            f"iterations {[i for _, i in rows]} {tag}")
        return rows

    rows = timed_steps(SIM_GRAVITY_STEPS, None, "gravity steps")
    top = int(torch.argmax(surface.verts[:nv, 1]))
    push_node = int(tm.grid_to_node[surface.edge_nodes[top, 0].long()])
    f_push = body.haptic_forces(np.array([push_node]), np.array([SIM_PUSH]))
    q_before = body.state.q.clone()
    rows += timed_steps(SIM_PUSH_STEPS, f_push, "haptic push steps "
                        f"(node {push_node}, {int((f_push != 0).any(1).sum())}"
                        " nodes in its rings)")
    n_kernels = device_kernels(lambda: body.timestep(f_push))
    it_last = body.stats()["cg_iters"]
    q = body.state.q
    fixed_t = fem.fixed
    if not bool(torch.isfinite(q).all()) or float(q.abs().max()) == 0.0:
        raise AssertionError("FEM state not finite and non-zero")
    if float(q[fixed_t].abs().max()) != 0.0:
        raise AssertionError("fixed nodes moved")
    if float((q - q_before)[push_node].abs().max()) == 0.0:
        raise AssertionError("the haptic push moved nothing")
    per_iter = (f"{n_kernels / max(it_last, 1):.1f} a CG iteration"
                if n_kernels else "")
    log(f"6.2 device kernel launches in one step: "
        f"{n_kernels if n_kernels else 'not measured'} for {it_last} CG "
        f"iterations {per_iter}; max |q| {float(q.abs().max()):.6f}, min q_y "
        f"{float(q[:, 1].min()):.6f}, {body.stats()['n_collided']} collided "
        f"{tag}")

    # 6.3 the surface moves with the FEM displacements.
    couple_ms, disp = sync_ms(lambda: couple_surface_displacements(
        surface.edge_nodes, surface.edge_t, tm.grid_to_node, q))
    dn = torch.linalg.norm(disp[:nv], dim=-1)
    qn = torch.linalg.norm(q, dim=-1)
    ends = tm.grid_to_node[surface.edge_nodes[:nv].long()].long()   # [nv, 2]
    if int(ends.min()) < 0:
        raise AssertionError("a surface vertex lies on an edge off the mesh")
    if not bool(torch.isfinite(disp).all()):
        raise AssertionError("surface displacement not finite")
    if bool((dn > qn[ends].amax(1) + 1e-6).any()) or not (
            0.5 * float(qn[ends].mean()) < float(dn.mean())
            <= float(qn[ends].amax(1).mean()) + 1e-6):
        raise AssertionError("surface displacement does not follow q")
    log(f"6.3 surface coupling {couple_ms:.3f} ms: |disp| mean "
        f"{float(dn.mean()):.6f} max {float(dn.max()):.6f} (|q| at the edge "
        f"ends mean {float(qn[ends].mean()):.6f}) {tag}")

    # 6.4 coupled frames on the unstructured solver (K2), then one
    # differentiable frame (K4) with its E-gradient.
    interp = build_disp_interp(nodes, n_centers=N_CENTERS, fixed=fixed,
                               kernel="wendland", sigma_fill=SIGMA_FILL,
                               device=device)
    f_ext = torch.zeros_like(fem.rest)
    f_ext[:, 1] = SIM_GRAVITY
    f_ext = f_ext + torch.as_tensor(f_push, dtype=f_ext.dtype, device=device)
    ro, rd = image_rays(WIDTH, HEIGHT, device)
    hw = (HEIGHT, WIDTH)
    st0 = body.state
    state, cg_iters = st0, []

    def coupled():
        nonlocal state
        t, hit, state, it = coupled_step_fast(
            scene, fem, interp, state, f_ext, ro, rd, params=params,
            image_hw=hw, cg_tol=CG_TOL, k_refresh=K_REFRESH)
        cg_iters.append(it)
        steps["trace_additive_wendland"] += 1
        return t, hit

    frame_ms, (t_def, hit_def) = sync_ms(coupled, reps=SIM_FRAMES)
    fem_state = st0

    def fem_only():
        nonlocal fem_state
        fem_state, _ = integ.timestep(fem, fem_state, f_ext, cg_tol=CG_TOL)
        return fem_state

    fem_ms, st1 = sync_ms(fem_only, reps=SIM_FRAMES)
    rbf_ms, w1 = sync_ms(lambda: disp_weights(interp, st1.q), reps=SIM_FRAMES)

    def trace_only():
        steps["trace_additive_wendland"] += 1
        return trace_deformed_rbf_fast(scene, interp, w1, ro, rd, params,
                                       image_hw=hw, need_grads=False,
                                       k_refresh=K_REFRESH)

    trace_ms, _ = sync_ms(trace_only, reps=SIM_FRAMES)
    n_def = int(hit_def.sum())
    if n_def <= 0 or not bool(torch.isfinite(t_def).all()) or (
            t_def.shape != (WIDTH * HEIGHT,)):
        raise AssertionError(f"coupled_step_fast: {n_def} hits, shape "
                             f"{tuple(t_def.shape)}")
    tele = {k: float(v) for k, v in
            coupling_telemetry(interp, w1, st1.q).items()}
    log(f"6.4 coupled_step_fast {WIDTH}x{HEIGHT}: {frame_ms:.3f} ms/frame, "
        f"{1e3 / frame_ms:.3f} fps, {n_def} hits, CG iterations {cg_iters}; "
        f"split fem {fem_ms:.3f} ms, rbf {rbf_ms:.3f} ms, trace "
        f"{trace_ms:.3f} ms; telemetry {tele} {tag}")

    interp_b = build_disp_interp(nodes, fixed=fixed, device=device)
    with torch.no_grad():
        bound_b = float(max_disp_bound(interp_b, disp_weights(interp_b, st1.q),
                                       st1.q))
    max_disp = MAX_DISP
    while 1.5 * bound_b > max_disp:
        max_disp += 0.25
    e_scale = torch.tensor(1.0, device=device, requires_grad=True)
    stats = {}
    fwd_ms, (t_b, hit_b, st_b, it_b) = sync_ms(lambda: coupled_step_fast(
        scene, fem, interp_b, st1, f_ext, ro, rd, E_scale=e_scale,
        params=params, image_hw=hw, differentiable=True, max_disp=max_disp,
        solve_stats=stats))
    steps["trace_additive_biharmonic"] += 1
    loss = torch.sum(torch.where(hit_b, t_b, 0.0))
    bwd_ms, _ = sync_ms(loss.backward)
    _check_grad("coupled_step_fast E_scale", e_scale.grad)
    with torch.no_grad():
        bound_b = float(max_disp_bound(
            interp_b, disp_weights(interp_b, st_b.q), st_b.q))
    if bound_b > max_disp or it_b != -1:
        raise AssertionError(f"max_disp_bound {bound_b} > max_disp "
                             f"{max_disp}, or iterations {it_b} != -1")
    log(f"6.4 differentiable coupled_step_fast {WIDTH}x{HEIGHT} "
        f"({interp_b.centers.shape[0]} biharmonic centers, max_disp "
        f"{max_disp}, max_disp_bound {bound_b:.6f}): {int(hit_b.sum())} hits, "
        f"dloss/dE {float(e_scale.grad):.6f}, CG iterations forward "
        f"{stats['forward_iters']}, adjoint {stats['adjoint_iters']}; "
        f"forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms {tag}")
    del t_b, hit_b, loss, st_b
    torch.cuda.empty_cache()

    # 6.5 shaded images: K1's hits at full size, the dense renderers at
    # the app's default frame.
    def rest_hits():
        steps["trace_additive_rest"] += 1
        return tt.trace_tiles_image(scene, ro, rd, HEIGHT, WIDTH, params)

    k1_ms, (t_rest, hit_rest) = sync_ms(rest_hits)
    shade_ms, rgb = sync_ms(lambda: shade(scene, ro, rd, t_rest, hit_rest))
    n_rest = int(hit_rest.sum())
    if rgb.shape != (WIDTH * HEIGHT, 3) or n_rest <= 0 or not bool(
            torch.isfinite(rgb).all()):
        raise AssertionError("shaded rest frame not finite")
    if bool((rgb[~hit_rest] != 1.0).any()) or float(
            (rgb[hit_rest] - 1.0).abs().max()) == 0.0:
        raise AssertionError("shaded rest frame: misses are not background "
                             "or hits are")
    cam = Camera.orbit(30.0, 20.0, 8.0, device=device)
    sw, sh = SIM_IMAGE
    img_ms, img_rest = sync_ms(lambda: render_image(scene, cam, sw, sh, params))
    def_ms, img_def = sync_ms(lambda: render_deformed(
        scene, grid, tm.grid_to_node, st1.q, cam, sw, sh, params))
    for label, img in (("render_image", img_rest), ("render_deformed",
                                                    img_def)):
        if img.shape != (sh, sw, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: shape {tuple(img.shape)} or "
                                 "non-finite pixels")
    moved = int((torch.abs(img_def - img_rest).amax(-1) > 1e-3).sum())
    if moved == 0:
        raise AssertionError("the deformed image equals the rest image")
    log(f"6.5 shaded rest frame {WIDTH}x{HEIGHT}: trace_tiles_image "
        f"{k1_ms:.3f} ms, shade {shade_ms:.3f} ms for {n_rest} hits; "
        f"{sw}x{sh} dense: render_image {img_ms:.3f} ms, render_deformed "
        f"{def_ms:.3f} ms, {moved} pixels differ {tag}")

    # 6.6 a scene of more than 96 ops: scan fold and the dense tracer.
    deep = union_chain_over_100_ops().pack(device=device)
    if len(deep.schedule) <= UNROLL_LIMIT:
        raise AssertionError("the deep scene fits the unrolled fold")
    gen = torch.Generator(device="cpu").manual_seed(0)
    pts = (torch.rand((65536, 3), generator=gen) * 2.4 - 1.2).to(device)
    fold_ms, f_scan = sync_ms(lambda: field(deep, pts))
    f_unrolled = field_via(deep, pts, "unrolled")
    err = float((f_scan - f_unrolled).abs().max())
    if not bool(torch.isfinite(f_scan).all()) or err > 1e-6 or float(
            f_scan.max()) < 0.5:
        raise AssertionError(f"scan fold: max |scan - unrolled| {err}")
    ro_d, rd_d = image_rays(*SIM_DEEP_RAYS, device, pose=(30.0, 20.0, 5.0))
    before = dict(tt.LAUNCHES)
    deep_ms, (t_d, hit_d) = sync_ms(lambda: tt.trace_fast(deep, ro_d, rd_d,
                                                          params))
    if dict(tt.LAUNCHES) != before:
        raise AssertionError("the deep scene launched a tile kernel")
    if int(hit_d.sum()) <= 0 or not bool(torch.isfinite(t_d).all()):
        raise AssertionError("the deep scene's trace has no hits")
    log(f"6.6 {len(deep.schedule)}-op scene ({deep.fold_registers} fold "
        f"registers): field at 65,536 points {fold_ms:.3f} ms, max |scan - "
        f"unrolled| {err:.3e}; trace_fast {SIM_DEEP_RAYS[0]}x"
        f"{SIM_DEEP_RAYS[1]} (dense tracer) {deep_ms:.3f} ms, "
        f"{int(hit_d.sum())} hits {tag}")

    launches = dict(tt.LAUNCHES)
    log(f"launches in the simulation frame: {launches}, steps {steps}; "
        f"phase total {time.perf_counter() - t_phase:.1f} s")
    for name in steps:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the simulation "
                                 "frame")
    if launches["trace_general"] != 0:
        raise AssertionError("the simulation frame launched the general "
                             "kernel")
    return launches, steps


def launches_per_step(launches, steps):
    """Each kernel's launches over the steps its path drove; raises when a
    path launched its kernel another number of times a step than 1."""
    out = {}
    for name, n_steps in steps.items():
        per = launches[name] / n_steps
        if per != LAUNCHES_PER_STEP:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{n_steps} steps")
        out[name] = int(per)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import fembrain_tpu_torch  # noqa: F401  (sets full-f32 matmuls)
    from fembrain_tpu_torch import native
    from fembrain_tpu_torch.render.sphere_trace import TraceParams

    device = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"

    def log(msg):
        print(msg, flush=True)

    # 1. versions and card
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"card: {card}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = native.build()
    native.load()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    report = lib_path.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")

    params = TraceParams()
    # 3. kernels against their plain versions
    results = kernel_phase(root, device, params, tag, log)
    torch.cuda.empty_cache()
    # 4. the main path, counted
    launches, steps, frame = main_path_phase(root, device, params, tag, log)
    torch.cuda.empty_cache()
    # 5. the training path, counted
    launches_t, steps_t = training_phase(root, device, params, frame, tag,
                                         log)
    torch.cuda.empty_cache()
    # 6. the simulation frame, counted
    launches_s, steps_s = simulation_frame_phase(root, device, params, tag,
                                                 log)
    paths = {"coupled_frame": (launches, steps),
             "training": (launches_t, steps_t),
             "simulation_frame": (launches_s, steps_s)}
    by_path = {name: {} for name, _, _ in KERNELS}
    for path, (counted, driven) in paths.items():
        for name, per in launches_per_step(counted, driven).items():
            by_path[name][path] = counted[name]

    kernels = [
        dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=sum(by_path[name].values()),
             launches_per_step=LAUNCHES_PER_STEP,
             launches_by_path=by_path[name], **results[name])
        for name, source, replaces in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
