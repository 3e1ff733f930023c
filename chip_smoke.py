#!/usr/bin/env python3
"""Drive the PyTorch port's coupled render+deform frame, its training
path, its simulation frame, its app, its surgical interaction and its
multi-device layer once on one CUDA card, through its hand-written
kernels.

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
  7. the app (`fembrain_tpu_torch.app`) on data/models/brain.sim at its
     own cellsize 0.14: build `SimulationApp` (polygonize, tetrahedralize
     and FEM set-up from its profiler), take 5 `timestep`s with a haptic
     push at the top surface node (ms and CG iterations a step), one
     `render_frame(hud=True)` at 400x300 (the dense trilinear tracer) and
     one `refit_rbf`; then its CLI, `main`, under the app's own gravity
     (a copy of brain.sim with GRAVITY=1): 4 frames with checkpoints,
     PNGs and metrics, against 2 frames and 2 more resumed from their
     checkpoint. The app launches none of the tile kernels.
  8. surgical interaction on brain at cellsize 0.14: build the VolMesh
     (`CuttableMesh`, with its invariant suite), sweep a scalpel blade
     through the whole tissue on a mid-cell plane and cut it (the edge x
     swept-quad classification on the card, timed by CUDA events and held
     to the CPU's), check the invariants and that the tissue parted, write
     and read the cut mesh as .veg; rebuild the FEM (anchors per part from
     the host core), step it under gravity and push one part with the
     probe through the gizmo (ring forces from the host core); render 3
     frames of the cut tissue through `coupled_step_fast` (K2), K2 held to
     its plain version; drop a 6-DOF box off-centre onto the other part for
     20 frames, then 5 frames in 3 DOF; blend a POINT onto brain's root in
     a `SketchMachine`, pick it, pack and trace at 1920x1080 (K1 while the
     scene stays additive, K3 otherwise; held to the plain version), undo
     and trace again (the rest hit count), save and read back the action
     script; run the mass-spring dumbbell and 65,536 particles 600 steps
     on the card against the CPU.
  9. the multi-device layer on the one card: the kernels built, the
     single-device port's results first, then D = 1 rank over NCCL and
     D = 2 ranks that both compute on cuda:0 and talk over gloo (each
     collective staged through the host), each rank started as its own
     process: the sharded rest trace of brain (K1) and of the resection
     (K3), twice each, bit for bit the single-device ones; 3 grid-backed
     sharded coupled frames (K2) and 2 node-partitioned ones (K4) from
     rest at the coupled cell's CG tolerance, held to the single-device
     frames by hit agreement, their FEM state within MD_Q_REL and their
     trace stage on the ranks' own state bit for bit the single-device
     one; one differentiable grid frame with the biharmonic interpolant
     (K4) and its E-gradient, the same on every rank and within
     MD_GRAD_REL of the single-device one. Per rank: ms, CG iterations,
     collectives and the bytes staged; launches counted in the ranks.
Phases 4 to 6, 8 and 9 also count the frames and steps they drive, and
each kernel's launches per step come from that, path by path: launches
over steps, held to 1. Then one JSON line with the kernels (`launches`
is the sum over the counted paths, `launches_by_path` the parts), the
card line, and the result line.
It needs a CUDA card and the repo beside it (the package
fembrain_tpu_torch/ and data/models/), and exits non-zero, naming what is
missing, without either.
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
APP_STEPS = 5              # the app's haptic steps
# The interaction path: the scalpel's steps across the tissue and the
# classification's tolerance on t against the CPU; Deformable steps under
# gravity and probe pushes (brain.sim's FORCECOEFF); coupled frames of the
# cut tissue; the rigid box; the mass-spring and particle runs.
CUT_STEPS, CUT_T_TOL = 7, 1e-6
INTERACT_STEPS, INTERACT_FRAMES = 5, 3
PROBE_HALF, PROBE_COEFF, PROBE_DRAG = (0.25, 0.25, 0.25), 5000.0, 0.05
BOX_HALF, BOX_MASS, BOX_DT, BOX_TISSUE_GRAVITY = (0.3, 0.2, 0.25), 20.0, \
    0.01, -9.8
BOX_DROP, BOX_FRAMES_6DOF, BOX_FRAMES_3DOF = 0.1, 20, 5
AUX_STEPS, N_PARTICLES, AUX_RTOL = 600, 65536, 1e-5
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
    from fembrain_tpu_torch.render import sphere_trace as st
    from fembrain_tpu_torch.render import tile_trace as tt
    from fembrain_tpu_torch.render.deformed import (
        coupled_step_grid_fast, disp_weights_centers, trace_deformed_rbf_fast,
    )

    tt.reset_launch_counts()
    bracket0 = dict(st.BRACKET)
    gfm.reset_cg_graph_counts()
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
    cg_iters, cg_graphed = [], []

    def coupled():
        nonlocal state
        stats = {}
        t, hit, state = coupled_step_grid_fast(
            scene, gf, interp, cgi, state, f_ext, ro, rd, params=params,
            image_hw=hw, cg_tol=CG_TOL, k_refresh=K_REFRESH,
            solve_stats=stats,
        )
        cg_iters.append(stats["forward_iters"])
        cg_graphed.append(stats["graphed_iters"])
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
    bracket = {k: st.BRACKET[k] - bracket0[k] for k in bracket0}
    # The rest frame's bracket alone: the kernel held to its plain version
    # on the same card tensors at the main path's margins, then both timed.
    for d in (0.0, MAX_DISP):
        margin = 0.05 + torch.tensor(d, device=device)
        card = st.prim_interval(scene, ro_b, rd_b, margin)
        plain = st._prim_interval_plain(scene, ro_b, rd_b, margin)
        for name, a, b in zip(("t_enter", "t_exit", "alive"), card, plain):
            if not torch.equal(a, b):
                raise AssertionError(f"bracket kernel's {name} differs from "
                                     f"the plain version's at margin "
                                     f"0.05 + {d}")
    bracket_ms = event_ms(lambda: st.prim_interval(scene, ro_b, rd_b),
                          reps=N_FRAMES)
    bracket_plain_ms = event_ms(
        lambda: st._prim_interval_plain(scene, ro_b, rd_b), reps=N_FRAMES)
    # Two sets of N_FRAMES rest frames and N_FRAMES kernel runs of the
    # rest split; N_FRAMES coupled frames and as many trace stages of the
    # coupled split.
    steps = {"trace_additive_rest": 3 * N_FRAMES,
             "trace_additive_wendland": len(cg_iters) + N_FRAMES}

    log(f"launches in the main path: {launches}, steps {steps}")
    share = sum(cg_graphed) / sum(cg_iters)
    log(f"CG graphs in the main path: {dict(gfm.CG_GRAPH)}; graphed share "
        f"of the coupled frames' CG iterations {share:.4f}")
    if share != 1.0:
        raise AssertionError("the coupled frames' CG ran outside its graphs")
    # One bracket a traced frame, each through the kernel.
    n_traces = 3 * N_FRAMES + len(cg_iters) + N_FRAMES
    log(f"brackets in the main path: {bracket}, traces {n_traces}")
    if bracket != {"card": n_traces, "plain": 0}:
        raise AssertionError("the main path bracketed outside the kernel")
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
    log(f"rest bracket {WIDTH}x{HEIGHT}: kernel {bracket_ms:.3f} ms, plain "
        f"{bracket_plain_ms:.3f} ms (CUDA events) {tag}")
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
        fwd_ms, (t, hit, st1) = sync_ms(lambda: coupled_step_grid_fast(
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
    t, hit0, _ = fd_frame(e_scale)
    torch.sum(torch.where(hit0, t, 0.0)).backward()
    g = float(e_scale.grad)

    def fd_loss(e):
        with torch.no_grad():
            t, _, _ = fd_frame(torch.tensor(e, device=device))
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
        stats = {}
        t, hit, state = coupled_step_fast(
            scene, fem, interp, state, f_ext, ro, rd, params=params,
            image_hw=hw, cg_tol=CG_TOL, k_refresh=K_REFRESH,
            solve_stats=stats)
        cg_iters.append(stats["forward_iters"])
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
    fwd_ms, (t_b, hit_b, st_b) = sync_ms(lambda: coupled_step_fast(
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
    if bound_b > max_disp:
        raise AssertionError(f"max_disp_bound {bound_b} > max_disp "
                             f"{max_disp}")
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


def app_phase(root, device, tag, log):
    """Phase 7: the app and its CLI on brain.sim; raises unless the
    state stays finite and moves under the push, the frame differs from
    the rest image, the refit RBF is finite, the CLI writes its PNGs,
    metrics and checkpoints, a resumed run ends where the unbroken one
    does, and no tile kernel was launched."""
    import json as json_
    import tempfile

    import numpy as np
    import torch

    from fembrain_tpu_torch import app as sim_app
    from fembrain_tpu_torch.fem.integrator import FemState
    from fembrain_tpu_torch.render import tile_trace as tt
    from fembrain_tpu_torch.render.sphere_trace import render_image
    from fembrain_tpu_torch.utils.checkpoint import load_pytree
    from fembrain_tpu_torch.utils.config import SimConfig
    from fembrain_tpu_torch.utils.profiler import the_profiler

    sim = root / "data" / "models" / "brain.sim"
    before = dict(tt.LAUNCHES)
    t_phase = time.perf_counter()
    prof = the_profiler()
    prof.reset()
    t0 = time.perf_counter()
    app = sim_app.SimulationApp(sim, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = prof.stats()
    nv = int(app.surface.n_verts)
    log(f"7.1 SimulationApp({sim.name}) cellsize {app.cfg.cellsize}: "
        f"{nv} verts, {int(app.surface.n_tris)} tris, {app.fem.n_nodes} "
        f"nodes, {app.fem.n_tets} tets; set-up {build_s:.3f} s: polygonize "
        f"{st['polygonize']['avg_ms']:.3f} ms, tetrahedralize "
        f"{st['tetrahedralize']['avg_ms']:.3f} ms, FEM set-up "
        f"{st['fem_setup']['avg_ms']:.3f} ms {tag}")

    # 7.2 haptic steps at the top surface node, FORCECOEFF downwards.
    top = int(torch.argmax(app.surface.verts[:nv, 1]))
    node = int(app._grid_to_node[app.surface.edge_nodes[top, 0].long()])
    push = (np.array([node]), np.array([[0.0, -app.cfg.force_coeff, 0.0]]))
    rows = []
    for _ in range(APP_STEPS):
        ms, disp = sync_ms(lambda: app.timestep(haptic=push))
        rows.append((ms, app.metrics.last.cg_iters))
    q = app.deformable.state.q
    if not bool(torch.isfinite(q).all()) or float(q[node, 1]) >= 0.0:
        raise AssertionError(f"app state not finite or not pushed down "
                             f"(q_y at node {node}: {float(q[node, 1])})")
    log(f"7.2 app.timestep with a push of {push[1][0].tolist()} at node "
        f"{node}: ms per step {[round(m, 3) for m, _ in rows]}, CG "
        f"iterations {[i for _, i in rows]}; max |q| "
        f"{float(q.abs().max()):.6f} {tag}")

    # 7.3 one frame with the HUD, beside the rest image; one RBF refit.
    frame_ms, img = sync_ms(lambda: app.render_frame(hud=True))
    sw, sh = SIM_IMAGE
    rest = np.clip(render_image(app.scene, app.camera, sw, sh).cpu().numpy(),
                   0, 1)
    moved = int((np.abs(img - rest).max(-1) > 1e-3).sum())
    if img.shape != (sh, sw, 3) or not np.isfinite(img).all() or (
            img.min() >= 1.0 or moved == 0):
        raise AssertionError(f"render_frame: shape {img.shape}, "
                             f"{moved} pixels differ from the rest image")
    rbf_ms, rbf = sync_ms(app.refit_rbf)
    d = app.deformed_vertices(disp)[:nv].cpu().numpy()
    f_on = rbf.evaluate(d)
    if rbf.centers.shape[0] == 0 or not np.isfinite(f_on).all():
        raise AssertionError("refit RBF: no centers or non-finite values")
    # Not held to the surface: brain.sim anchors nothing, so the push
    # moves the whole tissue, further than the field-space pull-back
    # follows, in the reference as here (ROADMAP.md, queue 3).
    on = float(np.abs(f_on).mean())
    log(f"7.3 render_frame(hud=True) {sw}x{sh} (render_deformed) "
        f"{frame_ms:.3f} ms, {moved} pixels differ from the rest image; "
        f"refit_rbf {rbf_ms:.3f} ms, {rbf.centers.shape[0]} centers, mean "
        f"|f| on the deformed surface {on:.6f} {tag}")
    app.close()

    # 7.4 the CLI under the app's gravity: unbroken against resumed.
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = SimConfig.load(sim)
        cfg = dataclasses.replace(
            cfg, gravity=True, relative_path=False,
            input_file=str(cfg.resolve_input(sim).resolve()))
        cfg.save(tmp / "falling.sim")
        base = ["--file", str(tmp / "falling.sim"), "--device", str(device),
                "--checkpoint-every", "2"]
        t0 = time.perf_counter()
        sim_app.main(base + ["--frames", "4", "--render-every", "2",
                             "--hud", "--out", str(tmp / "png"),
                             "--metrics", str(tmp / "m.jsonl"),
                             "--checkpoint", str(tmp / "a.npz")])
        cli_s = time.perf_counter() - t0
        sim_app.main(base + ["--frames", "2", "--checkpoint",
                             str(tmp / "b.npz")])
        t0 = time.perf_counter()
        sim_app.main(base + ["--frames", "2", "--resume", "--checkpoint",
                             str(tmp / "b.npz")])
        resume_s = time.perf_counter() - t0
        like = FemState(*(torch.zeros(1, device=device) for _ in range(3)))
        a = load_pytree(tmp / "a.npz", like)
        b = load_pytree(tmp / "b.npz", like)
        diff = max(float((x - y).abs().max())
                   for x, y in ((a.q, b.q), (a.qvel, b.qvel), (a.dv, b.dv)))
        scale = float(a.q.abs().max())
        pngs = sorted(p.name for p in (tmp / "png").glob("*.png"))
        recs = [json_.loads(line) for line in
                (tmp / "m.jsonl").read_text().splitlines()]
        if diff > 1e-5 * scale or scale == 0.0:
            raise AssertionError(f"resumed state differs from the unbroken "
                                 f"run by {diff} (max |q| {scale})")
        if pngs != ["frame_0000.png", "frame_0002.png"] or len(recs) != 4:
            raise AssertionError(f"CLI wrote {pngs} and {len(recs)} records")
    log(f"7.4 CLI under gravity {sim_app.APP_GRAVITY} a node: 4 frames in "
        f"{cli_s:.3f} s (set-up, 2 PNGs at {sw}x{sh}), CG iterations "
        f"{[r['cg_iters'] for r in recs]}, max |q| after 4 frames "
        f"{scale:.6f}; resumed 2 frames in {resume_s:.3f} s, |unbroken - "
        f"resumed| max {diff:.3e} {tag}")
    if dict(tt.LAUNCHES) != before:
        raise AssertionError("the app launched a tile kernel")
    log(f"app phase total {time.perf_counter() - t_phase:.1f} s")


class _ProbeListener:
    """Gizmo listener wiring the probe to the deformable: each drag moves
    the probe, turns its contacts into ring forces (the host core) through
    `Deformable.probe_forces` and takes one FEM step (the reference's
    AvatarProbe::onTranslate role)."""

    def __init__(self, probe, body):
        self.probe, self.body = probe, body
        self.rows = []

    def on_translate(self, delta, pos):
        stats = {}
        f = self.body.probe_forces(self.probe, pos, stats)
        ms, _ = sync_ms(lambda: self.body.timestep(f))
        self.rows.append((ms, self.body.stats()["cg_iters"],
                          stats["contacts"]))

    def on_rotate(self, quat):
        pass

    def on_scale(self, scale):
        pass


def uncounted(fn):
    """fn() with the kernels' launch counters put back afterwards: the
    launches that hold a kernel against its plain version are not the
    path's."""
    from fembrain_tpu_torch.render import tile_trace as tt

    before = dict(tt.LAUNCHES)
    out = fn()
    tt.LAUNCHES.update(before)
    return out


def interaction_phase(root, device, params, tag, log):
    """Phase 8: surgical interaction on brain at cellsize 0.14, counted;
    returns (launches, steps driven per kernel)."""
    import tempfile

    import numpy as np
    import torch

    from fembrain_tpu_torch import femcore
    from fembrain_tpu_torch.blob.reader import load_blob
    from fembrain_tpu_torch.blob.sketch import (
        SketchAddOp, SketchAddPrim, SketchMachine,
    )
    from fembrain_tpu_torch.blob.types import OpType, PrimType
    from fembrain_tpu_torch.fem import cutting, rigid
    from fembrain_tpu_torch.fem import integrator as integ
    from fembrain_tpu_torch.fem.avatars import AvatarProbe, AvatarScalpel
    from fembrain_tpu_torch.fem.deformable import Deformable
    from fembrain_tpu_torch.fem.integrator import FemState
    from fembrain_tpu_torch.fem.mass_spring import (
        make_dumbbell, step_mass_spring,
    )
    from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
    from fembrain_tpu_torch.graphics.gizmo import GizmoManager, GizmoType
    from fembrain_tpu_torch.mesh.io import read_veg, write_veg
    from fembrain_tpu_torch.mesh.polygonize import (
        extract_tet_mesh, grid_for_scene,
    )
    from fembrain_tpu_torch.mesh.quality import tet_quality
    from fembrain_tpu_torch.mesh.samples import bottom_nodes_per_component
    from fembrain_tpu_torch.ops.particles import (
        init_particles, step_particles,
    )
    from fembrain_tpu_torch.render import tile_trace as tt
    from fembrain_tpu_torch.render.deformed import (
        build_disp_interp, coupled_step_fast, disp_weights,
        trace_deformed_rbf_fast, wendland_spec,
    )
    from fembrain_tpu_torch.utils.ini import SettingsScript
    from fembrain_tpu_torch.utils.profiler import the_profiler

    tt.reset_launch_counts()
    steps = {"trace_additive_rest": 0, "trace_additive_wendland": 0}
    t_phase = time.perf_counter()
    host = {}

    # 8.1 the cut: VolMesh, a scalpel sweep through the whole tissue on a
    # mid-cell plane, the classification on the card held to the CPU.
    t0 = time.perf_counter()
    scene = load_scene(root, device)
    grid = grid_for_scene(scene, cellsize=CELLSIZE)
    tm = extract_tet_mesh(scene, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    nodes = tm.nodes[: tm.n_nodes].cpu().numpy().astype(np.float64)
    tets = tm.tets[: tm.n_tets].cpu().numpy()
    host["tet mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tissue = cutting.CuttableMesh(nodes, tets, device=device)
    host["VolMesh + invariants"] = time.perf_counter() - t0
    mesh = tissue.mesh
    n_parts_before = femcore.components(tets, len(nodes))[0]
    xmid = 0.5 * (nodes[:, 0].min() + nodes[:, 0].max())
    x0 = grid.lo[0] + (round((xmid - grid.lo[0]) / grid.cellsize) + 0.5) * (
        grid.cellsize)
    lo, hi = nodes.min(0) - 0.5, nodes.max(0) + 0.5
    scalpel = AvatarScalpel(blade_a=np.array([x0, hi[1], 0.0]),
                            blade_b=np.array([x0, lo[1], 0.0]))
    scalpel.grip()
    for z in np.linspace(lo[2] - 0.13, hi[2] + 0.11, CUT_STEPS + 1):
        scalpel.move_to([0.0, 0.0, z])
    quads = np.stack(scalpel.sweep_quads)
    p0 = np.stack([mesh.nodes[e.from_].pos for e in mesh.edges])
    p1 = np.stack([mesh.nodes[e.to].pos for e in mesh.edges])
    dev_in = [torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in (p0, p1, quads)]
    classify_ms = event_ms(lambda: cutting.edge_quad_hits(*dev_in), 10)
    call_ms, (hit, t_hit) = sync_ms(lambda: cutting.batched_edge_quad_hits(
        p0, p1, quads, device=device))
    hit_cpu, t_cpu = cutting.batched_edge_quad_hits(p0, p1, quads,
                                                    device="cpu")
    t_err = float(np.abs(t_hit[hit] - t_cpu[hit_cpu]).max()) if hit.any() \
        else 0.0
    if not np.array_equal(hit, hit_cpu) or t_err > CUT_T_TOL:
        raise AssertionError(f"cut classification on the card differs from "
                             f"the CPU: {int((hit != hit_cpu).sum())} hits, "
                             f"max |dt| {t_err}")
    n_edges = mesh.count_edges()
    prof = the_profiler()
    prof.reset()
    t0 = time.perf_counter()
    res = scalpel.release(tissue)
    host["cut"] = time.perf_counter() - t0
    stages = {k: round(v["avg_ms"] * v["count"] / 1e3, 3)
              for k, v in prof.stats().items() if k.startswith("cut_")}
    errs = mesh.check_invariants()
    pos, cells = mesh.restpositions(), mesh.cells_array()
    n_parts, labels = femcore.components(cells, len(pos))
    quality = tet_quality(pos, cells)
    if errs or res.n_cut_cells == 0 or n_parts <= n_parts_before:
        raise AssertionError(f"cut: {res}, {n_parts} parts (before "
                             f"{n_parts_before}), invariants {errs[:3]}")
    if quality["inverted"] or quality["degenerate"]:
        raise AssertionError(f"cut mesh quality {quality}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cut.veg"
        t0 = time.perf_counter()
        write_veg(path, pos, cells)
        back_nodes, back_tets, _ = read_veg(path)
        host[".veg write + read"] = time.perf_counter() - t0
    if not np.array_equal(back_tets, cells) or np.abs(
            back_nodes - pos).max() > 1e-5 * np.abs(pos).max():
        raise AssertionError("the cut mesh does not read back from .veg")
    log(f"8.1 cut: {len(tets)} tets, {n_edges} edges; scalpel {len(quads)} "
        f"quads at x {x0:.6f}: "
        f"{res.n_cut_edges} cut edges, {res.n_cut_cells} cut cells, "
        f"{res.n_new_cells} new cells -> {len(pos)} nodes, {len(cells)} tets, "
        f"{n_parts} parts (before {n_parts_before}); invariants "
        f"{len(errs)} violations; quality {quality}; classification on the "
        f"card {classify_ms:.3f} ms (CUDA events, {len(p0)} edges x "
        f"{len(quads)} quads), {call_ms:.3f} ms with its copies, hits equal "
        f"to the CPU's, max |dt| {t_err:.3e}; host s {host}, cut stages s "
        f"{stages} {tag}")

    # 8.2 rebuild the FEM, settle under gravity, push one part's top at
    # the cut face with the probe through the gizmo.
    t0 = time.perf_counter()
    fixed = bottom_nodes_per_component(pos, cells, frac=0.25)
    fem = build_fem_mesh(pos, cells, fixed=fixed, device=device)
    body = Deformable(fem, gravity=SIM_GRAVITY)
    torch.cuda.synchronize()
    host["FEM rebuild"] = time.perf_counter() - t0
    node_part = np.full(len(pos), -1)
    node_part[cells.reshape(-1)] = np.repeat(labels, 4)
    grav = []
    for _ in range(INTERACT_STEPS):
        ms, _ = sync_ms(lambda: body.timestep())
        grav.append((round(ms, 1), body.stats()["cg_iters"]))
    side = node_part[np.argmax(np.where(pos[:, 0] > x0, pos[:, 1], -np.inf))]
    q_now = body.state.q.cpu().numpy()
    cur = pos + q_now
    he = np.array(PROBE_HALF)
    near = (node_part == side) & (pos[:, 0] > x0) & (
        pos[:, 0] < x0 + 2 * he[0])
    top = int(np.argmax(np.where(near, cur[:, 1], -np.inf)))
    probe = AvatarProbe(half_extents=he, force_coeff=PROBE_COEFF, pos=np.array(
        [x0 + 1e-3 + he[0], cur[top, 1] + he[1] + 0.02, cur[top, 2]]))
    gizmo = GizmoManager()
    gizmo.gizmo_type = GizmoType.AVATAR
    gizmo.pos = probe.pos.copy()
    listener = _ProbeListener(probe, body)
    gizmo.register(listener)
    for _ in range(INTERACT_STEPS):
        gizmo.apply(np.array([0.0, -PROBE_DRAG, 0.0]))
    q = body.state.q.cpu().numpy()
    per_part = {int(c): float(np.abs(q[node_part == c]).max())
                for c in range(n_parts)}
    other = max(v for c, v in per_part.items() if c != side)
    if not np.isfinite(q).all() or per_part[side] <= other:
        raise AssertionError(f"pushed part {side} max |q| {per_part[side]} "
                             f"against the others' {other}")
    if sum(1 for r in listener.rows if r[2]) == 0:
        raise AssertionError("the probe touched nothing")
    pushes = [(round(m, 1), i, c) for m, i, c in listener.rows]
    log(f"8.2 FEM rebuilt ({fem.n_nodes} nodes, {fem.n_tets} tets, "
        f"{len(fixed)} anchors over {n_parts} components) in "
        f"{host['FEM rebuild']:.3f} s; gravity steps (ms, CG iterations) "
        f"{grav}; probe push on part {side} through the gizmo, (ms, CG "
        f"iterations, contacts) {pushes}, contact face {probe.contact_face}; max |q| per part {per_part} "
        f"{tag}")

    # 8.3 the cut tissue rendered through coupled_step_fast (K2).
    t0 = time.perf_counter()
    interp = build_disp_interp(pos, n_centers=N_CENTERS, fixed=fixed,
                               kernel="wendland", sigma_fill=SIGMA_FILL,
                               device=device)
    host["interpolant"] = time.perf_counter() - t0
    f_ext = torch.zeros_like(fem.rest)
    f_ext[:, 1] = SIM_GRAVITY
    ro, rd = image_rays(WIDTH, HEIGHT, device)
    hw = (HEIGHT, WIDTH)
    state, cg_iters, frames = body.state, [], []
    for _ in range(INTERACT_FRAMES):
        stats = {}
        ms, (t_def, hit_def, state) = sync_ms(lambda: coupled_step_fast(
            scene, fem, interp, state, f_ext, ro, rd, params=params,
            image_hw=hw, cg_tol=CG_TOL, k_refresh=K_REFRESH,
            solve_stats=stats))
        steps["trace_additive_wendland"] += 1
        frames.append(round(ms, 3))
        cg_iters.append(stats["forward_iters"])
    fem_ms, _ = sync_ms(lambda: integ.timestep(fem, state, f_ext,
                                              cg_tol=CG_TOL))
    rbf_ms, w = sync_ms(lambda: disp_weights(interp, state.q))

    def trace_only():
        steps["trace_additive_wendland"] += 1
        return trace_deformed_rbf_fast(scene, interp, w, ro, rd, params,
                                       image_hw=hw, need_grads=False,
                                       k_refresh=K_REFRESH)

    trace_ms, _ = sync_ms(trace_only)
    spec = wendland_spec(interp, w, k_refresh=K_REFRESH)
    ro_b, rd_b, _ = tt.image_rays_to_blocks(ro, rd, HEIGHT, WIDTH)
    inp = tt.prepare_tiles(scene, ro_b, rd_b, params, tt.TILE, spec)
    k2_ms = uncounted(lambda: event_ms(lambda: tt.trace_additive_cuda(inp),
                                       5))
    uncounted(lambda: compare(tt.trace_additive_cuda,
                              tt.trace_tiles_wendland_plain, inp,
                              "trace_additive_wendland", log,
                              f"8.3 K2 on the cut tissue {WIDTH}x{HEIGHT}"))
    del inp
    n_def = int(hit_def.sum())
    if n_def <= 0 or not bool(torch.isfinite(t_def).all()):
        raise AssertionError(f"cut tissue frame: {n_def} hits")
    log(f"8.3 coupled_step_fast on the cut tissue {WIDTH}x{HEIGHT}: ms per "
        f"frame {frames}, CG iterations {cg_iters}, {n_def} hits; split fem "
        f"{fem_ms:.3f} ms, rbf {rbf_ms:.3f} ms, trace {trace_ms:.3f} ms, K2 "
        f"alone {k2_ms:.3f} ms; "
        f"the implicit field is brain's own, so only the displacement shows "
        f"the cut {tag}")
    torch.cuda.empty_cache()

    # 8.4 a rigid box dropped off-centre onto the other part of the cut
    # tissue: 6 DOF, then 3 DOF, on the card.
    other_part = next(c for c in range(n_parts) if c != side)
    mine = node_part == other_part
    centre = pos[mine].mean(0)
    top_y = pos[mine, 1].max()
    bhe = np.array(BOX_HALF)
    box = rigid.RigidBody6State.at_rest(
        (centre[0] + 0.2, top_y + bhe[1] + BOX_DROP, centre[2] + 0.15),
        quat=(np.cos(0.2), 0.0, 0.0, np.sin(0.2)), device=device)
    ground = float(lo[1])
    # The tissue starts at rest under the box's world's gravity.
    tissue_state, touched, box_rows = FemState.rest(fem), 0, []
    for _ in range(BOX_FRAMES_6DOF):
        inside = rigid.box_tissue_forces_6dof(
            box, bhe, fem.rest + tissue_state.q)[0].abs().sum(1) > 0
        touched += int(inside.any())
        ms, (box, tissue_state, it) = sync_ms(
            lambda: rigid.coupled_box_tissue_step_6dof(
                box, bhe, BOX_MASS, fem, tissue_state, h=BOX_DT,
                ground_y=ground, tissue_gravity=BOX_TISSUE_GRAVITY))
        box_rows.append((round(ms, 1), it))
    box3 = rigid.RigidBoxState(pos=box.pos, vel=box.vel)
    rows3 = []
    for _ in range(BOX_FRAMES_3DOF):
        ms, (box3, tissue_state, it) = sync_ms(
            lambda: rigid.coupled_box_tissue_step(
                box3, bhe, BOX_MASS, fem, tissue_state, h=BOX_DT,
                ground_y=ground, tissue_gravity=BOX_TISSUE_GRAVITY))
        rows3.append((round(ms, 1), it))
    vals = torch.cat([box.pos, box.vel, box.quat, box.omega, box3.pos,
                      box3.vel, tissue_state.q.reshape(-1)])
    if not bool(torch.isfinite(vals).all()) or touched == 0:
        raise AssertionError(f"box: finite {bool(torch.isfinite(vals).all())}"
                             f", frames in contact {touched}")
    log(f"8.4 box on part {other_part} (mass {BOX_MASS}, h {BOX_DT}): 6 DOF "
        f"(ms, CG iterations) {box_rows}, {touched} frames in contact; "
        f"height {float(box.pos[1]):.6f}, speed "
        f"{float(torch.linalg.norm(box.vel)):.6f}, |omega| "
        f"{float(torch.linalg.norm(box.omega)):.6f}; then 3 DOF {rows3}, "
        f"height {float(box3.pos[1]):.6f}, speed "
        f"{float(torch.linalg.norm(box3.vel)):.6f}; tissue max |q| "
        f"{float(tissue_state.q.abs().max()):.6f} {tag}")

    # 8.5 sketching: a POINT blended onto brain's root, picked, packed,
    # traced (K1 if the scene stays additive, else K3), then undone.
    sdef = load_blob(root / "data" / "models" / "blobtree" / "brain.blob")
    sdef.flatten_instances()
    sketch = SketchMachine(sdef, device=device)
    n_prims = len(sdef.prims)

    def traced():
        sc = sketch.sync()
        name = ("trace_additive_rest" if tt.is_additive_path(sc)
                else "trace_general")
        steps[name] = steps.get(name, 0) + 1
        ms, (t, h) = sync_ms(lambda: tt.trace_tiles_image(
            sc, ro, rd, HEIGHT, WIDTH, params))
        return sc, name, ms, t, h

    _, _, _, _, hit_rest = traced()
    n_rest = int(hit_rest.sum())
    s_lo, s_hi = sdef.aabb()
    bump = (0.5 * (s_lo[0] + s_hi[0]), s_hi[1] + 0.15,
            0.5 * (s_lo[2] + s_hi[2]))
    t0 = time.perf_counter()
    sketch.add_action(SketchAddPrim(PrimType.POINT, pos=bump))
    sketch.add_action(SketchAddOp(OpType.BLEND, left=sdef.root_idx,
                                  left_is_op=True, right=n_prims))
    picked = sketch.select(np.array(bump) + [0.0, 3.0, 0.0], [0.0, -1.0, 0.0])
    host["sketch + select"] = time.perf_counter() - t0
    if picked != n_prims:
        raise AssertionError(f"select picked {picked}, not {n_prims}")
    pack_ms, edited = sync_ms(sketch.sync)
    sc, kname, trace_ms, _, hit_e = traced()
    ro_b, rd_b, _ = tt.image_rays_to_blocks(ro, rd, HEIGHT, WIDTH)
    if kname == "trace_general":
        inp = tt.prepare_general(sc, ro_b, rd_b, params)
        uncounted(lambda: compare(
            tt.trace_general_cuda,
            lambda i, c=None: tt.trace_tiles_general_plain(i, c,
                                                           use_live=False),
            inp, kname, log, f"8.5 sketched brain {WIDTH}x{HEIGHT}"))
    else:
        inp = tt.prepare_tiles(sc, ro_b, rd_b, params)
        uncounted(lambda: compare(tt.trace_additive_cuda, tt.trace_tiles_plain,
                                  inp, kname, log,
                                  f"8.5 sketched brain {WIDTH}x{HEIGHT}"))
    del inp
    n_edit = int(hit_e.sum())
    if not (sketch.backward() and sketch.backward()):
        raise AssertionError("undo failed")
    _, _, _, _, hit_undo = traced()
    n_undo = int(hit_undo.sum())
    if n_undo != n_rest or n_edit <= n_rest:
        raise AssertionError(f"hits: rest {n_rest}, sketched {n_edit}, "
                             f"undone {n_undo}")
    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "actions.ini"
        sketch.forward()
        sketch.forward()
        sketch.save_actions(script)
        back = SettingsScript.load(script)
        kinds = [back.read_str(f"ACTION {i}", "type") for i in range(2)]
        if back.read_int("GLOBAL", "count") != 2 or kinds != [
                "ADDPRIM", "ADDOP"]:
            raise AssertionError(f"action script read back as {kinds}")
    log(f"8.5 sketch: prim {picked} picked; sync {pack_ms:.3f} ms "
        f"({edited.n_prims} prims, additive {edited.is_additive}, kernel "
        f"{kname}); traced {WIDTH}x{HEIGHT} in {trace_ms:.3f} ms, hits rest "
        f"{n_rest}, sketched {n_edit}, after undo {n_undo}; action script "
        f"{kinds} {tag}")

    # 8.6 the mass-spring dumbbell and the particles, each on the card
    # against its CPU run.
    def springs(dev):
        ms_ = make_dumbbell(separation=2.0, k=50.0, device=dev)
        ms_.pos[1, 0] = 1.5
        for _ in range(AUX_STEPS):
            ms_ = step_mass_spring(ms_, dt=1 / 120, damping=0.005)
        return ms_

    def particles(dev):
        st = init_particles(N_PARTICLES, seed=0, box=1.0, device=dev)
        for _ in range(AUX_STEPS):
            st = step_particles(st, dt=1 / 60, box=1.0)
        return st

    aux_ms, (card_ms, card_p) = sync_ms(lambda: (springs(device),
                                                 particles(device)))
    cpu_ms, cpu_p = springs("cpu"), particles("cpu")
    errs_aux = {}
    for label, a, b in (("spring pos", card_ms.pos, cpu_ms.pos),
                        ("spring vel", card_ms.vel, cpu_ms.vel),
                        ("particle pos", card_p.pos, cpu_p.pos),
                        ("particle vel", card_p.vel, cpu_p.vel)):
        scale = float(b.abs().max())
        errs_aux[label] = float((a.cpu() - b).abs().max()) / scale
        if errs_aux[label] > AUX_RTOL:
            raise AssertionError(f"{label}: card against CPU {errs_aux}")
    if float(card_p.pos.abs().max()) > 1.0 + 1e-5:
        raise AssertionError("a particle left the box")
    sep = float(torch.linalg.norm(card_ms.pos[1] - card_ms.pos[0]))
    log(f"8.6 dumbbell {AUX_STEPS} steps (separation {sep:.6f}) and "
        f"{N_PARTICLES} particles {AUX_STEPS} steps on the card in "
        f"{aux_ms:.3f} ms; relative difference to the CPU {errs_aux} {tag}")

    launches = dict(tt.LAUNCHES)
    log(f"launches in the interaction path: {launches}, steps {steps}; host "
        f"s {host}; phase total {time.perf_counter() - t_phase:.1f} s")
    for name, n in launches.items():
        if (n > 0) != (steps.get(name, 0) > 0):
            raise AssertionError(f"{name}: {n} launches for "
                                 f"{steps.get(name, 0)} steps")
    return launches, steps


# Phase 9, multi-device on the one card: the world sizes (launch picks
# the transport: NCCL for one rank on the card, gloo for two that share
# it, staging each collective through the host), the frames each rank
# drives (forward frames at the coupled cell's CG_TOL), and how far a
# frame's FEM state may sit from the single-device step's (max |dq| /
# max |q|): two solves with other reduction orders agree within about
# their tolerance, CG_TOL forward and 1e-6 for the differentiable one.
MD_WORLDS = (1, 2)
MD_GRID_FRAMES, MD_PART_FRAMES = 3, 2
MD_Q_REL = {"grid": CG_TOL, "part": CG_TOL, "diff": 1e-3}
MD_GRAD_REL = 1e-3
MD_TIMEOUT_S = 300


def md_host_inputs(root: Path, device):
    """Phase 9's set-up on the host, handed to every rank: brain's tet
    mesh at CELLSIZE (the port's TetMesh as numpy fields), its anchors,
    the grid and the per-node gravity loads."""
    import numpy as np

    from fembrain_tpu_torch import convert
    from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh

    scene = load_scene(root, device)
    frame = fem_setup(scene, CELLSIZE, device, N_CENTERS, "wendland", -500.0)
    tm, grid = frame["tm"], frame["grid"]
    tets = tm.tets[: tm.n_tets].cpu().numpy()
    fem = build_fem_mesh(frame["nodes"], tets, fixed=frame["fixed"],
                         device=device)
    f_nodes = np.zeros((tm.n_nodes, 3), np.float32)
    f_nodes[:, 1] = -500.0 * fem.mass.cpu().numpy()
    host = dict(grid=(tuple(grid.lo), tuple(grid.dims), grid.cellsize),
                tm=convert.numpy_fields(tm),
                interp=convert.numpy_fields(frame["interp"]),
                nodes=frame["nodes"], tets=tets,
                fixed=frame["fixed"], n2g=frame["n2g"], f_nodes=f_nodes,
                f_grid=frame["f_ext"].cpu().numpy())
    return host, scene, frame, fem


def md_rank(device, root, host, params):
    """One rank of phase 9 on `device`: its rows of the sharded rest trace
    of brain (K1) and of the resection (K3), each run twice (the second
    warm), MD_GRID_FRAMES frames of coupled_step_grid_sharded (K2),
    MD_PART_FRAMES of coupled_step_sharded (K4), and one differentiable
    grid frame with the biharmonic interpolant (K4) and its E-gradient;
    with its launches, collectives, bytes staged, CG iterations and ms."""
    import numpy as np
    import torch

    from fembrain_tpu_torch import convert
    from fembrain_tpu_torch.blob.examples import brain_resection
    from fembrain_tpu_torch.fem import grid_sharded as gsh
    from fembrain_tpu_torch.fem import partitioned as pt
    from fembrain_tpu_torch.mesh.polygonize import GridSpec
    from fembrain_tpu_torch.parallel import sharding as sh
    from fembrain_tpu_torch.render import coupled_sharded as csd
    from fembrain_tpu_torch.render import tile_trace as tt

    t0 = time.perf_counter()
    world = torch.distributed.get_world_size()
    scene = load_scene(Path(root), device)
    resection = brain_resection().pack(device=device)
    tm = convert.tet_mesh(host["tm"], device=device)
    cs = csd.build_coupled_sharded(host["nodes"], host["tets"], world,
                                   fixed=host["fixed"], device=device)
    cgs = csd.build_coupled_grid_sharded(
        GridSpec(*host["grid"]), tm, world, fixed_nodes=host["fixed"],
        n_centers=N_CENTERS, kernel="wendland", device=device)

    def with_interp(interp):
        """cgs with `interp` and its centers' grid vertices (the shard
        layout's flat index is the grid's)."""
        return dataclasses.replace(cgs, interp=interp, center_flat=(
            torch.as_tensor(host["n2g"][interp.center_nodes.cpu().numpy()]
                            .astype(np.int32), device=device)))

    # The grid frames trace with the single-device frame's interpolant
    # (SIGMA_FILL), the differentiable one with the biharmonic one.
    cgs_b = with_interp(cs.interp)
    cgs = with_interp(convert.disp_interp(host["interp"], device=device))
    gmesh, rmesh = gsh.make_grid_mesh(), sh.make_mesh()
    nmesh = sh.make_mesh(axis=pt.NODE_AXIS)
    ro, rd = image_rays(WIDTH, HEIGHT, device)
    hw = (HEIGHT, WIDTH)
    f_grid = gsh.to_shard_layout(cgs.sgf, torch.as_tensor(
        host["f_grid"], device=device))[cgs.sgf.part]
    f_part = pt.to_partition_order(cs.pm, torch.as_tensor(
        host["f_nodes"], device=device))[cs.pm.part]
    torch.cuda.synchronize()
    out = dict(rank=cgs.sgf.part, setup_s=time.perf_counter() - t0, ms={},
               iters={}, backend=torch.distributed.get_backend())

    tt.reset_launch_counts()
    sh.reset_counts()
    for name, sc in (("rest", scene), ("resection", resection)):
        out["ms"][name] = []
        for _ in range(2):      # the first call in a process loads modules
            ms, (t, hit) = sync_ms(lambda: tt.trace_tiles_image_sharded(
                sc, ro, rd, HEIGHT, WIDTH, rmesh, params=params))
            out["ms"][name].append(ms)
        out[name] = (t.cpu(), hit.cpu())

    def frames(step, state, n, key):
        out["ms"][key], out["iters"][key] = [], []
        for _ in range(n):
            ms, (t, hit, state, it) = sync_ms(lambda: step(*state))
            out["ms"][key].append(ms)
            out["iters"][key].append(it)
        out[key] = (t.cpu(), hit.cpu(), state[0].cpu())

    frames(lambda q, v, dv: csd.coupled_step_grid_sharded(
        scene, cgs, gmesh, q, v, dv, f_grid, ro, rd, params=params,
        image_hw=hw, cg_tol=CG_TOL), cgs.sgf.rest_state(),
        MD_GRID_FRAMES, "grid")
    z = torch.zeros_like(f_part)
    frames(lambda q, v, dv: csd.coupled_step_sharded(
        scene, cs, nmesh, q, v, dv, f_part, ro, rd, params=params,
        image_hw=hw, cg_tol=CG_TOL), (z, z, z), MD_PART_FRAMES, "part")

    e = torch.tensor(1.0, device=device, requires_grad=True)
    q, v, dv = cgs.sgf.rest_state()
    fwd_ms, (t, hit, (q, _, _), _) = sync_ms(
        lambda: csd.coupled_step_grid_sharded(
            scene, cgs_b, gmesh, q, v, dv, f_grid, ro, rd, E_scale=e,
            params=params, image_hw=hw, differentiable=True))
    loss = torch.sum(torch.where(hit, t, 0.0))
    bwd_ms, _ = sync_ms(loss.backward)
    out["diff"] = (t.detach().cpu(), hit.cpu(), q.detach().cpu())
    out["grad"] = float(e.grad)
    out["ms"]["diff"] = [fwd_ms, bwd_ms]
    out["launches"], out["counts"] = dict(tt.LAUNCHES), dict(sh.COUNTS)
    out["perm"] = cs.pm.perm.cpu()
    return out


def multi_device_phase(root, device, params, tag, log):
    """Phase 9: the multi-device layer on the one card, counted in the
    ranks; returns (launches, steps driven per kernel), summed over every
    rank of every group."""
    import torch

    from fembrain_tpu_torch.blob.examples import brain_resection
    from fembrain_tpu_torch.fem import integrator as integ
    from fembrain_tpu_torch.parallel import sharding as sh
    from fembrain_tpu_torch.render import tile_trace as tt
    from fembrain_tpu_torch.render.deformed import (
        build_disp_interp, coupled_step_fast, coupled_step_grid_fast,
        disp_weights, disp_weights_centers, trace_deformed_rbf_fast,
    )

    t_phase = time.perf_counter()
    host, scene, frame, fem = md_host_inputs(root, device)
    gf, interp, cgi = frame["gf"], frame["interp"], frame["cgi"]
    bih = build_disp_interp(frame["nodes"], fixed=frame["fixed"],
                            device=device)
    cgi_b = center_grid_index(bih, frame["n2g"], device)
    ro, rd = image_rays(WIDTH, HEIGHT, device)
    hw = (HEIGHT, WIDTH)
    f_nodes = torch.as_tensor(host["f_nodes"], device=device)

    # The single-device port's results the ranks are held to (the
    # parent's launches are not the path's: the ranks count their own).
    ref = {name: tt.trace_tiles_image(sc, ro, rd, HEIGHT, WIDTH, params)
           for name, sc in (("rest", scene),
                            ("resection",
                             brain_resection().pack(device=device)))}
    st = gf.rest_state()
    iters, stats = {"grid": [], "part": []}, {}
    for _ in range(MD_GRID_FRAMES):
        t, hit, st = coupled_step_grid_fast(
            scene, gf, interp, cgi, st, frame["f_ext"], ro, rd,
            E_scale=None, params=params, image_hw=hw, cg_tol=CG_TOL,
            solve_stats=stats)
        iters["grid"].append(stats["forward_iters"])
    ref["grid"] = (t, hit, st.q)
    st = integ.FemState.rest(fem)
    for _ in range(MD_PART_FRAMES):
        t, hit, st = coupled_step_fast(
            scene, fem, bih, st, f_nodes, ro, rd, E_scale=None,
            params=params, image_hw=hw, cg_tol=CG_TOL, solve_stats=stats)
        iters["part"].append(stats["forward_iters"])
    ref["part"] = (t, hit, st.q)
    e = torch.tensor(1.0, device=device, requires_grad=True)
    t, hit, st = coupled_step_grid_fast(
        scene, gf, bih, cgi_b, gf.rest_state(), frame["f_ext"], ro, rd,
        E_scale=e, params=params, image_hw=hw, differentiable=True)
    torch.sum(torch.where(hit, t, 0.0)).backward()
    ref["diff"] = (t.detach(), hit, st.q.detach())
    grad = float(e.grad)
    ref = {k: tuple(x.cpu() for x in v) for k, v in ref.items()}
    ref["grad"] = grad
    del gf, fem
    torch.cuda.empty_cache()
    log(f"single-device references in {time.perf_counter() - t_phase:.1f} "
        f"s: CG iterations grid frames {iters['grid']}, partitioned "
        f"{iters['part']}; dloss/dE {grad:.6f}")

    def retrace(key, q):
        """The single-device trace stage of a frame on the FEM state q
        (on the host): center rows, weights, tile trace, and for the
        differentiable frame its correction."""
        q = q.to(device)
        if key == "grid":
            w = disp_weights_centers(interp, q.reshape(-1, 3)[cgi])
            ip = interp
        elif key == "part":
            w, ip = disp_weights(bih, q), bih
        else:
            w = disp_weights_centers(bih, q.reshape(-1, 3)[cgi_b])
            ip = bih
        t, hit = trace_deformed_rbf_fast(
            scene, ip, w, ro, rd, params, image_hw=hw,
            need_grads=key == "diff")
        return t.detach().cpu(), hit.cpu()

    launches = {name: 0 for name, _, _ in KERNELS}
    steps = dict(launches)
    per_rank_steps = {"trace_additive_rest": 2, "trace_general": 2,
                      "trace_additive_wendland": MD_GRID_FRAMES,
                      "trace_additive_biharmonic": MD_PART_FRAMES + 1}
    for world in MD_WORLDS:
        t0 = time.perf_counter()
        ranks = sh.launch(md_rank, world, str(root), host, params,
                          device="cuda", timeout_s=MD_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if [r["rank"] for r in ranks] != list(range(world)):
            raise AssertionError(f"blocks {[r['rank'] for r in ranks]}")
        for r in ranks:
            for name in launches:
                launches[name] += r["launches"][name]
                steps[name] += per_rank_steps[name]
            c = r["counts"]
            log(f"  D={world} {r['backend']} rank {r['rank']}: set-up "
                f"{r['setup_s']:.2f} s; ms (first call, warm) rest "
                + ", ".join(f"{m:.3f}" for m in r["ms"]["rest"])
                + "; resection "
                + ", ".join(f"{m:.3f}" for m in r["ms"]["resection"])
                + "; grid frames "
                + ", ".join(f"{m:.3f}" for m in r["ms"]["grid"])
                + " (CG " + ", ".join(map(str, r["iters"]["grid"]))
                + "), partitioned frames "
                + ", ".join(f"{m:.3f}" for m in r["ms"]["part"])
                + " (CG " + ", ".join(map(str, r["iters"]["part"]))
                + f"), differentiable (first autograd pass of the "
                f"process) {r['ms']['diff'][0]:.3f} + "
                f"{r['ms']['diff'][1]:.3f}; collectives: shift {c['shift']}"
                f", all_reduce {c['all_reduce']}, all_gather "
                f"{c['all_gather']}; bytes staged {c['staged_bytes']} {tag}")
        md_check(ranks, ref, retrace, world, log)
        log(f"D={world} ({ranks[0]['backend']}, {world} rank(s) on "
            f"cuda:0): {wall:.1f} s with start-up")
    log(f"launches in the multi-device path: {launches}, steps {steps}; "
        f"phase total {time.perf_counter() - t_phase:.1f} s")
    return launches, steps


def md_check(ranks, ref, retrace, world, log):
    """The ranks' results against the single-device port's: the rest and
    resection traces bit for bit; each frame's FEM state within MD_Q_REL
    of the single-device step's; its trace stage on the ranks' own state
    (center rows, weights, the tile trace, the correction) against the
    single-device one on that state, bit for bit for the forward frames,
    within K4's thresholds for the corrected differentiable one; the whole
    frame against the single-device frame by hit agreement (>= 0.999) and
    median |dt|; the E-gradient the same on every rank and within
    MD_GRAD_REL."""
    import torch

    def rows(key, i):
        return torch.cat([r[key][i] for r in ranks])

    for key in ("rest", "resection"):
        if not (torch.equal(rows(key, 0), ref[key][0])
                and torch.equal(rows(key, 1), ref[key][1])):
            raise AssertionError(f"D={world}: sharded {key} trace differs "
                                 f"from the single-device one")
    for key in ("grid", "part", "diff"):
        kernel = ("trace_additive_wendland" if key == "grid"
                  else "trace_additive_biharmonic")
        agree_min, max_tol, med_tol = THRESHOLDS[kernel]
        t, hit = rows(key, 0), rows(key, 1)
        q1 = ref[key][2]
        q = rows(key, 2)
        if key == "part":         # partition order back to node ids
            perm = ranks[0]["perm"].long()
            q = torch.zeros_like(q1).index_copy(0, perm, q[: q1.shape[0]])
        else:                     # the slabs stacked, padding planes off
            q = q[: q1.shape[0]]
        rel = float((q - q1).abs().max()) / float(q1.abs().max())
        t2, h2 = retrace(key, q)
        same = torch.equal(t, t2) and torch.equal(hit, h2)
        both = hit & h2
        dt2 = torch.abs(t[both] - t2[both])
        agree = float((hit == ref[key][1]).float().mean())
        both = hit & ref[key][1]
        dt = torch.abs(t[both] - ref[key][0][both])
        log(f"  D={world} {key}: max |dq| / max |q| {rel:.3e}; trace on "
            f"the ranks' state {'bit for bit' if same else 'max |dt| '}"
            f"{'' if same else f'{float(dt2.max()):.3e}'}; against the "
            f"single-device frame: hits {int(hit.sum())} vs "
            f"{int(ref[key][1].sum())}, agreement {agree:.6f}, max |dt| "
            f"{float(dt.max()):.3e} ({int((dt >= max_tol).sum())} over "
            f"{max_tol:g}), median {float(dt.median()):.3e}")
        if not rel < MD_Q_REL[key]:
            raise AssertionError(f"D={world} {key}: FEM state off by {rel}")
        if key != "diff" and not same:
            raise AssertionError(f"D={world} {key}: trace stage differs")
        if key == "diff" and (not torch.equal(hit, h2)
                              or float(dt2.max()) >= max_tol):
            raise AssertionError(f"D={world} {key}: corrected trace off")
        if agree < max(agree_min, 0.999) or (
                med_tol is not None and float(dt.median()) >= med_tol):
            raise AssertionError(f"D={world} {key}: frame off")
    g = [r["grad"] for r in ranks]
    rel = abs(g[0] - ref["grad"]) / max(abs(ref["grad"]), 1e-12)
    log(f"  D={world} dloss/dE {g[0]:.6f} (single device "
        f"{ref['grad']:.6f}, relative {rel:.3e})")
    if len(set(g)) != 1 or not rel < MD_GRAD_REL:
        raise AssertionError(f"D={world} E-gradient {g} vs {ref['grad']}")


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


# What the script reads from the checkout it stands in.
NEEDS = ("fembrain_tpu_torch/__init__.py", "fembrain_tpu_torch/csrc",
         "data/models/brain.sim", "data/models/blobtree/brain.blob")


def main() -> int:
    root = Path(__file__).resolve().parent
    missing = [rel for rel in NEEDS if not (root / rel).exists()]
    if missing:
        print(f"chip_smoke: {', '.join(missing)} not found beside "
              f"{Path(__file__).name}: run it from a checkout of the repo",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    torch.cuda.empty_cache()
    # 7. the app and its CLI (no tile kernel)
    app_phase(root, device, tag, log)
    torch.cuda.empty_cache()
    # 8. surgical interaction, counted
    launches_i, steps_i = interaction_phase(root, device, params, tag, log)
    torch.cuda.empty_cache()
    # 9. multi-device on the one card, counted in the ranks
    launches_m, steps_m = multi_device_phase(root, device, params, tag, log)
    paths = {"coupled_frame": (launches, steps),
             "training": (launches_t, steps_t),
             "simulation_frame": (launches_s, steps_s),
             "interaction": (launches_i, steps_i),
             "multi_device": (launches_m, steps_m)}
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
