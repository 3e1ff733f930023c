"""PyTorch port, the stage spans (utils.profiler.span) on the CPU: off
when no profile records, named and nested as the layers are under
torch.profiler, one `fem.cg_iter` a CG iteration forward and in the
adjoint, and no bit of the frame's output moved by recording them.

The frame is the coupled grid frame (`coupled_step_grid_fast`) on brain
at cellsize 0.35 (855 nodes), 64 biharmonic centres (K4's plain
version) and a 16 x 16 image; the port alone, no JAX. The spans are
read from the profiler's raw events: building its FunctionEvents for the
frame's ~350,000 operations takes half a minute on the CPU."""
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.fem import grid_fem as gfm
from fembrain_tpu_torch.fem import integrator as integ
from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
from fembrain_tpu_torch.mesh.polygonize import (
    extract_tet_mesh, grid_for_scene,
)
from fembrain_tpu_torch.mesh.samples import (
    bottom_nodes, bottom_nodes_per_component, truth_cube,
)
from fembrain_tpu_torch.render import deformed as pd
from fembrain_tpu_torch.render.camera import Camera, generate_rays
from fembrain_tpu_torch.utils import profiler as pprof

BRAIN = (Path(__file__).resolve().parent.parent
         / "data/models/blobtree/brain.blob")
W, H = 16, 16

# The spans of one coupled grid frame and the span each opens inside.
FRAME_PARENTS = {
    "fem.step": "frame",
    "fem.forces": "fem.step",
    "fem.precond_setup": "fem.step",
    "fem.solve": "fem.step",
    "fem.cg_iter": "fem.solve",
    "fem.matvec": "fem.cg_iter",
    "fem.precond": "fem.cg_iter",
    "coupling.weights": "frame",
    "coupling.spec": "frame",
    "trace": "frame",
    "trace.prepare": "trace",
    "trace.bracket": "trace.prepare",
    "trace.kernel": "trace",
}


@pytest.fixture(scope="module")
def brain():
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    scene = sc.pack(device="cpu")
    grid = grid_for_scene(scene, cellsize=0.35)
    tm = extract_tet_mesh(scene, grid, ncap=grid.n_vertices,
                          tetcap=grid.n_cells * 6)
    nodes = tm.nodes[: tm.n_nodes].numpy()
    tets = tm.tets[: tm.n_tets].numpy()
    fixed = bottom_nodes_per_component(nodes, tets, frac=0.25)
    gf = gfm.grid_fem_from_tetmesh(grid, tm, fixed_nodes=fixed,
                                   device="cpu")
    interp = pd.build_disp_interp(nodes, n_centers=64, fixed=fixed,
                                  device="cpu")
    n2g = gfm.node_to_grid_index(tm)
    cgi = torch.as_tensor(n2g[interp.center_nodes.numpy()].astype(np.int64))
    f_ext = torch.zeros((*gf.dims, 3))
    f_ext[..., 1] = -500.0 * gf.mass
    ro, rd = generate_rays(Camera.orbit(30.0, 20.0, 4.5, device="cpu"), W, H)
    return dict(scene=scene, gf=gf, interp=interp, cgi=cgi, f_ext=f_ext,
                ro=ro.reshape(-1, 3), rd=rd.reshape(-1, 3))


def frame(b, state, stats, **kw):
    return pd.coupled_step_grid_fast(
        b["scene"], b["gf"], b["interp"], b["cgi"], state, b["f_ext"],
        b["ro"], b["rd"], image_hw=(H, W), cg_tol=1e-2, solve_stats=stats,
        **kw)


# Every span name the tests meet, the `Profiler.event` blocks' included.
SPAN_NAMES = {*FRAME_PARENTS, "frame", "fem.cg_sync", "fem.adjoint",
              "trace.correct", "cut_gather", "cut_cells"}

Span = namedtuple("Span", "name start end thread")


def recorded(fn):
    """fn()'s result and the spans torch.profiler recorded, in the order
    they opened. A span is a host range, not a user annotation (so it
    has no device-side twin)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = prof.profiler.kineto_results.events()
    assert not any(e.is_user_annotation() for e in events)
    spans = [Span(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
             for e in events if e.name() in SPAN_NAMES]
    return out, sorted(spans, key=lambda s: (s.start, -s.end))


def names(spans):
    return [s.name for s in spans]


def inside(s, outer):
    return (s is not outer and s.thread == outer.thread
            and outer.start <= s.start and s.end <= outer.end)


def parent_span(s, spans):
    """The name of the innermost span around `s` on its thread, or None."""
    around = [o for o in spans if inside(s, o)]
    return min(around, key=lambda o: o.end - o.start).name if around \
        else None


def test_span_off_calls_no_record_function(brain, monkeypatch):
    """With no profile recording, `span` and every span on the frame's
    path never open a profiler range."""
    def refuse(name):
        raise AssertionError(f"profiler range {name!r} with no profile")

    monkeypatch.setattr(pprof, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with pprof.span("frame"):
        pass
    frame(brain, brain["gf"].rest_state(), {})


def test_frame_spans_nest_as_the_layers(brain):
    """One warm-started frame records each span of the frame, nested as
    the layers are, and one `fem.cg_iter` a forward CG iteration, each
    with one `fem.cg_sync` (the loop test's read) inside."""
    stats = {}
    _, spans = recorded(lambda: frame(brain, brain["gf"].rest_state(),
                                      stats))
    got = names(spans)
    assert got.count("frame") == 1 and got.count("trace") == 1
    for name, parent in FRAME_PARENTS.items():
        assert name in got, name
        assert {parent_span(e, spans) for e in spans
                if e.name == name} == {parent}
    syncs = [parent_span(e, spans) for e in spans
             if e.name == "fem.cg_sync"]
    assert syncs.count("fem.solve") == 2   # threshold and first loop test
    assert syncs.count("fem.cg_iter") == stats["forward_iters"] > 0
    assert got.count("fem.cg_iter") == stats["forward_iters"]
    assert got.count("fem.matvec") == got.count("fem.precond") \
        == stats["forward_iters"]
    assert "fem.adjoint" not in got and "trace.correct" not in got


def test_differentiable_frame_records_the_adjoint(brain):
    """A differentiable frame records `trace.correct` forward; its
    backward records `fem.adjoint`, with one `fem.cg_iter` inside it a
    CG iteration of the adjoint solve."""
    scale = torch.tensor(1.0, requires_grad=True)
    stats = {}

    def step():
        t, hit, _ = frame(brain, brain["gf"].rest_state(), stats,
                          E_scale=scale, differentiable=True)
        torch.sum(torch.where(hit, t, 0.0)).backward()

    _, spans = recorded(step)
    got = names(spans)
    assert got.count("trace.correct") == 1
    assert parent_span(spans[got.index("trace.correct")], spans) == "frame"
    assert got.count("fem.adjoint") == 1 and scale.grad is not None
    adj = spans[got.index("fem.adjoint")]
    adj_iters = [e for e in spans if e.name == "fem.cg_iter"
                 and inside(e, adj)]
    assert len(adj_iters) == stats["adjoint_iters"] > 0
    assert got.count("fem.cg_iter") == (stats["forward_iters"]
                                        + stats["adjoint_iters"])


def test_spans_move_no_bit(brain):
    """t, hit and the state after two frames are bit-identical with the
    profiler on and off."""
    def two_frames():
        st = brain["gf"].rest_state()
        for _ in range(2):
            t, hit, st = frame(brain, st, {})
        return t, hit, st

    t0, hit0, st0 = two_frames()
    (t1, hit1, st1), spans = recorded(two_frames)
    assert names(spans).count("frame") == 2
    assert torch.equal(t0, t1) and torch.equal(hit0, hit1)
    for a, b in ((st0.q, st1.q), (st0.qvel, st1.qvel), (st0.dv, st1.dv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("differentiable", [False, True])
def test_unstructured_step_spans(differentiable):
    """The unstructured solver's step (fem.integrator.timestep) records
    the same FEM spans as the grid step: forces, the block-Jacobi set-up
    and the solve in `fem.step`, one `fem.cg_iter` a CG iteration."""
    nodes, tets = truth_cube(3, 3, 3)
    mesh = build_fem_mesh(nodes, tets, fixed=bottom_nodes(nodes),
                          device="cpu")
    f_ext = torch.zeros_like(mesh.rest)
    f_ext[:, 1] = -500.0 * mesh.mass
    stats = {}
    _, spans = recorded(lambda: integ.timestep(
        mesh, integ.FemState.rest(mesh), f_ext, differentiable=differentiable,
        solve_stats=stats))
    got = names(spans)
    parents = {**FRAME_PARENTS, "fem.step": None}
    for name, parent in parents.items():
        if name.startswith("fem."):
            assert {parent_span(e, spans) for e in spans
                    if e.name == name} == {parent}, name
    assert got.count("fem.step") == 1
    assert got.count("fem.cg_iter") == stats["forward_iters"] > 0


def test_profiler_event_opens_a_span():
    """`Profiler.event(name)` keeps its host-clock sample and records a
    span of the same name, also when its block raises."""
    prof = pprof.Profiler()

    def blocks():
        with prof.event("cut_gather"):
            torch.ones(4).sum()
        with pytest.raises(ValueError):
            with prof.event("cut_cells"):
                raise ValueError

    _, spans = recorded(blocks)
    assert names(spans) == ["cut_gather", "cut_cells"]
    assert prof.stats()["cut_gather"]["count"] == 1
    assert prof.stats()["cut_cells"]["count"] == 1
