"""The control and the faults that the comparison deciding `correct` has
to catch.

The control is the reference put in the program's place, its matrix
products computed in TF32 (the nearest precision below the float32 with
TF32 off that the configuration states). A fault breaks the program's
timed path underneath the harness: a step that returns its state
unchanged, half of the rays left out, an answer altered where it is
produced.
"""
from __future__ import annotations

import dataclasses

import torch

from reference import trace as rtrace
from reference.field import Precision

TF32 = Precision(control=True)


@dataclasses.dataclass(frozen=True)
class State:
    q: torch.Tensor
    qvel: torch.Tensor
    dv: torch.Tensor


def coupled_frame_state(dep, state):
    """The reference's FEM step in TF32: (q, qvel, dv) on the grid."""
    dims = tuple(state.q.shape)
    step = dep.ref_step(TF32)
    q, v = state.q.reshape(-1, 3).float(), state.qvel.reshape(-1, 3).float()
    out = step.step(q, v, dep.f_ext.reshape(-1, 3).float())
    return tuple(x.reshape(dims) for x in out)


def coupled_trace(dep, state, ro, rd):
    """The reference's trace of a grid state in TF32."""
    return rtrace.trace_image(dep.ref_scene, ro, rd, *dep.image_hw,
                              disp=dep.ref_disp(state.q.reshape(-1, 3), TF32),
                              prec=TF32)


def coupled_frame(dep, state, ro, rd, stats):
    """The reference's coupled frame in TF32, in the program's place."""
    new = State(*coupled_frame_state(dep, state))
    return (*coupled_trace(dep, new, ro, rd), new)


def rest_frame(dep, ro, rd):
    """The reference's rest trace in TF32, in the program's place."""
    return rtrace.trace_image(dep.ref_scene, ro, rd, *dep.image_hw,
                              prec=TF32)


def train_steps(kind, dep, mix, pix_w, ro, rd, n):
    """The reference's first `n` training steps in TF32, in the program's
    place: (the steps as the kind's check reads them, the scale after)."""
    steps, scale = kind.reference_steps(dep, mix, pix_w, ro, rd, n, TF32,
                                        TF32)
    return [dict(loss=r["loss"], grad=r["grad"], t=r["t"], hit=r["hit"],
                 q=r["q"], v=r["v"]) for r in steps], scale


def _half_dropped(t, hit):
    hit = hit.clone()
    hit[::2] = False
    return t, hit


def _altered(t, hit):
    t = t.clone()
    i = int(torch.nonzero(hit)[0])
    t[i] = t[i] + 0.05
    return t, hit


FAULTS = ("state_unchanged", "half_dropped", "answer_altered")


def faulty(frame, fault: str):
    """`frame` (a kind's program_frame) with `fault` planted in it."""
    def broken(dep, *args):
        out = frame(dep, *args)
        t, hit = out[0], out[1]
        if fault == "state_unchanged":
            return (t, hit, args[0]) if len(out) == 3 else out
        t, hit = (_half_dropped if fault == "half_dropped" else _altered)(
            t, hit)
        return (t, hit, *out[2:])

    return broken


def plant(kind, fault: str) -> None:
    """Plant `fault` in a kind module's timed path: in a training kind a
    state left unchanged is an update that keeps the scale, the others
    go into its coupled frame; elsewhere into its program frame."""
    if hasattr(kind, "coupled_frame"):
        if fault == "state_unchanged":
            kind.update = lambda scale, g, mix: scale
        else:
            kind.coupled_frame = faulty(kind.coupled_frame, fault)
    else:
        kind.program_frame = faulty(kind.program_frame, fault)
