"""The plain training step of the E fit: one differentiable coupled frame
from rest, its loss and the loss's derivative in the stiffness scale.

From rest (q = v = 0, so every rotation is the identity) the step solves
A(s) dv = h f_ext with A(s) = (1 + h alpha) M + (h beta + h^2) s K; the
state after it is v = dv, q = h dv. The centres' displacements give the
biharmonic weights w, and the deformed trace its roots t0. The frame's
depth at a hit is the root moved once along the ray by Newton,
t = t0 - clamp(f(x0) / (grad f(x0) . d), +-cap), x0 = o + t0 d, with t0
and the slope held fixed, so t depends on s through f(x0; w) alone. The
loss is sum over hits of a per-pixel weight times t, and

    dL/ds = dL/dw . dw/ds,   dw/ds = P^-1 [h d(dv)/ds at the centres; 0],
    d(dv)/ds = -A^-1 (h beta + h^2) K dv.
"""
from __future__ import annotations

import dataclasses

import torch

from .field import Field, Precision
from .interp import Interp, biharmonic_disp, weights
from .scene import ISO
from .trace import STEP_FRAC, trace_image

CHUNK = 1 << 16   # hit rays a block of the correction


def pull_back(disp, p, prec: Precision):
    x = p
    for _ in range(disp.fp_iters):
        r = torch.sqrt(torch.clamp(
            torch.sum((x[:, None] - disp.centers[None]) ** 2, -1), min=1e-24))
        x = p - (disp.waff[:, 0][None] + prec.mm(x, disp.waff[:, 1:4].T)
                 + prec.mm(r, disp.w))
    return x


def deformed_field(field: Field, disp, p, prec):
    return field(pull_back(disp, p, prec)) - ISO


def step(dep, s: float, pix_w: torch.Tensor, ro, rd, prec: Precision,
         fem_prec: Precision) -> dict:
    """One training step at stiffness scale `s`: loss, dL/ds, the state
    (q, v on the grid, [n, 3]), the weights w, and the trace of its frame
    (t, hit, the field's rise along each ray at its root)."""
    c = dep.config
    st = dep.ref_step(fem_prec)
    st.ke = st.ke * s
    f_ext = dep.f_ext.reshape(-1, 3).to(fem_prec.dtype)
    zero = torch.zeros_like(f_ext)
    R = st.rotations(zero)
    A = st.operator(R)
    dv = st.solve(A, st.rhs(R, zero, zero, f_ext), R)
    free = st.free[:, None]
    # (h beta + h^2) K dv, from A dv = M-term + s (h beta + h^2) K dv.
    kdv = (A(dv) - st.mass_coef * st.mass[:, None] * dv) / s
    ddv = st.solve(A, -torch.where(free, kdv, 0.0), R)
    v1 = torch.where(free, dv, 0.0)
    q1 = torch.where(free, c["h"] * v1, 0.0)
    dq = torch.where(free, c["h"] * ddv, 0.0)
    interp: Interp = dep.ref_interp
    w = weights(interp, q1[dep.ref_cgi].float(), prec)
    dw = weights(interp, dq[dep.ref_cgi].float(), prec)
    disp = biharmonic_disp(interp, w, c["max_disp"], c["fp_iters"], prec)
    t0, hit, rise = trace_image(dep.ref_scene, ro, rd, *dep.image_hw,
                                disp=disp, prec=prec, slope=True)
    m = interp.centers.shape[0]
    lo = torch.as_tensor(dep.ref_scene.bbox_lo, device=ro.device) - 0.05 \
        - c["max_disp"]
    hi = torch.as_tensor(dep.ref_scene.bbox_hi, device=ro.device) + 0.05 \
        + c["max_disp"]
    cap = 0.5 * float(torch.sqrt(torch.sum((hi - lo) ** 2)) * STEP_FRAC)
    field = Field(dep.ref_scene, ro.device, prec)
    idx = torch.nonzero(hit).squeeze(-1)
    t = t0.clone()
    w_var = w.detach().clone().requires_grad_(True)
    grad_w = torch.zeros_like(w)
    loss = 0.0
    for i in range(0, idx.numel(), CHUNK):
        j = idx[i:i + CHUNK]
        x0 = ro[j] + t0[j, None] * rd[j]
        with torch.enable_grad():
            p = x0.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(
                deformed_field(field, disp, p, prec).sum(), p)
        dfdt = torch.sum(g * rd[j], -1)
        dfdt = torch.where(torch.abs(dfdt) < 1e-6,
                           torch.where(dfdt < 0, -1e-6, 1e-6), dfdt)
        with torch.enable_grad():
            d = dataclasses.replace(disp, w=w_var[:m], waff=w_var[m:].T)
            corr = torch.clamp(deformed_field(field, d, x0, prec) / dfdt,
                               -cap, cap)
            tj = t0[j] - corr
            part = torch.sum(pix_w[j].double() * tj.double())
            (gw,) = torch.autograd.grad(part, w_var)
        grad_w += gw
        loss += float(part.detach().double())
        t[j] = tj.detach()
    grad = float(torch.sum(grad_w.double() * dw.double()))
    return {"loss": loss, "grad": grad, "q": q1, "v": v1, "t": t,
            "hit": hit, "rise": rise, "w": w}


def update(scale, g, mix):
    """Gradient descent on the scale: the step -lr g clipped to `clip`
    of the scale, the scale kept in `scale_range`."""
    lo, hi = mix["scale_range"]
    clip = mix["clip"] * scale
    return torch.clamp(scale + torch.clamp(-mix["lr"] * g, -clip, clip),
                       lo, hi)
