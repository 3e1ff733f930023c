"""FastRBF: radial-basis-function approximation of the implicit field.

Port of the reference's FastRBF (src/implicit/RBF.{h,cpp}): after
deformation the analytic BlobTree no longer matches the deformed surface,
so a biharmonic RBF  f(x) = sum_i lambda_i |x - c_i|  is fitted to
surface + off-surface samples (the reference's greedy center selection to
a fitting accuracy, RBF.h:81-84; off-surface samples at +/- normal offset
from GPUPoly::computeOffSurfacePointsAndFields,
OclPolygonizer.cpp / Polygonizer.cl:1329-1350). Evaluation matches the
device kernel ComputeRBFPrimFieldArray (data/opencl/RBFRendering.cl:76-90).

Counterpart of fembrain_tpu/ops/rbf.py: the greedy fit is the same host
float64 numpy; evaluation is float32 torch on the instance's device (the
card when None), and the gradient is autograd of `field`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import default_device

DEFAULT_GREEDY_STEP = 64
DEFAULT_FITTING_ACCURACY = 1e-3
DEFAULT_OFF_SURFACE_LEN = 0.1


def off_surface_samples(points: np.ndarray, normals: np.ndarray,
                        offset: float = DEFAULT_OFF_SURFACE_LEN):
    """On-surface (value 0) plus +/- normal offset samples (+off outside
    -> negative field shift, like the reference's off-surface points)."""
    pts = np.concatenate(
        [points, points + offset * normals, points - offset * normals]
    )
    vals = np.concatenate(
        [
            np.zeros(len(points)),
            -offset * np.ones(len(points)),
            offset * np.ones(len(points)),
        ]
    )
    return pts, vals


class FastRBF:
    def __init__(self, device: torch.device | str | None = None):
        self.device = torch.device(
            default_device() if device is None else device)
        self.centers = np.zeros((0, 3))
        self.lambdas = np.zeros(0)
        self._c = torch.zeros((0, 3), device=self.device)
        self._lam = torch.zeros(0, device=self.device)

    # ----------------------------------------------------------------- fit
    def fit_greedy(
        self,
        points: np.ndarray,
        values: np.ndarray,
        start_count: int = 128,
        step: int = DEFAULT_GREEDY_STEP,
        fitting_accuracy: float = DEFAULT_FITTING_ACCURACY,
        max_centers: int = 2048,
        seed: int = 0,
    ) -> float:
        """Greedy center selection (reference computeInterpolationFunction,
        RBF.h:81-84): fit on a subset, add the worst-resid points, repeat
        until the max residual over ALL samples is below the accuracy.
        Returns the final max residual."""
        points = np.asarray(points, np.float64)
        values = np.asarray(values, np.float64)
        n = len(points)
        rng = np.random.default_rng(seed)
        sel = rng.choice(n, size=min(start_count, n), replace=False)
        selected = set(int(i) for i in sel)

        while True:
            idx = np.fromiter(selected, np.int64)
            self._solve(points[idx], values[idx])
            resid = np.abs(self.evaluate(points) - values)
            err = float(resid.max())
            if err <= fitting_accuracy or len(selected) >= min(n, max_centers):
                return err
            worst = np.argsort(resid)[::-1]
            added = 0
            for w in worst:
                if int(w) not in selected:
                    selected.add(int(w))
                    added += 1
                    if added >= step:
                        break
            if added == 0:
                return err

    def _solve(self, centers: np.ndarray, values: np.ndarray) -> None:
        d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
        # Tiny ridge for conditioning of the biharmonic system.
        a = d + 1e-9 * np.eye(len(centers))
        lam, *_ = np.linalg.lstsq(a, values, rcond=None)
        self.centers = centers
        self.lambdas = lam
        self._c = torch.as_tensor(centers.astype(np.float32),
                                  device=self.device)
        self._lam = torch.as_tensor(lam.astype(np.float32),
                                    device=self.device)

    # ---------------------------------------------------------------- eval
    def evaluate(self, x: np.ndarray) -> np.ndarray:
        """f(x) = sum lambda_i |x - c_i| (RBFRendering.cl:76-90), host
        points in, host values out."""
        x = np.asarray(x, np.float64).reshape(-1, 3)
        xt = torch.as_tensor(x.astype(np.float32), device=self.device)
        return self.field(xt).cpu().numpy()

    def field(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable evaluation at points [..., 3] on the device."""
        d = torch.linalg.norm(x[..., None, :] - self._c, dim=-1)
        return d @ self._lam

    def gradient(self, x) -> torch.Tensor:
        """Autograd gradient of `field` at points [N, 3]."""
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=self.device).reshape(-1, 3)
        with torch.enable_grad():
            p = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.field(p).sum(), p)
        return g

    # ----------------------------------------------------------- collision
    def intersects(self, v: np.ndarray, iso: float = 0.0):
        """Penetration query (reference FastRBF::intersects, RBF.h:64-68).
        With the off_surface_samples convention the field is positive
        inside, so penetration depth = f - iso."""
        f = self.evaluate(np.atleast_2d(v))
        pen = f - iso
        return pen > 0, pen
