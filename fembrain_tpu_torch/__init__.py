"""FemBrain in PyTorch with CUDA kernels for NVIDIA Hopper.

The package mirrors fembrain_tpu module for module. Float32 matrix
products run in full float32: reduced-precision (TF32) products once
pushed the Young's-modulus gradient 36% off and made CG diverge
(fembrain_tpu/render/deformed.py, fembrain_tpu/fem/grid_fem.py).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """Where a constructor puts its tensors when the caller names no
    device: the CUDA card. Without a card the first tensor raises; a
    caller that wants the CPU says `device="cpu"`."""
    return torch.device("cuda")


def _settle_cpu_math() -> None:
    """Call the CPU math kernels the package uses once on one element.

    A CPU kernel picks its vectorised implementation at its first call.
    In PyTorch 2.13's CPU build, when that first call runs on several
    threads at once, some threads can return inexact values (sqrt off by
    1e-3, sin and tanh by 1e-4). A first call on one element runs on one
    thread and settles the choice for every later call."""
    x = torch.ones(1)
    for fn in (torch.sqrt, torch.sin, torch.cos, torch.tan, torch.abs,
               torch.sign, torch.deg2rad):
        fn(x)
    torch.pow(x, 2.0)
    torch.linalg.norm(x[None], dim=-1)


_settle_cpu_math()
