"""The multi-device layer on torch.distributed: device meshes, the few
collectives the sharded solvers and traces use, and a launcher.

PyTorch counterpart of fembrain_tpu/parallel/sharding.py. The JAX
package writes one SPMD program over a `jax.sharding.Mesh` with
`shard_map`; here every rank is a process that runs the per-shard
function on its own block (one process per rank, `launch`):

    Mesh              -> torch.distributed.device_mesh.DeviceMesh
    shard_map body    -> the function each rank runs on its block
    lax.psum          -> all_reduce
    lax.ppermute      -> shift (paired isend/irecv, batch_isend_irecv)
    lax.all_gather    -> all_gather

Rays and FEM nodes or slabs are split over the ranks; the scene and the
small replicated state stay whole on every rank. Compute runs on the
rank's device (`cuda:<rank % cards>`, or the CPU when the caller asks);
the transport is NCCL on cards, one card a rank, and gloo otherwise.
Where gloo takes a CUDA tensor, the helpers copy it to the host and back
explicitly and count the bytes (`COUNTS["staged_bytes"]`): two ranks that
share one card compute on it and talk over the host.

Gradients. A loss is the sum of the ranks' local losses, and every rank
calls backward on its own. The collectives are autograd functions whose
backward is the adjoint collective: a shift's is the reverse shift, an
all_reduce's (a sum used whole on every rank) is an all_reduce of the
gradients, an all_gather's an all_reduce and the rank's slice.
`replicated(x)` marks an input held whole on every rank (Young's modulus,
the scene): identity forward, gradients summed over the ranks. Every rank
must run the same collectives in the same order, backward included, so a
function whose local output may not depend on a replicated quantity
(a rank whose rays all miss) ties it in with `tie`.

Every helper counts its calls in `COUNTS`, so the pattern of a CG
iteration can be pinned as calls (the JAX package pins it in compiled
HLO, tests/test_comm_volume.py).
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

RAY_AXIS = "rays"
HOST_AXIS = "host"
CHIP_AXIS = "chip"

# Calls of each collective helper and the bytes of the tensor each call
# hands over (a rank's share), and the bytes copied between a card and
# the host for gloo (both directions).
COUNTS = {"shift": 0, "shift_bytes": 0, "all_reduce": 0,
          "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0,
          "staged_bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# ------------------------------------------------------------- meshes

def _transport() -> str:
    """The mesh's device type: the transport's, not the compute's (two
    ranks on one card talk over gloo on the host)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, axis: str = RAY_AXIS) -> DeviceMesh:
    """1-D mesh over the first n ranks (default: all)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return DeviceMesh(_transport(), list(range(n)), mesh_dim_names=(axis,))


def _backend(device: torch.device, ranks_per_card: int = 1) -> str:
    """The transport for ranks computing on `device`: NCCL on cards,
    one card a rank (it refuses two ranks on one card), gloo otherwise."""
    return "nccl" if device.type == "cuda" and ranks_per_card <= 1 else "gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> int:
    """Multi-process entry point: with num_processes > 1, join the
    process group at `coordinator_address` (an init method, e.g.
    "tcp://host:port" or "file:///path") as rank `process_id`, for ranks
    that compute on `device` (the card when None, one card a process:
    NCCL; gloo for the CPU). A single process gets a no-op. Returns the
    number of ranks."""
    from .. import default_device

    device = default_device() if device is None else torch.device(device)
    if num_processes is not None and num_processes > 1:
        dist.init_process_group(_backend(device),
                                init_method=coordinator_address,
                                world_size=num_processes, rank=process_id)
    return dist.get_world_size() if dist.is_initialized() else 1


def make_host_chip_mesh(n_hosts: int | None = None,
                        chips_per_host: int | None = None) -> DeviceMesh:
    """2-D ('host', 'chip') mesh over the ranks, host-major (rank
    h * chips_per_host + c is host h's chip c)."""
    world = dist.get_world_size()
    n_hosts = 1 if n_hosts is None else n_hosts
    if chips_per_host is None:
        chips_per_host = world // n_hosts
    ranks = np.arange(n_hosts * chips_per_host).reshape(n_hosts,
                                                        chips_per_host)
    return DeviceMesh(_transport(), ranks.tolist(),
                      mesh_dim_names=(HOST_AXIS, CHIP_AXIS))


def shard_index(device_mesh: DeviceMesh, axis=None) -> tuple[int, int]:
    """(number of shards, this rank's shard) for a split over `axis`: a
    mesh dimension's name, or None for all dimensions jointly (host-major
    on the 2-D mesh, as the reference's P(('host', 'chip')))."""
    names = device_mesh.mesh_dim_names
    axes = names if axis is None else ((axis,) if isinstance(axis, str)
                                       else tuple(axis))
    n, idx = 1, 0
    for a in axes:
        size = device_mesh.size(names.index(a))
        n, idx = n * size, idx * size + device_mesh.get_local_rank(a)
    return n, idx


def split_group(device_mesh: DeviceMesh, axis=None):
    """The process group whose rank order is shard_index's order for a
    split over `axis`: the dimension's group, or the world for a split
    over every dimension of a mesh of several (its ranks in order)."""
    names = device_mesh.mesh_dim_names
    if isinstance(axis, str) or len(names) == 1:
        return device_mesh.get_group(names[0] if axis is None else axis)
    ranks = device_mesh.mesh.flatten().tolist()
    if axis not in (None, names, tuple(names)) or (
            ranks != list(range(dist.get_world_size()))):
        raise ValueError("a split over several mesh dimensions needs all "
                         "of them, over every rank in order")
    return None


def row_share(n: int, n_parts: int, part: int, multiple: int = 1) -> slice:
    """The rows [n] of part `part` when n, padded to a multiple of
    n_parts * multiple, is split into n_parts equal blocks (the last
    block loses the padding)."""
    chunk = n_parts * multiple
    per = -(-n // chunk) * chunk // n_parts
    lo = min(part * per, n)
    return slice(lo, min(lo + per, n))


def shard_rays(mesh: DeviceMesh, *arrays, device=None):
    """This rank's rows of each ray-batch array (split over every mesh
    dimension jointly), on `device` (default: where they are)."""
    n, idx = shard_index(mesh)
    out = []
    for a in arrays:
        rows = a[row_share(a.shape[0], n, idx)]
        out.append(rows if device is None else rows.to(device))
    return tuple(out)


def replicate(mesh: DeviceMesh, tree, device=None):
    """A copy of a dataclass of tensors (the scene, the camera) on every
    rank, on `device` (default: where it is). Each rank holds the whole
    tree already; this only moves it."""
    del mesh
    if device is None:
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).to(device)
        for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def pad_to_multiple(arr: torch.Tensor, multiple: int, axis: int = 0):
    """Pad `axis` with zeros so it divides `multiple`; returns (padded,
    true_n)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    shape = list(arr.shape)
    shape[axis] = rem
    return torch.cat([arr, arr.new_zeros(shape)], axis), n


# -------------------------------------------------------- collectives

def _host_copy(t: torch.Tensor, group) -> tuple[torch.Tensor, bool]:
    """The buffer the transport takes: a host copy of a CUDA tensor for
    gloo (counted), the tensor itself otherwise."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        COUNTS["staged_bytes"] += t.numel() * t.element_size()
        return t.detach().cpu(), True
    return t.detach().clone(), False


def _back(t: torch.Tensor, staged: bool, device) -> torch.Tensor:
    if staged:
        COUNTS["staged_bytes"] += t.numel() * t.element_size()
        return t.to(device)
    return t


def _count(kind: str, x: torch.Tensor) -> None:
    COUNTS[kind] += 1
    COUNTS[kind + "_bytes"] += x.numel() * x.element_size()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    _count("all_reduce", x)
    buf, staged = _host_copy(x.contiguous(), group)
    dist.all_reduce(buf, group=group)
    return _back(buf, staged, x.device)


def _shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    _count("shift", x)
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dst, src = rank + step, rank - step
    send, staged = _host_copy(x.contiguous(), group)
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= dst < size:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, dst), group))
    if 0 <= src < size:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _back(recv, staged, x.device)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    _count("all_gather", x)
    buf, staged = _host_copy(x.contiguous(), group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return _back(torch.cat(parts, dim), staged, x.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, step, group):
        ctx.step, ctx.group = step, group
        return _shift(x, step, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.step, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        lo = dist.get_rank(ctx.group) * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n), None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, *xs):
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros(s, dtype=d, device=v)
                     for s, d, v in ctx.shapes])


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of x over the group's ranks, on every rank (lax.psum)."""
    return _AllReduce.apply(x, group)


def shift(x: torch.Tensor, step: int, group=None) -> torch.Tensor:
    """Rank s sends x to rank s + step and returns what rank s - step
    sent, zeros where there is no such rank (lax.ppermute of a shift:
    the edge ranks add zeros, never a stale buffer)."""
    return _Shift.apply(x, step, group)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' x (equal shapes) concatenated along `dim` in rank order,
    on every rank (lax.all_gather(tiled=True))."""
    return _AllGather.apply(x, group, dim)


def replicated(x, group=None):
    """x, held whole on every rank: identity, with its gradient summed
    over the group's ranks (the transpose of the reference's psum)."""
    if not isinstance(x, torch.Tensor):
        return x
    return _Replicated.apply(x, group)


def tie(y: torch.Tensor, *xs: torch.Tensor) -> torch.Tensor:
    """y unchanged, with xs among its autograd inputs at zero gradient,
    so every rank's backward reaches the collectives behind xs."""
    return _Tie.apply(y, *xs)


# --------------------------------------------------- the training step

def _float_fields(scene) -> list[str]:
    return [f.name for f in dataclasses.fields(scene)
            if isinstance(getattr(scene, f.name), torch.Tensor)
            and getattr(scene, f.name).is_floating_point()]


def render_loss(scene, ro, rd, target, n_total: int | None = None):
    """This rank's share of the mean depth-difference loss over a ray
    batch split across all the ranks: its rays' squared differences
    summed and divided by the global ray count (all-reduced when
    `n_total` is not given). The shares sum to the reference's mean."""
    from ..render.sphere_trace import trace

    if n_total is None:
        n = torch.tensor([float(ro.shape[0])], device=ro.device)
        n_total = int(all_reduce(n).item())
    t, hit = trace(scene, ro, rd)
    d = torch.where(hit, t, 0.0)
    return torch.sum((d - target) ** 2) / n_total


def make_train_step(lr: float = 1e-2):
    """Differentiable-render training step over rays split across all
    the ranks: every rank differentiates its loss share with respect to
    every float scene field, the gradients are all-reduced over the
    ranks, and every rank applies the same update, so the scene stays the
    same on all of them. Returns
    train_step(scene, ro, rd, target) -> (new_scene, global loss)."""

    def train_step(scene, ro, rd, target):
        n = all_reduce(torch.tensor([float(ro.shape[0])], device=ro.device))
        names = _float_fields(scene)
        leaves = {k: getattr(scene, k).detach().requires_grad_(True)
                  for k in names}
        loss = render_loss(dataclasses.replace(scene, **leaves), ro, rd,
                           target, n_total=int(n.item()))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        new = {k: getattr(scene, k) - lr * all_reduce(
            torch.zeros_like(leaves[k]) if g is None else g)
            for k, g in zip(names, grads)}
        return dataclasses.replace(scene, **new), all_reduce(loss.detach())

    return train_step


# ------------------------------------------------------------ launcher

def _rank_main(fn, args, rank, world, init, backend, device, timeout_s,
               out):
    if device.type == "cpu":
        torch.set_num_threads(1)
        dev = device
    else:
        dev = torch.device(device.type, rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    result = fn(dev, *args)
    torch.save(result, out)
    dist.destroy_process_group()


def launch(fn, world_size: int, *args, device=None,
           timeout_s: float = 600.0) -> list:
    """Run fn(rank_device, *args) on `world_size` ranks, one spawned
    process each, joined in a process group through a file in a
    temporary directory (no port to collide on), and return the ranks'
    results in rank order (torch.save'd; keep them on the CPU).

    `device` is where the ranks compute: the card when None. On cards,
    rank r computes on card r % cards; with no more ranks than cards the
    transport is NCCL, else gloo (NCCL takes one card a rank, so two
    ranks that share one card talk over the host). The kernels must be
    built before: the ranks only load them. "cpu": every rank computes
    on the CPU with one thread (ranks share the host's cores), over gloo.
    A rank that fails, or a group that outlives `timeout_s`, fails the
    launch; every process is stopped before it returns or raises. fn and
    args must pickle (fn at a module's top)."""
    from .. import default_device

    device = default_device() if device is None else torch.device(device)
    per_card = 1
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("launch: no CUDA card; pass device='cpu' "
                               "to run the ranks on the CPU")
        per_card = -(-world_size // cards)
    backend = _backend(device, per_card)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="fembrain-ranks-") as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        outs = [Path(tmp) / f"rank{r}.pt" for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, args, r, world_size, init, backend, device, timeout_s,
            str(outs[r]))) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while (any(p.is_alive() for p in procs)
               and not any(p.exitcode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(
                f"ranks ended with exit codes {codes} (a rank's traceback "
                f"is on stderr; a negative code is a signal: stopped after "
                f"another rank failed or at {timeout_s:.0f} s)")
        return [torch.load(o, weights_only=False) for o in outs]
