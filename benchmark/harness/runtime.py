"""What every kind of cell shares: the device, the closed-loop window,
the profiled stretch and its reading, the result line.

End-to-end numbers are host-clock times around work that ends in a
device synchronise. A traced run records a stretch of the window with
torch.profiler and reads from it the device's busy time (the union of
its operations' intervals), each kernel's device time by name, the
operations that took most time and the longest idle gaps, each named by
the innermost host operation running across it.
"""
from __future__ import annotations

import dataclasses
import json
import re
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM: fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
TOP = 10
GAPS_NAMED = 500   # the longest gaps, each named by its host op
FORBIDDEN = ("jax", "jaxlib", "flax", "fembrain_tpu")


def additive_kernel(mode: int) -> tuple:
    """Device names of the port's additive tile kernel in `mode` (0 K1
    rest, 1 K2 Wendland, 2 K4 biharmonic), demangled and mangled."""
    return (f"trace_additive_kernel<{mode},", f"trace_additive_kernelILi{mode}E")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Window:
    """The closed loop's record: per frame (or step) host latency."""

    start: float = 0.0
    end: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)

    def frame_ms(self) -> float:
        return (self.end - self.start) * 1e3 / len(self.latencies)

    def p90_ms(self) -> float:
        return float(np.percentile(self.latencies, 90.0)) * 1e3


@dataclasses.dataclass
class Readings:
    """What a traced run hands the per-layer metric readers."""

    ops: list              # device operations (name, start_us, end_us)
    window_s: float        # host-clock length of the traced stretch
    busy_s: float          # union of the device operations' intervals
    units: int             # frames (or steps) traced
    counters: dict         # per frame / step lists, e.g. forward_iters
    bound_s: dict          # kernel tag -> least time for its counted frame
    kernels: dict          # kernel tag -> substrings of its device name

    def kernel_times(self, tag: str) -> list:
        """Device seconds of each launch of kernel `tag`, in order."""
        keys = self.kernels.get(tag, ())
        return [(e - s) * 1e-6 for n, s, e in self.ops
                if any(k in n for k in keys)]

    def launches(self) -> int:
        return sum(1 for n, _, _ in self.ops
                   if not n.startswith(("Memcpy", "Memset")))


class Profiled:
    """A stretch recorded by torch.profiler; `open()` and `close()` are
    called between frames (each after a device synchronise)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = 0.0

    def open(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def close(self):
        sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def read(self):
        """(device ops, host ops) as (name, start_us, end_us) lists."""
        dev, host = [], []
        for e in self.prof.events():
            rec = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append(rec)
            else:
                host.append(rec)
        return sorted(dev, key=lambda r: r[1]), host


def busy_and_gaps(ops, host):
    """Union length of the device intervals (s), and the longest idle
    gaps between them summed by the innermost host op spanning each
    gap's middle, largest sums first."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, e in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_host = {}
    if host and gaps:
        names = [n for n, _, _ in host]
        hs = np.array([s for _, s, _ in host], np.float64)
        he = np.array([e for _, _, e in host], np.float64)
        length = he - hs
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
            mid = 0.5 * (a + b)
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            name = (names[inside[np.argmin(length[inside])]]
                    if inside.size else "host idle")
            by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return busy * 1e-6, [[n, v] for n, v in top]


FUNCTORS = (r"binary_internal::(\w+?)Functor", r"CUDAFunctor_(\w+)",
            r"(\w+?)_kernel_cuda", r"(\w+?)_kernel_impl\(",
            r"(\w+?)_functor")


def short(name: str) -> str:
    """A device operation's name without its template arguments: the
    kernel, the functor of an elementwise or reduction kernel in
    brackets (`vectorized_elementwise_kernel[maximum]`), the mode of the
    port's additive tile kernel (`trace_additive_kernel<1>`)."""
    m = re.search(r"(\w*kernel\w*)<([^,>]*)", name)
    if m is None:
        return name[:60]
    if m.group(1) == "trace_additive_kernel":
        return f"trace_additive_kernel<{m.group(2)}>"
    for pat in FUNCTORS:
        f = re.search(pat, name)
        if f:
            return f"{m.group(1)}[{f.group(1)}]"
    return m.group(1)


def device_top(ops):
    by = {}
    for n, s, e in ops:
        n = short(n)
        by[n] = by.get(n, 0.0) + (e - s) * 1e-6
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def readings(prof: Profiled, units, counters, bound_s, kernels):
    ops, host = prof.read()
    busy, gaps = busy_and_gaps(ops, host)
    r = Readings(ops=ops, window_s=prof.t1 - prof.t0, busy_s=busy,
                 units=units, counters=counters, bound_s=bound_s,
                 kernels=kernels)
    return r, {"device_ops": device_top(ops), "idle_gaps": gaps}


def device_info(device, chips: int) -> dict:
    d = torch.device(device)
    if d.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


GAP_TOL = 1e-3   # field units: a ray whose depth departs by more


def trace_gap(t, hit, t_ref, hit_ref, rise, resid) -> dict:
    """How the program's trace (t, hit) stands against the reference's.
    Compared: `trace_surface_gap`, the largest over the program's hits of
    |f - iso| at its hit point in the reference's field (`resid`; an
    answer off the surface reads high, a different crossing of the same
    surface does not); `trace_gap_rays`, the rays both hit whose depth
    departs from the reference's by more than GAP_TOL in field units
    (|t - t_ref| times the field's rise along the ray at the reference's
    root); `trace_hit_flips`, the rays whose hit differs. Also read, not
    compared: the largest such field gap and |t - t_ref|. On a ray that
    grazes the surface the step pattern decides which crossing a march
    takes: a sound run now and then reads one gap ray there, and these
    two then read high."""
    both = hit & hit_ref
    gap = torch.abs(t - t_ref) * torch.abs(rise)
    any_both = bool(both.any())
    return {
        "trace_surface_gap": float(resid[hit].max()) if bool(hit.any())
        else 0.0,
        "trace_gap_rays": int((both & (gap > GAP_TOL)).sum()),
        "trace_hit_flips": int((hit != hit_ref).sum()),
        "trace_field_gap": float(gap[both].max()) if any_both else 0.0,
        "trace_max_dt": float(torch.abs(t - t_ref)[both].max())
        if any_both else 0.0,
    }


def worst(acc: dict, r: dict) -> dict:
    """The run's reading of each number: the largest over its frames (a
    sum for counts)."""
    out = dict(acc)
    for k, v in r.items():
        if k in out:
            out[k] = out[k] + v if isinstance(v, int) else max(out[k], v)
    return out


def note(frame: dict, r: dict) -> None:
    """One checked frame's readings, on stderr."""
    where = {k: frame[k] for k in ("frame", "roll") if k in frame}
    print("checked " + json.dumps({**where, **r}), file=sys.stderr)


def judge(readings_: dict, limits: dict) -> tuple:
    """(correct, checks): every compared number beside its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = readings_.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def emit(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    stderr, then the result line as the last line of stdout."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} <= {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
