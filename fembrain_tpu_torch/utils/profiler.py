"""Profiler (reference `Profiler` singleton + RAII ProfileAutoEvent,
src/base/Profiler.h:25-138): named timing sessions aggregating avg/low/high,
stage spans in torch.profiler traces, and a hook that records such a
trace.

Counterpart of fembrain_tpu/utils/profiler.py. `Profiler.event` times a
block on the host clock: work on the card is queued asynchronously, so
that is the time to enqueue it unless the block itself synchronises.
`span` names a stage in the trace of a running torch.profiler, on the
clock of its device events; with no profile recording it does nothing.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A stage of the program, `with span("fem.step"): ...`: a host range
    named `name` in the trace while a profile records, else a shared
    no-op context. It adds no synchronise, no event and no tensor, so the
    work it wraps runs as it would without it.

    The range is a function-scope record (`_RecordFunctionFast`), not a
    user annotation (`torch.profiler.record_function`): Kineto gives each
    user annotation a device-side twin typed as a CUDA event, which a
    reader of the device's operations would count as a kernel launch and
    as busy time. Kernels still link to their stage through the host
    tree: each carries the correlation id of the innermost host range
    that launched it."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


class _Event:
    """One timing block: appends its host seconds to `samples` on exit,
    also when the block raises, and opens `span(name)` around it."""

    def __init__(self, name: str, samples: list[float]):
        self.name, self.samples = name, samples

    def __enter__(self):
        self.span = span(self.name)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self.t0)
        return self.span.__exit__(*exc)


class Profiler:
    def __init__(self):
        self._samples: dict[str, list[float]] = defaultdict(list)

    def event(self, name: str) -> _Event:
        """RAII-style timing block (reference ProfileAutoEvent) and a
        span of the same name."""
        return _Event(name, self._samples[name])

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def stats(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            out[name] = {
                "count": len(xs),
                "avg_ms": 1e3 * sum(xs) / len(xs),
                "low_ms": 1e3 * min(xs),
                "high_ms": 1e3 * max(xs),
            }
        return out

    def reset(self) -> None:
        self._samples.clear()


@contextlib.contextmanager
def xprof_trace(logdir: str | Path):
    """torch.profiler trace of the block (the `--xprof` CLI flag uses
    this): CPU activity and the spans, and the card's where there is one,
    written as a Chrome trace JSON into `logdir`."""
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile() as prof:
        yield prof
    stamp = time.strftime("%Y%m%d_%H%M%S")
    prof.export_chrome_trace(str(out / f"trace_{stamp}_{os.getpid()}.json"))


_the_profiler: Profiler | None = None


def the_profiler() -> Profiler:
    global _the_profiler
    if _the_profiler is None:
        _the_profiler = Profiler()
    return _the_profiler
