"""Profiler (reference `Profiler` singleton + RAII ProfileAutoEvent,
src/base/Profiler.h:25-138): named timing sessions aggregating avg/low/high,
text or JSONL output, plus a hook into torch.profiler traces.

Counterpart of fembrain_tpu/utils/profiler.py. Work on the card is queued
asynchronously, so a wall time of it needs a synchronisation at its end;
`timed_readback` wraps that pattern.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict
from pathlib import Path

import torch


class _Event:
    """One timing block: appends its seconds to `samples` on exit, also
    when the block raises."""

    def __init__(self, samples: list[float]):
        self.samples = samples

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self.t0)
        return False


class Profiler:
    def __init__(self):
        self._samples: dict[str, list[float]] = defaultdict(list)

    def event(self, name: str) -> _Event:
        """RAII-style timing block (reference ProfileAutoEvent)."""
        return _Event(self._samples[name])

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

    def write_text(self, path: str | Path) -> None:
        lines = [
            f"{name}: n={s['count']} avg={s['avg_ms']:.3f}ms "
            f"low={s['low_ms']:.3f}ms high={s['high_ms']:.3f}ms"
            for name, s in self.stats().items()
        ]
        Path(path).write_text("\n".join(lines) + "\n")

    def write_jsonl(self, path: str | Path) -> None:
        with open(path, "a") as fh:
            for name, s in self.stats().items():
                fh.write(json.dumps({"event": name, **s}) + "\n")

    def reset(self) -> None:
        self._samples.clear()


def _tensors(x):
    """The tensors in a nest of tuples, lists, dicts and dataclasses."""
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def timed_readback(fn, *args) -> tuple[float, object]:
    """Run fn(*args) and return (seconds, output); when an output tensor
    lies on the card, the time ends with `torch.cuda.synchronize()`, so it
    covers the device work and not only its launch."""
    t0 = time.perf_counter()
    out = fn(*args)
    cuda = {t.device for t in _tensors(out) if t.is_cuda}
    for device in cuda:
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


@contextlib.contextmanager
def xprof_trace(logdir: str | Path):
    """torch.profiler trace of the block (the `--xprof` CLI flag uses
    this): CPU activity, and the card's where there is one, written as a
    Chrome trace JSON into `logdir`."""
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
