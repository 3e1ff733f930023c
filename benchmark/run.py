"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (fembrain_tpu_torch/) and
its data. With --trace 0 the result's metrics are the cell's end-to-end
metrics; with --trace 1 its per-layer metrics, read from a stretch of the
window recorded by torch.profiler. Either way the run ends by comparing
what the timed path produced with the plain reference in
benchmark/reference/, and prints each compared number beside its limit.
Exits non-zero without a result when there is no CUDA card (or fewer
than the cell asks for), when the port or its data are missing, or when
JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Kernel and compiler caches at fixed paths inside the checkout; the
# port's own nvcc build goes to fembrain_tpu_torch/_build/.
CACHE = ROOT / ".bench_cache"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def result_line(cell, res: dict, trace: int) -> dict:
    from harness import bench, runtime

    correct, checks = runtime.judge(res["compared"], cell.limits)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = bench.metric_reader(cell, m["name"]).read(res["readings"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics,
           "device": res["device"]}
    if trace:
        out["breakdown"] = res["breakdown"]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness import bench, runtime

    try:
        cell = bench.resolve(args.workload, root=ROOT)
    except (KeyError, FileNotFoundError) as e:
        return fail(f"cannot resolve workload {args.workload!r}: {e}")
    missing = [p for p in ("fembrain_tpu_torch/__init__.py",
                           "fembrain_tpu_torch/csrc", cell.config["scene"])
               if not (ROOT / p).exists()]
    if missing:
        return fail("the checkout lacks " + ", ".join(missing))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    import torch

    # The card does the work; host threads beyond the launching one only
    # contend with it for the host's cores.
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        return fail("no CUDA card")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} present")
    res = bench.kind_module(cell).run(cell, args.seed, args.seconds,
                                      args.trace, torch.device("cuda", 0),
                                      T_START)
    found = runtime.forbidden_modules()
    if found:
        return fail("loaded " + ", ".join(found))
    runtime.emit(result_line(cell, res, args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
