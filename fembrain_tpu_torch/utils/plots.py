"""Perf-plot script generation (reference GNUPLOT_Driver,
src/implicit/GNUPLOT_Driver.{h,cpp}): emit gnuplot scripts + data files
from metric records so perf history can be plotted outside the run.

Counterpart of fembrain_tpu/utils/plots.py, host Python.
"""
from __future__ import annotations

import json
from pathlib import Path


def write_gnuplot(
    jsonl_path: str | Path,
    out_prefix: str | Path,
    fields: tuple[str, ...] = ("ms_anim_total_frame", "fps", "cg_iters"),
    title: str = "fembrain_tpu perf",
) -> Path:
    """Read a metrics JSONL (utils.metrics) and write `<prefix>.dat` +
    `<prefix>.gp`; returns the script path."""
    rows = [
        json.loads(line)
        for line in Path(jsonl_path).read_text().splitlines()
        if line.strip()
    ]
    out_prefix = Path(out_prefix)
    dat = out_prefix.with_suffix(".dat")
    gp = out_prefix.with_suffix(".gp")

    with open(dat, "w") as fh:
        fh.write("# frame " + " ".join(fields) + "\n")
        for i, r in enumerate(rows):
            vals = " ".join(str(r.get(f, 0)) for f in fields)
            fh.write(f"{i} {vals}\n")

    lines = [
        f'set title "{title}"',
        "set xlabel 'frame'",
        "set key outside",
        f'set output "{out_prefix.name}.png"',
        "set terminal pngcairo size 900,500",
        "plot "
        + ", ".join(
            f'"{dat.name}" using 1:{i + 2} with lines title "{f}"'
            for i, f in enumerate(fields)
        ),
    ]
    gp.write_text("\n".join(lines) + "\n")
    return gp
