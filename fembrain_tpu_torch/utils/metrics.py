"""Experiment metrics sink (reference `DBLogger` -> sqlite,
src/deformable/DBLogger.h:25-111): per-frame records of solver/frame
timings, mesh stats, material params; JSONL primary sink with an optional
sqlite mirror for parity with the reference's schema.

Counterpart of fembrain_tpu/utils/metrics.py, host Python, the same
record and files.
"""
from __future__ import annotations

import dataclasses
import json
import sqlite3
import time
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Record:
    """Field set mirrors the reference DBLogger::Record (DBLogger.h:31-61)."""

    model_name: str = ""
    ct_elements: int = 0
    ct_vertices: int = 0
    rest_volume: float = 0.0
    total_volume: float = 0.0
    young_modulo: float = 0.0
    poisson_ratio: float = 0.0
    ms_anim_total_frame: float = 0.0
    ms_anim_sys_solver: float = 0.0
    ms_anim_apply_displacements: float = 0.0
    ms_poly_triangle_mesh: float = 0.0
    ms_poly_tetrahedra_mesh: float = 0.0
    ms_rbf_creation: float = 0.0
    ms_rbf_evaluation: float = 0.0
    fps: float = 0.0
    solver_threads: int = 1
    cg_iters: int = 0
    element_type: str = "TET"
    force_model: str = "COROTATIONAL LINEAR FEM"
    integrator: str = "JACOBI PRECONDITIONED CG"
    timestamp: str = ""


class MetricsLogger:
    """Batched metric writer (the reference batches 32 records and inserts
    on a TBB task thread, DBLogger.h:95-109; here batching is just buffered
    writes flushed on size or close)."""

    BATCH = 32

    def __init__(self, jsonl_path: str | Path | None = None,
                 sqlite_path: str | Path | None = None):
        self.jsonl_path = Path(jsonl_path) if jsonl_path else None
        self.sqlite_path = Path(sqlite_path) if sqlite_path else None
        self._buf: list[Record] = []
        self.last: Record | None = None
        self._db = None
        if self.sqlite_path:
            self._db = sqlite3.connect(self.sqlite_path)
            cols = ", ".join(
                f"{f.name} TEXT" if f.type == "str" else f"{f.name} REAL"
                for f in dataclasses.fields(Record)
            )
            self._db.execute(f"CREATE TABLE IF NOT EXISTS experiments ({cols})")

    def append(self, rec: Record) -> None:
        if not rec.timestamp:
            rec.timestamp = time.strftime("%Y-%m-%d %H:%M:%S")
        self.last = rec  # most recent record (feeds the live HUD rows)
        self._buf.append(rec)
        if len(self._buf) >= self.BATCH:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as fh:
                for rec in self._buf:
                    fh.write(json.dumps(dataclasses.asdict(rec)) + "\n")
        if self._db is not None:
            fields = dataclasses.fields(Record)
            ph = ", ".join("?" for _ in fields)
            rows = [
                tuple(getattr(r, f.name) for f in fields) for r in self._buf
            ]
            self._db.executemany(f"INSERT INTO experiments VALUES ({ph})", rows)
            self._db.commit()
        self._buf.clear()

    def close(self) -> None:
        self.flush()
        if self._db is not None:
            self._db.close()
            self._db = None
