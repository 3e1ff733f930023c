"""Host milliseconds of the probe stage a frame (Deformable.probe_forces:
the positions' read to the host, the contact query, the ring forces and
the load's copy back; its stats["host_ms"]), the mean over the traced
run's window. None where the program counts no probe stage."""


def read(r):
    ms = [v for v in r.counters.get("probe_host_ms", []) if v is not None]
    return sum(ms) / len(ms) if ms else None
