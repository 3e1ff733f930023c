"""Share of the traced frames' window in which no device operation
runs: 1 - (union of the operations' intervals) / window."""


def read(r):
    return 1.0 - r.busy_s / r.window_s if r.ops and r.window_s > 0 else None
