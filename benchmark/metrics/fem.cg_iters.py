"""CG iterations of the coupled frame's FEM solve, the mean over the
traced run's window (solve_stats["forward_iters"] of every frame)."""


def read(r):
    it = [v for v in r.counters.get("forward_iters", []) if v is not None]
    return sum(it) / len(it) if it else None
