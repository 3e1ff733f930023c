"""CG iterations of a training step, forward and adjoint solves together
(solve_stats "forward_iters" + "adjoint_iters"), the mean over the
traced run's window."""


def read(r):
    pairs = [(f, a) for f, a in zip(r.counters.get("forward_iters", []),
                                    r.counters.get("adjoint_iters", []))
             if f is not None and a is not None]
    return sum(f + a for f, a in pairs) / len(pairs) if pairs else None
