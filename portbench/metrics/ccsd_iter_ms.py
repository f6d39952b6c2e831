"""ccsd_iter_ms.<cell suffix>: milliseconds a solver iteration (residual, Jacobi
step, DIIS, one host read), ccwfn.timers 'ccwfn.iteration', total over
count across the traced window's jobs."""


def read(run):
    if run.kind != "cc":
        return None
    n = sum(u["iters"] for u in run.units)
    return 1e3 * sum(u["iter_s"] for u in run.units) / n if n else None
