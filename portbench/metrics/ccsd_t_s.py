"""ccsd_t_s: seconds from the SCF's output to a CCSD(T) energy, the whole
window over the jobs it completed (host clock)."""


def read(run):
    return run.seconds_per_unit() if run.kind == "cc" else None
