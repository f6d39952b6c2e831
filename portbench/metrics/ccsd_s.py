"""ccsd_s, ccsd_s.<cell suffix>: seconds from the SCF's output to a converged CCSD energy, the whole
window over the jobs it completed (host clock)."""


def read(run):
    return run.seconds_per_unit() if run.kind == "cc" else None
