"""t_s.ccsd_t: seconds of the (T) driver a job, ccwfn.timers
'ccwfn.triples', the mean over the traced window's jobs."""


def read(run):
    if run.kind != "cc" or run.traffic["model"] != "CCSD(T)":
        return None
    return sum(u["triples_s"] for u in run.units) / len(run.units)
