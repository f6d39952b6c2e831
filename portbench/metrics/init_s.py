"""init_s.<cell suffix>: seconds of the ccwfn constructor a job (the Hamiltonian's
host-to-device copy and MO transform, or the factors carried over), the
harness's span around it ending in a device synchronisation; the mean
over the traced window's jobs."""


def read(run):
    if run.kind != "cc":
        return None
    return sum(u["init_s"] for u in run.units) / len(run.units)
