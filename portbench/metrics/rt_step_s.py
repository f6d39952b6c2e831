"""rt_step_s: seconds an integrator step of real-time CC with the dipole
read on the host, the whole window over the steps it completed."""


def read(run):
    return run.seconds_per_unit() if run.kind == "rt" else None
