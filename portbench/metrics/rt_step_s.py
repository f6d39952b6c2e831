"""rt_step_s (and rt_step_s.<suffix>, such as rt_step_s.df, through the
fallback to this file): seconds an integrator step of real-time CC with
the dipole read on the host, the whole window over the steps it
completed; read in every run whose traffic names an `integrator`,
whatever its kind."""


def read(run):
    return run.seconds_per_unit() if "integrator" in run.traffic else None
