"""Time-dependent laser-field envelopes V(t).

The counterpart of pycc_tpu/rt/lasers.py.  The integrators hand V a Python
float t, so each envelope is plain `math` on floats and returns a Python
float: nothing is traced here, so no branch-free form is needed.
"""

import math


class gaussian_laser:
    def __init__(self, F_str, omega, sigma, center=0.0):
        self.F_str = F_str
        self.omega = omega
        self.sigma2 = sigma ** 2
        self.t0 = center

    def __call__(self, t):
        dt = t - self.t0
        return (self.F_str * math.exp(-dt ** 2 / (2 * self.sigma2))
                * math.cos(self.omega * dt))


class sine_square_laser:
    def __init__(self, F_str, omega, tprime, phase=0):
        self.F_str = F_str
        self.omega = omega
        self.tprime = tprime
        self.phase = phase

    def __call__(self, t):
        if t < 0 or t > self.tprime:
            return 0.0
        return (math.sin(math.pi * t / self.tprime) ** 2
                * math.cos(self.omega * t + self.phase) * self.F_str)


class delta_pulse_laser:
    def __init__(self, F_str, center=0.0, tol=1e-7):
        self.F_str = F_str
        self.center = center
        self.tol = tol

    def __call__(self, t):
        return self.F_str * 1.0 if abs(t - self.center) <= self.tol else 0.0


class lrcw_laser:
    """Linearly-ramped continuous wave; nr=0 gives a plain cosine wave."""

    def __init__(self, F_str, omega, nr):
        self.F_str = F_str
        self.omega = omega
        self.nr = nr

    def __call__(self, t):
        tc = 2 * math.pi / self.omega * self.nr
        ramp = t / tc if (t <= tc and tc > 0) else 1.0
        return ramp * self.F_str * math.cos(self.omega * t)


class qrcw_laser:
    """Quadratically-ramped continuous wave."""

    def __init__(self, F_str, omega, nr):
        self.F_str = F_str
        self.omega = omega
        self.nr = nr

    def __call__(self, t):
        tc = 2 * math.pi / self.omega * self.nr
        tsafe = max(tc, 1e-300)
        if t <= 0.5 * tc:
            ramp = 2 * t ** 2 / tsafe ** 2
        elif t <= tc:
            ramp = 1 - 2 * (t - tc) ** 2 / tsafe ** 2
        else:
            ramp = 1.0
        return ramp * self.F_str * math.cos(self.omega * t)
