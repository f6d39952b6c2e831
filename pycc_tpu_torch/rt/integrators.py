"""ODE integrators for real-time CC propagation.

The counterpart of pycc_tpu/rt/integrators.py, tableau for tableau: the
explicit fixed-step family (euler ... rk38), the embedded adaptive pairs
(hr, fehlberg, bs, ck, DOPRI5) with the step control of the `ck`
protocol, and implicit Gauss-Legendre collocation (gl4, gl6) solved by
fixed-point iteration.

Each integrator is a plain callable, `ODE(f, t, y) -> y_new` (adaptive:
`ODE(f, t, y, h0) -> (y_new, h_used, h_next)`), and pure arithmetic on
`y`: a torch tensor stays on its device across stages and steps, and a
numpy array stays a numpy array.  The adaptive error norm and the
Gauss-Legendre increment are one host read each (`_norm`).
"""

import numpy as np
import torch

from ..utils.log import logger as log


def _norm(x):
    """||x||_2 as a Python float: one host read for a tensor."""
    if isinstance(x, torch.Tensor):
        return torch.linalg.vector_norm(x).item()
    return float(np.linalg.norm(np.asarray(x)))


def _stages(tableau, f, t, y, h):
    ks = []
    for i, ci in enumerate(tableau.C):
        yi = y
        for j, aij in enumerate(tableau.A[i]):
            if aij != 0.0:
                yi = yi + h * aij * ks[j]
        ks.append(f(t + ci * h, yi))
    return ks


def _combine(y, h, weights, ks):
    out = y
    for bi, ki in zip(weights, ks):
        if bi != 0.0:
            out = out + h * bi * ki
    return out


class _ExplicitRK:
    """Fixed-step explicit Runge-Kutta from a Butcher tableau."""

    A = []          # lower-triangular stage coefficients (list of rows)
    B = []          # output weights
    C = []          # nodes

    def __init__(self, h):
        self.h = float(h)

    def __call__(self, f, t, y):
        return _combine(y, self.h, self.B, _stages(self, f, t, y, self.h))


class euler(_ExplicitRK):
    A = [[]]
    B = [1.0]
    C = [0.0]


class midpoint(_ExplicitRK):
    A = [[], [0.5]]
    B = [0.0, 1.0]
    C = [0.0, 0.5]


class heun(_ExplicitRK):
    A = [[], [1.0]]
    B = [0.5, 0.5]
    C = [0.0, 1.0]


class rk2(_ExplicitRK):
    """Ralston's 2nd-order method."""
    A = [[], [2.0 / 3.0]]
    B = [0.25, 0.75]
    C = [0.0, 2.0 / 3.0]


class rk3(_ExplicitRK):
    A = [[], [0.5], [-1.0, 2.0]]
    B = [1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0]
    C = [0.0, 0.5, 1.0]


class rk4(_ExplicitRK):
    A = [[], [0.5], [0.0, 0.5], [0.0, 0.0, 1.0]]
    B = [1.0 / 6.0, 2.0 / 6.0, 2.0 / 6.0, 1.0 / 6.0]
    C = [0.0, 0.5, 0.5, 1.0]


class rk38(_ExplicitRK):
    """Kutta's 3/8-rule 4th-order method."""
    A = [[], [1.0 / 3.0], [-1.0 / 3.0, 1.0], [1.0, -1.0, 1.0]]
    B = [1.0 / 8.0, 3.0 / 8.0, 3.0 / 8.0, 1.0 / 8.0]
    C = [0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0]


# ---------------------------------------------------------------------------
# Embedded adaptive pairs
# ---------------------------------------------------------------------------

class _EmbeddedRK:
    """Adaptive embedded pair with the `ck` step-control protocol: call as
    ODE(f, t, y, h0) -> (y_new, h_used, h_next)."""

    A = []
    B_low = []      # propagated solution weights
    B_high = []     # error-estimate solution weights
    C = []
    order = 4       # order used in the step-size exponent

    def __init__(self, maxiter=10, yconv=1e-7):
        self.maxiter = int(maxiter)
        self.yconv = float(yconv)

    def __call__(self, f, t, y, h0):
        h = float(h0)
        h_new = h
        for _ in range(self.maxiter):
            ks = _stages(self, f, t, y, h)
            y1 = _combine(y, h, self.B_low, ks)
            y2 = _combine(y, h, self.B_high, ks)
            err = _norm(y1 - y2)
            if err < self.yconv:
                h_new = 0.84 * h * (self.yconv / max(err, 1e-300)) ** (
                    1.0 / (self.order + 1))
                return y1, h, h_new
            h_new = 0.84 * h * (self.yconv / err) ** (1.0 / self.order)
            h = h_new
        log.info("y did not converge within %d iterations \n" % self.maxiter)
        return y1, h, h_new


class hr(_EmbeddedRK):
    """Heun-Euler 1(2) pair."""
    A = [[], [1.0]]
    B_low = [1.0, 0.0]
    B_high = [0.5, 0.5]
    C = [0.0, 1.0]
    order = 1


class fehlberg(_EmbeddedRK):
    """Fehlberg's RK1(2) pair."""
    A = [[], [0.5], [1.0 / 256.0, 255.0 / 256.0]]
    B_low = [1.0 / 256.0, 255.0 / 256.0, 0.0]
    B_high = [1.0 / 512.0, 255.0 / 256.0, 1.0 / 512.0]
    C = [0.0, 0.5, 1.0]
    order = 2


class bs(_EmbeddedRK):
    """Bogacki-Shampine 3(2) pair."""
    A = [[], [0.5], [0.0, 0.75], [2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0]]
    B_low = [2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0, 0.0]
    B_high = [7.0 / 24.0, 0.25, 1.0 / 3.0, 0.125]
    C = [0.0, 0.5, 0.75, 1.0]
    order = 3


class ck(_EmbeddedRK):
    """Cash-Karp 4(5) pair."""
    A = [[],
         [0.2],
         [3.0 / 40.0, 9.0 / 40.0],
         [0.3, -0.9, 1.2],
         [-11.0 / 54.0, 2.5, -70.0 / 27.0, 35.0 / 27.0],
         [1631.0 / 55296.0, 175.0 / 512.0, 575.0 / 13824.0,
          44275.0 / 110592.0, 253.0 / 4096.0]]
    B_low = [37.0 / 378.0, 0.0, 250.0 / 621.0, 125.0 / 594.0, 0.0,
             512.0 / 1771.0]
    B_high = [2825.0 / 27648.0, 0.0, 18575.0 / 48384.0, 13525.0 / 55296.0,
              277.0 / 14336.0, 0.25]
    C = [0.0, 0.2, 0.3, 0.6, 1.0, 0.875]
    order = 4


class DOPRI5(_EmbeddedRK):
    """Dormand-Prince 5(4) pair."""
    A = [[],
         [0.2],
         [3.0 / 40.0, 9.0 / 40.0],
         [44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0],
         [19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0,
          -212.0 / 729.0],
         [9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0,
          -5103.0 / 18656.0],
         [35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0,
          -2187.0 / 6784.0, 11.0 / 84.0]]
    B_low = [35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0,
             -2187.0 / 6784.0, 11.0 / 84.0, 0.0]
    B_high = [5179.0 / 57600.0, 0.0, 7571.0 / 16695.0, 393.0 / 640.0,
              -92097.0 / 339200.0, 187.0 / 2100.0, 1.0 / 40.0]
    C = [0.0, 0.2, 0.3, 0.8, 8.0 / 9.0, 1.0, 1.0]
    order = 5


# ---------------------------------------------------------------------------
# Implicit Gauss-Legendre collocation
# ---------------------------------------------------------------------------

class _GaussLegendre:
    A = None
    B = None
    C = None

    def __init__(self, h, Z_conv=1e-7, maxiter=10):
        self.h = float(h)
        self.Z_conv = float(Z_conv)
        self.maxiter = int(maxiter)

    def __call__(self, f, t, y):
        h = self.h
        s = len(self.B)
        F = [f(t + self.C[m] * h, y) for m in range(s)]
        Z = [0.0 * Fi for Fi in F]
        for _ in range(self.maxiter):
            F = [f(t + self.C[m] * h, y + Z[m]) for m in range(s)]
            Z_new = [h * sum(self.A[m][j] * F[j] for j in range(s))
                     for m in range(s)]
            delta = sum(_norm(Z_new[m] - Z[m]) for m in range(s))
            Z = Z_new
            if delta < self.Z_conv:
                F = [f(t + self.C[m] * h, y + Z[m]) for m in range(s)]
                break
        else:
            log.info("Z has not converged in %d iterations." % self.maxiter)
        return _combine(y, h, self.B, F)


class gl4(_GaussLegendre):
    """4th-order (2-stage) Gauss-Legendre collocation."""
    _s3 = np.sqrt(3.0)
    A = [[0.25, 0.25 - _s3 / 6.0], [0.25 + _s3 / 6.0, 0.25]]
    B = [0.5, 0.5]
    C = [0.5 - _s3 / 6.0, 0.5 + _s3 / 6.0]


class gl6(_GaussLegendre):
    """6th-order (3-stage) Gauss-Legendre collocation."""
    _s15 = np.sqrt(15.0)
    A = [[5.0 / 36.0, 2.0 / 9.0 - _s15 / 15.0, 5.0 / 36.0 - _s15 / 30.0],
         [5.0 / 36.0 + _s15 / 24.0, 2.0 / 9.0, 5.0 / 36.0 - _s15 / 24.0],
         [5.0 / 36.0 + _s15 / 30.0, 2.0 / 9.0 + _s15 / 15.0, 5.0 / 36.0]]
    B = [5.0 / 18.0, 4.0 / 9.0, 5.0 / 18.0]
    C = [0.5 - _s15 / 10.0, 0.5, 0.5 + _s15 / 10.0]
