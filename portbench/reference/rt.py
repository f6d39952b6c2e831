"""Real-time CCSD, plain: the right-hand side, one rk4 step, the dipole.

y = (t1, t2, l1, l2, phase) flattened, complex128.  Under the field the
Fock matrix is F0 + mu_tot V(t), mu_tot = (mu_x + mu_y + mu_z) / sqrt(3);
the right-hand side is (-i R_T, +i R_Lambda with HBAR rebuilt from that F,
-i times the quasienergy).  The dipole is the CCSD one-particle density
against the dipole integrals.
"""

import math

import torch

from .ccsd import build_tau, residuals_ccsd, slices
from .ein import ein
from .lam import build_hbar, lambda_residuals


class Gaussian:
    """F_str exp(-(t - t0)^2 / (2 sigma^2)) cos(omega (t - t0))."""

    def __init__(self, F_str, omega, sigma, center):
        self.F_str, self.omega = F_str, omega
        self.sigma2, self.t0 = sigma ** 2, center

    def __call__(self, t):
        dt = t - self.t0
        return (self.F_str * math.exp(-dt ** 2 / (2 * self.sigma2))
                * math.cos(self.omega * dt))


class RT:
    """The plain real-time CCSD system of one Hamiltonian."""

    def __init__(self, F0, ERI, L, vvvv, mu, no, V):
        self.F0, self.ERI, self.L, self.vvvv = F0, ERI, L, vvvv
        self.mu = mu
        self.mu_tot = sum(mu) / math.sqrt(3.0)
        self.no = no
        self.nv = F0.shape[0] - no
        self.V = V
        o = slice(0, no)
        self.loooo_tr = ein("ijij->", L[o, o, o, o])
        self.Loovv = L[o, o, slice(no, None), slice(no, None)]

    def split(self, y):
        no, nv = self.no, self.nv
        n1, n2 = no * nv, (no * nv) ** 2
        return (y[:n1].reshape(no, nv), y[n1:n1 + n2].reshape(no, no, nv, nv),
                y[n1 + n2:2 * n1 + n2].reshape(no, nv),
                y[2 * n1 + n2:-1].reshape(no, no, nv, nv), y[-1])

    def field(self, t):
        F = self.F0.to(torch.complex128)
        if self.V is None:
            return F
        return F + self.mu_tot.to(torch.complex128) * float(self.V(t))

    def f(self, t, y):
        no = self.no
        o, v = slices(no)
        t1, t2, l1, l2, _ = self.split(y)
        F = self.field(t)
        rt1, rt2 = residuals_ccsd(F, self.ERI, self.L, self.vvvv, t1, t2, no)
        H = build_hbar(F, self.ERI, self.L, self.vvvv, t1, t2, no)
        rl1, rl2 = lambda_residuals(H, self.L, t2, l1, l2, no)
        del H
        eref = 2.0 * torch.trace(F[o, o]) - self.loooo_tr
        ecc = (2.0 * ein("ia,ia->", F[o, v], t1)
               + ein("ijab,ijab->", build_tau(t1, t2), self.Loovv))
        return torch.cat([(rt1 * -1j).reshape(-1), (rt2 * -1j).reshape(-1),
                          (rl1 * 1j).reshape(-1), (rl2 * 1j).reshape(-1),
                          ((eref + ecc) * -1j).reshape(1)])

    def rk4(self, t, y, h):
        k1 = self.f(t, y)
        k2 = self.f(t + 0.5 * h, y + 0.5 * h * k1)
        k3 = self.f(t + 0.5 * h, y + 0.5 * h * k2)
        k4 = self.f(t + h, y + h * k3)
        return y + h * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0

    def dipole(self, y):
        """(mu_x, mu_y, mu_z) as a complex128 tensor of 3."""
        t1, t2, l1, l2, _ = self.split(y)
        D = onepdm(t1, t2, l1, l2, self.no)
        return torch.stack([torch.sum(m.to(D.dtype) * D) for m in self.mu])


def onepdm(t1, t2, l1, l2, no):
    """The CCSD one-particle density, (nact, nact)."""
    o, v = slices(no)
    nact = no + t1.shape[1]
    D = torch.zeros((nact, nact), dtype=t1.dtype, device=t1.device)
    D[o, o] = -ein("imef,jmef->ij", t2, l2) - ein("ie,je->ij", t1, l1)
    D[v, v] = ein("mnbe,mnae->ab", t2, l2) + ein("mb,ma->ab", t1, l1)
    Dov = 2.0 * t1
    Dov = Dov + 2.0 * ein("me,imae->ia", l1, t2)
    Dov = Dov - ein("me,miae->ia", l1, build_tau(t1, t2))
    Dov = Dov - ein("mi,ma->ia", ein("mnef,inef->mi", l2, t2), t1)
    Dov = Dov - ein("ea,ie->ia", ein("mnef,mnaf->ea", l2, t2), t1)
    D[o, v] = Dov
    D[v, o] = l1.T
    return D
