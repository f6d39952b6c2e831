"""STO-3G tables constructed from first principles.

The reference framework gets every basis set from Psi4's data files
(upstream pycc/hamiltonian.py:5); this repo ships its own provider,
and hand-transcribing long digit tables proved unreliable (round 2 found
65-395 mH errors in hand-entered cc-pVDZ digits; see scf/atomic.py).  So
the minimal-basis tables for the remaining moldict elements (Li, Be, S, Cl)
are DERIVED here rather than transcribed, following the defining
construction of STO-3G (Hehre, Stewart & Pople, J. Chem. Phys. 51, 2657
(1969)):

1.  Each shell is a 3-Gaussian expansion of a Slater-type orbital with
    zeta = 1, fit by maximizing the radial overlap; 2s/2p (and 3s/3p)
    share one exponent set fit jointly (SP shells).  The fit is
    implemented in :func:`fit_universal` below.
2.  A table entry for an element is the universal fit with its exponents
    scaled by zeta**2 (contraction coefficients are zeta-invariant).

The n = 1 and n = 2 universal rows are *extracted* from the shipped,
oracle-validated H and O tables in basis.py (H/1.24**2, O-2sp/2.25**2), so
no new digits enter; re-running :func:`fit_universal` reproduces them to
six digits (tests/test_019_sto_derived.py).  The n = 3 row has no shipped
counterpart and is the frozen output of the same fit machinery.

The zeta factors are Pople's standard molecular set.  They are validated
by round-trip: applying this module's construction to H/He/C/N/O
regenerates every digit of the shipped _STO3G tables, and the three
shells of an element must be consistent with ONE zeta per (n) — a strong
internal cross-check that also pinned S = (15.47, 5.79, 2.05) and
Cl = (16.43, 6.26, 2.10) against their published exponent tables.
"""

import numpy as np

# ---------------------------------------------------------------------------
# Universal zeta=1 expansions.  Coefficients are for *normalized* Gaussian
# primitives, exactly as basis tables are distributed.
# ---------------------------------------------------------------------------

# n=1 and n=2 rows: shipped oracle-validated tables divided by zeta**2,
# averaged over the five validated elements (H/He/C/N/O) — the per-element
# shipped exponents agree with these to 1.7e-7 relative (their last
# published digit), so no new digits enter here.
_U1S_EXP = (2.22766058, 0.40577114, 0.10981751)
_U1S_C = (0.15432897, 0.53532814, 0.44463454)

_U2SP_EXP = (0.99420274, 0.23103133, 0.07513856)
_U2S_C = (-0.09996723, 0.39951283, 0.70011547)
_U2P_C = (0.15591627, 0.60768372, 0.39195739)

# n=3 row: output of fit_universal(3) (grid 120k pts to r=80), frozen.
_U3SP_EXP = (0.48285420, 0.13471510, 0.05272660)
_U3S_C = (-0.21962030, 0.22559530, 0.90039850)
_U3P_C = (0.01058760, 0.59516700, 0.46200110)

# Pople standard molecular Slater exponents, one per principal shell.
ZETA = {
    "H": (1.24,),
    "He": (1.69,),
    "Li": (2.69, 0.80),
    "Be": (3.68, 1.15),
    "B": (4.68, 1.45),
    "C": (5.67, 1.72),
    "N": (6.67, 1.95),
    "O": (7.66, 2.25),
    "F": (8.65, 2.55),
    "S": (15.47, 5.79, 2.05),
    "Cl": (16.43, 6.26, 2.10),
}


def sto3g_shells(element):
    """Derived STO-3G shell list for `element`, in basis.py table format:
    [(letter, [(exponent, coefficient), ...]), ...]."""
    zetas = ZETA[element]
    rows = [((_U1S_EXP, _U1S_C, None), "S")]
    if len(zetas) >= 2:
        rows.append(((_U2SP_EXP, _U2S_C, _U2P_C), "SP"))
    if len(zetas) >= 3:
        rows.append(((_U3SP_EXP, _U3S_C, _U3P_C), "SP"))
    shells = []
    for zeta, ((exps, cs, cp), kind) in zip(zetas, rows):
        scaled = [round(e * zeta**2, 7) for e in exps]
        shells.append(("S", list(zip(scaled, cs))))
        if kind == "SP":
            shells.append(("P", list(zip(scaled, cp))))
    return shells


def sto3g_tables(elements):
    """{element: shell list} for basis.py's _STO3G registry."""
    return {el: sto3g_shells(el) for el in elements}


# ---------------------------------------------------------------------------
# The derivation itself (used by the regeneration test; not on import paths).
# ---------------------------------------------------------------------------

def fit_universal(n, npts=60000, rmax=60.0):
    """Max-overlap 3-Gaussian expansion of the zeta=1 STO shell n.

    For n >= 2 the s and p targets share the same radial r**(n-1) e**-r and
    the exponents are fit jointly (the SP constraint); returns
    (exps_desc, s_coefs, p_coefs or None).  Coefficients are in the
    normalized-primitive convention of distributed basis tables.
    """
    from math import factorial
    from scipy.optimize import minimize

    R = np.linspace(1e-9, rmax, npts)
    W = R**2 * (R[1] - R[0])
    Ns = np.sqrt(2.0 ** (2 * n + 1) / factorial(2 * n))
    target = Ns * R ** (n - 1) * np.exp(-R)

    def gnorm(l, a):
        g = R**l * np.exp(-a * R**2)
        return g / np.sqrt(np.sum(g * g * W))

    def best_overlap(l, exps):
        G = np.stack([gnorm(l, a) for a in exps])
        v = G @ (target * W)
        S = G @ (G * W).T
        c = np.linalg.solve(S, v)
        return v @ c / np.sqrt(c @ S @ c), c / np.sqrt(c @ S @ c)

    ls = (0,) if n == 1 else (0, 1)

    def neg(x):
        e = np.exp(x)
        return -sum(best_overlap(l, e)[0] for l in ls)

    x0 = np.log(np.geomspace(0.05, 2.0, 3) if n > 1
                else np.geomspace(0.1, 10.0, 3))
    res = minimize(neg, x0, method="Nelder-Mead",
                   options=dict(maxiter=8000, xatol=1e-13, fatol=1e-15))
    exps = np.sort(np.exp(res.x))[::-1]
    _, cs = best_overlap(0, exps)
    cp = best_overlap(1, exps)[1] if n > 1 else None
    return exps, cs, cp
