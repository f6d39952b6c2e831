"""LS-coupled spherically-equivalenced atomic HF: the cc-pVDZ construction.

The host copy of pycc_tpu/scf/atomic.py (numpy and scipy over this
package's own integral engine; nothing of pycc_tpu is imported): the same
functions, term for term, so that the port can re-derive the basis tables
it ships where pycc_tpu is not installed.

Dunning's correlation-consistent general contractions ARE the atomic-HF
orbital expansions of the ground-state atom in the optimized primitive set
(Dunning, JCP 90, 1007 (1989)).  This module re-derives them with the
repo's own integral engine, which is how the C/N cc-pVDZ tables in
basis.py were produced (no external quantum-chemistry package is a
dependency to transcribe them from, and hand-entered digits proved
unreliable — see tests/test_018_cn_basis.py).

Method: open-shell atomic HF with the p shell constrained to one radial
function (symmetry equivalencing) and the true LS-term p-shell coupling,

    E_pp(3P, p2) = Jxy - Kxy            (C)
    E_pp(4S, p3) = 3 (Jxy - Kxy)        (N)
    E_pp(3P, p4) = 6 Jxy - Kxy          (O)

where Jxy/Kxy are the radial Coulomb/exchange integrals between distinct
p components (F0 = Jxy + 2K xy/3, F2/25 = Kxy/3 in Slater-integral
language).  The closed s shells couple to the p density spherically
averaged.

Calibration (test_018): for O and H — whose published tables are pinned
externally through the frozen Psi4 CCSD oracles at 1e-11 — this procedure
reproduces every published contraction digit (|diff| < 5e-7), and running
a Nelder-Mead exponent optimization from O's published primitives gains
0.000 mH (they are a stationary point of this functional).  The same
procedure applied to C (shipped primitives) and N (valence s primitives
re-optimized, tight six fixed) produced the basis.py tables.
"""

import numpy as np

# cc-pVDZ primitive sets as shipped in basis.py (N valence s re-optimized;
# see module docstring)
PRIMITIVES = {
    "H": ([13.01, 1.962, 0.4446, 0.1220], []),
    "C": ([6665.0, 1000.0, 228.0, 64.71, 21.06, 6.459, 2.525, 0.5228, 0.1596],
          [9.439, 2.002, 0.5456, 0.1517]),
    "N": ([9046.0, 1357.0, 309.3, 87.73, 25.56, 8.212, 2.952639, 0.729690,
           0.220167],
          [13.55, 2.917, 0.7973, 0.2185]),
    "O": ([11720.0, 1759.0, 400.8, 113.7, 37.03, 13.27, 5.025, 1.013, 0.3023],
          [17.70, 3.854, 1.046, 0.2753]),
}

# (closed s orbitals, p-shell electrons, alpha, gamma):
#   E_pp = alpha * Jxy + gamma * Kxy for the LS ground term
STATES = {
    "H": (1, 0, 0.0, 0.0),
    "C": (2, 2, 1.0, -1.0),
    "N": (2, 3, 3.0, -3.0),
    "O": (2, 4, 6.0, -1.0),
}


def solve_atom(sym, s_exps=None, p_exps=None, damp=0.5, maxiter=4000,
               e_conv=1e-12):
    """Converge the LS-coupled atomic HF; returns dict with the energy,
    the 1s/2s s-orbital coefficient vectors `c`, and the 2p radial
    vector `w` (all over NORMALIZED primitives — the published-table
    convention)."""
    from scipy.linalg import eigh as geigh

    from . import integrals as ints
    from .basis import _REGISTRY, BasisSet
    from .mol import Molecule

    if s_exps is None or p_exps is None:
        s_exps, p_exps = PRIMITIVES[sym]
    tab = {sym: [("S", [(e, 1.0)]) for e in s_exps]
           + [("P", [(e, 1.0)]) for e in p_exps]}
    name = "_atomfit-" + sym.lower()
    _REGISTRY[name] = (tab, True)
    try:
        mol = Molecule("%s\nsymmetry c1" % sym)
        bas = BasisSet(mol, name)
    finally:
        del _REGISTRY[name]
    ns, npr = len(s_exps), len(p_exps)

    S = ints.overlap(bas)
    h = ints.kinetic(bas) + ints.nuclear_attraction(bas)
    E4 = ints.eri(bas)  # chemist (ab|cd)

    s_idx = np.arange(ns)
    px = ns + 3 * np.arange(npr)      # cartesian l=1 ordering: x, y, z
    py = px + 1

    Ss, hs = S[np.ix_(s_idx, s_idx)], h[np.ix_(s_idx, s_idx)]
    Sp, hp = S[np.ix_(px, px)], h[np.ix_(px, px)]
    ssss = E4[np.ix_(s_idx, s_idx, s_idx, s_idx)]
    ssxx = E4[np.ix_(s_idx, s_idx, px, px)]
    sxsx = E4[np.ix_(s_idx, px, s_idx, px)]
    xxyy = E4[np.ix_(px, px, py, py)]
    xyxy = E4[np.ix_(px, py, px, py)]

    ncs, Np, alpha, gamma = STATES[sym]

    _, Cs = geigh(hs, Ss)
    if sym == "H":
        c1 = Cs[:, 0]
        if c1[np.argmax(np.abs(c1))] < 0:
            c1 = -c1
        return dict(E=float(c1 @ hs @ c1), c=[c1], w=None, niter=0)

    _, Cp = geigh(hp, Sp)
    w = Cp[:, 0]

    def s_density(C):
        return 2.0 * (np.outer(C[:, 0], C[:, 0]) + np.outer(C[:, 1], C[:, 1]))

    Ds, R = s_density(Cs), np.outer(w, w)
    E_old, it = 0.0, 0
    for it in range(maxiter):
        Js = np.einsum("abcd,cd->ab", ssss, Ds)
        Ks = np.einsum("abcd,bd->ac", ssss, Ds)
        # p->s: sum_m (Np/3)(J[W_m] - K[W_m]/2); three identical radial
        # components -> Np * (J - K/2)
        Jp_on_s = Np * np.einsum("abcd,cd->ab", ssxx, R)
        Kp_on_s = Np * np.einsum("axby,xy->ab", sxsx, R)
        Fs = hs + Js - 0.5 * Ks + Jp_on_s - 0.5 * Kp_on_s

        Js_on_p = np.einsum("xyab,ab->xy", E4[np.ix_(px, px, s_idx, s_idx)], Ds)
        Ks_on_p = np.einsum("xayb,ab->xy", E4[np.ix_(px, s_idx, px, s_idx)], Ds)
        Gs_rad = Js_on_p - 0.5 * Ks_on_p
        MJ = np.einsum("abcd,cd->ab", xxyy, R)
        MK = np.einsum("acbd,cd->ab", xyxy, R)
        Fp = Np * (hp + Gs_rad) + 2.0 * alpha * MJ + 2.0 * gamma * MK

        _, Cs = geigh(Fs, Ss)
        _, Cp_new = geigh(Fp, Sp)
        w_new = Cp_new[:, 0]
        if w_new @ Sp @ w < 0:
            w_new = -w_new
        w = (1 - damp) * w_new + damp * w
        w /= np.sqrt(w @ Sp @ w)
        Ds = (1 - damp) * s_density(Cs) + damp * Ds
        R = np.outer(w, w)

        Jxy = np.einsum("abcd,ab,cd->", xxyy, R, R)
        Kxy = np.einsum("acbd,ab,cd->", xyxy, R, R)
        E = (np.einsum("ab,ab->", Ds, hs) + Np * np.einsum("ab,ab->", R, hp)
             + 0.5 * np.einsum("ab,ab->", Ds,
                               np.einsum("abcd,cd->ab", ssss, Ds)
                               - 0.5 * np.einsum("abcd,bd->ac", ssss, Ds))
             + Np * np.einsum("ab,ab->", R, Gs_rad)
             + alpha * Jxy + gamma * Kxy)
        if abs(E - E_old) < e_conv and it > 5:
            break
        E_old = E

    c1, c2 = Cs[:, 0].copy(), Cs[:, 1].copy()
    if c1[np.argmax(np.abs(c1))] < 0:
        c1 = -c1
    if c2[-1] < 0:
        c2 = -c2
    if w[np.argmax(np.abs(w))] < 0:
        w = -w
    return dict(E=float(E), c=[c1, c2], w=w, niter=it)


# ---------------------------------------------------------------------------
# aug-cc-pVDZ diffuse exponents (Kendall, Dunning & Harrison, JCP 96, 6796
# (1992)): one diffuse function per angular momentum, with the s/p
# exponents optimized for the HF energy of the atomic ANION in the
# presence of each other.  LS ground terms of the anions, same
# (alpha, gamma) parametrization as STATES (the p^5 2P row follows by
# hole-counting against closed p^6 = 15 Jxy: removing one electron
# removes Jxx + 4Jxy - 2Kxy = 5Jxy, so E_pp(p^5) = 10 Jxy exactly).
#
# Calibration (tests/test_022_aug_cn.py): for O — whose published diffuse
# set is pinned externally through the frozen aug-cc-pVDZ Psi4 oracles
# (tests/test_007) — optimize_aug reproduces BOTH published exponents to
# every published digit (s 0.07896, p 0.06856).  Applied to C/N it
# reproduces the published p exponents exactly (0.04041 / 0.05611) and
# lands within the shallow s minimum (derived 0.04642 / 0.06026 vs
# published 0.04690 / 0.06124; the basin is ~1e-5 mH flat).  The diffuse
# d is a correlation-optimized quantity (CISD on the anion) out of scope
# for this HF solver; it transfers by the O-calibrated even-tempered
# ratio d_aug/d_valence = 0.3320/1.1850, which also post-dicts the
# published C/N values to 2%/0.4% (0.15409->0.151, 0.22890->0.230).
# ---------------------------------------------------------------------------

ANION_STATES = {
    "C": (2, 3, 3.0, -3.0),   # C-  p3 4S
    "N": (2, 4, 6.0, -1.0),   # N-  p4 3P
    "O": (2, 5, 10.0, 0.0),   # O-  p5 2P
}


def anion_energy(sym, s_diffuse, p_diffuse):
    """LS-coupled atomic HF energy of the anion with one extra diffuse
    primitive per l appended to the cc-pVDZ primitive set."""
    s0, p0 = PRIMITIVES[sym]
    save = STATES[sym]
    STATES[sym] = ANION_STATES[sym]
    try:
        return solve_atom(sym, s_exps=list(s0) + [float(s_diffuse)],
                          p_exps=list(p0) + [float(p_diffuse)])["E"]
    finally:
        STATES[sym] = save


def optimize_aug(sym, guess=None, xatol=1e-4):
    """Derive the aug-cc-pVDZ diffuse (s, p) exponents for `sym` by
    minimizing the anion HF energy (the defining construction).  Returns
    (s_exp, p_exp)."""
    import numpy as _np
    from scipy.optimize import minimize

    if guess is None:
        guess = {"C": (0.05, 0.045), "N": (0.065, 0.055),
                 "O": (0.08, 0.069)}[sym]
    r = minimize(lambda v: anion_energy(sym, _np.exp(v[0]), _np.exp(v[1])),
                 _np.log(_np.asarray(guess)), method="Nelder-Mead",
                 options=dict(xatol=xatol, fatol=1e-11))
    return tuple(float(x) for x in _np.exp(r.x))
