"""Closed-shell spin-adapted CCSD residuals and energy, plain.

t1 (o,v), t2 (o,o,v,v); ERI <pq|rs> and L = 2<pq|rs> - <pq|sr> are
anything indexed like the full tensor (`hamiltonian.FullERI` or
`FactorERI`); `vvvv` is <ab|ef> as one (v,v,v,v) tensor.  Complex
amplitudes (real-time CC) give complex residuals.
"""

from .ein import ein, ladder, promote


def slices(no):
    return slice(0, no), slice(no, None)


def build_tau(t1, t2, f1=1.0, f2=1.0):
    return f1 * t2 + f2 * ein("ia,jb->ijab", t1, t1)


def build_Fae(F, L, t1, t2, no):
    o, v = slices(no)
    tau_h = build_tau(t1, t2, 1.0, 0.5)
    return (F[v, v]
            - 0.5 * ein("me,ma->ae", F[o, v], t1)
            + ein("mf,mafe->ae", t1, L[o, v, v, v])
            - ein("mnaf,mnef->ae", tau_h, L[o, o, v, v]))


def build_Fmi(F, L, t1, t2, no):
    o, v = slices(no)
    tau_h = build_tau(t1, t2, 1.0, 0.5)
    return (F[o, o]
            + 0.5 * ein("ie,me->mi", t1, F[o, v])
            + ein("ne,mnie->mi", t1, L[o, o, o, v])
            + ein("inef,mnef->mi", tau_h, L[o, o, v, v]))


def build_Fme(F, L, t1, no):
    o, v = slices(no)
    return F[o, v] + ein("nf,mnef->me", t1, L[o, o, v, v])


def build_Wmnij(ERI, t1, t2, no):
    o, v = slices(no)
    tau = build_tau(t1, t2)
    return (ERI[o, o, o, o]
            + ein("je,mnie->mnij", t1, ERI[o, o, o, v])
            + ein("ie,mnej->mnij", t1, ERI[o, o, v, o])
            + ein("ijef,mnef->mnij", tau, ERI[o, o, v, v]))


def build_Wmbej(ERI, L, t1, t2, no):
    o, v = slices(no)
    tau_x = build_tau(t1, t2, 0.5, 1.0)
    return (ERI[o, v, v, o]
            + ein("jf,mbef->mbej", t1, ERI[o, v, v, v])
            - ein("nb,mnej->mbej", t1, ERI[o, o, v, o])
            - ein("jnfb,mnef->mbej", tau_x, ERI[o, o, v, v])
            + 0.5 * ein("njfb,mnef->mbej", t2, L[o, o, v, v]))


def build_Wmbje(ERI, t1, t2, no):
    o, v = slices(no)
    tau_x = build_tau(t1, t2, 0.5, 1.0)
    return (-ERI[o, v, o, v]
            - ein("jf,mbfe->mbje", t1, ERI[o, v, v, v])
            + ein("nb,mnje->mbje", t1, ERI[o, o, o, v])
            + ein("jnfb,mnfe->mbje", tau_x, ERI[o, o, v, v]))


def build_Zmbij(ERI, t1, t2, no):
    o, v = slices(no)
    return ein("mbef,ijef->mbij", ERI[o, v, v, v], build_tau(t1, t2))


def _r_T1(F, ERI, L, t1, t2, Fae, Fme, Fmi, no):
    o, v = slices(no)
    t2s = 2.0 * t2 - t2.swapaxes(2, 3)
    return (F[o, v]
            + ein("ie,ae->ia", t1, Fae)
            - ein("ma,mi->ia", t1, Fmi)
            + ein("imae,me->ia", t2s, Fme)
            + ein("nf,nafi->ia", t1, L[o, v, v, o])
            + ein("mief,maef->ia", t2s, ERI[o, v, v, v])
            - ein("mnae,nmei->ia", t2, L[o, o, v, o]))


def residuals_ccsd(F, ERI, L, vvvv, t1, t2, no):
    """The CCSD T1/T2 residuals (r1, r2)."""
    o, v = slices(no)
    Fae = build_Fae(F, L, t1, t2, no)
    Fmi = build_Fmi(F, L, t1, t2, no)
    Fme = build_Fme(F, L, t1, no)
    Wmnij = build_Wmnij(ERI, t1, t2, no)
    Wmbej = build_Wmbej(ERI, L, t1, t2, no)
    Wmbje = build_Wmbje(ERI, t1, t2, no)
    Zmbij = build_Zmbij(ERI, t1, t2, no)
    tau = build_tau(t1, t2)

    r1 = _r_T1(F, ERI, L, t1, t2, Fae, Fme, Fmi, no)

    r2 = promote(0.5 * ERI[o, o, v, v], t2)
    r2 = r2 + ein("ijae,be->ijab", t2, Fae)
    r2 = r2 - 0.5 * ein("ijae,be->ijab", t2, ein("mb,me->be", t1, Fme))
    r2 = r2 - ein("imab,mj->ijab", t2, Fmi)
    r2 = r2 - 0.5 * ein("imab,jm->ijab", t2, ein("je,me->jm", t1, Fme))
    r2 = r2 + 0.5 * ein("mnij,mnab->ijab", Wmnij, tau)
    r2 = r2 + 0.5 * ladder(tau, vvvv)
    r2 = r2 - ein("ma,mbij->ijab", t1, Zmbij)
    r2 = r2 + ein("imae,mbej->ijab", t2 - t2.swapaxes(2, 3), Wmbej)
    r2 = r2 + ein("imae,mbej->ijab", t2, Wmbej + Wmbje.swapaxes(2, 3))
    r2 = r2 + ein("mjae,mbie->ijab", t2, Wmbje)
    tt = ein("ie,ma->imea", t1, t1)
    r2 = r2 - ein("imea,mbej->ijab", tt, ERI[o, v, v, o])
    r2 = r2 - ein("imeb,maje->ijab", tt, ERI[o, v, o, v])
    r2 = r2 + ein("ie,abej->ijab", t1, ERI[v, v, v, o])
    r2 = r2 - ein("ma,mbij->ijab", t1, ERI[o, v, o, o])
    r2 = r2 + r2.permute(1, 0, 3, 2)
    return r1, r2


def cc_energy(F, L, t1, t2, no):
    o, v = slices(no)
    ecc = 2.0 * ein("ia,ia->", F[o, v], t1)
    return ecc + ein("ijab,ijab->", build_tau(t1, t2), L[o, o, v, v])


def denominators(F, no):
    """(D1, D2) from diag(F): eps_i - eps_a, eps_i + eps_j - eps_a - eps_b."""
    o, v = slices(no)
    eps = F.diagonal().real
    D1 = eps[o, None] - eps[None, v]
    D2 = (eps[o, None, None, None] + eps[None, o, None, None]
          - eps[None, None, v, None] - eps[None, None, None, v])
    return D1, D2
