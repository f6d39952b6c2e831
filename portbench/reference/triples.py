"""The (T) energy, plain: one occupied row at a time.

For a row i and each j, the connected triples slab t3[i, j] (k, a, b, c)
is built by twelve einsums and projected on the seven quantities the (T)
energy needs; `row_energy` turns them into the row's energy.  float64
throughout.  The integral slices are cut from the reference Hamiltonian.
"""

import torch

from .ein import ein


def slices(F, ERI, L, no):
    """(Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps) in the layouts
    the row reads: Wvvvo_o[i,a,b,c] = <ab|ci>, Wovoo_t[j,k,i,a] = <ia|jk>."""
    o, v = slice(0, no), slice(no, None)
    Wvvvo_o = ERI[v, v, v, o].permute(3, 0, 1, 2).contiguous()
    Wovoo_t = ERI[o, v, o, o].permute(2, 3, 0, 1).contiguous()
    return (Wvvvo_o, Wovoo_t, ERI[v, o, v, v].contiguous(),
            ERI[o, o, o, v].contiguous(), L[o, o, v, v].contiguous(),
            F[o, v].contiguous(), F.diagonal().contiguous())


def t3_slab(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v):
    """t3[i, j] as (k, a, b, c)."""
    Wi = Wvvvo_o[i]
    Wj = Wvvvo_o[j]
    t3 = ein("bae,kce->kabc", Wi, t2[:, j])
    t3 = t3 + ein("cae,kbe->kabc", Wi, t2[j])
    t3 = t3 + ein("kace,be->kabc", Wvvvo_o, t2[j, i])
    t3 = t3 + ein("kbce,ae->kabc", Wvvvo_o, t2[i, j])
    t3 = t3 + ein("cbe,kae->kabc", Wj, t2[i])
    t3 = t3 + ein("abe,kce->kabc", Wj, t2[:, i])
    t3 = t3 - ein("kmc,mab->kabc", Wovoo_t[j], t2[i])
    t3 = t3 - ein("kmb,mac->kabc", Wovoo_t[:, j], t2[i])
    t3 = t3 - ein("mb,kmca->kabc", Wovoo_t[i, j], t2)
    t3 = t3 - ein("ma,kmcb->kabc", Wovoo_t[j, i], t2)
    t3 = t3 - ein("kma,mbc->kabc", Wovoo_t[:, i], t2[j])
    t3 = t3 - ein("kmc,mba->kabc", Wovoo_t[i], t2[j])
    denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return t3 / denom


def row_projections(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps, t2,
                    no):
    """The seven projections of row i, each stacked over j."""
    Ev1 = 2.0 * Evovv - Evovv.swapaxes(2, 3)
    rows = []
    for j in range(no):
        t3 = t3_slab(i, j, Wvvvo_o, Wovoo_t, t2, eps[:no], eps[no:])
        T = 2.0 * t3 - t3.swapaxes(2, 3) - t3.swapaxes(1, 3)
        rows.append((ein("kabc,kbc->a", t3, Loovv[j]),
                     ein("kabc,kba->c", t3, Loovv[j]),
                     ein("kabc,dkbc->ad", t3, Ev1),
                     ein("kabc,dkba->cd", t3, Evovv),
                     ein("kabc,kc->ab", t3, Fov),
                     ein("kabc,ka->bc", t3, Fov),
                     ein("kabc,klc->lab", T, Eooov[j])))
    return tuple(torch.stack(x) for x in zip(*rows))


def row_energy(i, proj, t1, t2w):
    X1a, X1m, Z1, Z1m, Z2a, Z2m, X2l = proj
    X2 = (Z1 - Z1m) + (Z2a - Z2m.swapaxes(1, 2))
    e = 2.0 * ein("a,ja->", t1[i], X1a - X1m)
    e = e + ein("jab,jab->", t2w[i], X2)
    return e - ein("lab,jlab->", t2w[i], X2l)


def t_energy(F, ERI, L, t1, t2, no):
    """E(T) of the amplitudes (t1, t2), a 0-d float64 tensor."""
    sl = slices(F, ERI, L, no)
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    e = torch.zeros((), dtype=torch.float64, device=t2.device)
    for i in range(no):
        e = e + row_energy(i, row_projections(i, *sl, t2, no), t1, t2w)
    return e
