"""Similarity-transformed Hamiltonian HBAR = e^{-T} H e^{T} (one/two-body).

The counterpart of pycc_tpu/cchbar.py.  For storage='full' and 'blocked'
(the block views, `models/blocked.eri_views`) the 11 blocks
come from one plain function of (F, ERI, L, t1, t2), term for term, so a
field-dressed F rebuilds HBAR with no object mutation.  `cchbar(ccwfn)`
exposes the blocks as attributes, and keeps the pre-laid ladder operand
the left ('ijef,efab') form of the K1 ladder needs (`HBar.Hvvvv_efab`).
Complex amplitudes (real-time CC) give a complex HBAR, built by the same
function.
For storage='df' the HBAR is models/dfhbar.build_hbar_df's, over the
Cholesky factors.
"""

import dataclasses
import time

import torch

from .models.blocked import eri_views
from .models.ccsd import build_tau, slices
from .ops.contract import contract
from .ops.kernels.vvvv import StackedComplex, stack_complex
from .parallel.mesh import (build_like, map_leading, mesh_vvvv, per_piece,
                            region, shard_hbar)
from .utils.log import logger as log

BLOCKS = ("Hov", "Hvv", "Hoo", "Hoooo", "Hvvvv", "Hvovv", "Hooov", "Hovvo",
          "Hovov", "Hvvvo", "Hovoo")
# the explicit blocks of the DF-HBAR: Hvvvv, Hvovv and Hvvvo stay implicit
# in the dressed factors
DF_BLOCKS = ("Hov", "Hvv", "Hoo", "Hoooo", "Hooov", "Hovvo", "Hovov",
             "Hovoo")


@dataclasses.dataclass(eq=False)
class HBar:
    Hov: torch.Tensor
    Hvv: torch.Tensor
    Hoo: torch.Tensor
    Hoooo: torch.Tensor
    Hvvvv: torch.Tensor
    Hvovv: torch.Tensor
    Hooov: torch.Tensor
    Hovvo: torch.Tensor
    Hovov: torch.Tensor
    Hvvvo: torch.Tensor
    Hovoo: torch.Tensor
    _efab: torch.Tensor = dataclasses.field(default=None, repr=False)

    @property
    def Hvvvv_efab(self):
        """Hvvvv laid out as (a, b, e, f), made once on first use: its
        (ab, ef) matrix is B[n=(a,b), k=(e,f)] = Hvvvv[e,f,a,b], so K1's
        A @ B.T computes the left form 'ijef,efab->ijab'
        (models/ccsd.vvvv_contract_efab).  A complex Hvvvv (the HBAR of
        real-time CC's complex amplitudes) is laid out as K1's stacked
        operand instead, [Re; Im] in the same (a, b, e, f) order
        (`ops/kernels/vvvv.StackedComplex`), in the one copy.  A Hvvvv
        Sharded over a mesh gives the operand Sharded over its own (a, b):
        each piece gathered from the (e, f) columns of every shard onto
        its cell's device (`parallel/mesh.build_like`)."""
        if self._efab is None:
            H = self.Hvvvv
            cplx = H.is_complex()

            def piece(sl, dev):
                x = region(H, (slice(None), slice(None), sl[-4], sl[-3]),
                           dev).permute(2, 3, 0, 1)
                return stack_complex(x).ri if cplx else x.contiguous()

            Wt = build_like(H, ((None,) if cplx else ()) + ("va", "vb"),
                            ((2,) if cplx else ()) + tuple(H.shape), piece)
            self._efab = StackedComplex(Wt) if cplx else Wt
        return self._efab


def _hvvvv(model, W, ERI, t1, t2, tau, no):
    """The model's Hvvvv from W = <ab|ef>, piece by piece on W's layout
    (`parallel/mesh.per_piece`): each piece the (A, B) rows, made on its
    piece's device from W's piece and the (A, B) slices of the o v^3 and
    o^2 v^2 integrals and amplitudes, so on a mesh no v^4 tensor forms on
    the home device; a plain W is one piece."""
    o, v = slices(no)
    vovv = None if model == "CCD" else ERI[v, o, v, v]
    oovv = ERI[o, o, v, v]

    def piece(p, sl):
        A, B = sl[0], sl[1]
        dev = p.device
        ov = oovv.to(dev)
        if model == "CCD":
            H = p + contract("mnab,mnef->abef", t2[:, :, A, B].to(dev), ov)
            return H.contiguous()
        H = (p - contract("mb,amef->abef", t1[:, B].to(dev), vovv[A].to(dev))
             - contract("ma,bmfe->abef", t1[:, A].to(dev), vovv[B].to(dev)))
        if model == "CC2":
            H = H + contract("nb,anef->abef", t1[:, B].to(dev),
                             contract("ma,mnef->anef", t1[:, A].to(dev), ov))
        else:
            H = H + contract("mnab,mnef->abef", tau[:, :, A, B].to(dev), ov)
        return H.contiguous()

    return per_piece(W, piece)


def _t1_hvvvv(t1, Hvvvv):
    """contract('if,abef->abei', t1, Hvvvv), piece by piece on Hvvvv's
    layout (`parallel/mesh.map_leading`)."""
    return map_leading(
        Hvvvv, lambda p, sl: contract("if,abef->abei", t1.to(p.device), p),
        tuple(Hvvvv.shape[2:3]) + (t1.shape[0],))


def build_hbar(model, F, ERI, L, t1, t2, no, vvvv=None):
    """All HBAR blocks for the given model ('CCSD', 'CCSD(T)' and 'CC3'
    share the CCSD forms; 'CCD' and 'CC2' have their own).  Hvvvv is
    contiguous.  vvvv: <ab|ef> as the ladder reads it (None: ERI[v,v,v,v]);
    a mesh ccwfn's is Sharded over (a, b), and Hvvvv is then built and
    read shard by shard on its layout (`_hvvvv`), every other block a
    plain tensor on the home device."""
    o, v = slices(no)
    tau = build_tau(t1, t2)
    ccd = model == "CCD"
    cc2 = model == "CC2"
    W = ERI[v, v, v, v] if vvvv is None else vvvv

    if ccd:
        Hov = F[o, v]
        Hvv = F[v, v] - contract("mnfa,mnfe->ae", t2, L[o, o, v, v])
        Hoo = F[o, o] + contract("inef,mnef->mi", t2, L[o, o, v, v])
        Hoooo = ERI[o, o, o, o] + contract("ijef,mnef->mnij", t2, ERI[o, o, v, v])
        Hvvvv = _hvvvv(model, W, ERI, t1, t2, tau, no)
        Hvovv = ERI[v, o, v, v]
        Hooov = ERI[o, o, o, v]
        Hovvo = (ERI[o, v, v, o]
                 - contract("jnfb,mnef->mbej", t2, ERI[o, o, v, v])
                 + contract("njfb,mnef->mbej", t2, L[o, o, v, v]))
        Hovov = ERI[o, v, o, v] - contract("jnfb,nmef->mbje", t2, ERI[o, o, v, v])
        Hvvvo = (ERI[v, v, v, o]
                 - contract("me,miab->abei", Hov, t2)
                 + contract("mnab,mnei->abei", tau, ERI[o, o, v, o])
                 - contract("imfa,bmfe->abei", t2, ERI[v, o, v, v])
                 - contract("imfb,amef->abei", t2, ERI[v, o, v, v])
                 + contract("mifb,amef->abei", t2, L[v, o, v, v]))
        Hovoo = (ERI[o, v, o, o]
                 + contract("me,ijeb->mbij", Hov, t2)
                 + contract("ijef,mbef->mbij", t2, ERI[o, v, v, v])
                 - contract("ineb,nmje->mbij", t2, ERI[o, o, o, v])
                 - contract("jneb,mnie->mbij", t2, ERI[o, o, o, v])
                 + contract("njeb,mnie->mbij", t2, L[o, o, o, v]))
        return HBar(Hov, Hvv, Hoo, Hoooo, Hvvvv, Hvovv, Hooov, Hovvo, Hovov,
                    Hvvvo, Hovoo)

    Hov = F[o, v] + contract("nf,mnef->me", t1, L[o, o, v, v])
    Hvv = (F[v, v]
           - contract("me,ma->ae", F[o, v], t1)
           + contract("mf,amef->ae", t1, L[v, o, v, v])
           - contract("mnfa,mnfe->ae", tau, L[o, o, v, v]))
    Hoo = (F[o, o]
           + contract("ie,me->mi", t1, F[o, v])
           + contract("ne,mnie->mi", t1, L[o, o, o, v])
           + contract("inef,mnef->mi", tau, L[o, o, v, v]))

    tmp = contract("je,mnie->mnij", t1, ERI[o, o, o, v])
    Hoooo = ERI[o, o, o, o] + tmp + tmp.permute(1, 0, 3, 2)
    if cc2:
        Hoooo = Hoooo + contract("jf,mnif->mnij", t1,
                                 contract("ie,mnef->mnif", t1, ERI[o, o, v, v]))
    else:
        Hoooo = Hoooo + contract("ijef,mnef->mnij", tau, ERI[o, o, v, v])

    Hvvvv = _hvvvv("CC2" if cc2 else "CCSD", W, ERI, t1, t2, tau, no)

    Hvovv = ERI[v, o, v, v] - contract("na,nmef->amef", t1, ERI[o, o, v, v])
    Hooov = ERI[o, o, o, v] + contract("if,nmef->mnie", t1, ERI[o, o, v, v])

    Hovvo = (ERI[o, v, v, o]
             + contract("jf,mbef->mbej", t1, ERI[o, v, v, v])
             - contract("nb,mnej->mbej", t1, ERI[o, o, v, o]))
    Hovov = (ERI[o, v, o, v]
             + contract("jf,bmef->mbje", t1, ERI[v, o, v, v])
             - contract("nb,mnje->mbje", t1, ERI[o, o, o, v]))
    if not cc2:
        Hovvo = (Hovvo
                 - contract("jnfb,mnef->mbej", tau, ERI[o, o, v, v])
                 + contract("njfb,mnef->mbej", t2, L[o, o, v, v]))
        Hovov = Hovov - contract("jnfb,nmef->mbje", tau, ERI[o, o, v, v])

    if cc2:
        Hvvvo = (ERI[v, v, v, o]
                 - contract("me,miab->abei", F[o, v], t2)
                 + _t1_hvvvv(t1, Hvvvv)
                 + contract("nb,anei->abei", t1,
                            contract("ma,mnei->anei", t1, ERI[o, o, v, o]))
                 - contract("mb,amei->abei", t1, ERI[v, o, v, o])
                 - contract("ma,bmie->abei", t1, ERI[v, o, o, v]))
        Hovoo = (ERI[o, v, o, o]
                 + contract("me,ijeb->mbij", F[o, v], t2)
                 - contract("nb,mnij->mbij", t1, Hoooo)
                 + contract("jf,mbif->mbij", t1,
                            contract("ie,mbef->mbif", t1, ERI[o, v, v, v]))
                 + contract("je,mbie->mbij", t1, ERI[o, v, o, v])
                 + contract("ie,bmje->mbij", t1, ERI[v, o, o, v]))
    else:
        Hvvvo = (ERI[v, v, v, o]
                 - contract("me,miab->abei", Hov, t2)
                 + _t1_hvvvv(t1, Hvvvv)
                 + contract("mnab,mnei->abei", tau, ERI[o, o, v, o])
                 - contract("imfa,bmfe->abei", t2, ERI[v, o, v, v])
                 - contract("imfb,amef->abei", t2, ERI[v, o, v, v])
                 + contract("mifb,amef->abei", t2, L[v, o, v, v]))
        tmp = ERI[v, o, v, o] - contract("infa,mnfe->amei", t2, ERI[o, o, v, v])
        Hvvvo = Hvvvo - contract("mb,amei->abei", t1, tmp)
        tmp = (ERI[v, o, o, v]
               - contract("infb,mnef->bmie", t2, ERI[o, o, v, v])
               + contract("nifb,mnef->bmie", t2, L[o, o, v, v]))
        Hvvvo = Hvvvo - contract("ma,bmie->abei", t1, tmp)

        Hovoo = (ERI[o, v, o, o]
                 + contract("me,ijeb->mbij", Hov, t2)
                 - contract("nb,mnij->mbij", t1, Hoooo)
                 + contract("ijef,mbef->mbij", tau, ERI[o, v, v, v])
                 - contract("ineb,nmje->mbij", t2, ERI[o, o, o, v])
                 - contract("jneb,mnie->mbij", t2, ERI[o, o, o, v])
                 + contract("njeb,mnie->mbij", t2, L[o, o, o, v]))
        tmp = ERI[o, v, o, v] - contract("infb,mnfe->mbie", t2, ERI[o, o, v, v])
        Hovoo = Hovoo + contract("je,mbie->mbij", t1, tmp)
        tmp = (ERI[v, o, o, v]
               - contract("jnfb,mnef->bmje", t2, ERI[o, o, v, v])
               + contract("njfb,mnef->bmje", t2, L[o, o, v, v]))
        Hovoo = Hovoo + contract("ie,bmje->mbij", t1, tmp)

    return HBar(Hov, Hvv, Hoo, Hoooo, Hvvvv, Hvovv, Hooov, Hovvo, Hovov,
                Hvvvo, Hovoo)


class cchbar:
    """cchbar(ccwfn): the HBAR of a converged ccwfn, built on its device
    (`ccwfn.timers` keeps 'hbar.build').  storage='full' or 'blocked': the
    11 blocks as
    attributes, and `Hvvvv_efab`, the left ladder's operand, made once on
    first use.  storage='df': `self.hbar` is a models/dfhbar.DFHBar (the
    blocks of at most o^3 v, the factors and their t1 dressings) and its 8
    explicit blocks are attributes; CCD, CCSD, CCSD(T) and CC3 take the
    CCSD forms, CC2 its own.  On a mesh ccwfn (parallel/mesh.py) the v^4
    and o v^3 blocks are Sharded (`shard_hbar`), Hvvvv built shard by
    shard."""

    def __init__(self, ccwfn):
        storage = getattr(ccwfn, "storage", "full")
        mesh = getattr(ccwfn, "mesh", None)
        t0 = time.time()
        self.ccwfn = ccwfn
        with ccwfn.timers.time("hbar.build"):
            if storage == "df":
                from .models.dfhbar import build_hbar_df
                self.hbar = build_hbar_df(
                    ccwfn.H.F, ccwfn.dfb, ccwfn.t1, ccwfn.t2, ccwfn.no,
                    model="CC2" if ccwfn.model == "CC2" else "CCSD")
                names = DF_BLOCKS
            else:
                ERI, L = eri_views(ccwfn)
                self.hbar = build_hbar(
                    ccwfn.model, ccwfn.H.F, ERI, L, ccwfn.t1, ccwfn.t2,
                    ccwfn.no, vvvv=mesh_vvvv(ccwfn))
                names = BLOCKS
            if mesh is not None:
                self.hbar = shard_hbar(self.hbar, mesh)
        for name in names:
            setattr(self, name, getattr(self.hbar, name))
        log.info("\nHBAR constructed in %.3f seconds.\n" % (time.time() - t0))

    @property
    def Hvvvv_efab(self):
        return self.hbar.Hvvvv_efab
