"""Lambda-amplitude solver: the left-hand eigenvector of HBAR.

The counterpart of pycc_tpu/cclambda.py for storage='full', 'blocked'
and 'df' and the models CCD, CC2, CCSD, CCSD(T) and CC3.  The residual is
a plain function of (hbar, t, l); its Hvvvv ladder ('ijef,efab') runs
through K1, on the HBAR's pre-laid operand under full and blocked
storage, and a block of a at a time over the dressed factors under
storage='df' (models/dfhbar.lambda_residuals_df, pycc_tpu's fused DF
step).  `solve_lambda` is the T-amplitude solver's loop: a Jacobi step from
diag(F), the pseudo-energy of the pre-extrapolation update, the on-device
DIIS ring from `start_diis`, and one host read per iteration.  For CCSD(T)
the (T) sources S1/S2 come from `triples.t3_lambda_sources`; CC3 adds the
T3/L3 terms of models/cc3.py to the CCSD form, over the full tensors or
one slab at a time (`ccwfn.t3_slabs`), over factors always the slab form
(`cc3.cc3_lambda_extra_scan_df`).  `solve_lambda(chk=..., resume=...)`
checkpoints l1/l2 and the DIIS ring as solve_cc does;
`solve_lambda_mixed` converges a float32 HBAR and Lambda first, then
refines in float64.  For a local ccwfn (filter=True, or the filter
simulation of a native one) each step is projected through the pair
spaces (`Local.filter_amps`), as pycc_tpu's is; the ladder stays K1's.
"""

import os
import time
import warnings

import torch

from .cchbar import build_hbar
from .models import cc3
from .models.blocked import eri_views
from .models.ccsd import (build_tau, pair_symmetric, slices,
                          vvvv_contract_efab)
from .ops.contract import contract
from .ops.diis import DIIS
from .ops.kernels.vvvv import vvvv_nt
from .parallel.mesh import dense, mesh_vvvv
from .utils.log import logger as log

def build_Goo(t2, l2):
    return contract("mjab,ijab->mi", t2, l2)


def build_Gvv(t2, l2):
    return -1.0 * contract("ijeb,ijab->ae", t2, l2)


def lambda_residuals(model, hb, F, ERI, L, t1, t2, l1, l2, no,
                     S1=None, S2=None, ladder=vvvv_nt):
    """r_L1, r_L2 for CCD/CC2/CCSD (+ optional (T) source terms S1/S2).
    hb is a cchbar.HBar; the Hvvvv ladder goes through `ladder` (K1 by
    default, `vvvv_nt_reference` for the plain product)."""
    # read whole: on a mesh assembled once a call (parallel/mesh.dense)
    Hvovv, Hvvvo = dense(hb.Hvovv), dense(hb.Hvvvo)
    o, v = slices(no)
    Goo = build_Goo(t2, l2)
    Gvv = build_Gvv(t2, l2)
    ccd = model == "CCD"
    cc2 = model == "CC2"

    Hovvo_s = 2.0 * hb.Hovvo - hb.Hovov.swapaxes(2, 3)

    if ccd:
        r1 = torch.zeros_like(l1)
    else:
        r1 = 2.0 * hb.Hov
        if S1 is not None:
            r1 = r1 + S1
        r1 = r1 + contract("ie,ea->ia", l1, hb.Hvv)
        r1 -= contract("ma,im->ia", l1, hb.Hoo)
        r1 += contract("imef,efam->ia", l2, Hvvvo)
        r1 -= contract("mnae,iemn->ia", l2, hb.Hovoo)
        r1 += contract("me,ieam->ia", l1, Hovvo_s)
        if cc2:
            tmp = contract("me,nmfe->nf", l1, t2)
            r1 += contract("nf,inaf->ia", tmp, 2.0 * L[o, o, v, v])
            tmp = contract("me,mnfe->nf", l1, build_tau(t1, t2))
            r1 -= contract("nf,inaf->ia", tmp, 2.0 * ERI[o, o, v, v])
            r1 += contract("nf,inaf->ia", tmp, ERI[o, o, v, v].swapaxes(2, 3))
        else:
            r1 -= 2.0 * contract("ef,eifa->ia", Gvv, Hvovv)
            r1 += contract("ef,eiaf->ia", Gvv, Hvovv)
            r1 -= 2.0 * contract("mn,mina->ia", Goo, hb.Hooov)
            r1 += contract("mn,imna->ia", Goo, hb.Hooov)

    r2 = L[o, o, v, v]
    if not ccd:
        if S2 is not None:
            r2 = r2 + 0.5 * S2
        r2 = r2 + 2.0 * contract("ia,jb->ijab", l1, hb.Hov)
        r2 -= contract("ja,ib->ijab", l1, hb.Hov)
        r2 += 2.0 * contract("ie,ejab->ijab", l1, Hvovv)
        r2 -= contract("ie,ejba->ijab", l1, Hvovv)
        r2 -= 2.0 * contract("mb,jima->ijab", l1, hb.Hooov)
        r2 += contract("mb,ijma->ijab", l1, hb.Hooov)
    if cc2:
        r2 = r2 + contract("ijeb,ea->ijab", l2,
                           F[v, v] - contract("me,ma->ae", F[o, v], t1))
        r2 -= contract("mjab,im->ijab", l2,
                       F[o, o] + contract("ie,me->mi", t1, F[o, v]))
    else:
        r2 = r2 + contract("ijeb,ea->ijab", l2, hb.Hvv)
        r2 -= contract("mjab,im->ijab", l2, hb.Hoo)
        r2 += 0.5 * contract("mnab,ijmn->ijab", l2, hb.Hoooo)
        r2 += 0.5 * vvvv_contract_efab(l2, hb.Hvvvv_efab, ladder)
        r2 += contract("mjeb,ieam->ijab", l2, Hovvo_s)
        r2 -= contract("mibe,jema->ijab", l2, hb.Hovov)
        r2 -= contract("mieb,jeam->ijab", l2, hb.Hovvo)
        r2 += contract("ae,ijeb->ijab", Gvv, L[o, o, v, v])
        r2 -= contract("mi,mjab->ijab", Goo, L[o, o, v, v])
    r2 = r2 + r2.permute(1, 0, 3, 2)
    return r1, r2


def cc3_extra_fn(cc):
    """The Lambda-CC3 extras for cc: the slab form or the full-tensor form
    (`ccwfn.t3_slabs`)."""
    from .ccwfn import t3_slabs
    return cc3.cc3_lambda_extra_scan if t3_slabs(cc) else cc3.cc3_lambda_extra


def lambda_residuals_from_F(model, F, ERI, L, t1, t2, l1, l2, no,
                            real_time=False, F_ref=None, ladder=vvvv_nt,
                            slabs=None, vvvv=None):
    """Rebuild HBAR from F on the fly (the real-time path's residual, F
    dressed by the field, every operand complex); CC3 takes the CCSD form
    plus its T3/L3 extras, in the slab form when `slabs` is True, the
    full-tensor form when False, and for None past o^3 v^3 = 2e8 elements
    (pycc_tpu's rule).  The Hvvvv ladder goes through `ladder`: under
    complex amplitudes one K1 launch on the HBAR's stacked complex
    operand.  vvvv: a mesh ccwfn's ladder operand (`parallel/mesh.
    mesh_vvvv`), over which Hvvvv is built, and its ladder run, shard by
    shard (`cchbar.build_hbar`)."""
    base = "CCSD" if model == "CC3" else model
    hb = build_hbar(base, F, ERI, L, t1, t2, no, vvvv=vvvv)
    r1, r2 = lambda_residuals(base, hb, F, ERI, L, t1, t2, l1, l2, no,
                              ladder=ladder)
    if model == "CC3":
        if slabs is None:
            from .ccwfn import T3_FULL_MAX
            slabs = no ** 3 * t2.shape[2] ** 3 > T3_FULL_MAX
        fn = cc3.cc3_lambda_extra_scan if slabs else cc3.cc3_lambda_extra
        Y1, Y2 = fn(F, ERI, L, t1, t2, l1, l2, no, real_time=real_time,
                    F_ref=F_ref)
        r1 = r1 + Y1
        r2 = r2 + Y2
    return r1, r2


def lambda_residuals_from_F_df(model, F, dfb, t1, t2, l1, l2, no,
                               real_time=False, F_ref=None, nblocks=None,
                               ladder=vvvv_nt):
    """`lambda_residuals_from_F` over Cholesky/DF factors: the DF-HBAR
    rebuilt from the (field-dressed) F each call (`build_hbar_df`, the CC2
    forms for CC2, else the CCSD forms) and `lambda_residuals_df`, whose
    ladder is one `ladder` call an a-block; no four-index object exists.
    CCD reduces to the CCSD forms at t1 = l1 = 0, with r1 pinned to zero.
    CC3 adds the factor-assembled slab extras
    (`cc3.cc3_lambda_extra_scan_df`)."""
    from .models.dfhbar import build_hbar_df, lambda_residuals_df
    if model not in ("CCD", "CC2", "CCSD", "CC3"):
        raise ValueError("Lambda over factors from F supports CCD, CC2, "
                         "CCSD and CC3 (got %s)." % model)
    dfh = build_hbar_df(F, dfb, t1, t2, no,
                        model="CC2" if model == "CC2" else "CCSD")
    r1, r2 = lambda_residuals_df(dfh, t1, t2, l1, l2, no, nblocks=nblocks,
                                 model="CCSD" if model == "CC3" else model,
                                 F=F, ladder=ladder)
    if model == "CC3":
        Y1, Y2 = cc3.cc3_lambda_extra_scan_df(F, dfb, t1, t2, l1, l2, no,
                                              real_time=real_time,
                                              F_ref=F_ref)
        r1 = r1 + Y1
        r2 = r2 + Y2
    return r1, r2


def pseudoenergy(ERI, l2, no):
    o, v = slices(no)
    return 0.5 * contract("ijab,ijab->", ERI[o, o, v, v], l2)


class cclambda:
    """cclambda(ccwfn, hbar).solve_lambda(...) on ccwfn's device, with
    l1 = 2 t1 and l2 = 2 (2 t2 - t2^T) as the start."""

    def __init__(self, ccwfn, hbar):
        self.ccwfn = ccwfn
        self.hbar = hbar
        self.l1 = 2.0 * ccwfn.t1
        self.l2 = 2.0 * (2.0 * ccwfn.t2 - ccwfn.t2.swapaxes(2, 3))

    def residuals(self, F, t1, t2, l1, l2):
        """Standalone residuals rebuilding HBAR from F (for RT-CC): over
        the dense tensors or block views, or over factors
        (`lambda_residuals_from_F_df`)."""
        cc = self.ccwfn
        if getattr(cc, "storage", "full") == "df":
            return lambda_residuals_from_F_df(
                cc.model, F, cc.dfb, t1, t2, l1, l2, cc.no,
                nblocks=getattr(cc, "df_nblocks", None))
        ERI, L = eri_views(cc)
        return lambda_residuals_from_F(cc.model, F, ERI, L, t1, t2, l1, l2,
                                       cc.no, vvvv=mesh_vvvv(cc))

    def solve_lambda_mixed(self, e_conv=1e-10, r_conv=1e-10, maxiter=100,
                           sp_conv=1e-6, sp_dtype=torch.float32,
                           refine_maxiter=None, **kw):
        """Mixed-precision Lambda, the scheme of ccwfn.solve_cc_mixed: the
        HBAR rebuilt in `sp_dtype` (float32) and Lambda converged to
        sp_conv or its noise floor, then the HBAR rebuilt in float64 and
        the same l1/l2 refined to e_conv/r_conv.  t1/t2 are a parameter of
        the Lambda equations, so the exact float64 amplitudes are kept
        through the floor stage and restored for the refinement, which
        starts from the floor's l2 made pair-symmetric.
        `self.hbar` is left at the float64 build and `self.e_sp_floor` is
        the floor's pseudo-energy.  Needs a precision='DP' ccwfn."""
        from .cchbar import cchbar
        cc = self.ccwfn
        if getattr(cc, "local", None) is not None:
            raise ValueError("solve_lambda_mixed supports canonical "
                             "storage modes only.")
        if cc.precision != "DP":
            raise ValueError("solve_lambda_mixed needs a precision='DP' "
                             "ccwfn construction (the f64 masters are the "
                             "refinement-stage Hamiltonian).")
        cc._ensure_mixed_masters()
        t1_64, t2_64 = cc.t1, cc.t2
        cc._cast_stage(sp_dtype)
        self.hbar = cchbar(cc)
        self.l1, self.l2 = self.l1.to(sp_dtype), self.l2.to(sp_dtype)
        self.e_sp_floor = float(self.solve_lambda(sp_conv, sp_conv, maxiter,
                                                  **kw))
        cc._cast_stage(torch.float64)
        cc.t1, cc.t2 = t1_64, t2_64
        self.hbar = cchbar(cc)
        self.l1 = self.l1.to(torch.float64)
        self.l2 = pair_symmetric(self.l2.to(torch.float64))
        return self.solve_lambda(e_conv, r_conv, refine_maxiter or maxiter,
                                 **kw)

    def _residual_fn(self, hb, S1, S2):
        """(residuals(l1, l2) -> (r1, r2), the <oo|vv> integrals of the
        pseudo-energy) for this ccwfn's storage and model: the DF-HBAR
        residual over factors (CC3 adding its factor-assembled slab
        extras) or the dense one (CC3 adding the full or slab extras)."""
        cc = self.ccwfn
        H, no, model = cc.H, cc.no, cc.model
        t1, t2 = cc.t1, cc.t2
        if getattr(cc, "storage", "full") == "df":
            from .models.dfccsd import _eri_oovv
            from .models.dfhbar import lambda_residuals_df

            def residuals(l1, l2):
                r1, r2 = lambda_residuals_df(hb, t1, t2, l1, l2, no, S1, S2,
                                             nblocks=getattr(
                                                 cc, "df_nblocks", None),
                                             model=model, F=H.F)
                if model == "CC3":
                    Y1, Y2 = cc3.cc3_lambda_extra_scan_df(H.F, cc.dfb, t1,
                                                          t2, l1, l2, no)
                    r1, r2 = r1 + Y1, r2 + Y2
                return r1, r2
            return residuals, _eri_oovv(cc.dfb)

        extra = cc3_extra_fn(cc) if model == "CC3" else None
        ERI, L = eri_views(cc)

        def residuals(l1, l2):
            r1, r2 = lambda_residuals(model, hb, H.F, ERI, L, t1, t2, l1, l2,
                                      no, S1, S2)
            if extra is not None:
                Y1, Y2 = extra(H.F, ERI, L, t1, t2, l1, l2, no)
                r1, r2 = r1 + Y1, r2 + Y2
            return r1, r2
        o, v = slices(no)
        return residuals, ERI[o, o, v, v]

    def solve_lambda(self, e_conv=1e-7, r_conv=1e-7, maxiter=100, max_diis=8,
                     start_diis=1, stall_limit=10, chk=None, chk_every=10,
                     chk_ring=False, resume=False):
        """Iterate the Lambda equations to the requested tolerances; returns
        the pseudo-energy.  max_diis=0 turns DIIS off; the noise-floor stop
        after `stall_limit` iterations without a 2% rms gain sets
        `self.converged` from the energy change alone, as in solve_cc.
        chk/chk_every/chk_ring/resume checkpoint the post-extrapolation
        l1/l2 (keys l1, l2, niter, lecc, and the DIIS ring), as
        ccwfn.solve_cc does."""
        from .ccwfn import _load_ring
        tstart = time.time()
        cc = self.ccwfn
        no = cc.no
        H = cc.H
        hb = getattr(self.hbar, "hbar", self.hbar)

        S1 = getattr(cc, "S1", None)
        S2 = getattr(cc, "S2", None)
        if cc.model == "CCSD(T)" and S1 is None:
            from .triples import t3_lambda_sources
            S1, S2 = t3_lambda_sources(cc)
        residuals, eri_oovv = self._residual_fn(hb, S1, S2)
        local = (cc.Local if getattr(cc, "local", None) is not None
                 else None)

        eps = torch.diagonal(H.F).to(self.l1.dtype)
        D1 = eps[:no, None] - eps[None, no:]
        D2 = (eps[:no, None, None, None] + eps[None, :no, None, None]
              - eps[None, None, no:, None] - eps[None, None, None, no:])
        use_diis = max_diis > 0
        niter0 = 0
        ring = None
        if resume and chk is not None and os.path.exists(chk):
            from .utils.checkpoint import load_amps
            d = load_amps(chk)
            dev = self.l1.device
            self.l1 = torch.as_tensor(d["l1"]).to(dev, self.l1.dtype)
            self.l2 = torch.as_tensor(d["l2"]).to(dev, self.l2.dtype)
            niter0 = int(d["niter"])
            if "diis_amps" in d and use_diis:
                ring = d
            log.info("Lambda-CC resumed from %s at iteration %d%s"
                     % (chk, niter0, " (with DIIS ring)" if ring else ""))
        diis = DIIS((self.l1, self.l2), max_diis=max(max_diis, 1))
        state = diis.init() if use_diis else None
        if ring is not None:
            _load_ring(diis, state, ring, "Lambda")

        l1, l2 = self.l1, self.l2
        lecc = float(0.5 * contract("ijab,ijab->", eri_oovv, l2))
        log.info("\nLCC Iter %3d: LCC PseudoE = %.15f  dE = % .5E"
                 % (niter0, lecc, -lecc))
        rms = float("inf")
        ediff = float("nan")
        best_rms = float("inf")
        stalled = 0
        for niter in range(niter0 + 1, maxiter + 1):
            with cc.timers.time("lambda.iteration"):
                lecc_last = lecc
                r1, r2 = residuals(l1, l2)
                if local is not None:
                    # the step in each pair's truncated space
                    inc1, inc2 = local.filter_amps(r1, r2)
                else:
                    inc1 = r1 / D1
                    inc2 = r2 / D2
                l1n = l1 + inc1
                l2n = l2 + inc2
                rms_t = torch.sqrt(torch.sum(inc1 * inc1)
                                   + torch.sum(inc2 * inc2))
                lecc_t = 0.5 * contract("ijab,ijab->", eri_oovv, l2n)
                if use_diis:
                    diis.push(state, (l1n, l2n), (l1, l2))
                    if niter >= start_diis:
                        l1, l2 = diis.extrapolate(state, (l1n, l2n))
                    else:
                        l1, l2 = l1n, l2n
                else:
                    l1, l2 = l1n, l2n
                # the one host read of the iteration
                lecc, rms = torch.stack([lecc_t, rms_t]).tolist()
            self.l1, self.l2 = l1n, l2n
            self.niter = niter
            ediff = lecc - lecc_last
            log.info("LCC Iter %3d: LCC PseudoE = %.15f  dE = % .5E  "
                     "rms = % .5E" % (niter, lecc, ediff, rms))
            if chk is not None and niter % chk_every == 0:
                from .utils.checkpoint import save_amps
                data = dict(l1=l1, l2=l2, niter=niter, lecc=lecc)
                if chk_ring and use_diis:
                    data.update(diis_amps=state.amps, diis_errs=state.errs,
                                diis_count=state.count)
                save_amps(chk, **data)
            if rms < 0.98 * best_rms:
                best_rms = rms
                stalled = 0
            else:
                stalled += 1
                if stall_limit and stalled >= stall_limit and rms >= r_conv:
                    self.converged = abs(ediff) < e_conv
                    log.info("\nLambda-CC hit the working-precision noise "
                             "floor (rms %.3E > r_conv %.1E, no improvement "
                             "in %d iterations); stopping with dE = %.3E.\n"
                             % (rms, r_conv, stall_limit, ediff))
                    return lecc
            if abs(ediff) < e_conv and rms < r_conv:
                self.converged = True
                log.info("\nLambda-CC has converged in %.3f seconds.\n"
                         % (time.time() - tstart))
                return lecc
        self.l1, self.l2 = l1, l2
        self.converged = False
        warnings.warn("Lambda-CC did NOT converge in %d iterations "
                      "(dE=%.2e rms=%.2e)" % (maxiter, ediff, rms))
        return lecc
