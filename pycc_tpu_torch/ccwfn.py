"""CC T-amplitude solver driver.

The counterpart of pycc_tpu/ccwfn.py for storage='full' and 'df' and the
models CCD, CC2, CCSD, CCSD(T) and CC3:
``ccwfn(scf_wfn, model=..., precision=..., device=..., storage=...)``
(or ``ccwfn.from_df_factors(B, F, no, ...)``) then ``solve_cc(e_conv,
r_conv, maxiter, max_diis, start_diis, stall_limit)``.  Each iteration
evaluates the residuals, takes a Jacobi step from diag(F), pushes the
step into the on-device DIIS ring and extrapolates, all eagerly on
`device`; the host reads one (energy, rms) pair per iteration.  For
CCSD(T) the converged CCSD amplitudes then feed the (T) energy
(`triples.t_vikings_scan`, through K2), or with make_t3_density=True the
(T) density (`ccwfn.t3_density`, which also leaves the Lambda sources and
density blocks for cclambda/ccdensity; t3_scan=True/False forces its slab
scan or its full-tensor form; over DF factors always the scan).  CC3
adds the T3 terms to the CCSD residual (models/cc3.py): over the full T3
tensor while o^3 v^3 is at most 2e8 elements, else one (i, j) slab at a
time; t3_scan=True/False forces the slab or the full-tensor form here
too, and storage='df' always takes the slab form.

storage='df' replaces the nact^4 ERI and L by three-index Cholesky
factors (`self.dfb`) and evaluates the residuals from them
(models/dfccsd.py).  With df_direct (the default when the SCF
wavefunction carries AO factors, i.e. run_rhf(df=True)) no four-index
tensor exists anywhere: AO factors -> MO transform (host) ->
recompression to active-space rank (on `device`).  Otherwise the dense MO
ERI is built once, factored on `device` and dropped.
"""

import dataclasses
import time
import warnings

import numpy as np
import torch

from . import triples
from .hamiltonian import Hamiltonian, build_hamiltonian
from .models import cc3
from .models import ccsd as eqs
from .models import dfccsd as dfq
from .ops.diis import DIIS
from .utils.device import init_device
from .utils.log import logger as log
from .utils.timing import Timers

_RESIDUALS = {
    "CCD": eqs.residuals_ccd,
    "CC2": eqs.residuals_cc2,
    "CCSD": eqs.residuals_ccsd,
    "CCSD(T)": eqs.residuals_ccsd,
    "CC3": cc3.residuals_cc3,
}

_ENERGY = {
    "CCD": eqs.ccd_energy,
    "CC2": eqs.cc_energy,
    "CCSD": eqs.cc_energy,
    "CCSD(T)": eqs.cc_energy,
    "CC3": eqs.cc_energy,
}

_DF_RESIDUALS = {
    "CCD": dfq.residuals_ccd_df,
    "CC2": dfq.residuals_cc2_df,
    "CCSD": dfq.residuals_ccsd_df,
    "CCSD(T)": dfq.residuals_ccsd_df,
    "CC3": cc3.residuals_cc3_scan_df,
}

# past this many o^3 v^3 elements the triples run one slab at a time
T3_FULL_MAX = 2e8

_NOT_PORTED_STORAGE = {
    "blocked": "Queue 1, item 10 (blocked storage and mixed precision)",
}
_NOT_PORTED_INIT_KWARGS = {
    "local": "Queue 1, item 12 (local correlation)",
    "local_cutoff": "Queue 1, item 12 (local correlation)",
    "pair_cutoff": "Queue 1, item 12 (local correlation)",
    "local_mos": "Queue 1, item 12 (local correlation)",
    "it2_opt": "Queue 1, item 12 (local correlation)",
    "filter": "Queue 1, item 12 (local correlation)",
    "mesh": "Queue 1, item 13 (multi-device)",
    "real_time": "Queue 1, item 11 (real-time CC)",
}
_NOT_PORTED_SOLVE_KWARGS = {
    "bf16_until": "Queue 1, item 10 (blocked storage and mixed precision)",
    "chk": "Queue 1, item 10 (checkpoint/resume)",
    "chk_every": "Queue 1, item 10 (checkpoint/resume)",
    "chk_ring": "Queue 1, item 10 (checkpoint/resume)",
    "resume": "Queue 1, item 10 (checkpoint/resume)",
}


def _not_ported(what, item):
    return NotImplementedError("%s is not ported yet: ROADMAP.md %s."
                               % (what, item))


def _reject(kwargs, table, where):
    for name in kwargs:
        if name not in table:
            raise TypeError("%s got an unexpected keyword argument %r"
                            % (where, name))
        raise _not_ported("%s(%s=...)" % (where, name), table[name])


def t3_slabs(cc):
    """Whether cc's triples (CC3's T3/L3, the (T) density) run one slab at
    a time: always over DF factors (the full-tensor forms read the dense
    ERI), else past o^3 v^3 = T3_FULL_MAX elements, unless cc.t3_scan
    (True/False) forces the slab or the full-tensor form."""
    if getattr(cc, "storage", "full") == "df":
        return True
    scan = getattr(cc, "t3_scan", None)
    if scan is None:
        return cc.no ** 3 * cc.nv ** 3 > T3_FULL_MAX
    return bool(scan)


def _check_model(model):
    model = model.upper()
    if model not in _RESIDUALS:
        raise ValueError("%s is not an allowed CC model." % model)
    return model


def _check_precision(precision):
    precision = precision.upper()
    if precision not in ("SP", "DP"):
        raise ValueError("%s is not an allowed precision arithmetic."
                         % precision)
    return precision


class ccwfn:
    """An RHF-CC wave function and energy object on one torch device.

    storage='df' options: df_tol (the Cholesky tolerance, default 1e-8),
    df_direct (None: on when scf_wfn carries AO factors), df_nblocks (the
    ladder's a-blocks; None: `dfccsd._ladder_blocks`).  They are ignored
    under storage='full', as pycc_tpu ignores them."""

    def __init__(self, scf_wfn, model="CCSD", precision="DP", device="cuda",
                 storage="full", df_tol=1e-8, df_direct=None,
                 df_nblocks=None, make_t3_density=False, t3_scan=None,
                 **kwargs):
        time_init = time.time()
        model = _check_model(model)
        storage = storage.lower()
        if storage in _NOT_PORTED_STORAGE:
            raise _not_ported("storage=%r" % storage,
                              _NOT_PORTED_STORAGE[storage])
        if storage not in ("full", "df"):
            raise ValueError("%s is not an allowed storage mode." % storage)
        precision = _check_precision(precision)
        _reject(kwargs, _NOT_PORTED_INIT_KWARGS, "ccwfn")

        self.model = model
        self.make_t3_density = bool(make_t3_density)
        self.t3_scan = t3_scan
        self.storage = storage
        self.precision = precision
        self.device = init_device(device)
        self.dtype = torch.float64 if precision == "DP" else torch.float32
        self.timers = Timers()

        self.ref = scf_wfn
        self.eref = scf_wfn.energy()
        self.nfzc = scf_wfn.frzcpi()[0]
        self.no = scf_wfn.doccpi()[0] - self.nfzc
        self.nmo = scf_wfn.nmo()
        self.nv = self.nmo - self.no - self.nfzc
        self.nact = self.no + self.nv

        if storage == "full":
            self.H = build_hamiltonian(scf_wfn, device=self.device,
                                       dtype=self.dtype)
            self._set_amplitudes(self.H.ERI[self.o, self.o, self.v, self.v])
        else:
            if df_direct is None:
                df_direct = getattr(scf_wfn, "B_ao", None) is not None
            self.df_direct = bool(df_direct)
            self.df_tol = df_tol
            self.df_nblocks = df_nblocks
            # F and the factors are made in float64; both take the
            # working dtype below
            with self.timers.time("ccwfn.hamiltonian"):
                H = build_hamiltonian(scf_wfn, device=self.device,
                                      eri=not self.df_direct)
            if self.df_direct:
                B = self._df_factors_direct(scf_wfn)
            else:
                from .ops.cholesky import cholesky_factor_eri
                with self.timers.time("ccwfn.df_cholesky"):
                    B = cholesky_factor_eri(H.ERI, tol=df_tol,
                                            device=self.device)
            # nothing four-index stays: the factors carry the integrals
            self.H = dataclasses.replace(H, F=H.F.to(self.dtype), ERI=None,
                                         L=None)
            del H
            self._set_df(B)
        log.info("CCWFN object initialized in %.3f seconds."
                 % (time.time() - time_init))

    @property
    def o(self):
        return slice(0, self.no)

    @property
    def v(self):
        return slice(self.no, self.nact)

    def _df_factors_direct(self, scf_wfn):
        """Integral-direct factors: the AO Cholesky factors of
        run_rhf(df=True) when they are as tight as df_tol (else made
        here), the MO transform on the host, and the recompression to
        active-space rank on the device.  No four-index tensor exists at
        any point."""
        from .ops.cholesky import recompress_factors
        from .scf.df import cholesky_factor_ao, factors_to_mo

        B_ao = getattr(scf_wfn, "B_ao", None)
        B_tol = getattr(scf_wfn, "B_tol", None)
        if B_ao is None or B_tol is None or B_tol > self.df_tol:
            with self.timers.time("ccwfn.df_ao_cholesky"):
                B_ao = cholesky_factor_ao(scf_wfn.basisset(), tol=self.df_tol)
        C_act = np.asarray(scf_wfn.Ca_subset("AO", "ACTIVE"))
        with self.timers.time("ccwfn.df_factors_to_mo"):
            B_mo = factors_to_mo(np.asarray(B_ao), C_act)
        with self.timers.time("ccwfn.df_recompress"):
            # (each pivot reads one number back, so this waits for the card)
            return recompress_factors(B_mo, tol=self.df_tol,
                                      device=self.device)

    def _set_df(self, B):
        """The DF solver state from float64 factors B (naux, nact, nact):
        the factor blocks in the working dtype, the MP2 guess assembled
        from them, and the model's factor residuals."""
        self.naux = B.shape[0]
        self.dfb = dfq.df_blocks(B.to(self.dtype), self.no)
        self._set_amplitudes(dfq._eri_oovv(self.dfb))
        log.info("DF/Cholesky factors: naux = %d (tol %s%s)"
                 % (self.naux, self.df_tol,
                    ", integral-direct" if self.df_direct else ""))

    def _set_amplitudes(self, eri_oovv):
        """Denominators from diag(F), t1 = 0, the MP2 t2 guess, and the
        model's residual and energy functions for the storage."""
        o, v = self.o, self.v
        eps = torch.diagonal(self.H.F)
        self.Dia = eps[o, None] - eps[None, v]
        self.Dijab = (eps[o, None, None, None] + eps[None, o, None, None]
                      - eps[None, None, v, None] - eps[None, None, None, v])
        self.t1 = torch.zeros((self.no, self.nv), dtype=self.dtype,
                              device=self.device)
        self.t2 = eri_oovv / self.Dijab
        self._residual_fn = (_DF_RESIDUALS if self.storage == "df"
                             else _RESIDUALS)[self.model]
        if (self.model == "CC3" and self.storage == "full"
                and t3_slabs(self)):
            self._residual_fn = cc3.residuals_cc3_scan
        self._energy_fn = _ENERGY[self.model]

    @classmethod
    def from_df_factors(cls, B, F, no, escf=0.0, model="CCSD",
                        precision="DP", df_nblocks=None, mu=None,
                        device="cuda"):
        """A storage='df' solver straight from precomputed MO-basis
        Cholesky/DF factors B (naux, nact, nact) and the active-space MO
        Fock matrix F (frozen core already dropped), numpy arrays or
        tensors: the state pycc_tpu's prepare-on-host pipeline writes
        (examples/prepare_df_molecule.py), carried onto `device`.  mu:
        optional (3, nact, nact) MO dipole integrals, cast to the working
        dtype as F is; without them H.mu is `()`."""
        self = cls.__new__(cls)
        self.model = _check_model(model)
        self.precision = _check_precision(precision)
        self.storage = "df"
        self.make_t3_density = False
        self.t3_scan = None
        self.df_direct = True
        self.df_tol = None
        self.df_nblocks = df_nblocks
        self.device = init_device(device)
        self.dtype = torch.float64 if self.precision == "DP" else torch.float32
        self.timers = Timers()
        self.ref = None
        self.eref = float(escf)
        self.nfzc = 0

        F = torch.as_tensor(F, dtype=self.dtype, device=self.device)
        self.no = int(no)
        self.nact = F.shape[0]
        self.nmo = self.nact
        self.nv = self.nact - self.no
        mu = () if mu is None else tuple(
            torch.as_tensor(m, dtype=self.dtype, device=self.device)
            for m in mu)
        self.H = Hamiltonian(F=F, ERI=None, L=None, mu=mu, no=self.no)
        self._set_df(torch.as_tensor(B, dtype=torch.float64,
                                     device=self.device))
        return self

    # ------------------------------------------------------------------
    def residuals(self, F, t1, t2):
        """T1/T2 residuals r_mu = <mu|HBAR|0> for the current amplitudes."""
        if self.storage == "df":
            return self._residual_fn(F, self.dfb, t1, t2, self.no,
                                     nblocks=self.df_nblocks)
        H = self.H
        return self._residual_fn(F, H.ERI, H.L, H.vvvv, t1, t2, self.no)

    def cc_energy(self, t1, t2, F=None):
        F = self.H.F if F is None else F
        if self.storage == "df":
            # t1 stays 0 under CCD, where this is the CCD energy
            return dfq.cc_energy_df(F, self.dfb, t1, t2, self.no)
        return self._energy_fn(F, self.H.L, t1, t2, self.no)

    # ------------------------------------------------------------------
    def solve_cc(self, e_conv=1e-7, r_conv=1e-7, maxiter=100, max_diis=8,
                 start_diis=1, stall_limit=10, **kwargs):
        """Iterate the CC amplitude equations to the requested tolerances.

        max_diis=0 turns DIIS off (plain Jacobi).  When the update rms has
        not improved by 2% for `stall_limit` straight iterations (the
        working precision's noise floor, common in SP), the solve stops and
        `self.converged` says whether the energy change met e_conv.

        For model="CCSD(T)" a converged solve adds the (T) energy: the
        return value and `self.ecc` are E(CCSD) + E(T).  The noise-floor
        stop and a solve that does not converge return E(CCSD) alone, as
        pycc_tpu does."""
        _reject(kwargs, _NOT_PORTED_SOLVE_KWARGS, "solve_cc")
        tstart = time.time()
        F = self.H.F
        use_diis = max_diis > 0
        diis = DIIS((self.t1, self.t2), max_diis=max(max_diis, 1))
        state = diis.init() if use_diis else None

        t1, t2 = self.t1, self.t2
        ecc = float(self.cc_energy(t1, t2))
        log.info("CC Iter %3d: CC Ecorr = %.15f  dE = % .5E  MP2"
                 % (0, ecc, -ecc))
        rms = float("inf")
        ediff = float("nan")
        best_rms = float("inf")
        stalled = 0
        for niter in range(1, maxiter + 1):
            with self.timers.time("ccwfn.iteration"):
                ecc_last = ecc
                r1, r2 = self.residuals(F, t1, t2)
                inc1 = r1 / self.Dia
                inc2 = r2 / self.Dijab
                t1n = t1 + inc1
                t2n = t2 + inc2
                rms_t = torch.sqrt(torch.sum(inc1 * inc1)
                                   + torch.sum(inc2 * inc2))
                ecc_t = self.cc_energy(t1n, t2n)
                if use_diis:
                    # DIIS error = the Jacobi increment from the amplitudes
                    # this iteration started from (post-extrapolation)
                    diis.push(state, (t1n, t2n), (t1, t2))
                    if niter >= start_diis:
                        t1, t2 = diis.extrapolate(state, (t1n, t2n))
                    else:
                        t1, t2 = t1n, t2n
                else:
                    t1, t2 = t1n, t2n
                # the one host read of the iteration
                ecc, rms = torch.stack([ecc_t, rms_t]).tolist()
            self.t1, self.t2 = t1n, t2n
            self.niter = niter
            ediff = ecc - ecc_last
            log.info("CC Iter %3d: CC Ecorr = %.15f  dE = % .5E  rms = % .5E"
                     % (niter, ecc, ediff, rms))
            if rms < 0.98 * best_rms:
                best_rms = rms
                stalled = 0
            else:
                stalled += 1
                if stall_limit and stalled >= stall_limit and rms >= r_conv:
                    self.ecc = ecc
                    self.converged = abs(ediff) < e_conv
                    log.info("\nCCWFN hit the working-precision noise floor "
                             "(rms %.3E > r_conv %.1E, no improvement in %d "
                             "iterations); stopping with dE = %.3E.\n"
                             % (rms, r_conv, stall_limit, ediff))
                    self._report(ecc)
                    return ecc
            if abs(ediff) < e_conv and rms < r_conv:
                # converged amplitudes = the pre-extrapolation update
                self.converged = True
                log.info("\nCCWFN converged in %.3f seconds.\n"
                         % (time.time() - tstart))
                if self.model == "CCSD(T)":
                    log.info("E(CCSD) = %20.15f" % ecc)
                    with self.timers.time("ccwfn.triples"):
                        if self.make_t3_density:
                            et = float(self.t3_density())
                        else:
                            et = float(triples.t_vikings_scan(self))
                    log.info("E(T)    = %20.15f" % et)
                    ecc = ecc + et
                self.ecc = ecc
                self._report(ecc)
                return ecc
        self.t1, self.t2 = t1, t2
        self.ecc = ecc
        self.converged = False
        warnings.warn("CCWFN did NOT converge in %d iterations "
                      "(dE=%.2e rms=%.2e)" % (maxiter, ediff, rms))
        return ecc

    def t3_density(self):
        """E(T) with the (T) density blocks and Lambda sources, which stay
        on this object for cclambda and ccdensity (`triples.t3_density`,
        or the slab scan `t3_density_scan` past o^3 v^3 = 2e8, when
        t3_scan=True, and over DF factors)."""
        return triples.t3_density_energy(self)

    def _report(self, ecc):
        log.info("E(REF)  = %20.15f" % self.eref)
        log.info("E(%s) = %20.15f" % (self.model, ecc))
        log.info("E(TOT)  = %20.15f" % (ecc + self.eref))
        self.timers.report()
