"""CC T-amplitude solver driver.

The counterpart of pycc_tpu/ccwfn.py for storage='full', 'blocked' and
'df' and the models CCD, CC2, CCSD, CCSD(T) and CC3:
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

storage='blocked' keeps the six unique Dirac blocks (models/blocked.py,
`self.blocks`), each transformed straight from the AO ERI
(`hamiltonian.mo_eri_blocks`), instead of ERI and L: H.ERI = H.L = None,
and every consumer reads the block views (`models/blocked.eri_views`).

`solve_cc(bf16_until=...)` (blocked and DF storage) runs the early
residuals from bfloat16 operands, K1 in its bf16 mode;
`solve_cc_mixed` pre-converges in float32 and refines in float64 from
float64 host masters; `solve_cc(chk=..., resume=...)` checkpoints the
iterate and the DIIS ring (utils/checkpoint.py, pycc_tpu's format).

local='PNO'|'PNO++'|'CPNO++'|'PAO' (local_cutoff, local_mos, it2_opt)
localizes the occupied orbitals (scf/localize.py), rebuilds H in that
basis and builds the pair spaces (local.Local).  filter=True is the
simulation path: the dense residuals (K1 in the ladder), each Jacobi
step projected through the pair spaces (`Local.filter_amps`).
filter=False also builds the native pair-space solver, `self.lccwfn`
(lccwfn.py; pair_cutoff= screens its pairs, lccwfn_screened.py).
"""

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from . import triples
from .hamiltonian import (Hamiltonian, ao_properties, build_hamiltonian,
                          mo_eri_blocks)
from .models import cc3
from .models import ccsd as eqs
from .models import dfccsd as dfq
from .models.blocked import ERIBlocks, LoovvOnly, blocked_views, eri_views
from .models.dfhbar import loovv_df
from .ops.diis import DIIS
from .ops.kernels.vvvv import vvvv_nt
from .parallel.mesh import Sharded
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

_VALID_LOCAL = (None, "PNO", "PAO", "CPNO++", "PNO++")
# what a precision stage derives from the stage's tensors: _cast_stage
# drops them (the bf16 copies, the (T) Lambda sources and density blocks)
_STAGE_CACHES = ("_bf16", "S1", "S2", "Doo_t3", "Dvv_t3", "Dov_t3",
                 "Goovv", "Gooov", "Gvvvo")


def _not_ported(what, item):
    return NotImplementedError("%s is not ported yet: ROADMAP.md %s."
                               % (what, item))


def _check_mesh(mesh, device):
    """A mesh must be a parallel.mesh.Mesh, and the solver runs on its home
    device: `device` may only name that one."""
    from .parallel.mesh import Mesh
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh= takes a pycc_tpu_torch.parallel.Mesh (from "
                        "parallel.make_mesh), got %r" % type(mesh).__name__)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if dev != mesh.home:
        raise ValueError("mesh= runs on the mesh's home device %s, but "
                         "device=%r" % (mesh.home, device))


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

    storage: 'full' (ERI and L), 'blocked' (the six Dirac blocks) or 'df'
    (Cholesky factors).  mesh: a parallel.make_mesh mesh, whose home
    device `device` must name; the storage's v^4 and o v^3 operands are
    then laid over it and every ladder runs a K1 launch a shard
    (parallel/mesh.py).  storage='df' options: df_tol (the Cholesky
    tolerance, default 1e-8), df_direct (None: on when scf_wfn carries AO
    factors), df_nblocks (the ladder's a-blocks; None:
    `dfccsd._ladder_blocks`).  They are ignored under the other storages,
    as pycc_tpu ignores them."""

    def __init__(self, scf_wfn, model="CCSD", precision="DP", device="cuda",
                 storage="full", df_tol=1e-8, df_direct=None,
                 df_nblocks=None, make_t3_density=False, t3_scan=None,
                 real_time=False, local=None, local_cutoff=1e-5,
                 pair_cutoff=None, local_mos="PIPEK_MEZEY", it2_opt=True,
                 filter=False, mesh=None):
        time_init = time.time()
        model = _check_model(model)
        storage = storage.lower()
        if storage not in ("full", "blocked", "df"):
            raise ValueError("%s is not an allowed storage mode." % storage)
        precision = _check_precision(precision)
        _check_mesh(mesh, device)
        self._check_local(local, local_mos, pair_cutoff, model, filter,
                          storage, df_direct, scf_wfn, mesh)
        self.mesh = mesh
        self.local = local
        self.local_cutoff = local_cutoff
        self.pair_cutoff = pair_cutoff
        self.local_mos = local_mos
        self.it2_opt = it2_opt
        self.filter = filter

        self.model = model
        self.make_t3_density = bool(make_t3_density)
        self.t3_scan = t3_scan
        self.real_time = bool(real_time)
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

        # on a mesh the integrals are made in host memory and cut into
        # their pieces from there (_apply_mesh): the home device never
        # holds a whole v^4 operand
        hdev = self.device if mesh is None else torch.device("cpu")
        if local is not None:
            self._init_local(scf_wfn)
        elif storage == "full":
            self.H = build_hamiltonian(scf_wfn, device=hdev,
                                       dtype=self.dtype)
            self._apply_mesh()
            self._set_amplitudes(self.H.ERI[self.o, self.o, self.v, self.v])
        elif storage == "blocked":
            # no nact^4 tensor: F and the properties, then the six blocks
            with self.timers.time("ccwfn.hamiltonian"):
                self.H = build_hamiltonian(scf_wfn, device=hdev,
                                           dtype=self.dtype, eri=False)
            with self.timers.time("ccwfn.blocks"):
                self.blocks = mo_eri_blocks(scf_wfn, device=hdev,
                                            dtype=self.dtype)
            self._apply_mesh()
            self._set_amplitudes(self.blocks.oovv)
        else:
            if df_direct is None:
                df_direct = getattr(scf_wfn, "B_ao", None) is not None
            self.df_direct = bool(df_direct)
            self.df_tol = df_tol
            self.df_nblocks = df_nblocks
            # F and the factors are made in float64; both take the
            # working dtype below
            with self.timers.time("ccwfn.hamiltonian"):
                H = build_hamiltonian(scf_wfn, device=hdev,
                                      eri=not self.df_direct)
            if self.df_direct:
                B = self._df_factors_direct(scf_wfn)
            else:
                from .ops.cholesky import cholesky_factor_eri
                with self.timers.time("ccwfn.df_cholesky"):
                    B = cholesky_factor_eri(H.ERI, tol=df_tol, device=hdev)
            # nothing four-index stays: the factors carry the integrals
            self.H = dataclasses.replace(H, F=H.F.to(self.dtype), ERI=None,
                                         L=None)
            del H
            self._set_df(B)
        log.info("CCWFN object initialized in %.3f seconds."
                 % (time.time() - time_init))

    def _apply_mesh(self, dtype=None):
        """On a mesh, lay the storage over it (parallel/mesh.py) from
        wherever it was made, host memory included, each piece cast to
        `dtype` (None: as it is) on its way: the full ERI and L with the
        ladder's operand, the Dirac blocks or the DF factors, each on its
        layout, and F and the properties on the home device.  The
        amplitudes and the denominators are made on the home device after
        it.  Without a mesh nothing moves."""
        from .parallel.mesh import shard_blocks, shard_df, shard_hamiltonian
        if self.mesh is None:
            return
        self.H = shard_hamiltonian(self.H, self.mesh, dtype)
        if self.storage == "blocked":
            self.blocks = shard_blocks(self.blocks, self.mesh, dtype)
        elif self.storage == "df":
            self.dfb = shard_df(self.dfb, self.mesh, dtype)

    @staticmethod
    def _check_local(local, local_mos, pair_cutoff, model, filter, storage,
                     df_direct, scf_wfn, mesh):
        """The local keywords' checks and refusals, pycc_tpu's, made
        before anything is built."""
        if local not in _VALID_LOCAL:
            raise ValueError("%s is not an allowed local-CC model." % local)
        if local is not None and mesh is not None:
            if filter:
                raise ValueError("mesh sharding with local models requires "
                                 "the native pair-space solver "
                                 "(filter=False); the filter-simulation "
                                 "path is dense.")
            raise _not_ported("lccwfn(mesh=...)", "Queue 1, item 13b (the "
                              "pair stacks over a mesh)")
        if local_mos not in ("PIPEK_MEZEY", "BOYS"):
            raise ValueError("%s is not an allowed MO localization method."
                             % local_mos)
        if pair_cutoff is not None and (local is None
                                        or model not in ("CCD", "CCSD")
                                        or filter):
            raise ValueError("pair_cutoff requires a native local CCD/CCSD "
                             "run (local=..., model='CCD'|'CCSD', "
                             "filter=False).")
        if local is not None and storage == "df":
            if df_direct or (df_direct is None
                             and getattr(scf_wfn, "B_ao", None) is not None):
                raise ValueError("df_direct supports canonical models only "
                                 "(no dense ERI exists for local=%s)."
                                 % local)
            raise ValueError("storage='df' supports canonical models only "
                             "(local correlation uses the pair-space "
                             "solver).")

    def _init_local(self, scf_wfn):
        """pycc_tpu's local flow: localize the active occupied orbitals on
        the host, rebuild H in that basis, build the pair spaces (`Local`)
        and filter the MP2 guess through them; with filter=False also the
        native pair-space solver (`self.lccwfn`).  storage='blocked' cuts
        its blocks from the localized ERI, which H keeps: the pair spaces
        and the native solver read it."""
        from .local import Local
        from .models.blocked import blocks_from_full
        from .scf.localize import boys, pipek_mezey

        no = self.no
        C = np.array(scf_wfn.Ca_subset("AO", "ACTIVE"))
        with self.timers.time("ccwfn.localize"):
            if self.local_mos == "PIPEK_MEZEY":
                C[:, :no] = pipek_mezey(C[:, :no], np.asarray(scf_wfn.S_ao),
                                        scf_wfn.basisset())
            else:
                C[:, :no] = boys(C[:, :no], ao_properties(scf_wfn)[0])
        self.C = C
        with self.timers.time("ccwfn.hamiltonian"):
            self.H = build_hamiltonian(scf_wfn, C=C, device=self.device,
                                       dtype=self.dtype)
        if self.storage == "blocked":
            self.blocks = blocks_from_full(self.H.ERI, no)
        o, v = self.o, self.v
        self._set_amplitudes(self.H.ERI[o, o, v, v])
        with self.timers.time("ccwfn.local"):
            self.Local = Local(self.local, C, self.nfzc, no, self.nv, self.H,
                               self.local_cutoff, self.it2_opt, wfn=scf_wfn)
        self.t1, self.t2 = self.Local.filter_amps(self.t1,
                                                  self.H.ERI[o, o, v, v])
        if not self.filter:
            from .lccwfn import lccwfn
            with self.timers.time("ccwfn.lccwfn"):
                self.Local.trans_integrals(o, v)
                if self.pair_cutoff is None:
                    # the no^4 D^2 pair-pair overlaps: only the unscreened
                    # equations read them; the screened ones build their
                    # strong-pair block themselves
                    self.Local.overlaps()
                self.lccwfn = lccwfn(o, v, no, self.nv, self.H, self.local,
                                     self.model, self.eref, self.Local,
                                     pair_cutoff=self.pair_cutoff)

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
        if self.mesh is not None:
            # cut the factors into their pieces from host memory
            B = B.cpu()
        self.dfb = dfq.df_blocks(B.to(self.dtype), self.no)
        self._apply_mesh()
        self._set_amplitudes(dfq._eri_oovv(self.dfb))
        log.info("DF/Cholesky factors: naux = %d (tol %s%s)"
                 % (self.naux, self.df_tol,
                    ", integral-direct" if self.df_direct else ""))

    def _set_amplitudes(self, eri_oovv):
        """Denominators from diag(F), t1 = 0, the MP2 t2 guess, and the
        model's residual and energy functions for the storage."""
        self._set_denominators()
        self.t1 = torch.zeros((self.no, self.nv), dtype=self.dtype,
                              device=self.device)
        self.t2 = eri_oovv / self.Dijab
        self._bind_model()

    def _set_denominators(self):
        o, v = self.o, self.v
        eps = torch.diagonal(self.H.F)
        self.Dia = eps[o, None] - eps[None, v]
        self.Dijab = (eps[o, None, None, None] + eps[None, o, None, None]
                      - eps[None, None, v, None] - eps[None, None, None, v])

    def _bind_model(self):
        """The model's residual and energy functions for the storage."""
        self._residual_fn = (_DF_RESIDUALS if self.storage == "df"
                             else _RESIDUALS)[self.model]
        if (self.model == "CC3" and self.storage != "df"
                and t3_slabs(self)):
            self._residual_fn = cc3.residuals_cc3_scan
        self._energy_fn = _ENERGY[self.model]

    @classmethod
    def from_df_factors(cls, B, F, no, escf=0.0, model="CCSD",
                        precision="DP", df_nblocks=None, mu=None,
                        device="cuda", mesh=None):
        """A storage='df' solver straight from precomputed MO-basis
        Cholesky/DF factors B (naux, nact, nact) and the active-space MO
        Fock matrix F (frozen core already dropped), numpy arrays or
        tensors: the state pycc_tpu's prepare-on-host pipeline writes
        (examples/prepare_df_molecule.py), carried onto `device`.  mu:
        optional (3, nact, nact) MO dipole integrals, cast to the working
        dtype as F is; without them H.mu is `()`.  mesh: a
        parallel.make_mesh mesh; Bvv is then laid over it (`shard_df`)."""
        self = cls.__new__(cls)
        self.model = _check_model(model)
        self.precision = _check_precision(precision)
        _check_mesh(mesh, device)
        self.mesh = mesh
        self.storage = "df"
        self.local = None
        self.filter = False
        self.make_t3_density = False
        self.t3_scan = None
        self.real_time = False
        self.df_direct = True
        self.df_tol = None
        self.df_nblocks = df_nblocks
        self.device = init_device(device)
        self.dtype = torch.float64 if self.precision == "DP" else torch.float32
        self.timers = Timers()
        self.ref = None
        self.eref = float(escf)
        self.nfzc = 0

        F_in = F
        F = torch.as_tensor(F, dtype=self.dtype, device=self.device)
        self.no = int(no)
        self.nact = F.shape[0]
        self.nmo = self.nact
        self.nv = self.nact - self.no
        mu = () if mu is None else tuple(
            torch.as_tensor(m, dtype=self.dtype, device=self.device)
            for m in mu)
        self.H = Hamiltonian(F=F, ERI=None, L=None, mu=mu, no=self.no)
        if self.precision == "DP":
            # the float64 host masters of solve_cc_mixed, taken while B
            # and F are still what the caller handed in (a lazy stash
            # would copy the device factors back)
            Bh = torch.as_tensor(B, dtype=torch.float64, device="cpu")
            no_ = self.no
            self._mixed_masters = dict(
                F=torch.as_tensor(F_in, dtype=torch.float64, device="cpu"),
                ERI=None, L=None, blocks=None,
                dfb=dfq.DFERI(Boo=Bh[:, :no_, :no_], Bov=Bh[:, :no_, no_:],
                              Bvv=Bh[:, no_:, no_:]),
                mu=tuple(x.to("cpu", torch.float64) for x in mu),
                m=(), p=(), Q=())
        self._set_df(torch.as_tensor(
            B, dtype=torch.float64,
            device=self.device if mesh is None else "cpu"))
        return self

    # ------------------------------------------------------------------
    def vvvv(self):
        """<ab|ef> as one contiguous (v,v,v,v) tensor, K1's B operand."""
        if self.storage == "blocked":
            return self.blocks.vvvv
        return self.H.vvvv

    def residuals(self, F, t1, t2, ladder=vvvv_nt):
        """T1/T2 residuals r_mu = <mu|HBAR|0> for the amplitudes (t1, t2)
        and a Fock matrix F, which real-time CC dresses with the field:
        the model's function for the storage (`_residual_fn`), its
        particle-particle ladder through `ladder` (K1 by default; CC2 has
        none), CC3's with real_time=self.real_time and F_ref=self.H.F, as
        pycc_tpu binds them."""
        kw = {} if self.model == "CC2" else {"ladder": ladder}
        if self.model == "CC3":
            kw.update(real_time=self.real_time, F_ref=self.H.F)
        if self.storage == "df":
            return self._residual_fn(F, self.dfb, t1, t2, self.no,
                                     nblocks=self.df_nblocks, **kw)
        ERI, L = eri_views(self)
        return self._residual_fn(F, ERI, L, self.vvvv(), t1, t2, self.no,
                                 **kw)

    def _integrals_bf16(self):
        """bfloat16 copies of the blocks or the factors, made once a stage
        (`_cast_stage` drops them)."""
        if "_bf16" not in self.__dict__:
            if self.storage == "df":
                self._bf16 = dfq.DFERI(*(b.to(torch.bfloat16)
                                         for b in self.dfb))
            else:
                self._bf16 = ERIBlocks(*(b.to(torch.bfloat16)
                                         for b in self.blocks))
        return self._bf16

    def residuals_bf16(self, F, t1, t2):
        """The residuals from bfloat16 operands: F, t1, t2 and the blocks
        or factors are all cast, so no float64 leftover promotes a product
        back; K1 takes its bf16 mode (`ladder_product`).  The result is
        bfloat16."""
        bf = torch.bfloat16
        F16, t1_16, t2_16 = F.to(bf), t1.to(bf), t2.to(bf)
        H16 = self._integrals_bf16()
        if self.storage == "df":
            return self._residual_fn(F16, H16, t1_16, t2_16, self.no,
                                     nblocks=self.df_nblocks)
        bE, bL = blocked_views(H16, self.no)
        return self._residual_fn(F16, bE, bL, H16.vvvv, t1_16, t2_16,
                                 self.no)

    def _loovv_bf16_stage(self):
        """L[o,o,v,v] for the energy of a bf16 step, in the working dtype:
        from blocks.oovv, or over DF assembled from the bf16 factors and
        cast up, as pycc_tpu's step16 has it."""
        if self.storage == "df":
            return loovv_df(self._integrals_bf16()).to(self.t2.dtype)
        e = self.blocks.oovv
        return 2.0 * e - e.swapaxes(2, 3)

    def cc_energy(self, t1, t2, F=None):
        F = self.H.F if F is None else F
        if self.storage == "df":
            # t1 stays 0 under CCD, where this is the CCD energy
            return dfq.cc_energy_df(F, self.dfb, t1, t2, self.no)
        return self._energy_fn(F, eri_views(self)[1], t1, t2, self.no)

    # ------------------------------------------------------------------
    def solve_cc(self, e_conv=1e-7, r_conv=1e-7, maxiter=100, max_diis=8,
                 start_diis=1, bf16_until=0.0, stall_limit=10, chk=None,
                 chk_every=10, chk_ring=False, resume=False):
        """Iterate the CC amplitude equations to the requested tolerances.

        max_diis=0 turns DIIS off (plain Jacobi).  When the update rms has
        not improved by 2% for `stall_limit` straight iterations (the
        working precision's noise floor, common in SP), the solve stops and
        `self.converged` says whether the energy change met e_conv.

        bf16_until > 0 (storage 'blocked' or 'df', models CCD, CC2, CCSD,
        CCSD(T)) evaluates the residuals from bfloat16 operands
        (`residuals_bf16`) while the update, DIIS and the energy stay in
        the working dtype, until the rms drops below bf16_until.  A bf16
        step whose rms does not improve (the bf16 noise floor) is rolled
        back, the DIIS ring's overwritten slot included, and the solve
        goes on in the working dtype.  `self.niter_bf16` counts the bf16
        iterations.

        chk=<path.npz> saves the post-extrapolation iterate (t1, t2,
        niter, ecc; with chk_ring=True the DIIS ring too) every
        `chk_every` iterations, atomically (utils/checkpoint.py, the
        format of pycc_tpu's); resume=True reloads it and continues the
        iteration count, on the uninterrupted trajectory when the ring
        was saved.  A ring of another depth than max_diis is dropped with
        a warning.

        For model="CCSD(T)" a converged solve adds the (T) energy: the
        return value and `self.ecc` are E(CCSD) + E(T).  The noise-floor
        stop and a solve that does not converge return E(CCSD) alone, as
        pycc_tpu does."""
        tstart = time.time()
        F = self.H.F
        use_bf16 = (bf16_until > 0 and self.storage in ("blocked", "df")
                    and self.local is None and self.model != "CC3")
        if bf16_until > 0 and not use_bf16:
            raise ValueError("bf16_until requires storage='blocked' or 'df' "
                             "and a canonical (non-local, non-CC3) model.")
        use_diis = max_diis > 0

        niter0 = 0
        ring = None
        if resume and chk is not None and os.path.exists(chk):
            from .utils.checkpoint import load_amps
            d = load_amps(chk)
            self.t1 = torch.as_tensor(d["t1"]).to(self.device, self.t1.dtype)
            self.t2 = torch.as_tensor(d["t2"]).to(self.device, self.t2.dtype)
            niter0 = int(d["niter"])
            if "diis_amps" in d and use_diis:
                ring = d
            log.info("CCWFN resumed from %s at iteration %d%s"
                     % (chk, niter0, " (with DIIS ring)" if ring else ""))
        diis = DIIS((self.t1, self.t2), max_diis=max(max_diis, 1))
        state = diis.init() if use_diis else None
        if ring is not None:
            _load_ring(diis, state, ring, "CCWFN")

        t1, t2 = self.t1, self.t2
        ecc = float(self.cc_energy(t1, t2))
        log.info("CC Iter %3d: CC Ecorr = %.15f  dE = % .5E  MP2"
                 % (niter0, ecc, -ecc))
        Loovv16 = self._loovv_bf16_stage() if use_bf16 else None
        bf16_active = use_bf16
        self.niter_bf16 = 0
        rms = float("inf")
        ediff = float("nan")
        best_rms = float("inf")
        stalled = 0
        for niter in range(niter0 + 1, maxiter + 1):
            with self.timers.time("ccwfn.iteration"):
                ecc_last = ecc
                if bf16_active and rms <= bf16_until:
                    bf16_active = False
                if bf16_active:
                    # the step may be rolled back: keep the pre-step
                    # amplitudes and what the push will overwrite
                    prev = (rms, t1, t2,
                            diis.mark(state) if use_diis else None)
                    r1, r2 = self.residuals_bf16(F, t1, t2)
                    r1, r2 = r1.to(t1.dtype), r2.to(t2.dtype)
                    self.niter_bf16 += 1
                else:
                    r1, r2 = self.residuals(F, t1, t2)
                if self.local is not None:
                    # the Jacobi step in each pair's truncated space
                    inc1, inc2 = self.Local.filter_amps(r1, r2)
                else:
                    inc1 = r1 / self.Dia
                    inc2 = r2 / self.Dijab
                t1n = t1 + inc1
                t2n = t2 + inc2
                rms_t = torch.sqrt(torch.sum(inc1 * inc1)
                                   + torch.sum(inc2 * inc2))
                if bf16_active:
                    ecc_t = self._energy_fn(F, LoovvOnly(Loovv16, self.no),
                                            t1n, t2n, self.no)
                else:
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
                if bf16_active and not rms < prev[0]:
                    # the bf16 noise floor (or a non-finite step): DIIS
                    # would extrapolate on noise, so undo the step and go
                    # on in the working dtype
                    log.info("CC Iter %3d: bf16 stage hit its noise floor "
                             "(rms % .3E); switching to full precision"
                             % (niter, rms))
                    bf16_active = False
                    rms, t1, t2 = prev[:3]
                    if use_diis:
                        diis.restore(state, prev[3])
            self.t1, self.t2 = t1n, t2n
            self.niter = niter
            ediff = ecc - ecc_last
            log.info("CC Iter %3d: CC Ecorr = %.15f  dE = % .5E  rms = % .5E"
                     % (niter, ecc, ediff, rms))
            if chk is not None and niter % chk_every == 0:
                self._save_chk(chk, t1, t2, niter, ecc,
                               state if chk_ring and use_diis else None)
            if rms < 0.98 * best_rms:
                best_rms = rms
                stalled = 0
            elif not bf16_active:
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

    def _save_chk(self, chk, t1, t2, niter, ecc, state):
        from .utils.checkpoint import save_amps
        data = dict(t1=t1, t2=t2, niter=niter, ecc=ecc)
        if state is not None:
            data.update(diis_amps=state.amps, diis_errs=state.errs,
                        diis_count=state.count)
        with self.timers.time("ccwfn.checkpoint"):
            save_amps(chk, **data)

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

    # ------------------------------------------------------------------
    def _ensure_mixed_masters(self):
        """Stash float64 host (CPU) masters of F, the integrals of the
        storage (ERI and L, the blocks or the factors) and the property
        operators: each precision stage's device copies are cast from
        them, so the card never holds both precisions at once."""
        if "_mixed_masters" in self.__dict__:
            return

        def host(x):
            if isinstance(x, Sharded):
                return x.full("cpu")
            return None if x is None else x.detach().to("cpu", copy=True)

        H = self.H
        self._mixed_masters = dict(
            F=host(H.F),
            ERI=host(H.ERI) if self.storage == "full" else None,
            L=host(H.L) if self.storage == "full" else None,
            blocks=(ERIBlocks(*map(host, self.blocks))
                    if self.storage == "blocked" else None),
            dfb=(dfq.DFERI(*map(host, self.dfb))
                 if self.storage == "df" else None),
            **{k: tuple(map(host, getattr(H, k)))
               for k in ("mu", "m", "p", "Q")})

    def _cast_stage(self, dtype):
        """Re-point everything a residual, Lambda or sigma reads at `dtype`
        copies of the float64 masters on the device: F, the integrals of
        the storage, the properties (mu and Q in `dtype`, m and p in its
        complex width), the amplitudes (t2 made pair-symmetric,
        `models/ccsd.pair_symmetric`); re-derive Dia/Dijab and rebind the
        model; drop the caches derived from the old stage (`_STAGE_CACHES`:
        the bf16 copies, the (T) sources and density blocks).  The old
        stage's integrals lose their last reference before the new ones
        are made."""
        m = self._mixed_masters
        dev = self.device
        cdtype = torch.complex64 if dtype == torch.float32 \
            else torch.complex128

        def put(x):
            return x.to(dev, dtype).contiguous()

        def putp(x):
            return x.to(dev, cdtype if x.is_complex() else dtype)

        self.H = self.blocks = self.dfb = None
        for name in _STAGE_CACHES:
            self.__dict__.pop(name, None)
        if self.mesh is not None:
            # the host masters cut into their pieces, each piece cast on
            # its way to its device
            self.H = Hamiltonian(
                F=m["F"], ERI=m["ERI"], L=m["L"],
                **{k: m[k] for k in ("mu", "m", "p", "Q")}, no=self.no)
            self.blocks, self.dfb = m["blocks"], m["dfb"]
            self._apply_mesh(dtype)
        else:
            full = self.storage == "full"
            self.H = Hamiltonian(
                F=put(m["F"]), ERI=put(m["ERI"]) if full else None,
                L=put(m["L"]) if full else None,
                **{k: tuple(map(putp, m[k])) for k in ("mu", "m", "p", "Q")},
                no=self.no)
            if self.storage == "blocked":
                self.blocks = ERIBlocks(*map(put, m["blocks"]))
            elif self.storage == "df":
                self.dfb = dfq.DFERI(*map(put, m["dfb"]))
        self.dtype = dtype
        self.t1 = self.t1.to(dtype)
        # a float32 stage leaves roundoff in the pair-antisymmetric part of
        # t2, which moved the refined Ecorr of (H2O)_6/cc-pVDZ by 2.1e-10
        self.t2 = eqs.pair_symmetric(self.t2.to(dtype))
        self._set_denominators()
        self._bind_model()

    def solve_cc_mixed(self, e_conv=1e-10, r_conv=1e-10, maxiter=100,
                       sp_conv=1e-6, sp_dtype=torch.float32,
                       refine_maxiter=None, sp_kwargs=None,
                       refine_kwargs=None, chk=None, chk_every=20,
                       resume=False, **kw):
        """Mixed-precision solve for any storage: converge in `sp_dtype`
        (float32) to sp_conv or its noise floor, then refine in float64 to
        e_conv/r_conv from the floor amplitudes.  The fixed point does not
        depend on the dtype, so the result is a pure float64 solve's.

        sp_kwargs go to the floor stage only (bf16_until, say, which then
        runs its own bf16 stage first), refine_kwargs to the refinement
        only, **kw to both.  chk=<base> checkpoints each stage
        (<base>.sp.npz, <base>.rf.npz) and the floor's end
        (<base>.floor.npz: its amplitudes and `e_sp_floor`), so resume=True
        re-enters the right stage: a finished floor is not solved again.
        `self.e_sp_floor` is the floor stage's energy; `self.stages` lists
        (stage, dtype, iterations, seconds, bf16 iterations).  Needs a
        precision='DP' construction (the float64 masters are the
        refinement's Hamiltonian)."""
        if self.local is not None:
            raise ValueError("solve_cc_mixed supports canonical storage "
                             "modes (the local filters hold their own "
                             "f64 stacks).")
        if self.precision != "DP":
            raise ValueError("solve_cc_mixed needs a precision='DP' "
                             "construction (the f64 masters are the "
                             "refinement-stage Hamiltonian).")
        from .utils.checkpoint import load_amps, save_amps
        self._ensure_mixed_masters()
        self.stages = []
        floor_chk = (str(chk) + ".floor.npz") if chk else None
        if resume and floor_chk and os.path.exists(floor_chk):
            d = load_amps(floor_chk, device=self.device)
            self.t1, self.t2 = d["t1"], d["t2"]
            self.e_sp_floor = float(d["e_sp_floor"])
            log.info("CCWFN mixed resume: floor stage already complete "
                     "(%s, E_floor=%.10f); entering f64 refinement"
                     % (floor_chk, self.e_sp_floor))
        else:
            self._cast_stage(sp_dtype)
            kw_sp = dict(kw)
            kw_sp.update(sp_kwargs or {})
            if chk is not None:
                kw_sp.setdefault("chk", str(chk) + ".sp.npz")
                kw_sp.setdefault("chk_every", chk_every)
                kw_sp.setdefault("resume", resume)
            t0 = time.time()
            self.e_sp_floor = float(self.solve_cc(sp_conv, sp_conv, maxiter,
                                                  **kw_sp))
            self.stages.append(("floor", str(sp_dtype), self.niter,
                                time.time() - t0, self.niter_bf16))
            if floor_chk is not None:
                with self.timers.time("ccwfn.checkpoint"):
                    save_amps(floor_chk, t1=self.t1, t2=self.t2,
                              e_sp_floor=self.e_sp_floor)
        self._cast_stage(torch.float64)
        kw_rf = dict(kw)
        kw_rf.update(refine_kwargs or {})
        if chk is not None:
            kw_rf.setdefault("chk", str(chk) + ".rf.npz")
            kw_rf.setdefault("chk_every", max(1, chk_every // 4))
            kw_rf.setdefault("resume", resume)
        t0 = time.time()
        ecc = self.solve_cc(e_conv, r_conv, refine_maxiter or maxiter,
                            **kw_rf)
        self.stages.append(("refine", str(torch.float64), self.niter,
                            time.time() - t0, self.niter_bf16))
        return ecc


def _load_ring(diis, state, ring, who):
    """Fill a fresh DIIS ring from a checkpoint's diis_amps/diis_errs/
    diis_count, unless it was saved at another depth: then warn and keep
    the empty ring (the amplitudes are restored all the same)."""
    depth = ring["diis_amps"].shape[0]
    if depth != state.amps.shape[0]:
        log.warning("%s resume: checkpoint DIIS ring depth %d != current "
                    "max_diis ring depth %d; starting with an empty ring "
                    "(amplitudes are restored)."
                    % (who, depth, state.amps.shape[0]))
        return
    state.amps.copy_(torch.as_tensor(ring["diis_amps"]))
    state.errs.copy_(torch.as_tensor(ring["diis_errs"]))
    state.count = int(ring["diis_count"])
