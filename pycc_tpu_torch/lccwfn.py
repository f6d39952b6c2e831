"""Native local-space CC solver (PNO/PAO/PNO++/CPNO++ amplitudes).

The counterpart of pycc_tpu/lccwfn.py.  Amplitudes live in the truncated
pair-local spaces, as padded stacks t1 (no, D) and t2 (no^2, D, D).
CCD, CCSD and CC2 run the local-scaling pair-space equations
(lccwfn_local.py), whose cost per iteration depends on the truncated
dimension D and not on nv; with pair_cutoff, CCD and CCSD run them over
the compact strong-pair stacks (lccwfn_screened.py).  The dense backend
(`_use_local_eqs = False`) is the cross-validation oracle: the canonical
residual (K1 in its ladder on the card) on the back-transformed
amplitudes, projected pair by pair.  Each iteration takes a Jacobi step
in the semicanonical pair bases and a DIIS step over the local
amplitudes, all on the device; the host reads one (energy, rms) pair an
iteration.

mesh= (a parallel.make_mesh mesh): the precomputed stacks are cut over
it by pycc_tpu's rule (`parallel.mesh.shard_pair_stacks`: the pair-
leading ones over ('va', 'vb'), the compact screened ones over 'va') and
the residuals read them piece by piece.  pycc_tpu also lays t2 and the
denominators over the mesh; here they stay on the home device with t1,
the Jacobi step and DIIS (t2 is o^2 D^2), as a canonical mesh solver
keeps its amplitudes home.
"""

import time

import torch

from .models import ccsd as eqs
from .ops.contract import contract
from .ops.diis import DIIS
from .utils.log import logger as log


class lccwfn:
    def __init__(self, o, v, no, nv, H, local, model, eref, Local,
                 pair_cutoff=None, mesh=None):
        self.o, self.v = o, v
        self.no, self.nv = no, nv
        self.H = H
        self.local = local
        self.model = model
        self.eref = eref
        self.Local = Local
        self.pair_cutoff = pair_cutoff
        self.mesh = mesh

        # initial local amplitudes: t2[ij] = -ERIoovv_loc[ij] / D[ij]
        QLp = Local.QLp
        D2 = Local.D2
        self._QLii = QLp[Local._ii]
        self._eps_ii = Local.epsp[Local._ii]
        self._fo = Local._fo
        self._Dloc = -Local._D2p
        eri_loc = (QLp.mT @ H.ERI[o, o, v, v].reshape(no * no, nv, nv)
                   @ QLp)
        self.t2 = -eri_loc / self._Dloc
        self.t1 = torch.zeros((no, D2), dtype=H.F.dtype, device=H.F.device)

        self._residual_fn = {"CCD": eqs.residuals_ccd,
                             "CCSD": eqs.residuals_ccsd,
                             "CC2": eqs.residuals_cc2}[model]
        self._energy_fn = (eqs.ccd_energy if model == "CCD"
                           else eqs.cc_energy)

        self._use_local_eqs = model in ("CCD", "CCSD", "CC2")
        if self._use_local_eqs:
            # the closures hold `pre`, not self: a cycle through self would
            # keep H, the pair spaces and the stacks alive past `del`
            from . import lccwfn_local as leq
            if model in ("CCD", "CCSD") and pair_cutoff is not None:
                # compact strong-pair stacks: P^2 D^2 memory instead of
                # no^4 D^2; weak pairs frozen at local MP2
                from . import lccwfn_screened as seq
                if model == "CCD":
                    pre = seq.precompute_ccd_screened(H, Local, no, nv,
                                                      pair_cutoff)
                    self._res = lambda t1r, t2r: (
                        None, seq.residuals_ccd_screened(pre, t2r))
                    self._en = lambda t1r, t2r: seq.energy_ccd_screened(
                        pre, t2r)
                else:
                    pre = seq.precompute_ccsd_screened(H, Local, no, nv,
                                                       pair_cutoff)
                    self._res = lambda t1r, t2r: seq.residuals_ccsd_screened(
                        pre, t1r, t2r)
                    self._en = lambda t1r, t2r: seq.energy_ccsd_screened(
                        pre, t1r, t2r)
                log.info("pair screening: %d of %d pairs strong "
                         "(cutoff %.1e)" % (pre["P"], no * no, pair_cutoff))
            elif model == "CCD":
                pre = leq.precompute_ccd(H, Local, no, nv)
                self._res = lambda t1r, t2r: (
                    None, leq.residuals_ccd_local(pre, t2r))
                self._en = lambda t1r, t2r: leq.energy_ccd_local(pre, t2r)
            else:
                pre = leq.precompute_ccsd(H, Local, no, nv)
                res = (leq.residuals_cc2_local if model == "CC2"
                       else leq.residuals_ccsd_local)
                self._res = lambda t1r, t2r: res(pre, t1r, t2r)
                self._en = lambda t1r, t2r: leq.energy_ccsd_local(pre, t1r,
                                                                  t2r)
            if mesh is not None:
                # the closures above read this `pre`, the pieces
                from .parallel.mesh import shard_pair_stacks
                pre = shard_pair_stacks(pre, mesh, no)
            self._pre = pre

    def dense_amps(self, t1loc, t2loc):
        """The canonical-basis (t1, t2) of local amplitudes."""
        no, nv = self.no, self.nv
        QLp = self.Local.QLp
        t1 = contract("iva,ia->iv", self._QLii, t1loc)
        t2 = QLp @ t2loc.reshape(no * no, *t2loc.shape[-2:]) @ QLp.mT
        return t1, t2.reshape(no, no, nv, nv)

    def _project(self, r1, r2):
        no, nv = self.no, self.nv
        QLp = self.Local.QLp
        r1loc = contract("iva,iv->ia", self._QLii, r1)
        r2loc = QLp.mT @ r2.reshape(no * no, nv, nv) @ QLp
        return r1loc, r2loc

    def lcc_energy(self):
        if self._use_local_eqs:
            no, D2 = self.no, self.Local.D2
            return float(self._en(self.t1, self.t2.reshape(no, no, D2, D2)))
        return float(self._dense_energy(self.t1, self.t2))

    def _dense_energy(self, t1loc, t2loc):
        t1, t2 = self.dense_amps(t1loc, t2loc)
        return self._energy_fn(self.H.F, self.H.L, t1, t2, self.no)

    def _step_local(self, t1r, t2r):
        """One local-equation iteration: (t1n, t2n, ecc, rms) tensors."""
        no, D2 = self.no, self.Local.D2
        r1, r2 = self._res(t1r, t2r)
        if r1 is None:
            t1n = t1r
        else:
            t1n = t1r + r1 / (self._fo[:, None] - self._eps_ii)
        t2n = t2r - r2 / self._Dloc.reshape(no, no, D2, D2)
        rr = torch.sum(r2 * r2)
        if r1 is not None:
            rr = rr + torch.sum(r1 * r1)
        return t1n, t2n, self._en(t1n, t2n), torch.sqrt(rr)

    def _step_dense(self, t1loc, t2loc):
        """One dense-backend iteration: the canonical residual of the
        back-transformed amplitudes, projected into the pair bases."""
        H = self.H
        t1, t2 = self.dense_amps(t1loc, t2loc)
        r1, r2 = self._residual_fn(H.F, H.ERI, H.L, H.vvvv, t1, t2, self.no)
        r1loc, r2loc = self._project(r1, r2)
        t1n = t1loc + r1loc / (self._fo[:, None] - self._eps_ii)
        t2n = t2loc - r2loc / self._Dloc
        rms = torch.sqrt(torch.sum(r1loc ** 2) + torch.sum(r2loc ** 2))
        return t1n, t2n, self._dense_energy(t1n, t2n), rms

    def solve_lcc(self, e_conv=1e-7, r_conv=1e-7, maxiter=100, max_diis=8,
                  start_diis=1):
        tstart = time.time()
        no, D2 = self.no, self.Local.D2
        if self._use_local_eqs:
            t1, t2 = self.t1, self.t2.reshape(no, no, D2, D2)
            step = self._step_local
        else:
            t1, t2 = self.t1, self.t2
            step = self._step_dense
        diis = DIIS((t1, t2), max_diis=max(max_diis, 1))
        state = diis.init()
        elcc = self.lcc_energy()
        log.info("CC Iter %3d: lCC Ecorr = %.15f dE = % .5E MP2"
                 % (0, elcc, -elcc))
        for niter in range(1, maxiter + 1):
            elcc_last = elcc
            t1n, t2n, ecc, rms = step(t1, t2)
            # DIIS over the local amplitudes (the reference's native solver
            # has none)
            if max_diis > 0:
                diis.push(state, (t1n, t2n), (t1, t2))
            if max_diis > 0 and niter >= start_diis:
                t1, t2 = diis.extrapolate(state, (t1n, t2n))
            else:
                t1, t2 = t1n, t2n
            # the one host read of the iteration
            elcc, rms = torch.stack([ecc, rms]).tolist()
            self.niter = niter
            ediff = elcc - elcc_last
            log.info("lCC Iter %3d: lCC Ecorr = %.15f  dE = % .5E  rms = "
                     "% .5E" % (niter, elcc, ediff, rms))
            if abs(ediff) < e_conv and rms < r_conv:
                log.info("\nlCC has converged in %.3f seconds.\n"
                         % (time.time() - tstart))
                log.info("E(REF)  = %20.15f" % self.eref)
                log.info("E(%s) = %20.15f" % (self.local + "-" + self.model,
                                              elcc))
                log.info("E(TOT)  = %20.15f" % (elcc + self.eref))
                break
        self.t1 = t1
        self.t2 = t2.reshape(no * no, D2, D2)
        self.elcc = elcc
        return elcc
