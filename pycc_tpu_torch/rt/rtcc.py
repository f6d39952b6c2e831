"""Real-time CC: the ODE right-hand side and its observables.

The counterpart of pycc_tpu/rt/rtcc.py.  `rtcc(ccwfn, cclambda, ccdensity,
V)` propagates the complex amplitudes y = (t1, t2, l1, l2, phase) of a
converged CCD, CC2, CCSD or CC3 wave function under a field V(t) coupled
through the dipole: the right-hand side `f(t, y)` dresses F = F0 +
mu_tot V(t), evaluates the T residuals (times -i), the Lambda residuals
with the HBAR rebuilt from that F (times +i) and the phase quasienergy,
and concatenates them, eagerly on `ccwfn.device`.  Both particle-particle
ladders of a right-hand side run on K1: the T ladder (complex tau against
the real <ab|ef>) and the Lambda ladder (complex l2 against the complex
HBAR's Hvvvv), one launch each on full and blocked storage, one launch an
a-block each over DF factors (`ladder=` takes `vvvv_nt_reference` for the
plain products).

A torch tensor y stays on the device: `f`, the integrators
(rt/integrators.py) and `propagate` keep it there, and each observable
(`dipole`, `lagrangian`, `energy`, `phase`, `autocorrelation`) reads back
a few scalars.  A numpy y (scipy's complex_ode) is copied to the device
and the result back, once each way.  `propagate(chk=True)` writes
pycc_tpu's pickle checkpoints (chk.pk, output.pk, t_out.pk; y as a host
numpy array), so a trajectory started in either package resumes in the
other.

A local ccwfn (filter=True) projects the T and Lambda residuals onto
its pair spaces (`Local.filter_res`, on the complex tensors by their
real and imaginary parts), as pycc_tpu's right-hand side does.

Storage: 'full' reads H.ERI and H.L, 'blocked' the block views
(`models/blocked.eri_views`), 'df' the fused factor forms (the DF
residual, `cclambda.lambda_residuals_from_F_df`, and the precomputed
L[o,o,o,o] trace and L[o,o,v,v] for the phase).  CC3 takes the slab or
the full-tensor T3/L3 forms (`ccwfn.t3_slabs`).

Not ported (ROADMAP.md "Not ported"): `ri_split=True`, pycc_tpu's
(re, im) pairs of real tensors for a runtime without complex dtypes
(ops/ctensor.py), and `rhs_split=True`, the host-split DF right-hand side
built on the split DF residual; both raise ValueError.  pycc_tpu's
host-stepped CC3 right-hand side (`_f_rows`) is the slab form here.
"""

import pickle as pk
from os.path import exists

import numpy as np
import torch

from ..ccdensity import (build_Doooo, build_Dooov, build_Doovv, build_Dovov,
                         build_Dvvvo, build_Dvvvv, build_Moo, build_Mvv,
                         onepdm)
from ..cclambda import lambda_residuals_from_F, lambda_residuals_from_F_df
from ..ccwfn import t3_slabs
from ..models.blocked import eri_views
from ..models.ccsd import build_tau, slices
from ..ops.contract import contract
from ..ops.kernels.vvvv import vvvv_nt
from ..parallel.mesh import mesh_vvvv


def _host(x):
    """x as a host numpy array (a tensor copied back once)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class rtcc:
    """Real-time CC object providing data for an ODE propagator."""

    def __init__(self, ccwfn, cclambda, ccdensity, V, magnetic=False,
                 kick=None, ri_split=False, rhs_split=None, ladder=vvvv_nt):
        if ri_split:
            raise ValueError(
                "rtcc(ri_split=True): the (re, im) real-pair amplitudes "
                "(pycc_tpu's ops/ctensor.py) are not ported; torch has "
                "complex dtypes, so the port propagates complex tensors "
                "(ROADMAP.md, Not ported)")
        if rhs_split:
            raise ValueError(
                "rtcc(rhs_split=True): the host-split DF right-hand side "
                "needs the split DF residual (residuals_ccsd_df_split), "
                "which is not ported; the fused DF right-hand side runs "
                "instead (ROADMAP.md, Not ported)")
        model = ccwfn.model
        if model not in ("CCD", "CC2", "CCSD", "CC3"):
            raise ValueError("rtcc supports CCD, CC2, CCSD and CC3 (got %s)."
                             % model)
        self.ccwfn = ccwfn
        self.cclambda = cclambda
        self.ccdensity = ccdensity
        self.V = V
        self.magnetic = bool(magnetic)
        self.ladder = ladder
        self.device = ccwfn.device
        self.storage = getattr(ccwfn, "storage", "full")

        self.mu = ccwfn.H.mu
        if kick:
            s_to_i = {"x": 0, "y": 1, "z": 2}
            self.mu_tot = self.mu[s_to_i[kick.lower()]]
        else:
            self.mu_tot = sum(self.mu) / np.sqrt(3.0)
        if magnetic:
            self.m = ccwfn.H.m

        no, nv = ccwfn.no, ccwfn.nv
        self.no, self.nv = no, nv
        self._len1 = no * nv
        self._len2 = (no * nv) ** 2
        o, v = slices(no)
        # the field-independent parts of the phase: the L[o,o,o,o] trace
        # and L[o,o,v,v] (assembled once over factors or blocks)
        if self.storage == "df":
            from ..models.dfccsd import _eri_oooo
            from ..models.dfhbar import loovv_df
            e4 = _eri_oooo(ccwfn.dfb)
            self._loooo_tr = (2.0 * contract("ijij->", e4)
                              - contract("ijji->", e4))
            self._Loovv = loovv_df(ccwfn.dfb)
            del e4
        else:
            L = eri_views(ccwfn)[1]
            self._loooo_tr = contract("ijij->", L[o, o, o, o])
            self._Loovv = L[o, o, v, v]
        self._slabs = t3_slabs(ccwfn)

    # ------------------------------------------------------------------
    def _dev(self, x):
        """x (tensor, numpy array or number) as a tensor on the device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _field(self, t, dtype):
        """F0 + mu_tot V(t) in `dtype` (the amplitudes' complex dtype)."""
        F0 = self.ccwfn.H.F.to(dtype)
        if self.V is None:
            return F0
        return F0 + self.mu_tot.to(dtype) * float(self.V(t))

    def _split(self, y):
        no, nv = self.no, self.nv
        len1, len2 = self._len1, self._len2
        t1 = y[:len1].reshape(no, nv)
        t2 = y[len1:len1 + len2].reshape(no, no, nv, nv)
        l1 = y[len1 + len2:2 * len1 + len2].reshape(no, nv)
        l2 = y[2 * len1 + len2:-1].reshape(no, no, nv, nv)
        return t1, t2, l1, l2

    def t_residuals(self, F, t1, t2):
        """The T1/T2 residuals under F (the ccwfn's model and storage;
        the ladder through `self.ladder`)."""
        return self.ccwfn.residuals(F, t1, t2, ladder=self.ladder)

    def lambda_residuals(self, F, t1, t2, l1, l2):
        """The Lambda residuals with the HBAR rebuilt from F."""
        cc = self.ccwfn
        kw = dict(real_time=cc.real_time, F_ref=cc.H.F, ladder=self.ladder)
        if self.storage == "df":
            return lambda_residuals_from_F_df(
                cc.model, F, cc.dfb, t1, t2, l1, l2, self.no,
                nblocks=getattr(cc, "df_nblocks", None), **kw)
        ERI, L = eri_views(cc)
        return lambda_residuals_from_F(cc.model, F, ERI, L, t1, t2, l1, l2,
                                       self.no, slabs=self._slabs,
                                       vvvv=mesh_vvvv(cc), **kw)

    def _phase(self, F, t1, t2):
        o, v = slices(self.no)
        eref = 2.0 * torch.trace(F[o, o]) - self._loooo_tr
        if self.ccwfn.model == "CCD":
            ecc = contract("ijab,ijab->", t2, self._Loovv)
        else:
            ecc = 2.0 * contract("ia,ia->", F[o, v], t1)
            ecc = ecc + contract("ijab,ijab->", build_tau(t1, t2),
                                 self._Loovv)
        return (eref + ecc) * (-1.0j)

    def f(self, t, y):
        """The ODE right-hand side at time t: a device tensor for a tensor
        y, a numpy array for a numpy y (scipy's complex_ode)."""
        host = not isinstance(y, torch.Tensor)
        if host:
            y = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        t1, t2, l1, l2 = self._split(y)
        F = self._field(t, y.dtype)
        rt1, rt2 = self.t_residuals(F, t1, t2)
        rl1, rl2 = self.lambda_residuals(F, t1, t2, l1, l2)
        if getattr(self.ccwfn, "local", None) is not None:
            # the pair-space projection is real-linear: it commutes with
            # the -i and +i below
            filter_res = self.ccwfn.Local.filter_res
            rt1, rt2 = filter_res(rt1, rt2)
            rl1, rl2 = filter_res(rl1, rl2)
        out = torch.cat([(rt1 * (-1.0j)).reshape(-1),
                         (rt2 * (-1.0j)).reshape(-1),
                         (rl1 * 1.0j).reshape(-1),
                         (rl2 * 1.0j).reshape(-1),
                         self._phase(F, t1, t2).reshape(1).to(y.dtype)])
        return out.cpu().numpy() if host else out

    # ------------------------------------------------------------------
    def collect_amps(self, t1, t2, l1, l2, phase):
        """y as one device tensor: complex128 for precision 'DP',
        complex64 for 'SP'."""
        dtype = (torch.complex128 if self.ccwfn.precision == "DP"
                 else torch.complex64)
        parts = [self._dev(x).to(dtype).reshape(-1)
                 for x in (t1, t2, l1, l2, phase)]
        return torch.cat(parts)

    def extract_amps(self, y):
        """(t1, t2, l1, l2, phase) as views of y: tensors for a tensor y,
        numpy arrays for a numpy y."""
        if not isinstance(y, torch.Tensor):
            y = np.asarray(y)
        t1, t2, l1, l2 = self._split(y)
        return t1, t2, l1, l2, y[-1]

    def dipole(self, t1, t2, l1, l2, magnetic=False, real_time=False):
        """(mu_x, mu_y, mu_z) as Python complex numbers (magnetic=True: the
        magnetic dipole): the one-pdm against the property integrals, for
        CC3 with the triples blocks against the T1-transformed integrals
        (`build_Moo`, `build_Mvv`).  One host read."""
        cc = self.ccwfn
        t1, t2, l1, l2 = (self._dev(x) for x in (t1, t2, l1, l2))
        ints = self.m if magnetic else self.mu
        no, nv = self.no, self.nv
        if cc.model == "CC3":
            from ..models.cc3 import cc3_onepdm, cc3_onepdm_scan
            fn = cc3_onepdm_scan if self._slabs else cc3_onepdm
            opdm, opdm_cc3 = fn(cc, t1, t2, l1, l2, real_time=real_time)
            # promote, never cast down: the magnetic integrals are pure
            # imaginary, and real amplitudes would drop them
            dt = torch.promote_types(opdm.dtype, ints[0].dtype)
            opdm, opdm_cc3 = opdm.to(dt), opdm_cc3.to(dt)
            vals = []
            for ax in range(3):
                I = ints[ax].to(dt)
                M = torch.zeros_like(I)
                M[:no, :no] = build_Moo(no, nv, I, t1)
                M[-nv:, -nv:] = build_Mvv(no, nv, I, t1)
                vals.append(torch.sum(I * opdm) + torch.sum(M * opdm_cc3))
        else:
            opdm = onepdm(cc.model, t1, t2, l1, l2, no, cc.nact)
            dt = torch.promote_types(opdm.dtype, ints[0].dtype)
            opdm = opdm.to(dt)
            vals = [torch.sum(ints[ax].to(dt) * opdm) for ax in range(3)]
        return tuple(complex(x) for x in torch.stack(vals).cpu().tolist())

    def lagrangian(self, t, t1, t2, l1, l2):
        """The real-time Lagrangian at (t, t1, t2, l1, l2), a Python
        complex: the reference energy under the field plus the one- and
        two-electron density energies (over factors
        `dfdensity.density_energy_df`)."""
        cc = self.ccwfn
        model, no = cc.model, self.no
        o, v = slices(no)
        t1, t2, l1, l2 = (self._dev(x) for x in (t1, t2, l1, l2))
        F = self._field(t, t1.dtype)
        if model == "CC3":
            from ..models.cc3 import cc3_onepdm, cc3_onepdm_scan
            fn = cc3_onepdm_scan if self._slabs else cc3_onepdm
            opdm, opdm_cc3 = fn(cc, t1, t2, l1, l2)
            opdm = opdm + opdm_cc3
        else:
            opdm = onepdm(model, t1, t2, l1, l2, no, cc.nact)
        eref = 2.0 * torch.trace(F[o, o]) - self._loooo_tr
        eone = torch.sum(F * opdm)
        if self.storage == "df":
            from ..models.dfdensity import density_energy_df
            _, etwo = density_energy_df(
                F, cc.dfb, t1, t2, l1, l2, no, model=model,
                nblocks=getattr(cc, "df_nblocks", None), ladder=self.ladder)
        else:
            ERI = eri_views(cc)[0]
            etwo = 0.5 * contract("ijkl,ijkl->", ERI[o, o, o, o],
                                  build_Doooo(model, t1, t2, l2))
            etwo = etwo + 0.5 * contract("abcd,abcd->", ERI[v, v, v, v],
                                         build_Dvvvv(model, t1, t2, l2))
            etwo = etwo + contract("ijka,ijka->", ERI[o, o, o, v],
                                   build_Dooov(model, t1, t2, l1, l2))
            etwo = etwo + contract("abci,abci->", ERI[v, v, v, o],
                                   build_Dvvvo(model, t1, t2, l1, l2))
            etwo = etwo + contract("iajb,iajb->", ERI[o, v, o, v],
                                   build_Dovov(model, t1, t2, l1, l2))
            etwo = etwo + 0.5 * contract("ijab,ijab->", ERI[o, o, v, v],
                                         build_Doovv(model, t1, t2, l1, l2))
        return complex((eref + eone + etwo).item())

    def phase(self, F, t1, t2):
        """The phase's time derivative, -i times the quasienergy."""
        F, t1, t2 = (self._dev(x) for x in (F, t1, t2))
        return complex(self._phase(F, t1, t2).item())

    def energy(self, t, t1, t2):
        """The CC energy of (t1, t2) under the field at t, complex128."""
        cc = self.ccwfn
        t1, t2 = self._dev(t1), self._dev(t2)
        F = self._field(t, torch.complex128)
        return complex(cc.cc_energy(t1, t2, F=F).item())

    def autocorrelation(self, y_left, y_right):
        """The autocorrelation <Psi(left)|Psi(right)> of two states, on the
        device; one host read."""
        y_left, y_right = self._dev(y_left), self._dev(y_right)
        t1_l, t2_l, l1_l, l2_l, phase_l = self.extract_amps(y_left)
        t1_r, t2_r, l1_r, l2_r, phase_r = self.extract_amps(y_right)
        c = contract
        A = 1.0 + c("ia,ia->", l1_l, t1_r - t1_l)
        A = A + 0.5 * c("ijab,ijab->", l2_l, t2_r - t2_l)
        A = A + 0.5 * c("ijab,ia,jb->", l2_l, t1_l, t1_l)
        A = A + 0.5 * c("ijab,ia,jb->", l2_l, t1_r, t1_r)
        A = A - c("ijab,ia,jb->", l2_l, t1_l, t1_r)
        A = A * torch.exp(-phase_l) * torch.exp(phase_r)
        B = 1.0 - c("ia,ia->", l1_r, t1_r - t1_l)
        B = B - 0.5 * c("ijab,ijab->", l2_r, t2_r - t2_l)
        B = B + 0.5 * c("ijab,ia,jb->", l2_r, t1_r, t1_r)
        B = B + 0.5 * c("ijab,ia,jb->", l2_r, t1_l, t1_l)
        B = B - c("ijab,ia,jb->", l2_r, t1_l, t1_r)
        B = B * torch.exp(-phase_r) * torch.exp(phase_l)
        return complex((0.5 * A + 0.5 * torch.conj(B)).item())

    # ------------------------------------------------------------------
    def _observables(self, t, y):
        t1, t2, l1, l2, _ = self.extract_amps(y)
        ret = {"ecc": self.lagrangian(t, t1, t2, l1, l2)}
        ret["mu_x"], ret["mu_y"], ret["mu_z"] = self.dipole(t1, t2, l1, l2)
        if self.magnetic:
            ret["m_x"], ret["m_y"], ret["m_z"] = self.dipole(
                t1, t2, l1, l2, magnetic=True)
        return ret

    def step(self, ODE, yi, t, ref=False):
        """One step of ODE from (t, yi): (y, the observables at t).  The
        Lagrangian is taken at t, the start of the step, as pycc_tpu
        takes it."""
        y = ODE(self.f, t, yi)
        return y, self._observables(t, y)

    def propagate(self, ODE, yi, tf, ti=0, ref=False, chk=False, tchk=False,
                  ofile="output.pk", tfile="t_out.pk", cfile="chk.pk", k=2):
        """Step ODE from ti to tf; returns the observables keyed by the
        time ('%.*f' % (k, t)), with the amplitudes every `tchk` steps as
        a second dict when tchk is set.  y is carried on the device, and
        the last state is left in `self.y`.
        chk=True resumes output.pk / t_out.pk where they exist and
        rewrites chk.pk (y as a host array, time) and output.pk every
        step, pycc_tpu's protocol and keys; ref_wfn.npy holds the MO
        coefficients."""
        point = 0
        key = "%.*f" % (k, ti)
        yi = self._dev(yi)

        if chk:
            if exists(cfile):
                with open(cfile, "rb") as cf:
                    chkp = pk.load(cf)
            else:
                chkp = {}
                if getattr(self.ccwfn, "ref", None) is not None:
                    np.save("ref_wfn", np.asarray(self.ccwfn.ref.Ca()))
        if chk and exists(ofile):
            with open(ofile, "rb") as of:
                ret = pk.load(of)
        else:
            ret = {key: {}}

        save_t = tchk is not False
        if save_t:
            if chk and exists(tfile):
                with open(tfile, "rb") as ampf:
                    ret_t = pk.load(ampf)
            else:
                ret_t = {key: None}
            t1, t2, l1, l2, phase = (_host(x) for x in self.extract_amps(yi))
            ret_t[key] = {"t1": t1, "t2": t2, "l1": l1, "l2": l2,
                          "phase": phase}

        ret[key] = self._observables(ti, yi)

        t = ti
        while t < tf:
            point += 1
            y, props = self.step(ODE, yi, t, ref)
            t += ODE.h
            key = "%.*f" % (k, t)
            ret[key] = props
            yi = y
            if chk:
                chkp["y"] = _host(y)
                chkp["time"] = t
                with open(ofile, "wb") as of:
                    pk.dump(ret, of, pk.HIGHEST_PROTOCOL)
                with open(cfile, "wb") as cf:
                    pk.dump(chkp, cf, pk.HIGHEST_PROTOCOL)
            if save_t and (point % tchk < 0.0001):
                t1, t2, l1, l2, _ = (_host(x) for x in self.extract_amps(y))
                ret_t[key] = {"t1": t1, "t2": t2, "l1": l1, "l2": l2}
                with open(tfile, "wb") as ampf:
                    pk.dump(ret_t, ampf, pk.HIGHEST_PROTOCOL)

        self.y = yi
        if save_t:
            return ret, ret_t
        return ret
