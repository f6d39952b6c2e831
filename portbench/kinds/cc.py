"""kind 'cc': a closed loop of coupled-cluster jobs, concurrency 1.

Traffic knobs: model, e_conv, r_conv, maxiter.

A job starts from the run's seeded SCF output, builds a fresh `ccwfn`
(full or blocked storage from the wavefunction, DF from the factors
through `ccwfn.from_df_factors`) and solves it to the traffic's
tolerances; its energy is read on the host.  Nothing a job derived is
handed to the next.  The window starts jobs until its seconds have passed
and lets the last one finish.

The judge (`judge`) holds the window's output to the plain reference:

  ham     max |H - H_ref| / max |H_ref| over F, ERI, L, or over F and the
          factor blocks for DF storage
  res     || R_ref(t1, t2) / D ||: the reference CCSD residual at the last
          job's converged amplitudes, in the solver's own norm
  e_gap   max over every job of |E_job - E_ref(t1, t2)| in Eh, E_ref the
          reference CCSD energy of those amplitudes, plus the reference
          (T) energy for CCSD(T)
"""

import time
import warnings

import pycc_tpu_torch
from pycc_tpu_torch.ops.kernels.triples import t_energy_row
from pycc_tpu_torch.triples import scan_slices, t_scan_df_slices

from portbench.harness.check import F64, as_f64, full_hamiltonian, gap, norm
from portbench.harness.jobs import span, sync
from portbench.reference import ccsd as rcc
from portbench.reference import triples as rtr
from portbench.reference.hamiltonian import FactorERI, FullERI, spin_adapted


class Runner:
    """setup(), window(seconds), units (one record a job: init_s, job_s,
    energy, niter, converged, iter_s, iters, triples_s), failed,
    outputs()."""

    def __init__(self, cfg, traffic, inputs, device, precision=None):
        self.cfg, self.traffic, self.inputs = cfg, traffic, inputs
        self.device = device
        self.precision = precision or cfg["precision"]
        self.units = []
        self.window_s = None
        self._last = None

    def _make(self):
        t = self.traffic
        if self.cfg["storage"] == "df":
            x = self.inputs
            return pycc_tpu_torch.ccwfn.from_df_factors(
                x.B, x.F, x.no, model=t["model"], precision=self.precision,
                device=self.device)
        return pycc_tpu_torch.ccwfn(
            self.inputs, model=t["model"], precision=self.precision,
            device=self.device, storage=self.cfg["storage"])

    def setup(self):
        """One init, three iterations of the solver (residuals, energies,
        host reads, and two DIIS extrapolations, whose linear solve loads
        its library on first use) and, for CCSD(T), one (T) row."""
        cc = self._make()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cc.solve_cc(0.0, 0.0, maxiter=3)
        if self.traffic["model"] == "CCSD(T)":
            if cc.storage == "df":
                sl = t_scan_df_slices(cc.H.F, *cc.dfb, cc.no)
            else:
                sl = scan_slices(cc)
            t_energy_row(0, *sl, cc.t2, cc.no)
            del sl
        del cc
        sync(self.device)

    def job(self):
        t = self.traffic
        self._last = None
        with span("job"):
            t0 = time.perf_counter()
            with span("init"):
                cc = self._make()
                sync(self.device)
            t_init = time.perf_counter() - t0
            with span("solve"):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    e = cc.solve_cc(t["e_conv"], t["r_conv"], t["maxiter"])
            t_job = time.perf_counter() - t0
        tm = cc.timers
        self.units.append(dict(
            init_s=t_init, job_s=t_job, energy=float(e), niter=cc.niter,
            converged=bool(cc.converged),
            iter_s=tm.total["ccwfn.iteration"],
            iters=tm.count["ccwfn.iteration"],
            triples_s=tm.total.get("ccwfn.triples", 0.0)))
        self._last = cc

    def window(self, seconds):
        sync(self.device)
        t0 = time.perf_counter()
        while not self.units or time.perf_counter() - t0 < seconds:
            self.job()
        sync(self.device)
        self.window_s = time.perf_counter() - t0

    @property
    def failed(self):
        return sum(not u["converged"] for u in self.units)

    def outputs(self):
        """The last job's Hamiltonian (or factors) and amplitudes, and
        every job's energy."""
        cc, self._last = self._last, None
        out = dict(t1=cc.t1, t2=cc.t2, F=cc.H.F, no=cc.no,
                   energies=[u["energy"] for u in self.units])
        if cc.storage == "df":
            out["dfb"] = tuple(cc.dfb)
        else:
            out["ERI"], out["L"] = cc.H.ERI, cc.H.L
        return out


def judge(cfg, traffic, inputs, out, device):
    """{ham, res, e_gap} of the window's output (see the module's text)."""
    no = out["no"]
    v = slice(no, None)
    if cfg["storage"] == "df":
        B = as_f64(inputs.B, device)
        F = as_f64(inputs.F, device)
        o = slice(0, no)
        ham = max([gap(out["F"], F)] + [
            gap(x, B[:, a, b]) for x, (a, b) in
            zip(out["dfb"], ((o, o), (o, v), (v, v)))])
        out.pop("dfb")
        ERI = FactorERI(B, no)
        L = FactorERI(B, no, L=True, eri=ERI)
        vvvv = ERI[v, v, v, v]
    else:
        F, ERIt, _ = full_hamiltonian(inputs, device)
        ham = max(gap(out["F"], F), gap(out.pop("ERI"), ERIt))
        Lt = spin_adapted(ERIt)
        ham = max(ham, gap(out.pop("L"), Lt))
        ERI, L = FullERI(ERIt), FullERI(Lt)
        vvvv = ERIt[v, v, v, v].contiguous()
    t1, t2 = out["t1"].to(F64), out["t2"].to(F64)
    r1, r2 = rcc.residuals_ccsd(F, ERI, L, vvvv, t1, t2, no)
    del vvvv
    D1, D2 = rcc.denominators(F, no)
    res = norm([(r1, D1), (r2, D2)])
    del r1, r2
    e_ref = float(rcc.cc_energy(F, L, t1, t2, no))
    if traffic["model"] == "CCSD(T)":
        e_ref += float(rtr.t_energy(F, ERI, L, t1, t2, no))
    e_gap = max(abs(e - e_ref) for e in out["energies"])
    return dict(ham=ham, res=res, e_gap=e_gap)
