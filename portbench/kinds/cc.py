"""kind 'cc': a closed loop of coupled-cluster jobs, concurrency 1.

Traffic knobs: model, e_conv, r_conv, maxiter.  A cell of more than one
card (`devices`, the home card first) lays every job's storage over the
most square `parallel.make_mesh` of its cards (2 x 2 for four), made
once; a cell of one card runs each job on that card.

A job starts from the run's seeded SCF output, builds a fresh `ccwfn`
(full or blocked storage from the wavefunction, DF from the factors
through `ccwfn.from_df_factors`; on the mesh, if any) and solves it to
the traffic's tolerances; its energy is read on the host.  Nothing a job
derived is handed to the next.  The window starts jobs until its seconds
have passed and lets the last one finish.

The judge (`judge`) holds the window's output to the plain reference:

  ham     max |H - H_ref| / max |H_ref| over F, ERI, L, or over F and the
          factor blocks for DF storage; where the port's ERI is no tensor
          (full storage on a mesh) the same number taken over the 16
          occupied/virtual blocks of ERI and of L (`SpaceERI`, each block
          of the port's read through its __getitem__, so no whole ERI
          sits on one card)
  res     || R_ref(t1, t2) / D ||: the reference CCSD residual at the last
          job's converged amplitudes, in the solver's own norm
  e_gap   max over every job of |E_job - E_ref(t1, t2)| in Eh, E_ref the
          reference CCSD energy of those amplitudes, plus the reference
          (T) energy for CCSD(T)
"""

import time
import warnings

import torch

import pycc_tpu_torch
from pycc_tpu_torch.ops.kernels.triples import t_energy_row
from pycc_tpu_torch.parallel import make_mesh
from pycc_tpu_torch.triples import scan_slices, t_scan_df_slices

from portbench.harness.check import (F64, as_f64, full_hamiltonian, gap,
                                     gap_rows, norm)
from portbench.harness.jobs import span, sync
from portbench.reference import ccsd as rcc
from portbench.reference import triples as rtr
from portbench.reference.hamiltonian import (FactorERI, FullERI, SpaceERI,
                                             mo_fock, space_slices,
                                             spin_adapted)

SPACES = ["".join((p, q, r, s)) for p in "ov" for q in "ov" for r in "ov"
          for s in "ov"]
# the blocks of ERI and of L that the reference's CCSD residual and energy
# read (reference/ccsd.py), and its (T) energy (reference/triples.py): the
# blocked judge keeps these and frees the others once compared
CCSD_READS = ({"oooo", "ooov", "oovo", "oovv", "ovvo", "ovvv", "ovov",
               "vvvo", "ovoo", "vvvv"},
              {"ovvv", "oovv", "ooov", "ovvo", "oovo"})
T_READS = ({"vvvo", "ovoo", "vovv", "ooov"}, {"oovv"})


class Runner:
    """setup(), window(seconds), units (one record a job: init_s, job_s,
    energy, niter, converged, iter_s, iters, triples_s), failed,
    outputs().  devices: the cell's cards, `device` (the home card)
    first; more than one are laid out as the mesh."""

    def __init__(self, cfg, traffic, inputs, device, precision=None,
                 devices=None):
        self.cfg, self.traffic, self.inputs = cfg, traffic, inputs
        self.device = device
        self.devices = [device] if devices is None else list(devices)
        self.precision = precision or cfg["precision"]
        self.mesh = (make_mesh(devices=self.devices)
                     if len(self.devices) > 1 else None)
        self.units = []
        self.window_s = None
        self._last = None

    def _make(self):
        t = self.traffic
        if self.cfg["storage"] == "df":
            x = self.inputs
            return pycc_tpu_torch.ccwfn.from_df_factors(
                x.B, x.F, x.no, model=t["model"], precision=self.precision,
                device=self.device, mesh=self.mesh)
        return pycc_tpu_torch.ccwfn(
            self.inputs, model=t["model"], precision=self.precision,
            device=self.device, storage=self.cfg["storage"], mesh=self.mesh)

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
        sync(*self.devices)

    def job(self):
        t = self.traffic
        self._last = None
        with span("job"):
            t0 = time.perf_counter()
            with span("init"):
                cc = self._make()
                sync(*self.devices)
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
        sync(*self.devices)
        t0 = time.perf_counter()
        while not self.units or time.perf_counter() - t0 < seconds:
            self.job()
        sync(*self.devices)
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
    elif not isinstance(out["ERI"], torch.Tensor):
        F, ERI, L, ham = _blocks_judged(inputs, out, device,
                                        traffic["model"])
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


def _blocks_judged(inputs, out, device, model):
    """(F, ERI, L, ham) of full storage on a mesh: the reference's F, its
    ERI and L as `SpaceERI` blocks, and ham over F, ERI and L, the port's
    ERI and L (out's, taken out of it) read a few rows of a block at a
    time: for each of ERI and L the largest gap over its 16 blocks over
    its largest |ref| over them, the whole judge's number.  Every block
    but <vv|vv> is made in one pass over the AO ERI, <vv|vv> in a second;
    a block that the residual, the energy and the (T) do not read is
    freed once it is compared."""
    no = out["no"]
    C = as_f64(inputs.Ca_subset("AO", "ACTIVE"), device)
    F = mo_fock(C, as_f64(inputs.Fa(), device))
    ERI = SpaceERI(C, inputs.ERI_ao, no)
    L = SpaceERI(C, inputs.ERI_ao, no, L=True, eri=ERI)
    keep_e, keep_l = CCSD_READS
    if model == "CCSD(T)":
        keep_e, keep_l = keep_e | T_READS[0], keep_l | T_READS[1]
    port_eri, port_l = out.pop("ERI"), out.pop("L")
    ERI.make([sp for sp in SPACES if sp != "vvvv"])
    # [max |x - ref|, max |ref|] of ERI and of L over the blocks so far
    seen = {"ERI": [0.0, 0.0], "L": [0.0, 0.0]}

    def compare(name, x, key, ref):
        num, den = gap_rows(x, key, ref)
        seen[name] = [max(seen[name][0], num), max(seen[name][1], den)]

    # a block and its r <-> s partner together, since L's block reads both
    pairs = sorted({tuple(sorted({sp, sp[:2] + sp[3] + sp[2]}))
                    for sp in SPACES})
    for pair in pairs:
        keys = [space_slices(sp, no) for sp in pair]
        for k in keys:
            compare("ERI", port_eri, k, ERI[k])
        for sp, k in zip(pair, keys):
            compare("L", port_l, k, L[k])
            if sp not in keep_l:
                L.drop(sp)
        for sp in pair:
            if sp not in keep_e:
                ERI.drop(sp)
    ham = max([gap(out["F"], F)] + [num / den for num, den in seen.values()])
    return F, ERI, L, ham
