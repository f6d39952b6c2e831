"""kind 'rt': integrator steps of real-time CC under a laser pulse.

Traffic knobs: model, setup_conv, maxiter, integrator, h, pulse (shape
'gaussian': F_str, omega, sigma, center).

Set-up solves CCSD and Lambda once and makes `rtcc` under the pulse; the
window takes integrator steps of `rtcc.f` from t = 0 and reads the dipole
on the host after each, until its seconds have passed and the step that
reaches the pulse's centre is done.  That step's start and end are kept
on the host for the judge, in two buffers made in set-up (pinned on a
card, where the copies run on a stream of their own beside the steps, so
that the window pays for no host copy); the last step's stay where they
are.

The judge (`judge`) holds the window's output to the plain reference:

  ham         max |H - H_ref| / max |H_ref| over F, ERI, L and mu
  res0        the reference field-free right-hand side at the set-up's
              converged (t, lambda): the T and Lambda residuals in the
              solver's norm
  step_pulse  || y_k - rk4_ref(y_k-1) || / || rk4_ref(y_k-1) - y_k-1 ||
              for the step k that reaches the pulse's centre, redone by
              the reference under the field from the program's state
              before it
  mu_pulse    max |mu(t_k) - mu_ref(y_k)| over the three axes, in a.u.
  step        the same as step_pulse for the window's last step
  mu_gap      the same as mu_pulse for the last step
"""

import math
import time
import warnings

import torch

import pycc_tpu_torch
from pycc_tpu_torch.rt import integrators
from pycc_tpu_torch.rt.lasers import gaussian_laser

from portbench.harness.check import as_f64, full_hamiltonian, gap, norm
from portbench.harness.jobs import span, sync
from portbench.reference import ccsd as rcc
from portbench.reference.hamiltonian import (FullERI, mo_property,
                                             spin_adapted)
from portbench.reference.rt import RT, Gaussian


def _keep(y, buf, stream):
    """buf, which y is copied into: on a card by `stream` once the current
    stream has made y, without waiting for the copy, which the window's
    closing synchronisation waits for."""
    if stream is None:
        return buf.copy_(y)
    stream.wait_stream(torch.cuda.current_stream(y.device))
    with torch.cuda.stream(stream):
        buf.copy_(y, non_blocking=True)
    # y's memory is not handed out again before the copy has read it
    y.record_stream(stream)
    return buf


class Runner:
    """setup(), window(seconds), units (one record a step: t, mu, rhs, the
    right-hand sides the step evaluated), failed, outputs()."""

    def __init__(self, cfg, traffic, inputs, device, precision=None):
        self.cfg, self.traffic, self.inputs = cfg, traffic, inputs
        self.device = device
        self.precision = precision or cfg["precision"]
        self.units = []
        self.window_s = None

    def make(self):
        """A ccwfn of the run's inputs (a kind over other storage, such as
        kinds/rt_df.py, makes its own)."""
        return pycc_tpu_torch.ccwfn(self.inputs, model=self.traffic["model"],
                                    precision=self.precision,
                                    device=self.device,
                                    storage=self.cfg["storage"])

    def setup(self):
        t = self.traffic
        conv = t["setup_conv"]
        cc = self.make()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cc.solve_cc(conv, conv, t["maxiter"])
            lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
            lam.solve_lambda(conv, conv, t["maxiter"])
        lam.hbar = None
        p = t["pulse"]
        V = gaussian_laser(p["F_str"], p["omega"], p["sigma"],
                           center=p["center"])
        self.rt = pycc_tpu_torch.rtcc(cc, lam, None, V)
        self.start = dict(t1=cc.t1, t2=cc.t2, l1=lam.l1, l2=lam.l2)
        self.y0 = self.rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
        self.ode = getattr(integrators, t["integrator"])(t["h"])
        # the host buffers of the pulse step's start and end
        card = self.y0.is_cuda
        self._bufs = [torch.empty(self.y0.shape, dtype=self.y0.dtype,
                                  pin_memory=card) for _ in range(2)]
        self._stream = torch.cuda.Stream(self.y0.device) if card else None
        # one right-hand side and one dipole read: every shape of a step
        self.rt.f(0.0, self.y0)
        self.rt.dipole(*self.rt.extract_amps(self.y0)[:4])
        sync(self.device)

    def window(self, seconds):
        rt, ode = self.rt, self.ode
        center = self.traffic["pulse"]["center"]
        y, t = self.y0, 0.0
        self._pulse = None
        sync(self.device)
        t0 = time.perf_counter()
        while (not self.units or self._pulse is None
               or time.perf_counter() - t0 < seconds):
            y_prev, t_prev = y, t
            with span("step"):
                y = ode(rt.f, t, y)
                t = t + ode.h
            with span("dipole"):
                mu = rt.dipole(*rt.extract_amps(y)[:4])
            self.units.append(dict(t=t, mu=mu, rhs=len(ode.C)))
            if self._pulse is None and t >= center:
                with span("keep"):
                    kept = [_keep(x, buf, self._stream)
                            for x, buf in zip((y_prev, y), self._bufs)]
                    self._pulse = dict(y_prev=kept[0], t_prev=t_prev,
                                       y=kept[1], mu=mu)
        sync(self.device)
        self.window_s = time.perf_counter() - t0
        self._end = dict(y_prev=y_prev, t_prev=t_prev, y=y,
                         mu=self.units[-1]["mu"])

    @property
    def failed(self):
        return sum(not all(math.isfinite(abs(m)) for m in u["mu"])
                   for u in self.units)

    def outputs(self):
        """The Hamiltonian, the set-up's converged state, the step that
        reaches the pulse's centre and the last step (each its start, its
        end and the dipole after it)."""
        cc = self.rt.ccwfn
        out = dict(self.hamiltonian(cc), mu=cc.H.mu, no=cc.no, h=self.ode.h,
                   pulse=self._pulse, end=self._end, **self.start)
        self.rt = None
        return out

    def hamiltonian(self, cc):
        """What of cc's Hamiltonian the judge compares, besides mu."""
        return dict(F=cc.H.F, ERI=cc.H.ERI, L=cc.H.L)


def _step_numbers(ref, s, h, device):
    """(step, mu gap) of one kept step s, redone by the reference."""
    c128 = torch.complex128
    y_prev = s["y_prev"].to(device, c128)
    y = s["y"].to(device, c128)
    y_ref = ref.rk4(s["t_prev"], y_prev, h)
    step = float(torch.linalg.vector_norm(y - y_ref)
                 / torch.linalg.vector_norm(y_ref - y_prev))
    del y_ref, y_prev
    mu_ref = ref.dipole(y).cpu().tolist()
    return step, max(abs(complex(a) - b) for a, b in zip(s["mu"], mu_ref))


def judge(cfg, traffic, inputs, out, device):
    """{ham, res0, step_pulse, mu_pulse, step, mu_gap} of the window's
    output (see the module's text)."""
    no = out["no"]
    v = slice(no, None)
    F, ERIt, C = full_hamiltonian(inputs, device)
    mu = [mo_property(C, as_f64(m, device)) for m in inputs.ao_props[0]]
    ham = max([gap(out["F"], F), gap(out.pop("ERI"), ERIt)]
              + [gap(a, b) for a, b in zip(out["mu"], mu)])
    Lt = spin_adapted(ERIt)
    ham = max(ham, gap(out.pop("L"), Lt))
    vvvv = ERIt[v, v, v, v].contiguous()
    ref = RT(F, FullERI(ERIt), FullERI(Lt), vvvv, mu, no, pulse(traffic))
    return dict(ham=ham, **judge_steps(ref, out, device))


def pulse(traffic):
    """The reference's field of the traffic's pulse."""
    p = traffic["pulse"]
    return Gaussian(p["F_str"], p["omega"], p["sigma"], p["center"])


def judge_steps(ref, out, device):
    """{res0, step_pulse, mu_pulse, step, mu_gap} of the window's output
    (see the module's text), redone by `ref` (reference/rt.RT)."""
    no = out["no"]
    V = ref.V
    c128 = torch.complex128

    # the start: the field-free right-hand side at the set-up's state
    y0 = torch.cat([out[k].to(device, c128).reshape(-1)
                    for k in ("t1", "t2", "l1", "l2")]
                   + [torch.zeros(1, dtype=c128, device=device)])
    ref.V = None
    r = ref.split(ref.f(0.0, y0))
    ref.V = V
    D1, D2 = rcc.denominators(ref.F0, no)
    res0 = norm(zip(r[:4], (D1, D2, D1, D2)))
    del r, y0

    # the step under the pulse's peak and the window's last step, each
    # from the program's state before it
    step_pulse, mu_pulse = _step_numbers(ref, out.pop("pulse"), out["h"],
                                         device)
    step, mu_gap = _step_numbers(ref, out.pop("end"), out["h"], device)
    return dict(res0=res0, step_pulse=step_pulse, mu_pulse=mu_pulse,
                step=step, mu_gap=mu_gap)
