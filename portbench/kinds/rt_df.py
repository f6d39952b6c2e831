"""kind 'rt_df': integrator steps of real-time CC over MO factors under a
laser pulse.

Traffic knobs, set-up, window, units and judged numbers: kinds/rt.py's,
on a ccwfn made from the run's seeded factors and MO dipole integrals
(`ccwfn.from_df_factors(B, F, no, mu=...)`), on one card.

The judge holds the window's output to the plain reference over the
factors (reference/rt_df.py, whose v^4 terms are made a block at a time):

  ham         max |H - H_ref| / max |H_ref| over F, the three factor
              blocks (B[:, o, o], B[:, o, v], B[:, v, v]) and mu
  res0, step_pulse, mu_pulse, step, mu_gap
              as kinds/rt.py's
"""

import pycc_tpu_torch

from portbench.harness.check import as_f64, gap
from portbench.kinds import rt
from portbench.reference.rt_df import factor_rt


class Runner(rt.Runner):
    """kinds/rt.py's Runner on a ccwfn over factors."""

    def make(self):
        x = self.inputs
        return pycc_tpu_torch.ccwfn.from_df_factors(
            x.B, x.F, x.no, model=self.traffic["model"],
            precision=self.precision, mu=x.mu, device=self.device)

    def hamiltonian(self, cc):
        return dict(F=cc.H.F, dfb=tuple(cc.dfb))


def judge(cfg, traffic, inputs, out, device):
    """{ham, res0, step_pulse, mu_pulse, step, mu_gap} of the window's
    output (see the module's text)."""
    no = out["no"]
    o, v = slice(0, no), slice(no, None)
    B = as_f64(inputs.B, device)
    F = as_f64(inputs.F, device)
    mu = [as_f64(m, device) for m in inputs.mu]
    ham = max([gap(out["F"], F)]
              + [gap(x, B[:, a, b]) for x, (a, b) in
                 zip(out.pop("dfb"), ((o, o), (o, v), (v, v)))]
              + [gap(a, b) for a, b in zip(out["mu"], mu)])
    ref = factor_rt(B, F, mu, no, rt.pulse(traffic))
    return dict(ham=ham, **rt.judge_steps(ref, out, device))
