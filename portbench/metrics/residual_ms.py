"""residual_ms.<cell suffix>: device milliseconds of a CCSD residual,
the span 'ccwfn.residual' around `ccwfn.residuals` in `solve_cc` (the
model's residual: over factors its W assembly and K1's a-blocks), over
its count in the traced window."""

from portbench.harness import spans


def read(run):
    return spans.ms_per(spans.table(run), "ccwfn.residual", "ccwfn.residual")
