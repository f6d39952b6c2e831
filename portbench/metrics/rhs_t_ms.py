"""rhs_t_ms.<cell suffix>: device milliseconds of a right-hand side's T
side, the span 'rtcc.t_side' around `rtcc.t_residuals` (its ladder on
K1), over the count of 'rtcc.f'."""

from portbench.harness import spans


def read(run):
    return spans.ms_per(spans.table(run), "rtcc.t_side", "rtcc.f",
                        parent="rtcc.f")
