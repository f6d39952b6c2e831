"""rhs_lambda_ms.<cell suffix>: device milliseconds of a right-hand
side's Lambda side without its HBAR rebuild (the Lambda residuals, their
ladder on K1): the span 'rtcc.lambda_side' less 'hbar.rebuild', over the
count of 'rtcc.f'."""

from portbench.harness import spans


def read(run):
    rows = spans.table(run)
    side = spans.ms_per(rows, "rtcc.lambda_side", "rtcc.f", parent="rtcc.f")
    hbar = spans.ms_per(rows, "hbar.rebuild", "rtcc.f",
                        parent="rtcc.lambda_side")
    return None if side is None or hbar is None else side - hbar
