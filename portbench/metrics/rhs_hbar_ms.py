"""rhs_hbar_ms.<cell suffix>: device milliseconds of a right-hand side's
HBAR rebuild from the field-dressed F, the span 'hbar.rebuild' in
`cclambda.lambda_residuals_from_F` (or `_from_F_df`) under
'rtcc.lambda_side', over the count of 'rtcc.f'."""

from portbench.harness import spans


def read(run):
    return spans.ms_per(spans.table(run), "hbar.rebuild", "rtcc.f",
                        parent="rtcc.lambda_side")
