"""rhs_ms.<cell suffix>: device milliseconds of a real-time CC right-hand
side, the span 'rtcc.f' (the T side, the Lambda side with its HBAR
rebuild, the phase and the concatenation), over its count."""

from portbench.harness import spans


def read(run):
    return spans.ms_per(spans.table(run), "rtcc.f", "rtcc.f")
