"""diis_ms.<cell suffix>: device milliseconds of a DIIS step, the span
'ccwfn.diis' around the push and the extrapolation in `solve_cc`, over
its count in the traced window."""

from portbench.harness import spans


def read(run):
    return spans.ms_per(spans.table(run), "ccwfn.diis", "ccwfn.diis")
