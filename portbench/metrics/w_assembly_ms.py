"""w_assembly_ms.<cell suffix>: device milliseconds of the DF ladder's W
assembly a residual: every span 'ladder.assemble' (one an a-block in
`dfhbar.ladder_apply`: `ladder_W`'s GEMM and its (a, b, e, f) copy, not
the K1 call) under 'ccwfn.residual', over the residuals' count."""

from portbench.harness import spans


def read(run):
    return spans.ms_per(spans.table(run), "ladder.assemble",
                        "ccwfn.residual", parent="ccwfn.residual")
