"""w_assembly_ms.rt_df: device milliseconds of the DF ladders' W assembly
a real-time right-hand side: every span 'ladder.assemble' (one an a-block
in `dfhbar.ladder_apply`: `ladder_W`'s GEMM and its (a, b, e, f) copy,
complex here, not the K1 call), those of the T ladder under
'rtcc.t_side' and of the Lambda ladder under 'rtcc.lambda_side', over the
count of 'rtcc.f'.  Where an assembly records under another parent, its
time cannot be told apart, and the metric is left out."""

from portbench.harness import spans

SIDES = {"rtcc.t_side", "rtcc.lambda_side"}


def read(run):
    rows = spans.table(run)
    row = rows.get("ladder.assemble") if rows else None
    if row is None or not set(str(row["parent"]).split("|")) <= SIDES:
        return None
    return spans.ms_per(rows, "ladder.assemble", "rtcc.f")
