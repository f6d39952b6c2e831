"""k1_roofline.rt: K1's share of its roofline in real-time CC's ladders.

Work: 2 M N K of the two complex ladder products of a right-hand side,
(2 o^2, v^2, v^2) and (2 o^2, 2 v^2, v^2) (harness/roofline.k1_ladders_rt),
times the right-hand sides the integrator's steps evaluated, never K1's
launch counter.  Bytes: each input read once, the output written
once.  Bound: the larger of flop / 67 TFLOP/s (f64; f32 67) and bytes /
3.35 TB/s.  Time: the device time of K1's kernels, by name, in the
window's trace."""

from portbench.harness import roofline

# csrc/vvvv_nt.cu: one `kernel` template in each of the namespaces f64,
# f32 and bf16
KERNELS = ("f64::kernel<", "f32::kernel<", "bf16::kernel<")


def read(run):
    if run.trace is None or run.kind != "rt":
        return None
    dp = run.cfg["precision"] == "DP"
    rhs = sum(u["rhs"] for u in run.units)
    return roofline.share_pct(roofline.k1_ladders_rt(run.no, run.nv),
                              rhs, 8 if dp else 4,
                              run.trace.kernel_seconds(KERNELS),
                              "f64" if dp else "f32")
