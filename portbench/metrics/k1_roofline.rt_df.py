"""k1_roofline.rt_df: K1's share of its roofline in real-time CC's ladders
over factors (kind 'rt_df').

Work: 2 M N K of the two complex ladders of a right-hand side, each one
product (2 o^2, 2 v^2, v^2) (harness/roofline.k1_ladders_rt_df: (1152,
93312, 46656) at (24, 216), which the port launches as 36 a-blocks of
(1152, 2592, 46656)), times the right-hand sides the integrator's steps
evaluated, never K1's launch counter; the dipole read runs no ladder.
Bytes: each product's inputs read once and its output written once.  Bound: the larger of flop / 67 TFLOP/s (f64; f32 67) and bytes /
3.35 TB/s.  Time: the device time of K1's kernels, by name, in the
window's trace."""

from portbench.harness import roofline

# csrc/vvvv_nt.cu: one `kernel` template in each of the namespaces f64,
# f32 and bf16
KERNELS = ("f64::kernel<", "f32::kernel<", "bf16::kernel<")


def read(run):
    if run.trace is None or run.kind != "rt_df":
        return None
    dp = run.cfg["precision"] == "DP"
    rhs = sum(u["rhs"] for u in run.units)
    products = roofline.k1_ladders_rt_df(run.no, run.nv)
    return roofline.share_pct(products, rhs, 8 if dp else 4,
                              run.trace.kernel_seconds(KERNELS),
                              "f64" if dp else "f32")
