"""k2_roofline.ccsd_t: K2's share of its roofline in the (T) energy.

Work: o rows a job, each 2 o^2 v^3 (8 v + 9 o) flop
(harness/roofline.k2_row_flops), over the jobs the run completed.  Bytes:
a row's operands read once and its seven outputs written once
(k2_row_bytes).  Bound: the larger of flop / 67 TFLOP/s and bytes /
3.35 TB/s.  Time: the device time of K2's kernel, by name."""

from portbench.harness import roofline

# csrc/t_row.cu
KERNELS = ("t_row_kernel<",)


def read(run):
    if (run.trace is None or run.kind != "cc"
            or run.traffic["model"] != "CCSD(T)"):
        return None
    t = run.trace.kernel_seconds(KERNELS)
    if not t:
        return None
    no, nv = run.no, run.nv
    dp = run.cfg["precision"] == "DP"
    b = 8 if dp else 4
    rows = no * len(run.units)
    bound = roofline.bound_s([(roofline.k2_row_flops(no, nv),
                               "f64" if dp else "f32")],
                             roofline.k2_row_bytes(no, nv, b, b))
    return 100.0 * rows * bound / t
