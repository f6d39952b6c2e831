"""k1_roofline.<cell suffix>: K1's share of its roofline in the CCSD
residuals of kind 'cc' (kind 'rt' has k1_roofline.rt.py).

Work: 2 M N K of one (o^2, v^2, v^2) ladder product a residual
(harness/roofline.k1_ladders_ccsd; over factors its a-blocks together)
times the residuals the solvers made (their iterations), never K1's
launch counter.  Bytes: each input read once, the output written
once.  Bound: the larger of flop / 67 TFLOP/s (f64; f32 67) and bytes /
3.35 TB/s.  Time: the device time of K1's kernels, by name, in the
window's trace."""

from portbench.harness import roofline

# csrc/vvvv_nt.cu: one `kernel` template in each of the namespaces f64,
# f32 and bf16
KERNELS = ("f64::kernel<", "f32::kernel<", "bf16::kernel<")


def read(run):
    if run.trace is None or run.kind != "cc":
        return None
    dp = run.cfg["precision"] == "DP"
    residuals = sum(u["niter"] for u in run.units)
    return roofline.share_pct(roofline.k1_ladders_ccsd(run.no, run.nv),
                              residuals, 8 if dp else 4,
                              run.trace.kernel_seconds(KERNELS),
                              "f64" if dp else "f32")
