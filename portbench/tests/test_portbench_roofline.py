"""The work and byte counts of K1 and K2 against hand counts."""

import pytest

from portbench.harness import roofline


def test_k1_ladder_counts_by_hand():
    # (H2O)_6/cc-pVDZ: o = 24, v = 114, the CCSD ladder (576, 12996, 12996)
    (M, N, K), = roofline.k1_ladders_ccsd(24, 114)
    assert (M, N, K) == (576, 12996, 12996)
    flop, nbytes = roofline.product(M, N, K, 8)
    assert flop == 2 * 576 * 12996 * 12996 == 194_568_210_432
    assert nbytes == 8 * (576 * 12996 * 2 + 12996 * 12996)
    # flop-bound: 194.56 GFLOP / 67 TFLOP/s = 2.904 ms (PERF.md's bound)
    bound = roofline.bound_s([(flop, "f64")], nbytes)
    assert bound == pytest.approx(2.904e-3, rel=1e-3)
    assert roofline.share_pct([(M, N, K)], 10, 8, 10 * 2 * bound) \
        == pytest.approx(50.0)
    assert roofline.share_pct([(M, N, K)], 0, 8, 1.0) is None


def test_k1_rt_ladders_by_hand():
    t, lam = roofline.k1_ladders_rt(24, 114)
    assert t == (1152, 12996, 12996) and lam == (1152, 25992, 12996)
    assert roofline.bound_s([(roofline.product(*t, 8)[0], "f64")], 0) \
        == pytest.approx(5.808e-3, rel=1e-3)
    assert roofline.bound_s([(roofline.product(*lam, 8)[0], "f64")], 0) \
        == pytest.approx(11.616e-3, rel=1e-3)


def test_k1_rt_df_ladders_by_hand():
    # (H2O)_6/aug-cc-pVDZ over factors: two ladders, each the port's 36
    # a-blocks of (1152, 2592, 46656) as one product
    products = roofline.k1_ladders_rt_df(24, 216)
    assert products == [(1152, 93312, 46656)] * 2
    flop, nbytes = roofline.product(*products[0], 8)
    # 36 x 4.159 ms at 67 TFLOP/s (PERF.md's K1 table): the flops bound
    # the whole ladder as they bound each a-block
    assert roofline.bound_s([(flop, "f64")], nbytes) \
        == pytest.approx(36 * 4.159e-3, rel=1e-3)
    assert nbytes / roofline.HBM_BYTES_S < 0.1 * 36 * 4.159e-3


def test_k1_rt_df_ladders_are_the_ports_products(tiny, monkeypatch):
    """At the tiny size, the products the port's DF right-hand sides hand
    to K1 in the window come to k1_ladders_rt_df's flops a right-hand
    side, however the port blocks them."""
    import pycc_tpu_torch.models.dfhbar as dfhbar
    from portbench.kinds import rt
    from portbench.tests.common import run_tiny_units

    flops, start = [], []
    real = dfhbar.ladder_product

    def seen(ladder, A, B, *args, **kw):
        flops.append(2 * A.shape[0] * B.shape[0] * A.shape[1])
        return real(ladder, A, B, *args, **kw)
    monkeypatch.setattr(dfhbar, "ladder_product", seen)
    real_window = rt.Runner.window

    def window(self, seconds):
        start.append(len(flops))
        return real_window(self, seconds)
    monkeypatch.setattr(rt.Runner, "window", window)
    cfg = tiny.config("h2o6_avdz_df")
    no, nv = cfg["ndocc"] - cfg["nfzc"], cfg["nbf"] - cfg["ndocc"]
    result, _, units, _ = run_tiny_units(tiny, "h2o6_avdz_df.rt_df")
    per_rhs = sum(2 * M * N * K
                  for M, N, K in roofline.k1_ladders_rt_df(no, nv))
    rhs = sum(u["rhs"] for u in units)
    # the judge runs none of the port's code
    assert rhs and sum(flops[start[0]:]) == per_rhs * rhs


def test_k2_row_counts_by_hand():
    no, nv = 24, 114
    # o^2 v^3 t3 elements: build 6 (v + o) FMA, projections 2 v + 3 o
    elems = no * no * nv ** 3
    assert roofline.k2_row_flops(no, nv) == 2 * elems * (
        6 * (nv + no) + 2 * nv + 3 * no)
    streamed = (no * nv ** 3 * 2 + no ** 3 * nv * 2 + no * no * nv * nv * 2)
    outs = 2 * no * nv + 4 * no * nv * nv + no * no * nv * nv
    assert roofline.k2_row_bytes(no, nv, 8, 8) == 8 * (
        streamed + no * nv + no + nv + outs)
    # 28.734 ms a row at 67 TFLOP/s (PERF.md's K2 table)
    assert roofline.bound_s([(roofline.k2_row_flops(no, nv), "f64")],
                            roofline.k2_row_bytes(no, nv, 8, 8)) \
        == pytest.approx(28.734e-3, rel=1e-4)
