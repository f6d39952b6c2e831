"""The yardstick of the kernels: peaks, and work and bytes from shapes.

Work and bytes are counted from the shapes of the products the algorithm
needs and from the solver's own counts (iterations, right-hand sides,
rows), never from a kernel's launch counter, so the same work is read
whatever implements it.  Each input byte is counted read once and each
output byte written once.  Peaks: NVIDIA H100 SXM data sheet, dense, at
its 700 W limit (float64 on the FP64 tensor cores).
"""

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"f64": 67e12, "f32": 67e12, "bf16->f32": 989e12}


def bound_s(work, nbytes):
    """The least time the card could take: the larger of the operations
    at their type's peak ([(flop, type)]) and the bytes at the HBM rate."""
    return max(sum(flop / PEAK_FLOPS[label] for flop, label in work),
               nbytes / HBM_BYTES_S)


def product(M, N, K, elem_bytes):
    """(flop, bytes) of C (M, N) = A (M, K) @ B (N, K)^T."""
    return 2.0 * M * N * K, float(M * K + N * K + M * N) * elem_bytes


def k1_ladders_ccsd(no, nv):
    """K1's products in one CCSD residual: 'ijef,abef->ijab', (o^2, v^2,
    v^2).  Over factors the a-blocks of W together are the same product."""
    return [(no * no, nv * nv, nv * nv)]


def k1_ladders_rt(no, nv):
    """K1's products in one real-time CCSD right-hand side: the T ladder,
    complex tau as stacked real and imaginary rows against the real <ab|ef>,
    (2 o^2, v^2, v^2), and the Lambda ladder, complex l2 against the complex
    HBAR's Hvvvv as [Re; Im], (2 o^2, 2 v^2, v^2)."""
    return [(2 * no * no, nv * nv, nv * nv),
            (2 * no * no, 2 * nv * nv, nv * nv)]


def k1_ladders_rt_df(no, nv):
    """K1's products in one real-time CCSD right-hand side over factors:
    the T ladder (complex tau against the complex t1-dressed W) and the
    Lambda ladder (complex l2 against the complex Bd_ae W), each as one
    product (2 o^2, 2 v^2, v^2): the rows of the amplitudes stacked [Re;
    Im], and W as [Re W; Im W].  The port launches each a-block of W
    apart; the a-blocks together are the same product, and at these
    shapes the flops bound it, so the count of blocks does not matter."""
    return [(2 * no * no, 2 * nv * nv, nv * nv)] * 2


def k2_row_flops(no, nv):
    """One (T) row: o^2 v^3 t3 elements, each built with 6 (v + o) FMA and
    projected with 2 v + 3 o more."""
    return 2.0 * no ** 2 * nv ** 3 * (8 * nv + 9 * no)


def k2_row_bytes(no, nv, in_bytes, acc_bytes):
    """One (T) row's operands read once (Wv, Ot, Ev, Eo, L and t2 in the
    streamed type, Fov and eps in the tile type) and its seven outputs
    written once."""
    streamed = (2 * no * nv ** 3 + 2 * no ** 3 * nv + no ** 2 * nv ** 2 * 2)
    small = no * nv + no + nv
    outs = 2 * no * nv + 4 * no * nv ** 2 + no ** 2 * nv ** 2
    return streamed * in_bytes + (small + outs) * acc_bytes


def share_pct(products, count, elem_bytes, kernel_s, label="f64"):
    """100 x bound / kernel time for `count` repetitions of `products`
    [(M, N, K)], or None when nothing ran."""
    if not count or not kernel_s:
        return None
    flop = nbytes = 0.0
    for M, N, K in products:
        f, b = product(M, N, K, elem_bytes)
        flop, nbytes = flop + f, nbytes + b
    return 100.0 * count * bound_s([(flop, label)], nbytes) / kernel_s
