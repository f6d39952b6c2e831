#!/usr/bin/env python3
"""How many EOM-CCSD roots the (H2O)_6/aug-cc-pVDZ DF stack of
chip_smoke.py's [dfpost] phase needs: the Davidson for 3 roots (subspace
maxM 60, then 30 with the preconditioner's sign flipped to the textbook
1/(E - diag HBAR)) against 6 roots (maxM 60), each from the same HBAR_SS
guess, with the residual norms of the returned Ritz vectors recomputed.

    python3 probes/eom_df_roots.py      (from the repository root; one card,
                                         about 6 minutes)

The lowest excited states of the hexamer are six near-degenerate
n -> 3s states, one a water; the probe shows whether a block of 3
resolves them.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import pycc_tpu_torch  # noqa: E402
from pycc_tpu_torch.data import moldict  # noqa: E402
from pycc_tpu_torch.scf import run_rhf  # noqa: E402

# (roots, maxM, preconditioner sign flipped)
CASES = ((3, 60, False), (3, 30, True), (6, 60, False))


def main():
    t00 = time.perf_counter()
    _, smi = cs.phase_device()
    pycc_tpu_torch.set_verbosity("quiet")
    cs.phase_build()
    wfn = run_rhf(moldict[cs.DF_SIZE], "aug-cc-pvdz", freeze_core=True,
                  df=True, df_tol=cs.DF_TOL)
    cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD", storage="df",
                              df_tol=cs.DF_TOL, device=cs.DEVICE)
    cs._solve(cc, 1e-10, 1e-10)
    eom = pycc_tpu_torch.cceom(pycc_tpu_torch.cchbar(cc))
    t0 = time.perf_counter()
    _, g1 = eom.guess(2 * max(n for n, _, _ in CASES), "HBAR_SS")
    print("[eom] HBAR_SS guess %.1f s (host)" % (time.perf_counter() - t0),
          flush=True)
    n1 = cc.no * cc.nv
    dim = n1 + n1 * n1
    pycc_tpu_torch.set_verbosity("info")   # the Davidson's iterations
    D0 = eom.D.clone()
    for N, maxM, flip in CASES:
        guess = np.zeros((2 * N, dim))
        guess[:, :n1] = g1[:2 * N].reshape(2 * N, n1)
        eom.D = -D0 if flip else D0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        E, C = eom.solve_eom(N=N, e_conv=1e-8, r_conv=1e-6, maxM=maxM,
                             guess=guess, maxiter=60)
        x = eom.ritz
        w = torch.as_tensor(E, device=x.device)[:, None]
        rn = torch.linalg.norm(eom.sigma(x) - w * x, dim=1).tolist()
        print("[eom] N=%d maxM=%d flip=%s: %.1f s  %d iterations  converged "
              "%s  E %s  residuals %s  peak %.2f GB  | %s"
              % (N, maxM, flip, time.perf_counter() - t0, eom.niter,
                 eom.converged, E, rn, torch.cuda.max_memory_allocated() / 1e9,
                 smi), flush=True)
        del C, x
        torch.cuda.empty_cache()
    print("[eom] total %.1f s" % (time.perf_counter() - t00))


if __name__ == "__main__":
    main()
