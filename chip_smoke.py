#!/usr/bin/env python3
"""Drive pycc_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          (from the repository root)

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: a CUDA card must be present; print its name, torch/CUDA
     versions and nvidia-smi's name and power limit;
  2. build the K1 kernel (csrc/vvvv_nt.cu) with nvcc;
  3. K1 against its plain version (A @ B.T) at three shape groups, each in
     float64, float32 and bf16->float32, with the median of 5 timed runs;
  4. the frozen oracles on device="cuda" in DP (CCSD, CCD, CC2 on H2O),
     and precision="SP" against DP;
  5. a real size: (H2O)_6/cc-pVDZ CCSD (144 basis functions, (no, nv) =
     (24, 114) with the frozen core) through run_rhf -> ccwfn -> solve_cc.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import time

import torch

import pycc_tpu_torch
from pycc_tpu_torch.data import moldict
from pycc_tpu_torch.ops.kernels import vvvv
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt, vvvv_nt_reference
from pycc_tpu_torch.scf import run_rhf

DEVICE = "cuda:0"

# pycc_tpu, float64, on a CPU host:
#   pycc_tpu.ccwfn(run_rhf(moldict["(H2O)_6"], "cc-pvdz", freeze_core=True))
#       .solve_cc(e_conv=1e-10, r_conv=1e-10)
REAL_SIZE = "(H2O)_6"
REAL_ESCF = -456.223927411946
REAL_ECCSD = -1.295563980852

# frozen reference-suite values (tests/test_002, tests/test_004)
ORACLES = [
    ("sto-3g", "CCSD", True, -0.070616830152761),
    ("cc-pvdz", "CCSD", True, -0.222029814166783),
    ("cc-pvdz", "CCD", False, -0.222559319034),
    ("cc-pvdz", "CC2", False, -0.215857544656),
]

K1_SHAPES = [
    ((16, 361, 361), "H2O/cc-pVDZ ladder"),
    ((1000, 4999, 5003), "ragged"),
    ((576, 12996, 12996), "(H2O)_6/cc-pVDZ ladder"),
]
# (label, operand dtype, bf16 mode, tolerance on max|err| / max|ref|)
K1_TYPES = [
    ("f64", torch.float64, False, 1e-12),
    ("f32", torch.float32, False, 1e-5),
    ("bf16->f32", torch.bfloat16, True, 2e-2),
]


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print("[device] %s | torch %s | CUDA %s | devices %d"
          % (name, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()))
    print("[device] nvidia-smi name, power.limit: %s" % smi)
    return name, smi


def phase_build():
    t0 = time.perf_counter()
    log = vvvv.build()
    print("[build] vvvv_nt.cu built in %.2f s" % (time.perf_counter() - t0))
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("[build]   " + line.strip())


def _median_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(smi):
    cells = {}
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    for (m, n, k), what in K1_SHAPES:
        A64 = torch.randn((m, k), generator=gen, device=DEVICE,
                          dtype=torch.float64)
        B64 = torch.randn((n, k), generator=gen, device=DEVICE,
                          dtype=torch.float64)
        for label, dtype, bf16, tol in K1_TYPES:
            A, B = A64.to(dtype), B64.to(dtype)
            out = vvvv_nt(A, B, bf16=bf16)
            torch.cuda.synchronize()
            ref = vvvv_nt_reference(A, B, bf16=bf16)
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError("K1 %s %s: got %s %s, want %s %s"
                                     % (label, (m, n, k), tuple(out.shape),
                                        out.dtype, tuple(ref.shape), ref.dtype))
            err = (out.double() - ref.double()).abs().max().item()
            rel = err / ref.double().abs().max().item()
            if not rel < tol:
                raise AssertionError("K1 %s %s: max|err|/max|ref| = %.3e >= %.0e"
                                     % (label, (m, n, k), rel, tol))
            del out, ref
            vvvv_nt(A, B, bf16=bf16)   # warm-up
            A @ B.T
            torch.cuda.synchronize()
            ms = _median_ms(lambda: vvvv_nt(A, B, bf16=bf16))
            plain_ms = _median_ms(lambda: A @ B.T)
            tflops = 2.0 * m * n * k / (ms * 1e-3) / 1e12
            print("[K1] %-22s (M,N,K)=(%d,%d,%d) %-9s max|err|=%.3e rel=%.3e "
                  "(tol %.0e)  kernel %.3f ms (%.2f TFLOP/s)  A@B.T %.3f ms  | %s"
                  % (what, m, n, k, label, err, rel, tol, ms, tflops,
                     plain_ms, smi))
            cells[(m, n, k), label] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=plain_ms)
            del A, B
        del A64, B64
        torch.cuda.empty_cache()
    return cells


def _solve(cc, e_conv, r_conv):
    t0 = time.perf_counter()
    e = cc.solve_cc(e_conv=e_conv, r_conv=r_conv, maxiter=100)
    torch.cuda.synchronize()
    return e, time.perf_counter() - t0


def phase_oracles():
    h2o = moldict["H2O"]
    wfns = {}
    e_dp = None
    for basis, model, fzc, oracle in ORACLES:
        if (basis, fzc) not in wfns:
            wfns[basis, fzc] = run_rhf(h2o, basis, freeze_core=fzc)
        cc = pycc_tpu_torch.ccwfn(wfns[basis, fzc], model=model,
                                  device=DEVICE)
        vvvv_nt.launches = 0
        e, secs = _solve(cc, 1e-12, 1e-12)
        launches = vvvv_nt.launches
        gap = abs(e - oracle)
        print("[oracle] H2O/%s %s fzc=%s: Ecorr = %.15f  |dE| = %.2e  "
              "%d iterations  %d K1 launches  %.2f s"
              % (basis, model, fzc, e, gap, cc.niter, launches, secs))
        if not (cc.converged and gap < 1e-11):
            raise AssertionError("oracle H2O/%s %s missed: %.3e"
                                 % (basis, model, gap))
        if model in ("CCSD", "CCD") and launches < cc.niter:
            raise AssertionError("%s: %d K1 launches in %d iterations"
                                 % (model, launches, cc.niter))
        if (basis, model, fzc) == ("cc-pvdz", "CCSD", True):
            e_dp = e
    cc = pycc_tpu_torch.ccwfn(wfns["cc-pvdz", True], precision="SP",
                              device=DEVICE)
    e_sp, secs = _solve(cc, 1e-8, 1e-7)
    print("[oracle] H2O/cc-pvdz CCSD SP: Ecorr = %.12f  |SP - DP| = %.2e  "
          "%d iterations  %.2f s" % (e_sp, abs(e_sp - e_dp), cc.niter, secs))
    if not abs(e_sp - e_dp) < 1e-6:
        raise AssertionError("SP lands %.3e from DP" % abs(e_sp - e_dp))


def phase_real_size(smi):
    torch.cuda.reset_peak_memory_stats()
    vvvv_nt.launches = 0
    t0 = time.perf_counter()
    wfn = run_rhf(moldict[REAL_SIZE], "cc-pvdz", freeze_core=True)
    t_scf = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc = pycc_tpu_torch.ccwfn(wfn, device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    e, t_solve = _solve(cc, 1e-10, 1e-10)
    launches = vvvv_nt.launches
    peak = torch.cuda.max_memory_allocated()
    print("[real] %s/cc-pVDZ CCSD  nbf=%d (no, nv)=(%d, %d)  | %s"
          % (REAL_SIZE, wfn.basisset().nbf, cc.no, cc.nv, smi))
    print("[real] E(SCF) = %.12f  |dE(SCF)| = %.2e  SCF %.1f s (host)"
          % (wfn.energy(), abs(wfn.energy() - REAL_ESCF), t_scf))
    print("[real] Hamiltonian + ccwfn init %.1f s  solve %.1f s  %d iterations"
          "  %.3f s/iter  peak device memory %.2f GB  K1 launches %d"
          % (t_init, t_solve, cc.niter, t_solve / cc.niter, peak / 1e9,
             launches))
    print("[real] Ecorr(CCSD) = %.12f  |dE| = %.2e" % (e, abs(e - REAL_ECCSD)))
    ok_shapes = (cc.t2.shape == (cc.no, cc.no, cc.nv, cc.nv)
                 and bool(torch.isfinite(cc.t2).all()))
    if not ok_shapes:
        raise AssertionError("t2 is not finite or has the wrong shape")
    if not abs(wfn.energy() - REAL_ESCF) < 1e-9:
        raise AssertionError("E(SCF) missed the frozen value")
    if not (cc.converged and abs(e - REAL_ECCSD) < 1e-9):
        raise AssertionError("Ecorr(CCSD) missed the frozen value")
    if launches < cc.niter:
        raise AssertionError("%d K1 launches in %d iterations"
                             % (launches, cc.niter))
    return launches


def main():
    name, smi = phase_device()
    pycc_tpu_torch.set_verbosity("quiet")
    phase_build()
    cells = phase_kernel(smi)
    phase_oracles()
    launches = phase_real_size(smi)
    main_cell = cells[K1_SHAPES[-1][0], "f64"]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "vvvv_nt", "route": "cuda",
        "source": "pycc_tpu_torch/csrc/vvvv_nt.cu",
        "replaces": "pycc_tpu/ops/kernels/vvvv.py:38",
        "launches": launches, **main_cell}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
