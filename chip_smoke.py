#!/usr/bin/env python3
"""Drive pycc_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          (from the repository root)

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: a CUDA card must be present; print its name, torch/CUDA
     versions and nvidia-smi's name and power limit;
  2. build the K1 (csrc/vvvv_nt.cu) and K2 (csrc/t_row.cu) kernels with
     nvcc, both at once, and count the tensor-core instructions (DMMA for
     float64, HMMA for bf16) that cuobjdump finds in each;
  3. K1 against its plain version (A @ B.T, also its library yardstick)
     at three shape groups, each in float64, float32 and bf16->float32,
     with the median of 5 timed runs and the least time the card could
     take (bound_ms: the larger of bytes / 3.35 TB/s and flop / peak);
  4. K2 against its plain version (t_energy_row_reference) at (no, nv) =
     (4, 19), (7, 45) and (24, 114), each in float64, float32 and
     bf16->float32, with the median of 5 timed runs of one row and its
     bound;
  5. the frozen oracles on device="cuda" in DP (CCSD, CCD, CC2 and the
     CCSD(T) triples on H2O), and precision="SP" against DP;
  6. a real size: (H2O)_6/cc-pVDZ CCSD(T) (144 basis functions, (no, nv) =
     (24, 114) with the frozen core) through run_rhf -> ccwfn -> solve_cc,
     then the same (T) through the two plain paths.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import collections
import json
import math
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import pycc_tpu_torch
from pycc_tpu_torch.ops.kernels import build as kernel_build
from pycc_tpu_torch.data import moldict
from pycc_tpu_torch import triples
from pycc_tpu_torch.ops.kernels import triples as k2
from pycc_tpu_torch.ops.kernels import vvvv
from pycc_tpu_torch.ops.kernels.triples import (t_energy_row,
                                                t_energy_row_reference,
                                                t_row_finalize)
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt, vvvv_nt_reference
from pycc_tpu_torch.scf import run_rhf

DEVICE = "cuda:0"

# name: (E(SCF), Ecorr(CCSD), E(T)), from pycc_tpu in float64 on a CPU host:
#   cc = pycc_tpu.ccwfn(run_rhf(moldict[name], "cc-pvdz", freeze_core=True))
#   cc.solve_cc(e_conv=1e-10, r_conv=1e-10); pycc_tpu.triples.t_vikings_scan(cc)
# except the (H2O)_6 E(T), which is the float64 plain pair-symmetric scan of
# this package (triples.t_vikings_scan_core, held to pycc_tpu's at 1e-12 by
# tests/test_torch_triples.py) on an H100; the kernel path and the plain
# row loop gave the same 12 digits.
FROZEN = {
    "(H2O)_4": (-304.146784080189, -0.861900803788, -0.014841440703),
    "(H2O)_6": (-456.223927411946, -1.295563980852, -0.022743160994),
}
REAL_SIZE = "(H2O)_6"

# frozen reference-suite values (tests/test_002, tests/test_004)
# (basis, model, freeze_core, Ecorr; for CCSD(T) the (T) energy alone)
ORACLES = [
    ("sto-3g", "CCSD", True, -0.070616830152761),
    ("cc-pvdz", "CCSD", True, -0.222029814166783),
    ("cc-pvdz", "CCD", False, -0.222559319034),
    ("cc-pvdz", "CC2", False, -0.215857544656),
    ("sto-3g", "CCSD(T)", True, -0.000099957499645),
    ("cc-pvdz", "CCSD(T)", True, -0.003861236558801),
]

K1_SHAPES = [
    ((16, 361, 361), "H2O/cc-pVDZ ladder"),
    ((1000, 4999, 5003), "ragged"),
    ((576, 12996, 12996), "(H2O)_6/cc-pVDZ ladder"),
]
# the H100 SXM data sheet's dense peaks (at its 700 W limit): HBM bytes/s,
# and flop/s for the arithmetic each kernel does in each type (float64 on
# the FP64 tensor cores, float32 on the CUDA cores, bf16 on the tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"f64": 67e12, "f32": 67e12, "bf16->f32": 989e12}

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


def bound(work, nbytes):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the HBM rate and the flop over the peaks; work is
    [(flop, type label)], each part at its type's peak."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(flops / PEAK_FLOPS[label] for flops, label in work) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _sass_mma(name):
    """Counts of the tensor-core instructions in a built kernel library."""
    from torch.utils.cpp_extension import CUDA_HOME
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
         kernel_build.paths(name)[1]],
        capture_output=True, text=True, check=True).stdout
    return dict(collections.Counter(
        w.rstrip(";") for line in sass.splitlines() for w in line.split()
        if w.startswith(("DMMA", "HMMA"))))


def phase_build():
    t0 = time.perf_counter()
    mods = (("vvvv_nt", vvvv), ("t_row", k2))
    with ThreadPoolExecutor(len(mods)) as pool:
        logs = list(pool.map(lambda m: m[1].build(), mods))
    print("[build] vvvv_nt.cu and t_row.cu built in %.2f s"
          % (time.perf_counter() - t0))
    for (name, _), log in zip(mods, logs):
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("[build] %s: %s" % (name, line.strip()))
    for name, _ in mods:
        mma = _sass_mma(name)
        print("[build] %s SASS tensor-core instructions: %s" % (name, mma))
        for op in ("DMMA", "HMMA"):     # float64 and bf16 tensor-core paths
            if not any(x.startswith(op) for x in mma):
                raise AssertionError("%s has no %s instruction" % (name, op))


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
            plain_ms = _median_ms(lambda: vvvv_nt_reference(A, B, bf16=bf16))
            library_ms = _median_ms(lambda: A @ B.T)
            flops = 2.0 * m * n * k
            elem = 2 if bf16 else A.element_size()
            nbytes = (m + n) * k * elem + m * n * (4 if bf16 else elem)
            bound_ms, bound_by = bound([(flops, label)], nbytes)
            print("[K1] %-22s (M,N,K)=(%d,%d,%d) %-9s max|err|=%.3e rel=%.3e "
                  "(tol %.0e)  kernel %.3f ms (%.2f TFLOP/s)  bound %.3f ms "
                  "(%s, %.0f%% of it)  plain %.3f ms  A@B.T %.3f ms  | %s"
                  % (what, m, n, k, label, err, rel, tol, ms,
                     flops / (ms * 1e-3) / 1e12, bound_ms, bound_by,
                     100.0 * bound_ms / ms, plain_ms, library_ms, smi))
            cells[(m, n, k), label] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
            del A, B
        del A64, B64
        torch.cuda.empty_cache()
    return cells


K2_SHAPES = [
    ((4, 19), "H2O/cc-pVDZ fzc", None),          # None: every row
    ((7, 45), "ragged", (0, 6)),
    ((24, 114), "(H2O)_6/cc-pVDZ fzc", (0, 23)),
]
# (label, operand dtype, stream_dtype, tolerance on max|err| / max|ref|)
K2_TYPES = [
    ("f64", torch.float64, None, 1e-12),
    ("f32", torch.float32, None, 1e-5),
    ("bf16->f32", torch.float32, torch.bfloat16, 2e-2),
]
K2_OUTPUTS = ("X1a", "X1m", "Z1", "Z1m", "Z2a", "Z2m", "X2l")


def k2_row_flops(no, nv):
    """The kernel's arithmetic for one row: o^2 v^3 t3 elements, each
    built with 6 (v + o) FMA and projected with 2 v + 3 o more."""
    return 2.0 * no ** 2 * nv ** 3 * (8 * nv + 9 * no)


def k2_build_flops(no, nv):
    """The t3 build's share of k2_row_flops: 6 (v + o) FMA an element."""
    return 2.0 * no ** 2 * nv ** 3 * 6 * (nv + no)


def k2_work(no, nv, label):
    """[(flop, type label)] of one row: in the bf16 mode the build
    multiplies bf16 operands on the bf16 tensor cores and the projections
    run in float32; otherwise all of it is in the operands' type."""
    if label != "bf16->f32":
        return [(k2_row_flops(no, nv), label)]
    build = k2_build_flops(no, nv)
    return [(build, label), (k2_row_flops(no, nv) - build, "f32")]


def k2_row_bytes(no, nv, in_bytes, acc_bytes):
    """One row's operands read once (Wv, Ot, Ev, Eo, L and t2 in the
    streamed type, Fov and eps in the tile type) and its seven outputs
    written once."""
    streamed = (2 * no * nv ** 3 + 2 * no ** 3 * nv + no ** 2 * nv ** 2 * 2)
    small = no * nv + no + nv
    outs = 2 * no * nv + 4 * no * nv ** 2 + no ** 2 * nv ** 2
    return streamed * in_bytes + (small + outs) * acc_bytes


def _k2_inputs(no, nv, gen):
    """Random row-kernel operands in float64, scaled and with the orbital
    energies spread as in tests/test_012_infra.py."""
    def mk(*shape):
        return 0.02 * torch.randn(shape, generator=gen, device=DEVICE,
                                  dtype=torch.float64)
    eps = torch.cat([torch.linspace(-2.0, -0.5, no, dtype=torch.float64),
                     torch.linspace(0.3, 3.0, nv, dtype=torch.float64)])
    return (mk(no, nv, nv, nv), mk(no, no, no, nv), mk(nv, no, nv, nv),
            mk(no, no, no, nv), mk(no, no, nv, nv), mk(no, nv),
            eps.to(DEVICE), mk(no, no, nv, nv))


def phase_k2(smi, shapes=K2_SHAPES):
    cells = {}
    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    for (no, nv), what, rows in shapes:
        ops64 = _k2_inputs(no, nv, gen)
        rows = tuple(range(no)) if rows is None else rows
        for label, dtype, sd, tol in K2_TYPES:
            ops = tuple(x.to(dtype) for x in ops64)
            worst = dict.fromkeys(K2_OUTPUTS, 0.0)
            err = 0.0
            for i in rows:
                out = t_energy_row(i, *ops, no, stream_dtype=sd)
                torch.cuda.synchronize()
                ref = t_energy_row_reference(i, *ops, no, stream_dtype=sd)
                for name, a, b in zip(K2_OUTPUTS, out, ref):
                    if a.shape != b.shape or a.dtype != b.dtype:
                        raise AssertionError(
                            "K2 %s %s %s: got %s %s, want %s %s"
                            % (label, (no, nv), name, tuple(a.shape),
                               a.dtype, tuple(b.shape), b.dtype))
                    e = (a.double() - b.double()).abs().max().item()
                    err = max(err, e)
                    worst[name] = max(worst[name],
                                      e / b.double().abs().max().item())
                del out, ref
            rels = " ".join("%s %.1e" % kv for kv in worst.items())
            if not max(worst.values()) < tol:
                raise AssertionError("K2 %s %s: max|err|/max|ref| %s (tol %.0e)"
                                     % (label, (no, nv), rels, tol))
            i = rows[0]
            # the row-independent operands, formed once as t_vikings_rows
            # forms them for all rows
            derived = k2.t_row_derived(ops[1], ops[2], ops[7], sd)
            t_energy_row(i, *ops, no, stream_dtype=sd, derived=derived)
            t_energy_row_reference(i, *ops, no, stream_dtype=sd)   # warm-up
            torch.cuda.synchronize()
            ms = _median_ms(lambda: t_energy_row(
                i, *ops, no, stream_dtype=sd, derived=derived))
            plain_ms = _median_ms(
                lambda: t_energy_row_reference(i, *ops, no, stream_dtype=sd))
            del derived
            in_bytes = 2 if sd == torch.bfloat16 else ops[0].element_size()
            acc_bytes = 4 if sd == torch.bfloat16 else in_bytes
            bound_ms, bound_by = bound(
                k2_work(no, nv, label),
                k2_row_bytes(no, nv, in_bytes, acc_bytes))
            print("[K2] %-20s (no,nv)=(%d,%d) %-9s rows %s  max|err|/max|ref|: "
                  "%s (tol %.0e)  row %d: kernel %.3f ms (%.2f TFLOP/s)  "
                  "bound %.3f ms (%s, %.0f%% of it)  plain %.3f ms  | %s"
                  % (what, no, nv, label, ",".join(map(str, rows))
                     if len(rows) < no else "all", rels, tol, i, ms,
                     k2_row_flops(no, nv) / (ms * 1e-3) / 1e12, bound_ms,
                     bound_by, 100.0 * bound_ms / ms, plain_ms, smi))
            cells[(no, nv), label] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)
            del ops
        del ops64
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
    et_dp = None
    for basis, model, fzc, oracle in ORACLES:
        if (basis, fzc) not in wfns:
            wfns[basis, fzc] = run_rhf(h2o, basis, freeze_core=fzc)
        cc = pycc_tpu_torch.ccwfn(wfns[basis, fzc], model=model,
                                  device=DEVICE)
        vvvv_nt.launches = 0
        t_energy_row.launches = 0
        e, secs = _solve(cc, 1e-12, 1e-12)
        launches = vvvv_nt.launches
        k2_launches = t_energy_row.launches
        if model == "CCSD(T)":
            eccsd = float(cc.cc_energy(cc.t1, cc.t2))
            value, what = e - eccsd, "E(T)"
        else:
            value, what = e, "Ecorr"
        gap = abs(value - oracle)
        print("[oracle] H2O/%s %s fzc=%s: %s = %.15f  |dE| = %.2e  "
              "%d iterations  %d K1 launches  %d K2 launches  %.2f s"
              % (basis, model, fzc, what, value, gap, cc.niter, launches,
                 k2_launches, secs))
        if not (cc.converged and gap < 1e-11):
            raise AssertionError("oracle H2O/%s %s missed: %.3e"
                                 % (basis, model, gap))
        if model != "CC2" and launches < cc.niter:
            raise AssertionError("%s: %d K1 launches in %d iterations"
                                 % (model, launches, cc.niter))
        if model == "CCSD(T)":
            if k2_launches != cc.no or cc.ecc != e:
                raise AssertionError("CCSD(T): %d K2 launches for no = %d, "
                                     "ecc %r, returned %r"
                                     % (k2_launches, cc.no, cc.ecc, e))
            if basis == "cc-pvdz":
                eccsd_dp, et_dp = eccsd, value
    cc = pycc_tpu_torch.ccwfn(wfns["cc-pvdz", True], model="CCSD(T)",
                              precision="SP", device=DEVICE)
    e_sp, secs = _solve(cc, 1e-8, 1e-7)
    eccsd_sp = float(cc.cc_energy(cc.t1, cc.t2))
    et_sp = e_sp - eccsd_sp
    print("[oracle] H2O/cc-pvdz CCSD(T) SP: Ecorr(CCSD) = %.12f  |SP - DP| = "
          "%.2e  E(T) = %.12f  |SP - DP| = %.2e  %d iterations  %.2f s"
          % (eccsd_sp, abs(eccsd_sp - eccsd_dp), et_sp, abs(et_sp - et_dp),
             cc.niter, secs))
    if not (cc.converged and abs(eccsd_sp - eccsd_dp) < 1e-6
            and abs(et_sp - et_dp) < 1e-6):
        raise AssertionError("SP lands %.3e (CCSD), %.3e ((T)) from DP"
                             % (abs(eccsd_sp - eccsd_dp), abs(et_sp - et_dp)))


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = float(fn())
    return out, time.perf_counter() - t0


def phase_real_size(smi, name=REAL_SIZE):
    escf_ref, eccsd_ref, et_ref = FROZEN[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wfn = run_rhf(moldict[name], "cc-pvdz", freeze_core=True)
    t_scf = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD(T)", device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    vvvv_nt.launches = 0
    t_energy_row.launches = 0
    e, t_solve = _solve(cc, 1e-10, 1e-10)
    launches = {"vvvv_nt": vvvv_nt.launches, "t_row": t_energy_row.launches}
    peak = torch.cuda.max_memory_allocated()
    t_t = cc.timers.total["ccwfn.triples"]
    eccsd = float(cc.cc_energy(cc.t1, cc.t2))
    et = e - eccsd
    print("[real] %s/cc-pVDZ CCSD(T)  nbf=%d (no, nv)=(%d, %d)  | %s"
          % (name, wfn.basisset().nbf, cc.no, cc.nv, smi))
    print("[real] E(SCF) = %.12f  |dE(SCF)| = %.2e  SCF %.1f s (host)"
          % (wfn.energy(), abs(wfn.energy() - escf_ref), t_scf))
    print("[real] Hamiltonian + ccwfn init %.1f s  CCSD solve %.1f s  %d "
          "iterations  %.3f s/iter  (T) %.1f s  peak device memory %.2f GB  "
          "K1 launches %d  K2 launches %d"
          % (t_init, t_solve - t_t, cc.niter, (t_solve - t_t) / cc.niter,
             t_t, peak / 1e9, launches["vvvv_nt"], launches["t_row"]))
    print("[real] Ecorr(CCSD) = %.12f  |dE| = %.2e" % (eccsd,
                                                      abs(eccsd - eccsd_ref)))
    print("[real] E(T) = %.12f  |dE| = %.2e" % (et, abs(et - et_ref)))

    # the same (T) through the two plain paths, on the same slices
    sl = triples.scan_slices(cc)
    t1, t2, no = cc.t1, cc.t2, cc.no
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    e_rows, t_rows = _timed(lambda: sum(
        t_row_finalize(i, t_energy_row_reference(i, *sl, t2, no), t1, t2w)
        for i in range(no)))
    e_scan, t_scan = _timed(
        lambda: triples.t_vikings_scan_core(*sl, t1, t2, no))
    print("[real] (T): kernel rows %.1f s E(T) %.12f | plain rows %.1f s "
          "E(T) %.12f | plain pair-symmetric scan %.1f s E(T) %.12f  | %s"
          % (t_t, et, t_rows, e_rows, t_scan, e_scan, smi))
    print("[real] peak device memory with the plain paths %.2f GB"
          % (torch.cuda.max_memory_allocated() / 1e9))

    ok_shapes = (cc.t2.shape == (cc.no, cc.no, cc.nv, cc.nv)
                 and bool(torch.isfinite(cc.t2).all()) and math.isfinite(et))
    if not ok_shapes:
        raise AssertionError("t2 or E(T) is not finite, or t2 has the wrong "
                             "shape")
    if not abs(wfn.energy() - escf_ref) < 1e-9:
        raise AssertionError("E(SCF) missed the frozen value")
    if not (cc.converged and abs(eccsd - eccsd_ref) < 1e-9):
        raise AssertionError("Ecorr(CCSD) missed the frozen value")
    if not abs(et - et_ref) < 1e-9:
        raise AssertionError("E(T) missed the frozen value")
    if not (abs(e_rows - et) < 1e-10 and abs(e_scan - et) < 1e-10):
        raise AssertionError("the plain (T) paths disagree with the kernel's")
    if launches["vvvv_nt"] < cc.niter or launches["t_row"] != cc.no:
        raise AssertionError("%d K1 launches in %d iterations, %d K2 launches "
                             "for no = %d" % (launches["vvvv_nt"], cc.niter,
                                              launches["t_row"], cc.no))
    return launches


def main():
    name, smi = phase_device()
    pycc_tpu_torch.set_verbosity("quiet")
    phase_build()
    k1_cells = phase_kernel(smi)
    k2_cells = phase_k2(smi)
    phase_oracles()
    launches = phase_real_size(smi)
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "vvvv_nt", "route": "cuda",
         "source": "pycc_tpu_torch/csrc/vvvv_nt.cu",
         "replaces": "pycc_tpu/ops/kernels/vvvv.py:38",
         "launches": launches["vvvv_nt"],
         **k1_cells[K1_SHAPES[-1][0], "f64"]},
        {"name": "t_row", "route": "cuda",
         "source": "pycc_tpu_torch/csrc/t_row.cu",
         "replaces": "pycc_tpu/ops/kernels/triples.py:170",
         "launches": launches["t_row"],
         **k2_cells[K2_SHAPES[-1][0], "f64"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
