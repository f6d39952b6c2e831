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
     at four shape groups (the last one a-block of the DF ladder of
     phase 7), each in float64, float32 and bf16->float32, and at the
     EOM sigma batch of phase 6b, the stacked complex / in_Y1 ladder
     of phase 6c (also real-time CC's T ladder, phase 6f), the CC3
     ladder of phase 6d, the DF EOM sigma block of phase 7b and the
     stacked complex-W Lambda ladder of phase 6f (its library yardstick
     one complex128 A @ B.T) in float64, with the median of 5 timed runs
     and the least time the card could take (bound_ms: the larger of
     bytes / 3.35 TB/s and flop / peak);
  4. K2 against its plain version (t_energy_row_reference) at (no, nv) =
     (4, 19), (7, 45) and (24, 114), each in float64, float32 and
     bf16->float32, at (24, 216) (phase 7's (T)) in float64, and at
     (104, 20), past one chunk of the occupied l, in float64 to 1e-13,
     with the median of timed runs of one row and its bound; the
     kernel's shared-memory layout held to its Python mirror;
  5. the frozen oracles on device="cuda" in DP (CCSD, CCD, CC2 and the
     CCSD(T) triples on H2O; Lambda, densities and EOM-CCSD roots of
     tests/test_005, test_011 and test_006; the linear-response
     polarizability of tests/test_007 and the MU/M/M*/P/P*/Q
     pseudoresponses of test_013), precision="SP" against DP, and the DF
     (Cholesky) oracles: storage="df" CCSD on STO-3G and, from
     run_rhf(df=True), on cc-pVDZ, and DF-direct CCSD(T) against dense;
     the CC3 energy, Lambda pseudo-energy and CFOUR dipole of
     tests/test_009 and DF CC3 on STO-3G against dense (tests/test_026);
     and the DF post-convergence oracles: the DF Lambda pseudo-energy and
     DF EOM-CCSD roots of tests/test_019, the DF polarizability of
     test_020, the CCSD(T) density over factors and the DF density
     energies of test_024, and DF Lambda-CC3 and the CC3 one-pdm of
     test_026, each against its frozen value or dense storage;
     Then tests/test_016's blocked and bf16-gated oracles and test_027's
     mixed-precision and checkpoint cases (K1 in bf16 and f32 there);
     and the real-time CC oracles: He/cc-pVDZ under a sine^2 pulse
     through scipy's vode (test_008's mu_z(1.0), test_013's
     autocorrelation), the H2O/cc-pVDZ rk4 dipoles of test_008, the
     (H2)_2/cc-pVDZ electric and magnetic dipoles of test_015, He's
     checkpoint/restart equality and H2O/STO-3G's DF right-hand side
     against the dense one (test_025), each right-hand side's K1
     launches counted; and the local-correlation oracles: test_010's
     filter-path energies and Lambda pseudo-energies (K1 launches =
     iterations), its native cases (native CCD/CCSD = filter, native CC2
     = its dense backend, the pair-screened ones), test_028's DLPNO-MP2
     and test_013's two local real-time trajectories (K1 in both complex
     ladders of every right-hand side);
  6. a real size on full storage: (H2O)_6/cc-pVDZ CCSD(T) (144 basis
     functions, (no, nv) = (24, 114) with the frozen core) through
     run_rhf -> ccwfn -> solve_cc, one residual timed at the converged
     amplitudes, and the (T) with bf16 slabs (t_vikings_scan(slab_dtype=
     torch.bfloat16): K2's bf16 stream, one launch a row, held to
     tests/test_004's two conditions against the float64 K2 value);
  6b. [post] post-convergence on phase 6's ccwfn: the (T) density scan
     (its E(T) held to K2's), HBAR, Lambda-CCSD(T) (K1 on the pre-laid
     'ijef,efab' operand, one launch an iteration), the densities and
     their energy (held to E(CCSD) + E(T)), and EOM-CCSD for 3 roots from
     the CIS guess (one K1 launch a sigma batch), with the residuals
     recomputed from the
     returned subspace and the sigma through K1 held to the plain one;
  6c. [resp] linear response on the same ccwfn and its Lambda: the 21
     pertbars (12 complex), the conditioning probe, the MU-MU dynamic
     polarizability (linresp: 3 right and 3 left solves, K1 in every
     r_X and r_Y and once an in_Y1) and one complex M_X right solve
     (K1 on stacked real and imaginary rows), with every returned vector's
     residual recomputed and each K1 ladder held to the plain one;
  6d. [cc3] CC3 at a real size on full storage: (H2O)_4/cc-pVDZ (96
     basis functions, (no, nv) = (16, 76) with the frozen core, o^3 v^3 =
     1.8e9, so the slab forms) through run_rhf -> ccwfn(model="CC3") ->
     solve_cc -> cchbar -> cclambda -> ccdensity.compute_onepdm and the
     CC3 dipole, K1 in the CCSD part of every CC3 residual and in the
     CCSD-form ladder of every Lambda-CC3 step; one residual and one
     Lambda step timed by part and held to their plain-ladder selves, the
     residual recomputed at the returned amplitudes, E(CC3) held to the
     frozen pycc_tpu value;
  6e. [mixed] blocked storage, mixed precision and checkpoint/resume on
     phase 6's wavefunction: ccwfn(storage="blocked") (its init against
     [real]'s), solve_cc_mixed with a bf16 stage and checkpoints (K1 in
     bf16, f32 and f64, launches counted by mode), the stage-aware
     resume, the (T) through K2 on slices cut from the block views,
     solve_lambda_mixed against a float64 Lambda, the density energy,
     solve_eom_mixed against [post]'s roots, solve_right_mixed and
     solve_left_mixed for MU_Z (residuals recomputed), a blocked residual
     timed against phase 6's full one, and the blocked ladder in each
     type held to its plain version;
  6f. [rt] real-time CC at [real]'s size on its wavefunction (no second
     SCF): a CCSD ccwfn on full storage, its solve and Lambda, then
     rtcc under a Gaussian pulse and rk4(0.01) for 10 steps (40
     right-hand sides), y on the card; the field-free right-hand side
     at the converged state (residuals and the phase's quasienergy), the
     Lagrangian and dipole at t = 0, one right-hand side through K1
     against the plain ladder, K1's launches counted for each of the two
     complex ladders (the T side's stacked tau, the Lambda side's
     stacked complex W), the right-hand side split by part; after [cc3],
     two rk4 steps at (H2O)_4/cc-pVDZ on [cc3]'s wavefunction against
     pycc_tpu's frozen mu_z and Lagrangian;
  6g. [local] local correlation at [real]'s size on its wavefunction:
     the PNO filter path (localize, H rebuild, pair spaces, CCSD and the
     filtered Lambda against pycc_tpu's frozen E, Lambda and pair
     dimensions, K1 launches = iterations, one iteration under
     torch.profiler) and the native pair-space CCSD through
     ccwfn(filter=False) on the same spaces (= the filter path); after
     [cc3], on its (H2O)_4 wavefunction, the same checks of the filter
     path, the native stacks' bytes reckoned first, then native CCSD
     unscreened, at pair_cutoff = 0 and at pair_cutoff = 1e-4;
  7. [df] a real size over Cholesky factors, which full storage cannot
     hold on 80 GB: (H2O)_6/aug-cc-pVDZ DF-CCSD(T) (246 basis functions,
     (24, 216)) through run_rhf(df=True) -> ccwfn(storage="df") ->
     solve_cc, with the host seconds and the ladder split into W assembly
     and K1; its DF-SCF and AO property integrals run in a spawned worker
     process from the top of the script (`DFWorker`, two host threads),
     beside the earlier phases, and the script stops it on every exit;
  7b. [dfpost] the DF post-convergence stack at that size, on phase 7's
     factors, F and dipole integrals (ccwfn.from_df_factors, CCSD,
     solved by solve_cc_mixed with a bf16 stage: K1 in bf16, f32 and f64
     at the DF a-block): HBAR,
     Lambda, the densities and their energy (held to Ecorr(CCSD)),
     EOM-CCSD for the 6 lowest roots (residuals recomputed, the sigma
     through K1 held to the plain one), one right and one left MU_Z solve
     and that polarizability element (residuals recomputed), each K1
     caller (Lambda, EOM, densities, response) counted and held to its
     plain ladder.
  7c. [dfrt] real-time CCSD over those factors on [dfpost]'s converged
     CCSD and Lambda (no new SCF or solve): rtcc under the Gaussian pulse
     for 2 rk4(0.01) steps, y on the card; the field-free right-hand side
     at the converged state, the Lagrangian and dipole at t = 0, one
     right-hand side through K1 against the plain ladder, K1's launches
     counted for each of the two complex ladders (one launch an a-block
     of the complex W a side), the right-hand side split into the T side,
     the DF-HBAR rebuild, the W assembly and the Lambda side; then two
     rk4 steps at (H2O)_4/cc-pVDZ over factors (storage="df", the MO
     ERI's Cholesky) on [cc3]'s wavefunction against pycc_tpu's frozen mu
     and Lagrangian at 1e-10.
  8. [mesh] the sharded paths at full width, on [real]'s wavefunction
     and [df]'s factors (no new SCF), over a 2 x 2 mesh of cuda:(i % n)
     for n cards (on one card the four shards share cuda:0): (H2O)_6
     CCSD(T) through ccwfn(mesh=) (E held to [real]'s at 1e-11, K1 one
     launch a shard an iteration, K2 on slices assembled from the shards),
     the (T) density, HBAR, Lambda (held to [post]'s pseudo-energy at
     1e-10) and 3 EOM roots from the CIS guess (held to [post]'s at 1e-7),
     one sharded ladder timed against one launch on the whole W; and
     DF-CCSD at (24, 216) through from_df_factors(mesh=) (held to [df]'s
     at 1e-10, K1 one launch an a-block a shard).  Each init's rise of the
     home card's peak is checked against what the card then holds (the
     integrals are cut into pieces from host memory).  K1 at the
     per-shard shapes is in phase 3's table.  Last, the native local
     solver over the mesh, ccwfn(local="PNO", filter=False, mesh=): its
     stacks cut by pycc_tpu's rule, (H2O)_6 CCSD held to [local]'s native
     energy at 1e-11 and (H2O)_4 at pair_cutoff 1e-4 (the screened stacks
     over 'va') to [local]'s, with the stacks' bytes a cell against
     whole, s/iter against [local]'s and the peak.
The script's total seconds and the card's name and power limit precede
the kernels' summary.
The line before the last is the kernels' JSON summary (one entry for each
kernel on each path); the last line is {"ok": true, "device": {...}}.
"""

import collections
import gc
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import tempfile
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import pycc_tpu_torch
from pycc_tpu_torch.ops.kernels import build as kernel_build
from pycc_tpu_torch.data import moldict
from pycc_tpu_torch import triples
from pycc_tpu_torch.cchbar import build_hbar
from pycc_tpu_torch.cclambda import cc3_extra_fn, lambda_residuals
from pycc_tpu_torch.ccdensity import build_Moo, build_Mvv
from pycc_tpu_torch.hamiltonian import ao_properties, build_hamiltonian
from pycc_tpu_torch.models import cc3, dfccsd
from pycc_tpu_torch.models.ccsd import (build_tau, residuals_ccsd,
                                        vvvv_contract, vvvv_contract_efab)
from pycc_tpu_torch.models.dfdensity import density_energy_df
from pycc_tpu_torch.models.dfhbar import build_hbar_df, hvvvv_x2_df
from pycc_tpu_torch.ops.kernels import triples as k2
from pycc_tpu_torch.ops.kernels import vvvv
from pycc_tpu_torch.ops.kernels.triples import (t_energy_row,
                                                t_energy_row_reference)
from pycc_tpu_torch.ops.cholesky import cholesky_factor_eri
from pycc_tpu_torch.ops.kernels.vvvv import (stack_rows, vvvv_nt,
                                             vvvv_nt_reference)
from pycc_tpu_torch.rt.integrators import rk4
from pycc_tpu_torch.rt.lasers import gaussian_laser, sine_square_laser
from pycc_tpu_torch.scf import integrals as ints
from pycc_tpu_torch.scf import run_rhf
from pycc_tpu_torch.utils.timing import trace

from portbench.harness.roofline import (HBM_BYTES_S, bound_s, k2_row_bytes,
                                        k2_row_flops)

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

# name: (Ecorr(CC3), Lambda-CC3 pseudo-energy), cc-pVDZ, frozen core,
# from pycc_tpu in float64 on a CPU host (its slab-row forms, 20 CC3 and 18
# Lambda iterations):
#   cc = pycc_tpu.ccwfn(run_rhf(moldict[name], "cc-pvdz", freeze_core=True),
#                       model="CC3")
#   cc.solve_cc(1e-10, 1e-10)
#   pycc_tpu.cclambda(cc, pycc_tpu.cchbar(cc)).solve_lambda(1e-10, 1e-10)
FROZEN_CC3 = {
    "(H2O)_4": (-0.877321787710256, -0.862491519909963),
}
CC3_SIZE = "(H2O)_4"
CC3_NO, CC3_NV = 16, 76

# name: (E(SCF), Ecorr(CCSD), E(T)) over Cholesky factors, aug-cc-pVDZ,
# frozen core, df_tol=1e-8.  E(SCF) and Ecorr(CCSD) from pycc_tpu in
# float64 on a CPU host:
#   wfn = run_rhf(moldict[name], "aug-cc-pvdz", freeze_core=True, df=True,
#                 df_tol=1e-8)
#   pycc_tpu.ccwfn(wfn, storage="df", df_tol=1e-8).solve_cc(e_conv=1e-10,
#                                                           r_conv=1e-10)
# (24 iterations, naux 2873 -> 2798).  E(T) from this package's float64
# plain pair-symmetric scan (triples.t_vikings_scan_core on the
# triples.t_scan_df_slices slices) on an H100, with which the K2 path
# agreed to 4e-17; that run's E(SCF) and Ecorr(CCSD) were within 7e-13
# and 1e-12 of pycc_tpu's.
FROZEN_DF = {
    "(H2O)_6": (-456.281955855946, -1.391551649523, -0.036743561234),
}
DF_SIZE = "(H2O)_6"
DF_NO, DF_NV = 24, 216          # (H2O)_6/aug-cc-pVDZ with the frozen core
DF_TOL = 1e-8
# the a-block ladder_df launches K1 on there: (o^2, blk*v, v^2)
DF_BLK = -(-DF_NV // dfccsd._ladder_blocks(DF_NV, 0))
K1_DF_SHAPE = (DF_NO ** 2, DF_BLK * DF_NV, DF_NV ** 2)

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

# the EOM roots of phase 6b, and the sigma batch K1 sees there: the
# Davidson adds one vector a root that has not converged
EOM_ROOTS = 3
K1_FULL_SHAPE = (576, 12996, 12996)
K1_EOM_SHAPE = (EOM_ROOTS * 576, 12996, 12996)
# the response ladders of phase 6c: a complex X2 or Y2 as stacked real and
# imaginary rows, and in_Y1's two l2 ladders stacked, are both (2 o^2, ...)
K1_RESP_SHAPE = (2 * 576, 12996, 12996)
# the CC3 ladders of phase 6d, the CCSD residual's and Lambda's:
# (o^2, v^2, v^2)
K1_CC3_SHAPE = (CC3_NO ** 2, CC3_NV ** 2, CC3_NV ** 2)
# the roots of phase 7b's EOM: (H2O)_6/aug-cc-pVDZ's lowest excited states
# are six near-degenerate n -> 3s states, one a water, within 16 mEh; a
# 3-root Davidson converges on mixtures of them (residual norms stop near
# 1e-3, probes/eom_df_roots.py), a 6-root one resolves the cluster
DFPOST_EOM_ROOTS = 6
# the DF EOM sigma of phase 7b: a block of DFPOST_EOM_ROOTS vectors' rows
# stacked against one a-block, (k o^2, blk*v, v^2)
K1_DF_EOM_SHAPE = (DFPOST_EOM_ROOTS * DF_NO ** 2,) + K1_DF_SHAPE[1:]
# the real-time ladders of phase 6f: the T side's complex tau against the
# real <ab|ef> is K1_RESP_SHAPE; the Lambda side's complex l2 against the
# complex HBAR's Hvvvv is one product of the stacked operands, (2 o^2,
# 2 v^2, v^2), whose library yardstick is one complex128 A @ B.T at
# (o^2, v^2, v^2)
K1_RT_SHAPE = (2 * 576, 2 * 12996, 12996)
# the local real-time ladders of the test_013 oracles (H2O/cc-pVDZ, all
# electrons, (no, nv) = (5, 19)): the T side's stacked complex tau and the
# Lambda side's stacked complex W
K1_LOCAL_RT_SHAPE = (2 * 25, 361, 361)
K1_LOCAL_RT_LAMBDA_SHAPE = (2 * 25, 2 * 361, 361)
# [dfrt]: over factors both ladders of a right-hand side assemble a
# complex W (the T side's factor dressed by the complex t1, the Lambda
# side's Bd_ae), so each goes in a-block by a-block as [Re W; Im W]
# against the stacked complex rows, on a quarter of the real block budget
# (dfhbar.ladder_apply): (2 o^2, 2 blk v, v^2), one launch an a-block a
# side; its library yardstick one complex128 A @ B.T at (o^2, blk v, v^2)
DFRT_BLOCKS = dfccsd._ladder_blocks(DF_NV, 0, dfccsd.LADDER_MAX_ELEMS // 4)
K1_DFRT_SHAPE = (2 * DF_NO ** 2, 2 * -(-DF_NV // DFRT_BLOCKS) * DF_NV,
                 DF_NV ** 2)
K1_COMPLEX_LIBRARY = (K1_RT_SHAPE, K1_LOCAL_RT_LAMBDA_SHAPE, K1_DFRT_SHAPE)
# [mesh]: a 2 x 2 mesh; each shard's ladder is one K1 launch against its
# (a, b) columns of W, (o^2, (v/2)^2, v^2) at [real]'s (24, 114), the EOM
# sigma batch's rows against the same columns, and over [df]'s factors
# one launch an a-block of a shard's (v/2) a, sized to the ladder budget
MESH_SHAPE = (2, 2)
K1_MESH_SHAPE = (576, 57 * 57, 12996)
K1_MESH_EOM_SHAPE = (EOM_ROOTS * 576, 57 * 57, 12996)
MESH_DF_BLOCKS = dfccsd._block_count(DF_NV // 2, DF_NV // 2 * DF_NV ** 2,
                                     dfccsd.LADDER_MAX_ELEMS)
K1_MESH_DF_SHAPE = (DF_NO ** 2,
                    -(-(DF_NV // 2) // MESH_DF_BLOCKS) * (DF_NV // 2),
                    DF_NV ** 2)
# (shape, what, types: "all" or the labels of K1_TYPES timed there)
K1_SHAPES = [
    ((16, 361, 361), "H2O/cc-pVDZ ladder", "all"),
    ((1000, 4999, 5003), "ragged", "all"),
    (K1_FULL_SHAPE, "(H2O)_6/cc-pVDZ ladder", "all"),
    (K1_DF_SHAPE, "(H2O)_6/aug DF ladder block", "all"),
    (K1_EOM_SHAPE, "(H2O)_6 EOM sigma batch", ("f64",)),
    (K1_RESP_SHAPE, "(H2O)_6 complex/in_Y1 ladder", ("f64",)),
    (K1_CC3_SHAPE, "(H2O)_4 CC3 ladder", ("f64",)),
    (K1_DF_EOM_SHAPE, "(H2O)_6/aug DF EOM sigma block", ("f64",)),
    (K1_RT_SHAPE, "(H2O)_6 RT complex-W ladder", ("f64",)),
    (K1_LOCAL_RT_SHAPE, "H2O local RT T ladder", ("f64",)),
    (K1_LOCAL_RT_LAMBDA_SHAPE, "H2O local RT W ladder", ("f64",)),
    (K1_MESH_SHAPE, "(H2O)_6 2x2 mesh shard", ("f64",)),
    (K1_MESH_EOM_SHAPE, "(H2O)_6 mesh EOM shard", ("f64",)),
    (K1_MESH_DF_SHAPE, "(H2O)_6/aug mesh DF block", ("f64",)),
    (K1_DFRT_SHAPE, "(H2O)_6/aug DF RT complex-W block", ("f64",)),
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


def bound(work, nbytes):
    """(bound_ms, bound_by): the benchmark's roofline bound (`bound_s`,
    the H100 SXM data sheet's dense peaks) and which of the operations or
    the bytes set it."""
    t = bound_s(work, nbytes)
    return t * 1e3, ("operations" if t > nbytes / HBM_BYTES_S
                     else "bytes")


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
    # K2's shared-memory layout against its Python mirror, which the CPU
    # tests hold to no <= 200 (no size depends on nv)
    lib = k2._library()
    for no in (4, 24, K2_CHUNKED[0], 200):
        for acc in (8, 4):
            got = (lib.t_row_chunk(no, acc), lib.t_row_smem_bytes(no, acc))
            want = (k2.t_row_chunk(no, acc), k2.t_row_smem_bytes(no, acc))
            if got != want:
                raise AssertionError("K2 layout at no = %d x %d B: library "
                                     "%s, mirror %s" % (no, acc, got, want))
    print("[build] t_row layout = its Python mirror at 4 occupied sizes x 2 "
          "types")
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
    for (m, n, k), what, types in K1_SHAPES:
        A64 = torch.randn((m, k), generator=gen, device=DEVICE,
                          dtype=torch.float64)
        B64 = torch.randn((n, k), generator=gen, device=DEVICE,
                          dtype=torch.float64)
        for label, dtype, bf16, tol in K1_TYPES:
            if types != "all" and label not in types:
                continue
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
            if (m, n, k) in K1_COMPLEX_LIBRARY:
                # the same function as one complex product: the stacked
                # rows' halves as real and imaginary parts
                Ac = torch.complex(A[:m // 2], A[m // 2:])
                Bc = torch.complex(B[:n // 2], B[n // 2:])
                Ac @ Bc.T
                library_ms = _median_ms(lambda: Ac @ Bc.T)
                del Ac, Bc
            else:
                library_ms = _median_ms(lambda: A @ B.T)
            flops = 2.0 * m * n * k
            elem = 2 if bf16 else A.element_size()
            nbytes = (m + n) * k * elem + m * n * (4 if bf16 else elem)
            bound_ms, bound_by = bound([(flops, label)], nbytes)
            print("[K1] %-22s (M,N,K)=(%d,%d,%d) %-9s max|err|=%.3e rel=%.3e "
                  "(tol %.0e)  kernel %.3f ms (%.2f TFLOP/s)  bound %.3f ms "
                  "(%s, %.0f%% of it)  plain %.3f ms  %s %.3f ms  | %s"
                  % (what, m, n, k, label, err, rel, tol, ms,
                     flops / (ms * 1e-3) / 1e12, bound_ms, bound_by,
                     100.0 * bound_ms / ms, plain_ms,
                     ("complex128 A@B.T (%d,%d,%d)" % (m // 2, n // 2, k)
                      if (m, n, k) in K1_COMPLEX_LIBRARY else "A@B.T"),
                     library_ms, smi))
            cells[(m, n, k), label] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
            del A, B
        del A64, B64
        torch.cuda.empty_cache()
    return cells


K2_CHUNKED = (104, 20)
# ((no, nv), what, rows checked (None: every row), types, timed runs)
K2_SHAPES = [
    ((4, 19), "H2O/cc-pVDZ fzc", None, "all", 5),
    ((7, 45), "ragged", (0, 6), "all", 5),
    ((24, 114), "(H2O)_6/cc-pVDZ fzc", (0, 23), "all", 5),
    ((DF_NO, DF_NV), "(H2O)_6/aug-cc-pVDZ fzc", (0, 23), ("f64",), 3),
    # past one chunk of the occupied l (in float64 a ring slot holds the
    # Eo rows of 89): two chunks of l, a ragged 8-wide tile
    (K2_CHUNKED, "two l chunks", (0, K2_CHUNKED[0] - 1), ("f64",), 3),
]
# the f64 tolerance there: the chunked X2l sums are held tighter
K2_CHUNKED_TOL = 1e-13
# (label, operand dtype, stream_dtype, tolerance on max|err| / max|ref|)
K2_TYPES = [
    ("f64", torch.float64, None, 1e-12),
    ("f32", torch.float32, None, 1e-5),
    ("bf16->f32", torch.float32, torch.bfloat16, 2e-2),
]
K2_OUTPUTS = ("X1a", "X1m", "Z1", "Z1m", "Z2a", "Z2m", "X2l")


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
    for (no, nv), what, rows, types, reps in shapes:
        ops64 = _k2_inputs(no, nv, gen)
        rows = tuple(range(no)) if rows is None else rows
        for label, dtype, sd, tol in K2_TYPES:
            if types != "all" and label not in types:
                continue
            if (no, nv) == K2_CHUNKED:
                tol = K2_CHUNKED_TOL
            ops = tuple(x.to(dtype) for x in ops64)
            worst = dict.fromkeys(K2_OUTPUTS, 0.0)
            err = 0.0
            for i in rows:
                pairs = t_energy_row.pairs_built
                out = t_energy_row(i, *ops, no, stream_dtype=sd)
                torch.cuda.synchronize()
                if t_energy_row.pairs_built - pairs != no * (no + 1) // 2:
                    raise AssertionError("K2 %s %s: %d pairs built a launch"
                                         % (label, (no, nv), t_energy_row.
                                            pairs_built - pairs))
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
                i, *ops, no, stream_dtype=sd, derived=derived), reps)
            plain_ms = _median_ms(
                lambda: t_energy_row_reference(i, *ops, no, stream_dtype=sd),
                reps)
            del derived
            in_bytes = 2 if sd == torch.bfloat16 else ops[0].element_size()
            acc_bytes = 4 if sd == torch.bfloat16 else in_bytes
            bound_ms, bound_by = bound(
                k2_work(no, nv, label),
                k2_row_bytes(no, nv, in_bytes, acc_bytes))
            lc = k2.t_row_chunk(no, acc_bytes)
            print("[K2] %-20s (no,nv)=(%d,%d) %-9s rows %s  max|err|/max|ref|: "
                  "%s (tol %.0e)  row %d: kernel %.3f ms (%.2f TFLOP/s)  "
                  "bound %.3f ms (%s, %.0f%% of it)  plain %.3f ms  l chunk "
                  "%d (%d B shared a block)  | %s"
                  % (what, no, nv, label, ",".join(map(str, rows))
                     if len(rows) < no else "all", rels, tol, i, ms,
                     k2_row_flops(no, nv) / (ms * 1e-3) / 1e12, bound_ms,
                     bound_by, 100.0 * bound_ms / ms, plain_ms, lc,
                     k2.t_row_smem_bytes(no, acc_bytes), smi))
            cells[(no, nv), label] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                layout="occupied l in chunks of %d of %d" % (lc, no))
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
            else:
                e_t_sto3g = e
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
    phase_post_oracles(wfns)
    phase_response_oracles()
    phase_df_oracles(wfns["sto-3g", True], e_t_sto3g)
    phase_cc3_oracles(wfns["sto-3g", True])
    phase_dfpost_oracles(wfns["sto-3g", True])
    phase_mixed_oracles(wfns)
    phase_rt_oracles(wfns["sto-3g", True])
    return phase_local_oracles()


def _by_mode(fn):
    """fn's result and K1's launches by mode ("f64", "f32", "bf16") in
    it, counted from 0."""
    vvvv.reset_launches()
    out = fn()
    return out, dict(vvvv_nt.launches_by_mode)


def phase_mixed_oracles(wfns):
    """tests/test_016's blocked CCSD oracle and bf16-gated solves and
    test_027's mixed-precision and checkpoint cases on the card, each at
    its test's tolerance, with K1's bf16 and f32 launches checked."""
    sto, dz = wfns["sto-3g", True], wfns["cc-pvdz", True]
    e_sto, e_dz = ORACLES[0][3], ORACLES[1][3]
    gaps = []       # (what, |gap|, tolerance)
    modes = {}

    def cc(wfn=sto, **kw):
        if kw.get("storage") == "df":
            kw.setdefault("df_tol", 1e-12)
        return pycc_tpu_torch.ccwfn(wfn, device=DEVICE, **kw)

    gaps.append(("blocked CCSD cc-pVDZ",
                 abs(cc(dz, storage="blocked").solve_cc(1e-12, 1e-12)
                     - e_dz), 1e-11))
    for storage, tol in (("blocked", 1e-11), ("df", 1e-10)):
        c = cc(storage=storage)
        e, modes["bf16_until " + storage] = _by_mode(
            lambda: c.solve_cc(1e-12, 1e-12, bf16_until=1e-3))
        gaps.append(("bf16_until " + storage, abs(e - e_sto), tol))
    for storage in ("full", "blocked"):
        e, modes["mixed " + storage] = _by_mode(
            lambda: cc(storage=storage).solve_cc_mixed(1e-12, 1e-12))
        gaps.append(("mixed " + storage, abs(e - e_sto), 1e-11))
    e64 = cc(storage="df").solve_cc(1e-12, 1e-12)
    emx = cc(storage="df").solve_cc_mixed(1e-12, 1e-12)
    gaps += [("mixed df - f64", abs(emx - e64), 1e-11),
             ("mixed df", abs(emx - e_sto), 1e-9)]

    c = cc(storage="df")
    c.solve_cc(1e-12, 1e-12)
    le64 = pycc_tpu_torch.cclambda(c, pycc_tpu_torch.cchbar(c)).solve_lambda(
        1e-12, 1e-12)
    c = cc(storage="df")
    c.solve_cc_mixed(1e-12, 1e-12)
    lam = pycc_tpu_torch.cclambda(c, pycc_tpu_torch.cchbar(c))
    lemx, modes["lambda mixed df"] = _by_mode(
        lambda: lam.solve_lambda_mixed(1e-12, 1e-12))
    gaps.append(("Lambda mixed df - f64", abs(lemx - le64), 1e-11))

    c = cc()
    c.solve_cc(1e-12, 1e-12)
    _, lam, _, _ = _lambda(c, 1e-12, 1e-12)
    resp = pycc_tpu_torch.ccresponse(pycc_tpu_torch.ccdensity(c, lam))
    A = resp.pertbar["MU_X"]
    px = resp.solve_right(A, RESP_OMEGA, 1e-12, 1e-12)[2]
    py = resp.solve_left(A, RESP_OMEGA, 1e-12, 1e-12)[2]
    (_, _, pxm), modes["response mixed"] = _by_mode(
        lambda: resp.solve_right_mixed("MU_X", RESP_OMEGA, 1e-12, 1e-12,
                                       sp_conv=1e-5))
    pym = resp.solve_left_mixed("MU_X", RESP_OMEGA, 1e-12, 1e-12,
                                sp_conv=1e-5)[2]
    gaps += [("right mixed - f64", abs(pxm - px), 1e-10),
             ("left mixed - f64", abs(pym - py), 1e-10)]

    c = cc(run_rhf(moldict["H2O"], "sto-3g", freeze_core=False))
    c.solve_cc(1e-12, 1e-12)
    E64, _ = pycc_tpu_torch.cceom(pycc_tpu_torch.cchbar(c)).solve_eom(
        N=3, e_conv=1e-9, r_conv=1e-7)
    eom = pycc_tpu_torch.cceom(pycc_tpu_torch.cchbar(c))
    (Emx, _), modes["eom mixed"] = _by_mode(
        lambda: eom.solve_eom_mixed(N=3, e_conv=1e-9, r_conv=1e-7))
    gaps.append(("EOM mixed - f64", np.abs(Emx - E64).max(), 1e-8))

    with tempfile.TemporaryDirectory() as d:
        pa, pb = os.path.join(d, "a.npz"), os.path.join(d, "b.npz")
        kw = dict(chk_every=1, chk_ring=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # maxiter stops on purpose
            cc().solve_cc(1e-12, 1e-12, maxiter=8, chk=pa, **kw)
            cc().solve_cc(1e-12, 1e-12, maxiter=4, chk=pb, **kw)
            cc().solve_cc(1e-12, 1e-12, maxiter=8, chk=pb, resume=True,
                          **kw)
        da, db = np.load(pa), np.load(pb)
        gaps += [("resume t2 at iteration 8",
                  np.abs(da["t2"] - db["t2"]).max(), 1e-12),
                 ("resume ecc at iteration 8",
                  abs(float(da["ecc"]) - float(db["ecc"])), 1e-12)]
        if not int(da["niter"]) == int(db["niter"]) == 8:
            raise AssertionError("resume: niter %s, %s" % (da["niter"],
                                                           db["niter"]))
    for what, gap, tol in gaps:
        print("[oracle] %-28s |d| = %.2e  (tol %.0e)" % (what, gap, tol))
    print("[oracle] K1 launches by mode: %s"
          % "; ".join("%s %s" % kv for kv in modes.items()))
    bad = [(what, gap) for what, gap, tol in gaps if not gap < tol]
    if bad:
        raise AssertionError("mixed/blocked oracles missed: %s" % bad)
    if not all(modes[k]["bf16"] > 0 for k in modes if k.startswith("bf16")):
        raise AssertionError("a bf16-gated solve launched K1 in bf16 no time")
    if not all(modes[k]["f32"] > 0 for k in modes if "mixed" in k):
        raise AssertionError("a mixed solve launched K1 in f32 no time")


# the all-electron H2O/STO-3G of tests/test_011 (bohr)
H2O_T011 = """
O 0.000000000000000   0.000000000000000   0.143225857166674
H 0.000000000000000  -1.638037301628121  -1.136549142277225
H 0.000000000000000   1.638037301628121  -1.136549142277225
symmetry c1
units bohr
"""


def _lambda(cc, e_conv, r_conv, **kw):
    """HBAR and a solved Lambda for a converged cc, with the K1 launches
    of the Lambda solve."""
    hb = pycc_tpu_torch.cchbar(cc)
    lam = pycc_tpu_torch.cclambda(cc, hb)
    vvvv_nt.launches = 0
    lecc = lam.solve_lambda(e_conv, r_conv, **kw)
    return hb, lam, lecc, vvvv_nt.launches


def phase_post_oracles(wfns):
    """Lambda, densities and EOM-CCSD on the card in DP against the frozen
    values of tests/test_005, test_011 and test_006."""
    for basis, oracle in (("sto-3g", -0.068826452648939),
                          ("cc-pvdz", -0.217838951550509)):
        cc = pycc_tpu_torch.ccwfn(wfns[basis, True], device=DEVICE)
        ecc, _ = _solve(cc, 1e-12, 1e-12)
        hb, lam, lecc, launches = _lambda(cc, 1e-12, 1e-12)
        dens = pycc_tpu_torch.ccdensity(cc, lam)
        edens = dens.compute_energy()
        print("[oracle] H2O/%s Lambda-CCSD: pseudo-E = %.15f  |dE| = %.2e  "
              "%d iterations  %d K1 launches  density E - Ecorr = %.2e"
              % (basis, lecc, abs(lecc - oracle), lam.niter, launches,
                 edens - ecc))
        if not (lam.converged and abs(lecc - oracle) < 1e-11
                and abs(edens - ecc) < 1e-12):
            raise AssertionError("Lambda/density oracle H2O/%s missed" % basis)
        if launches < lam.niter:
            raise AssertionError("Lambda: %d K1 launches in %d iterations"
                                 % (launches, lam.niter))
        if basis == "cc-pvdz":
            eom = pycc_tpu_torch.cceom(hb)
            vvvv_nt.launches = 0
            E, _ = eom.solve_eom(N=3, e_conv=1e-9, r_conv=1e-7)
            launches = vvvv_nt.launches
            ref = np.array([0.246365746068, 0.313591867750, 0.354390071110])
            print("[oracle] H2O/cc-pvdz EOM-CCSD fzc roots %s  max|dE| = "
                  "%.2e  %d K1 launches" % (np.array2string(E, precision=12),
                                            np.abs(E - ref).max(), launches))
            if not (eom.converged and np.abs(E - ref).max() < 1e-7
                    and launches > 0):
                raise AssertionError("EOM-CCSD oracle missed")

    wfn = run_rhf(H2O_T011, "sto-3g", freeze_core=False)
    for t3_scan in (None, True):
        cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD(T)", make_t3_density=True,
                                  t3_scan=t3_scan, device=DEVICE)
        ecc = cc.solve_cc(1e-12, 1e-12, 75, max_diis=0)
        et = ecc - float(cc.cc_energy(cc.t1, cc.t2))
        et_tjl = float(triples.t_tjl(cc))
        _, lam, lcc, _ = _lambda(cc, 1e-12, 1e-12, maxiter=75, max_diis=0)
        dens = pycc_tpu_torch.ccdensity(cc, lam)
        dens.compute_energy()
        gaps = (abs(lcc - -0.069084521221746),
                abs(dens.eone - 0.104463374777302),
                abs(dens.etwo - -0.175243393781829))
        print("[oracle] H2O/sto-3g all-electron CCSD(T) t3_scan=%s: density "
              "(T) - t_tjl = %.2e  |d lcc| = %.2e  |d eone| = %.2e  "
              "|d etwo| = %.2e" % ((t3_scan, abs(et - et_tjl)) + gaps))
        if not (abs(et - et_tjl) < 1e-14 and max(gaps) < 1e-11):
            raise AssertionError("CCSD(T) density oracle (t3_scan=%s) missed"
                                 % t3_scan)


def _response(cc, conv):
    """A ccresponse over a converged cc: Lambda to conv, then the
    densities' object the response driver takes."""
    _, lam, _, _ = _lambda(cc, conv, conv)
    return pycc_tpu_torch.ccresponse(pycc_tpu_torch.ccdensity(cc, lam))


def phase_response_oracles():
    """Linear response on the card in DP against the frozen values of
    tests/test_007 (the H2O/aug-cc-pVDZ polarizability, all electrons)
    and test_013 (the H2O/STO-3G pseudoresponses, complex M and P
    among them)."""
    h2o = moldict["H2O"]
    cc = pycc_tpu_torch.ccwfn(run_rhf(h2o, "aug-cc-pvdz", freeze_core=False),
                              device=DEVICE)
    _solve(cc, 1e-12, 1e-12)
    resp = _response(cc, 1e-12)
    vvvv_nt.launches = 0
    tensor, secs = _synced(lambda: resp.linresp("MU", "MU", 0.0656))
    polar = np.diag(tensor)
    ref = np.array([9.92992070420665, 13.443740151331559, 11.342765745046526])
    gaps = np.abs(polar - ref).tolist() + [abs(polar.mean()
                                               - 11.572142200333)]
    print("[oracle] H2O/aug-cc-pvdz linresp MU-MU at 0.0656: alpha diag %s  "
          "max|d| = %.2e  %d K1 launches  %.2f s"
          % (np.array2string(polar, precision=10), max(gaps),
             vvvv_nt.launches, secs))
    if not (max(gaps) < 1e-8 and np.abs(tensor - np.diag(polar)).max() < 1e-6
            and vvvv_nt.launches > 0):
        raise AssertionError("polarizability oracle missed")

    cc = pycc_tpu_torch.ccwfn(run_rhf(h2o, "sto-3g", freeze_core=False),
                              device=DEVICE)
    cc.solve_cc(1e-13, 1e-13, 200)
    resp = _response(cc, 1e-13)
    check, secs = _synced(lambda: resp.pertcheck(0.01))
    ref = {
        "MU_X_0.010000": 0.059711553704, "MU_Y_0.010000": 7.341419446523,
        "MU_Z_0.010000": 3.071438076138, "MU_X_-0.010000": 0.056273457658,
        "M_X_0.010000": 0.607770924164, "M_Y_0.010000": 0.710225214533,
        "M_Z_0.010000": 0.775111802368, "M*_X_-0.010000": 0.586575382108,
        "P_X_-0.010000": 0.097163221394, "P_Y_-0.010000": 2.169072875250,
        "P_Z_-0.010000": 1.497365713340, "P*_X_0.010000": 0.103276788499,
        "Q_XX_0.010000": 5.942498696750, "Q_YZ_0.010000": 19.240803761856,
        "Q_ZZ_0.010000": 0.250165812115, "Q_XY_-0.010000": 0.192591582644,
    }
    gap = max(abs(complex(check[k]).real - v) for k, v in ref.items())
    print("[oracle] H2O/sto-3g pertcheck at +-0.01: %d pseudoresponses, max|d| "
          "over the %d frozen = %.2e  %.2f s" % (len(check), len(ref), gap, secs))
    if not (len(check) == 48 and gap < 1e-10):
        raise AssertionError("pertcheck oracle missed: %.3e" % gap)


def phase_df_oracles(wfn_sto3g, e_t_sto3g):
    """storage="df" on the card: CCSD on STO-3G from the dense-sourced
    factors and on cc-pVDZ from run_rhf(df=True) against the frozen
    oracles, and DF-direct CCSD(T) on STO-3G against the dense CCSD(T)."""
    cases = [
        ("sto-3g", "CCSD", lambda: wfn_sto3g, dict(df_tol=1e-12),
         -0.070616830152761, 1e-10),
        ("cc-pvdz", "CCSD", lambda: run_rhf(moldict["H2O"], "cc-pvdz",
                                            freeze_core=True, df=True,
                                            df_tol=1e-10),
         dict(df_tol=1e-10), -0.222029814166783, 1e-9),
        ("sto-3g", "CCSD(T)", lambda: wfn_sto3g,
         dict(df_direct=True, df_tol=1e-11), e_t_sto3g, 1e-9),
    ]
    for basis, model, wfn, kw, want, tol in cases:
        cc = pycc_tpu_torch.ccwfn(wfn(), model=model, storage="df",
                                  device=DEVICE, **kw)
        vvvv_nt.launches = 0
        t_energy_row.launches = 0
        e, secs = _solve(cc, 1e-12, 1e-12)
        launches = (vvvv_nt.launches, t_energy_row.launches)
        print("[oracle] H2O/%s %s storage=df %s: E = %.15f  |dE| = %.2e "
              "(tol %.0e)  naux %d  %d iterations  %d K1 launches  %d K2 "
              "launches  %.2f s" % (basis, model, kw, e, abs(e - want), tol,
                                    cc.naux, cc.niter, launches[0],
                                    launches[1], secs))
        if not (cc.converged and abs(e - want) < tol):
            raise AssertionError("DF oracle H2O/%s %s missed: %.3e"
                                 % (basis, model, abs(e - want)))
        k2_want = cc.no if model == "CCSD(T)" else 0
        if launches != (cc.niter * dfccsd._ladder_blocks(cc.nv, cc.naux),
                        k2_want):
            raise AssertionError("DF %s: %s launches in %d iterations"
                                 % (model, launches, cc.niter))


def cc3_dipole(cc, lam):
    """The CC3 dipole mu . opdm + M(t1) . opdm_cc3 from the CC3 one-pdm,
    the T1-transformed dipole blocks M from build_Moo/build_Mvv (as
    pycc_tpu's rtcc.dipole forms it), as numpy (3,)."""
    dens = pycc_tpu_torch.ccdensity(cc, lam, onlyone=True)
    opdm, opdm_cc3 = dens.compute_onepdm(cc.t1, cc.t2, lam.l1, lam.l2)
    no, nv = cc.no, cc.nv
    out = []
    for mu in cc.H.mu:
        M = torch.zeros_like(mu)
        M[:no, :no] = build_Moo(no, nv, mu, cc.t1)
        M[no:, no:] = build_Mvv(no, nv, mu, cc.t1)
        out.append((mu * opdm).sum() + (M * opdm_cc3).sum())
    return torch.stack(out).cpu().numpy()


def scf_dipole(wfn):
    """The SCF dipole: nuclear + 2 tr(C_occ^T mu_AO C_occ)."""
    mu_ao = ints.dipole(wfn.basisset())
    C, nd = wfn.Ca(), wfn.ndocc
    return np.array([wfn.molecule().nuclear_dipole()[ax]
                     + 2 * np.trace(C[:, :nd].T @ mu_ao[ax] @ C[:, :nd])
                     for ax in range(3)])


def phase_cc3_oracles(wfn_sto3g):
    """CC3 on the card against tests/test_009 (H2O_Teach/cc-pVDZ, all
    electrons: Psi4's E(CC3), CFOUR's Lambda pseudo-energy and dipole)
    and tests/test_026 (DF CC3 on H2O/STO-3G against dense storage)."""
    wfn = run_rhf(moldict["H2O_Teach"], "cc-pvdz", freeze_core=False)
    cc = pycc_tpu_torch.ccwfn(wfn, model="CC3", device=DEVICE)
    vvvv_nt.launches = 0
    ecc, secs = _solve(cc, 1e-12, 1e-12)
    launches = vvvv_nt.launches
    _, lam, lecc, lam_launches = _lambda(cc, 1e-12, 1e-12)
    mu = cc3_dipole(cc, lam)
    ref = np.array([0, 0, 0.7703875967]) - scf_dipole(wfn)    # CFOUR
    gaps = (abs(ecc - -0.227888246840310), abs(lecc - -0.2233231845185215),
            abs(mu[1] - ref[1]), abs(mu[2] - ref[2]))
    print("[oracle] H2O_Teach/cc-pvdz CC3 all-electron: Ecorr = %.15f  "
          "|dE| = %.2e  %d iterations  %d K1 launches  %.2f s | Lambda "
          "pseudo-E = %.15f  |dE| = %.2e  %d iterations  %d K1 launches | "
          "dipole y, z %.12f %.12f  |d| = %.2e %.2e"
          % (ecc, gaps[0], cc.niter, launches, secs, lecc, gaps[1],
             lam.niter, lam_launches, mu[1], mu[2], gaps[2], gaps[3]))
    if not (cc.converged and lam.converged and max(gaps[:2]) < 1e-11
            and max(gaps[2:]) < 1e-10):
        raise AssertionError("CC3 oracles missed: %s" % (gaps,))
    if launches < cc.niter or lam_launches < lam.niter:
        raise AssertionError("CC3: %d K1 launches in %d iterations, Lambda "
                             "%d in %d" % (launches, cc.niter, lam_launches,
                                           lam.niter))

    dense = pycc_tpu_torch.ccwfn(wfn_sto3g, model="CC3", device=DEVICE)
    e_dense, _ = _solve(dense, 1e-12, 1e-12)
    cc = pycc_tpu_torch.ccwfn(wfn_sto3g, model="CC3", storage="df",
                              df_tol=1e-13, device=DEVICE)
    vvvv_nt.launches = 0
    e_df, secs = _solve(cc, 1e-12, 1e-12)
    print("[oracle] H2O/sto-3g CC3 storage=df (df_tol 1e-13): E = %.15f  "
          "dense %.15f  |diff| = %.2e  naux %d  %d iterations  %d K1 "
          "launches  %.2f s" % (e_df, e_dense, abs(e_df - e_dense), cc.naux,
                                cc.niter, vvvv_nt.launches, secs))
    if not (cc.converged and dense.converged and abs(e_df - e_dense) < 1e-9):
        raise AssertionError("DF CC3 missed dense: %.3e"
                             % abs(e_df - e_dense))
    if vvvv_nt.launches != cc.niter * dfccsd._ladder_blocks(cc.nv, cc.naux):
        raise AssertionError("DF CC3: %d K1 launches in %d iterations"
                             % (vvvv_nt.launches, cc.niter))


def _launched(fn):
    """fn's result and the K1 launches it made, counted from 0."""
    vvvv_nt.launches = 0
    out = fn()
    return out, vvvv_nt.launches


def phase_dfpost_oracles(wfn_sto3g):
    """The DF post-convergence stack on the card against tests/test_019
    (the DF Lambda pseudo-energy; the DF EOM-CCSD roots equal to full
    storage's), test_020 (the DF polarizability equal to full storage's),
    test_024 (the CCSD(T) density over prepared factors; the density
    energy over factors equal to dense storage's for CCD, CC2 and CCSD
    on random amplitudes) and test_026 (DF Lambda-CC3 and the CC3 one-pdm
    equal to dense storage's), each at its test's tolerance, with the K1
    launches of the DF Lambda solves checked against iterations x
    blocks."""
    full = pycc_tpu_torch.ccwfn(wfn_sto3g, device=DEVICE)
    _solve(full, 1e-12, 1e-12)
    cc = pycc_tpu_torch.ccwfn(wfn_sto3g, storage="df", df_tol=1e-13,
                              device=DEVICE)
    _solve(cc, 1e-12, 1e-12)
    nblocks = dfccsd._ladder_blocks(cc.nv, cc.naux)
    hb, lam, lecc, launches = _lambda(cc, 1e-12, 1e-12)
    hb_full, lam_full, _, _ = _lambda(full, 1e-12, 1e-12)
    (E, _), eom_launches = _launched(lambda: pycc_tpu_torch.cceom(hb)
                                     .solve_eom(N=3, e_conv=1e-8, r_conv=1e-7))
    E_full, _ = pycc_tpu_torch.cceom(hb_full).solve_eom(N=3, e_conv=1e-8,
                                                        r_conv=1e-7)
    tensors = [pycc_tpu_torch.ccresponse(pycc_tpu_torch.ccdensity(
        c, l, onlyone=True)).linresp("MU", "MU", RESP_OMEGA)
        for c, l in ((cc, lam), (full, lam_full))]
    gaps = (abs(lecc - -0.068826452648939), np.abs(E - E_full).max(),
            np.abs(tensors[0] - tensors[1]).max())
    print("[oracle] H2O/sto-3g storage=df post-convergence: Lambda pseudo-E "
          "|dE| = %.2e (%d iterations, %d K1 launches, %d blocks)  EOM roots "
          "|DF - full| = %.2e (%d K1 launches)  linresp MU-MU |DF - full| = "
          "%.2e" % (gaps[0], lam.niter, launches, nblocks, gaps[1],
                    eom_launches, gaps[2]))
    if not (lam.converged and gaps[0] < 1e-9 and gaps[1] < 1e-7
            and gaps[2] < 1e-8):
        raise AssertionError("DF post-convergence oracles missed: %s"
                             % (gaps,))
    if launches != lam.niter * nblocks or eom_launches < 1:
        raise AssertionError("DF Lambda: %d K1 launches in %d iterations of "
                             "%d blocks; EOM %d" % (launches, lam.niter,
                                                    nblocks, eom_launches))

    # tests/test_024: the CCSD(T) density chain over prepared factors
    H = build_hamiltonian(run_rhf(H2O_T011, "sto-3g", freeze_core=False),
                          device=DEVICE)
    B = cholesky_factor_eri(H.ERI, tol=1e-14, device=DEVICE)
    cc_t = pycc_tpu_torch.ccwfn.from_df_factors(B, H.F, H.no,
                                                model="CCSD(T)",
                                                device=DEVICE)
    cc_t.make_t3_density = True
    cc_t.solve_cc(1e-12, 1e-12, 75, max_diis=0)
    _, lam_t, lcc, _ = _lambda(cc_t, 1e-12, 1e-12, maxiter=75, max_diis=0)
    dens = pycc_tpu_torch.ccdensity(cc_t, lam_t)
    dens.compute_energy()
    gaps = (abs(lcc - -0.069084521221746), abs(dens.eone - 0.104463374777302),
            abs(dens.etwo - -0.175243393781829))
    # ... and the density energy over factors against dense storage on
    # test_024's random amplitudes
    H = build_hamiltonian(wfn_sto3g, device=DEVICE)
    B = cholesky_factor_eri(H.ERI, tol=1e-14, device=DEVICE)
    ERI = torch.einsum("Ppr,Pqs->pqrs", B, B)
    no, nact = H.no, H.F.shape[0]
    rng = np.random.default_rng(24)
    t1, t2, l1, l2 = (torch.as_tensor(0.05 * rng.standard_normal(shape),
                                      device=DEVICE) for shape in
                      ((no, nact - no), (no, no, nact - no, nact - no)) * 2)
    lam_r = types.SimpleNamespace(l1=l1, l2=l2)
    dgaps = []
    for model in ("CCD", "CC2", "CCSD"):
        common = dict(model=model, t1=t1, t2=t2, no=no, nact=nact,
                      o=slice(0, no), v=slice(no, nact))
        e_dense = pycc_tpu_torch.ccdensity(types.SimpleNamespace(
            storage="full", H=types.SimpleNamespace(F=H.F, ERI=ERI),
            **common), lam_r).compute_energy()
        e_df = pycc_tpu_torch.ccdensity(types.SimpleNamespace(
            storage="df", dfb=dfccsd.df_blocks(B, no),
            H=types.SimpleNamespace(F=H.F, ERI=None), **common),
            lam_r).compute_energy()
        dgaps.append(abs(e_dense - e_df))
    print("[oracle] H2O/sto-3g all-electron CCSD(T) density over factors: "
          "|d lcc| = %.2e  |d eone| = %.2e  |d etwo| = %.2e | density "
          "energy over factors - dense (CCD, CC2, CCSD) %s"
          % (gaps + (", ".join("%.1e" % g for g in dgaps),)))
    if not (max(gaps) < 1e-9 and max(dgaps) < 1e-11):
        raise AssertionError("DF density oracles missed: %s %s"
                             % (gaps, dgaps))

    # tests/test_026: Lambda-CC3 and the CC3 one-pdm over factors
    out = {}
    for storage in ("df", "full"):
        kw = dict(storage="df", df_tol=1e-13) if storage == "df" else {}
        c3 = pycc_tpu_torch.ccwfn(wfn_sto3g, model="CC3", device=DEVICE, **kw)
        _solve(c3, 1e-11, 1e-11)
        _, l3, le, _ = _lambda(c3, 1e-11, 1e-11)
        pdm = pycc_tpu_torch.ccdensity(c3, l3, onlyone=True).compute_onepdm(
            c3.t1, c3.t2, l3.l1, l3.l2)
        out[storage] = (le, pdm, l3.converged)
    gaps = (abs(out["df"][0] - out["full"][0]),
            max((a - b).abs().max().item()
                for a, b in zip(out["df"][1], out["full"][1])))
    print("[oracle] H2O/sto-3g CC3 storage=df: Lambda pseudo-E |DF - dense| "
          "= %.2e  one-pdm (opdm, opdm_cc3) max|DF - dense| = %.2e" % gaps)
    if not (out["df"][2] and out["full"][2] and max(gaps) < 1e-9):
        raise AssertionError("DF Lambda-CC3 / one-pdm missed dense: %s"
                             % (gaps,))


def _synced(fn):
    """fn's result and its seconds on the host clock, the card drained at
    both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_real_size(smi, name=REAL_SIZE):
    escf_ref, eccsd_ref, et_ref = FROZEN[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wfn = run_rhf(moldict[name], "cc-pvdz", freeze_core=True)
    t_scf = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD(T)", device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init = dict(seconds=t_init, peak=torch.cuda.max_memory_allocated(),
                held=torch.cuda.memory_allocated() - base)
    vvvv_nt.launches = 0
    k2.reset_launches()
    e, t_solve = _solve(cc, 1e-10, 1e-10)
    launches = {"vvvv_nt": vvvv_nt.launches, "t_row": t_energy_row.launches}
    pairs = t_energy_row.pairs_built
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
          "K1 launches %d  K2 launches %d (%d (j, k) pairs built)"
          % (t_init, t_solve - t_t, cc.niter, (t_solve - t_t) / cc.niter,
             t_t, peak / 1e9, launches["vvvv_nt"], launches["t_row"], pairs))
    print("[real] Ecorr(CCSD) = %.12f  |dE| = %.2e" % (eccsd,
                                                      abs(eccsd - eccsd_ref)))
    print("[real] E(T) = %.12f  |dE| = %.2e" % (et, abs(et - et_ref)))

    # the (T) with bf16 slabs: K2's bf16 stream, float32 accumulation
    k2.reset_launches()
    e16, t16 = _synced(lambda: triples.t_vikings_scan(
        cc, slab_dtype=torch.bfloat16))
    n16 = dict(t_energy_row.launches_by_stream)
    launches["t_row_bf16"] = n16["bf16"]
    e16_dtype, e16 = e16.dtype, float(e16)
    print("[real] (T) with bf16 slabs (t_vikings_scan(slab_dtype="
          "torch.bfloat16)): %.2f s, K2 launches by stream %s, E(T) = %.12f "
          "(%s)  |E(T) - f64 K2's| = %.2e = %.2e |E(T)|  | %s"
          % (t16, n16, e16, e16_dtype, abs(e16 - et),
             abs(e16 - et) / abs(et), smi))

    # one full-storage residual at the converged amplitudes, which
    # [mixed] times its blocked residual against
    t1, t2 = cc.t1.clone(), cc.t2.clone()
    r = cc.residuals(cc.H.F, t1, t2)
    res_ms = _median_ms(lambda: cc.residuals(cc.H.F, t1, t2), reps=3)
    print("[real] init peak device memory %.2f GB, held after init %.2f GB;"
          " one residual at the converged amplitudes %.2f ms  | %s"
          % (init["peak"] / 1e9, init["held"] / 1e9, res_ms, smi))
    real = dict(wfn=wfn, init=init, t1=t1, t2=t2, r=r, res_ms=res_ms)

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
    if (launches["vvvv_nt"] < cc.niter or launches["t_row"] != cc.no
            or pairs != cc.no * cc.no * (cc.no + 1) // 2):
        raise AssertionError("%d K1 launches in %d iterations, %d K2 launches "
                             "(%d pairs built) for no = %d"
                             % (launches["vvvv_nt"], cc.niter,
                                launches["t_row"], pairs, cc.no))
    # test_004's two conditions on the bf16 (T)
    if not (n16 == {"f64": 0, "f32": 0, "bf16": cc.no}
            and e16_dtype == torch.float32
            and 0.0 < abs(e16 - et) < 5e-3 * abs(et)):
        raise AssertionError("[real] bf16 (T): launches %s, %s E(T) %.12f vs "
                             "f64 %.12f" % (n16, e16_dtype, e16, et))
    return launches, cc, eccsd, et, real


def _eom_checks(eom, C, E, nroots=EOM_ROOTS):
    """The per-root residual norms |sigma x - omega x| of the nroots Ritz
    vectors x of the returned subspace C, with sigma recomputed through K1;
    max|sigma_K1(x) - sigma_plain(x)| / max|sigma_plain(x)|; max|omega -
    E|; and the seconds of sigma(x) through K1 and through the plain
    ladder."""
    S = torch.cat([eom.sigma(C[i:i + 2 * nroots])
                   for i in range(0, C.shape[0], 2 * nroots)])
    w, a = np.linalg.eig((C @ S.T).double().cpu().numpy())
    idx = np.real(w).argsort()[:nroots]
    a = torch.as_tensor(np.real(a[:, idx]).T.copy(), dtype=C.dtype,
                        device=C.device)
    x = a @ C
    del S
    s_k1, t_k1 = _synced(lambda: eom.sigma(x))
    s_plain, t_plain = _synced(
        lambda: eom.sigma(x, ladder=vvvv_nt_reference))
    omega = torch.as_tensor(np.real(w[idx]), dtype=C.dtype, device=C.device)
    rn = torch.linalg.norm(s_k1 - omega[:, None] * x, dim=1).tolist()
    rel = ((s_k1 - s_plain).abs().max() / s_plain.abs().max()).item()
    return rn, rel, np.abs(np.real(w[idx]) - E).max(), t_k1, t_plain


def phase_post(cc, eccsd, et_k2, smi, name=REAL_SIZE):
    """Post-convergence on phase 6's converged (H2O)_6 CCSD(T) ccwfn: the
    (T) density, HBAR, Lambda, the densities and EOM-CCSD, each timed, with
    K1's launches counted from 0 over the Lambda solve and over the EOM
    solve alone."""
    et_ref = FROZEN[name][2]
    torch.cuda.reset_peak_memory_stats()
    et_d, t_dens = _synced(lambda: float(cc.t3_density()))
    hb, t_hbar = _synced(lambda: pycc_tpu_torch.cchbar(cc))
    _, t_efab = _synced(lambda: hb.Hvvvv_efab)
    lam = pycc_tpu_torch.cclambda(cc, hb)
    vvvv_nt.launches = 0
    lecc, t_lam = _synced(lambda: lam.solve_lambda(1e-10, 1e-10))
    lam_launches = vvvv_nt.launches
    peak_lam = torch.cuda.max_memory_allocated()

    def densities():
        dens = pycc_tpu_torch.ccdensity(cc, lam)
        dens.compute_energy()
        return dens.eone, dens.etwo
    (eone, etwo), t_den = _synced(densities)
    e_total = eccsd + et_k2

    eom = pycc_tpu_torch.cceom(hb)
    vvvv_nt.launches = 0
    (E, C), t_eom = _synced(lambda: eom.solve_eom(
        N=EOM_ROOTS, e_conv=1e-8, r_conv=1e-6, guess="CIS"))
    eom_launches = vvvv_nt.launches
    peak = torch.cuda.max_memory_allocated()
    n_sigma = cc.timers.count["eom.sigma"]
    rn, rel, dw, t_k1, t_plain = _eom_checks(eom, C, E)

    print("[post] %s/cc-pVDZ CCSD(T) post-convergence  | %s" % (name, smi))
    print("[post] (T) density scan %.1f s: E(T) = %.12f  |E(T) - K2's| = "
          "%.2e  |dE| from frozen = %.2e"
          % (t_dens, et_d, abs(et_d - et_k2), abs(et_d - et_ref)))
    print("[post] HBAR %.2f s (+ pre-laid efab operand %.3f s)  Lambda %.2f s "
          "%d iterations %.3f s/iter  pseudo-E = %.12f  K1 launches %d  peak "
          "device memory through Lambda %.2f GB"
          % (t_hbar, t_efab, t_lam, lam.niter, t_lam / lam.niter, lecc,
             lam_launches, peak_lam / 1e9))
    print("[post] densities + compute_energy %.2f s: eone + etwo = %.12f  "
          "E(CCSD) + E(T) = %.12f  |diff| = %.2e"
          % (t_den, eone + etwo, e_total, abs(eone + etwo - e_total)))
    print("[post] EOM-CCSD %d roots %.1f s (the %s guess on the host %.1f "
          "s): %s Eh  %d iterations  subspace %d  sigma batches %d  K1 "
          "launches %d  residual norms %s  |Ritz - E| %.2e  peak device "
          "memory %.2f GB"
          % (EOM_ROOTS, t_eom, "CIS", cc.timers.total["eom.guess"],
             np.array2string(E, precision=10), eom.niter, C.shape[0],
             n_sigma, eom_launches, ", ".join("%.2e" % r for r in rn), dw,
             peak / 1e9))
    print("[post] sigma of the %d Ritz vectors: through K1 %.3f s, through "
          "the plain ladder %.3f s, rel diff %.2e  | %s"
          % (EOM_ROOTS, t_k1, t_plain, rel, smi))

    if not (abs(et_d - et_k2) < 1e-10 and abs(et_d - et_ref) < 1e-9):
        raise AssertionError("the (T)-density E(T) missed K2's or the frozen")
    if not (lam.converged and math.isfinite(lecc)):
        raise AssertionError("Lambda did not converge")
    if lam_launches < lam.niter:
        raise AssertionError("Lambda: %d K1 launches in %d iterations"
                             % (lam_launches, lam.niter))
    if not abs(eone + etwo - e_total) < 1e-9:
        raise AssertionError("the density energy missed E(CCSD) + E(T)")
    if not (eom.converged and np.all(np.isfinite(E)) and np.all(E > 0)):
        raise AssertionError("EOM-CCSD did not converge to 3 real positive "
                             "roots: %s" % E)
    if not (max(rn) <= 1e-6 and rel <= 1e-12):
        raise AssertionError("EOM: residual norms %s, sigma K1 vs plain %.2e"
                             % (rn, rel))
    if eom_launches < 1:
        raise AssertionError("EOM-CCSD launched K1 no time")
    return ({"lambda": lam_launches, "eom": eom_launches, "pseudo_e": lecc},
            lam, E)


RESP_OMEGA = 0.0656
RESP_CONV = 1e-10


def _recording(resp):
    """Make resp record each solve_right and solve_left it runs, linresp's
    own among them: (side, pertbar, omega, v1, v2, converged, iterations)
    in call order."""
    solves = []
    for side in ("right", "left"):
        def call(A, omega, *args, _solve=getattr(resp, "solve_" + side),
                 _side=side, **kw):
            v1, v2, pseudo = _solve(A, omega, *args, **kw)
            solves.append((_side, A, omega, v1, v2, resp.converged,
                           resp.niter))
            return v1, v2, pseudo
        setattr(resp, "solve_" + side, call)
    return solves


def _resp_residual(resp, A, omega, X, Y=None):
    """max|r / (D + omega)| of a right solve's X (r_X recomputed) or,
    given Y, of the left solve's Y over that X (r_Y, with its
    inhomogeneous terms from X), for the response object's storage."""
    if Y is None:
        r1, r2 = resp._r_X(resp._Adict(A), omega, *X)
    else:
        r1, r2 = resp._r_Y(*resp._in_Y(A, *X), omega, *Y)
    return max((r1 / (resp.Dia + omega)).abs().max().item(),
               (r2 / (resp.Dijab + omega)).abs().max().item())


def _resp_residuals(resp, solves):
    """`_resp_residual` of each recorded solve's returned vectors, a left
    solve's over the X of the right solve before it."""
    out = []
    X = None
    for side, A, omega, v1, v2, _, _ in solves:
        if side == "right":
            X = (v1, v2)
            out.append(_resp_residual(resp, A, omega, X))
        else:
            out.append(_resp_residual(resp, A, omega, X, (v1, v2)))
    return out


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _rel_plain(fn):
    """max|fn(K1) - fn(plain)| / max|fn(plain)| over fn's outputs, for fn
    of the ladder (vvvv_nt or vvvv_nt_reference)."""
    return max(_rel(a, b) for a, b in zip(fn(vvvv_nt),
                                          fn(vvvv_nt_reference)))


def _resp_ladder_checks(resp, A, X, Y):
    """The response ladders through K1 against the plain product on
    converged vectors, as `_rel_plain`: r_X on X and r_Y on Y, each
    without its inhomogeneous terms ((HBAR - omega) X and its left form
    are far from 0, where the converged residuals are not), and the
    left inhomogeneous terms of pertbar A over X."""
    (X1, X2), (Y1, Y2) = X, Y
    zero = {"Avo": torch.zeros_like(X1.T), "Avvoo": torch.zeros_like(X2)}
    return {
        "r_X": _rel_plain(lambda ld: resp._r_X(zero, RESP_OMEGA, X1, X2,
                                               ladder=ld)),
        "r_Y": _rel_plain(lambda ld: resp._r_Y(
            torch.zeros_like(Y1), torch.zeros_like(Y2), RESP_OMEGA, Y1, Y2,
            ladder=ld)),
        "in_Y": _rel_plain(lambda ld: resp._in_Y(A, X1, X2, ladder=ld)),
    }


def _ladder_checks(resp, A, X, Y, Xm):
    """`_resp_ladder_checks` on the MU_X X and Y of pertbar A, and r_X on
    the complex M_X X (Xm)."""
    rels = {k + " MU_X": v
            for k, v in _resp_ladder_checks(resp, A, X, Y).items()}
    zero = {"Avo": torch.zeros_like(Xm[0].T),
            "Avvoo": torch.zeros_like(Xm[1])}
    rels["r_X M_X"] = _rel_plain(lambda ld: resp._r_X(zero, RESP_OMEGA, *Xm,
                                                      ladder=ld))
    return rels


def phase_resp(cc, lam, smi, name=REAL_SIZE):
    """Linear response on phase 6's converged (H2O)_6 CCSD(T) ccwfn and its
    Lambda (with the (T) sources, taken as pycc_tpu takes it): the
    pertbars, the conditioning probe, the MU-MU polarizability and one
    complex M_X right solve, each timed, with K1's launches counted from 0
    over linresp and over the M_X solve."""
    dens = pycc_tpu_torch.ccdensity(cc, lam)
    torch.cuda.reset_peak_memory_stats()
    timers = cc.timers
    resp, t_init = _synced(lambda: pycc_tpu_torch.ccresponse(dens))
    perts = list({id(A): A for A in resp.pertbar.values()}.values())
    n_complex = sum(A.Avo.is_complex() for A in perts)
    sigma, t_probe = _synced(lambda: resp.estimate_conditioning(RESP_OMEGA))
    solves = _recording(resp)

    def iters():
        return {side: (timers.count["response.%s_iteration" % side],
                       timers.total["response.%s_iteration" % side])
                for side in ("right", "left")}
    before = iters()
    vvvv_nt.launches = 0
    tensor, t_lr = _synced(lambda: resp.linresp(
        "MU", "MU", RESP_OMEGA, e_conv=RESP_CONV, r_conv=RESP_CONV))
    lr_launches = vvvv_nt.launches
    after = iters()
    lr = {side: (after[side][0] - before[side][0],
                 after[side][1] - before[side][1]) for side in after}
    vvvv_nt.launches = 0
    (X1m, X2m, pm), t_m = _synced(lambda: resp.solve_right(
        resp.pertbar["M_X"], RESP_OMEGA, RESP_CONV, RESP_CONV))
    m_launches, m_iters = vvvv_nt.launches, resp.niter
    peak = torch.cuda.max_memory_allocated()

    resid = _resp_residuals(resp, solves)
    converged = [(side, ok, niter) for side, _, _, _, _, ok, niter in solves]
    (_, A, _, X1, X2, _, _), (_, _, _, Y1, Y2, _, _) = solves[:2]
    rels = _ladder_checks(resp, A, (X1, X2), (Y1, Y2), (X1m, X2m))
    # the MU_Z right pseudo-response (linresp's fifth solve), which
    # [mixed]'s solve_right_mixed is held to
    side, A_z, _, X1z, X2z, _, _ = solves[4]
    if not (side == "right" and A_z is resp.pertbar["MU_Z"]):
        raise AssertionError("linresp's fifth solve is not the MU_Z right")
    muz = complex(resp.pseudoresponse(A_z, X1z, X2z)).real
    alpha = np.diag(tensor)
    # the recording wrappers refer to resp: drop them, so that resp and its
    # 9.4 GB of pertbars go when this phase returns, not at the next
    # garbage collection
    del resp.solve_right, resp.solve_left

    print("[resp] %s/cc-pVDZ CCSD(T) linear response at omega = %.4f  | %s"
          % (name, RESP_OMEGA, smi))
    print("[resp] ccresponse %.2f s (%d pertbars, %d complex)  conditioning "
          "probe %.2f s: sigma_min <= %.6f"
          % (t_init, len(perts), n_complex, t_probe, sigma))
    print("[resp] linresp MU-MU %.2f s: right %d iterations %.4f s/iter, left "
          "%d iterations %.4f s/iter, K1 launches %d; alpha diag %s"
          % (t_lr, lr["right"][0], lr["right"][1] / lr["right"][0],
             lr["left"][0], lr["left"][1] / lr["left"][0], lr_launches,
             np.array2string(alpha, precision=10)))
    print("[resp] solve_right M_X (complex) %.2f s: %d iterations %.4f s/iter "
          " pseudoresponse %.10f%+.10fj  K1 launches %d"
          % (t_m, m_iters, t_m / m_iters, pm.real, pm.imag, m_launches))
    print("[resp] max|r/(D + omega)| of each returned vector, recomputed "
          "(linresp right/left by component, then M_X): %s"
          % ", ".join("%.1e" % r for r in resid))
    print("[resp] K1 vs the plain ladder, max|diff|/max|plain|: %s  | peak "
          "device memory %.2f GB  | %s"
          % ("  ".join("%s %.1e" % kv for kv in rels.items()), peak / 1e9,
             smi))

    bad = [(side, niter) for side, ok, niter in converged if not ok]
    if bad:
        raise AssertionError("response solves did not converge: %s" % bad)
    if not max(resid) <= 10 * RESP_CONV:
        raise AssertionError("a returned vector's max|r/D| is %.2e"
                             % max(resid))
    if not max(rels.values()) <= 1e-12:
        raise AssertionError("K1 and the plain ladder differ: %s" % rels)
    n_iter = lr["right"][0] + lr["left"][0]
    if lr_launches < n_iter or m_launches < m_iters:
        raise AssertionError("K1: %d launches in %d linresp iterations, %d in "
                             "%d M_X iterations" % (lr_launches, n_iter,
                                                    m_launches, m_iters))
    if not (np.all(np.isfinite(alpha)) and np.all(alpha > 0)):
        raise AssertionError("alpha diagonal %s" % alpha)
    return {"response": lr_launches, "response_complex": m_launches}, muz


MIXED_CONV = 1e-10
# [mixed]'s checkpoint cadence: none in the ~22 floor iterations, the
# floor's own save, and one save every 10 refinement iterations
# (solve_cc_mixed saves the refinement 4 times as often): the writer and
# the stage-aware resume still run, on 2 saves instead of 8 (2 s each)
MIXED_CHK_EVERY = 40
# the bf16 stage of the mixed CCSD solves: residuals from bf16 operands
# until the update rms drops below this
BF16_UNTIL = 1e-3


def _gb(nbytes):
    return nbytes / 1e9


def phase_mixed(real, post_E, muz, smi, name=REAL_SIZE):
    """[mixed]: blocked storage, mixed precision and checkpoint/resume at
    [real]'s size on its wavefunction (no second SCF): a CCSD ccwfn on the
    six blocks, solve_cc_mixed with a bf16 stage and checkpoints, the
    stage-aware resume, the (T) through K2 on slices cut from the block
    views, solve_lambda_mixed (against a float64 Lambda on the same HBAR),
    the density energy, solve_eom_mixed (against [post]'s roots),
    solve_right_mixed and solve_left_mixed for MU_Z (each against a
    float64 solve on this object; the right also against [resp]'s, whose
    left carries the (T) Lambda sources), each returned
    vector's residual recomputed; then a blocked residual timed against
    [real]'s full one at the same amplitudes, and the blocked ladder in
    each type held to its plain version.  K1's launches are counted by
    mode from 0 over the CCSD solve and over the three mixed
    post-convergence solves."""
    eccsd_ref, et_ref = FROZEN[name][1], FROZEN[name][2]
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cc, t_init = _synced(lambda: pycc_tpu_torch.ccwfn(
        real["wfn"], model="CCSD", storage="blocked", device=DEVICE))
    init_peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated() - base
    block_mb = {k: b.numel() * b.element_size() / 1e6
                for k, b in zip(cc.blocks._fields, cc.blocks)}

    tmp = tempfile.TemporaryDirectory()
    chk = os.path.join(tmp.name, "mx")
    (ecc, t_mx), modes = _by_mode(lambda: _synced(lambda: cc.solve_cc_mixed(
        MIXED_CONV, MIXED_CONV, sp_kwargs={"bf16_until": BF16_UNTIL},
        chk=chk, chk_every=MIXED_CHK_EVERY)))
    stages = list(cc.stages)
    saves = (cc.timers.count["ccwfn.checkpoint"],
             cc.timers.total["ccwfn.checkpoint"])
    sizes = {sfx: os.path.getsize(chk + sfx)
             for sfx in (".sp.npz", ".floor.npz", ".rf.npz")
             if os.path.exists(chk + sfx)}
    ok_mixed = cc.converged
    e_floor = cc.e_sp_floor
    e_res, t_res = _synced(lambda: cc.solve_cc_mixed(
        MIXED_CONV, MIXED_CONV, sp_kwargs={"bf16_until": BF16_UNTIL},
        chk=chk, chk_every=MIXED_CHK_EVERY, resume=True))
    res_stages = [st[0] for st in cc.stages]
    tmp.cleanup()

    t_energy_row.launches = 0
    et, t_t = _synced(lambda: float(triples.t_vikings_scan(cc)))
    k2_launches = t_energy_row.launches

    # Lambda: float64 on the blocked HBAR, then the mixed solve
    hb = pycc_tpu_torch.cchbar(cc)
    lam64 = pycc_tpu_torch.cclambda(cc, hb)
    le64, t_l64 = _synced(lambda: lam64.solve_lambda(MIXED_CONV, MIXED_CONV))
    del lam64
    lam = pycc_tpu_torch.cclambda(cc, hb)
    del hb
    vvvv.reset_launches()
    lemx, t_lmx = _synced(lambda: lam.solve_lambda_mixed(MIXED_CONV,
                                                         MIXED_CONV))
    (eone, etwo), t_den = _synced(lambda: _density(cc, lam))

    eom = pycc_tpu_torch.cceom(lam.hbar)
    (E, C), t_eom = _synced(lambda: eom.solve_eom_mixed(
        N=EOM_ROOTS, e_conv=1e-8, r_conv=1e-6))
    e_floor_eom = eom.e_sp_floor

    resp = pycc_tpu_torch.ccresponse(pycc_tpu_torch.ccdensity(
        cc, lam, onlyone=True))
    post_modes = dict(vvvv_nt.launches_by_mode)
    post_launches = vvvv_nt.launches
    px64 = resp.solve_right(resp.pertbar["MU_Z"], RESP_OMEGA, RESP_CONV,
                            RESP_CONV)[2]
    vvvv.reset_launches()
    (X1, X2, px), t_right = _synced(lambda: resp.solve_right_mixed(
        "MU_Z", RESP_OMEGA, RESP_CONV, RESP_CONV))
    right_ok = resp.converged
    for k in post_modes:
        post_modes[k] += vvvv_nt.launches_by_mode[k]
    post_launches += vvvv_nt.launches
    py64 = resp.solve_left(resp.pertbar["MU_Z"], RESP_OMEGA, RESP_CONV,
                           RESP_CONV)[2]
    vvvv.reset_launches()
    (Y1, Y2, py), t_left = _synced(lambda: resp.solve_left_mixed(
        "MU_Z", RESP_OMEGA, RESP_CONV, RESP_CONV))
    left_ok = resp.converged
    for k in post_modes:
        post_modes[k] += vvvv_nt.launches_by_mode[k]
    post_launches += vvvv_nt.launches
    peak = torch.cuda.max_memory_allocated()
    px, px64, py, py64 = (complex(x).real for x in (px, px64, py, py64))

    # the checks, after the counts were read
    rn, rel_eom, dw, _, _ = _eom_checks(eom, C, E)
    del eom, C
    A = resp.pertbar["MU_Z"]
    res_x = _resp_residual(resp, A, RESP_OMEGA, (X1, X2))
    res_y = _resp_residual(resp, A, RESP_OMEGA, (X1, X2), (Y1, Y2))
    del resp, X1, X2, Y1, Y2
    t1r, t2r = real["t1"], real["t2"]
    rb = cc.residuals(cc.H.F, t1r, t2r)
    res_gap = max((a - b).abs().max().item() for a, b in zip(rb, real["r"]))
    del rb
    ms_b = _median_ms(lambda: cc.residuals(cc.H.F, t1r, t2r), reps=3)
    ms_16 = _median_ms(lambda: cc.residuals_bf16(cc.H.F, t1r, t2r), reps=3)
    tau = build_tau(cc.t1, cc.t2)
    ladder_rel = {}
    for label, dtype, _, tol in K1_TYPES:
        W = cc.blocks.vvvv.to(dtype)
        ladder_rel[label] = (_rel(*(vvvv_contract(tau.to(dtype), W, ld)
                                    .double() for ld in
                                    (vvvv_nt, vvvv_nt_reference))), tol)
        del W

    print("[mixed] %s/cc-pVDZ CCSD on blocked storage, mixed precision, "
          "checkpoints  | %s" % (name, smi))
    print("[mixed] blocked init %.1f s (full storage's %.1f s): peak %.2f GB "
          "(%.2f GB), held after init %.2f GB (%.2f GB); blocks MB %s"
          % (t_init, real["init"]["seconds"], _gb(init_peak),
             _gb(real["init"]["peak"]), _gb(held), _gb(real["init"]["held"]),
             ", ".join("%s %.1f" % kv for kv in block_mb.items())))
    print("[mixed] solve_cc_mixed (bf16_until %.0e, chk every %d) %.2f s: %s;"
          " K1 launches by mode %s; %d checkpoint saves %.2f s (%.2f s "
          "each), files %s bytes; Ecorr = %.12f |dE| from frozen = %.2e"
          % (BF16_UNTIL, MIXED_CHK_EVERY, t_mx, "; ".join(
              "%s %s %d iterations (%d bf16) %.2f s %.4f s/iter"
              % (st, dt, n, n16, sec, sec / n)
              for st, dt, n, sec, n16 in stages), modes, saves[0], saves[1],
             saves[1] / max(saves[0], 1), sizes, ecc,
             abs(ecc - eccsd_ref)))
    print("[mixed] resume %.2f s: stages %s, e_sp_floor equal %s, |E - "
          "E(first)| = %.2e" % (t_res, res_stages, cc.e_sp_floor == e_floor,
                                abs(e_res - ecc)))
    print("[mixed] (T) on block-sourced slices %.1f s: E(T) = %.12f |dE| "
          "from frozen = %.2e  K2 launches %d"
          % (t_t, et, abs(et - et_ref), k2_launches))
    print("[mixed] Lambda f64 %.2f s, mixed %.2f s (floor %.12f): pseudo-E "
          "%.12f |mixed - f64| = %.2e; densities %.2f s: eone + etwo - Ecorr"
          " = %.2e" % (t_l64, t_lmx, lam.e_sp_floor, lemx, abs(lemx - le64),
                       t_den, eone + etwo - ecc))
    print("[mixed] EOM mixed %d roots %.1f s: %s Eh (floor %s) |E - [post]| ="
          " %.2e  residual norms %s  |Ritz - E| %.2e"
          % (EOM_ROOTS, t_eom, np.array2string(E, precision=10),
             np.array2string(e_floor_eom, precision=8),
             np.abs(E - post_E).max(), ", ".join("%.2e" % r for r in rn), dw))
    print("[mixed] MU_Z right mixed %.2f s: %.12f |d f64 right| = %.2e |d "
          "[resp]| = %.2e; left mixed %.2f s: %.12f |d f64 left| = %.2e; "
          "max|r/(D + omega)| right %.1e left %.1e"
          % (t_right, px, abs(px - px64), abs(px - muz), t_left, py,
             abs(py - py64), res_x, res_y))
    print("[mixed] K1 launches of the mixed Lambda, EOM and response by "
          "mode %s (%d); peak device memory %.2f GB"
          % (post_modes, post_launches, _gb(peak)))
    print("[mixed] one residual at [real]'s converged amplitudes: blocked "
          "%.2f ms, full %.2f ms, bf16 %.2f ms; max|blocked - full| = %.2e;"
          " the blocked ladder vs its plain version %s  | %s"
          % (ms_b, real["res_ms"], ms_16, res_gap,
             ", ".join("%s %.1e" % (k, v[0]) for k, v in ladder_rel.items()),
             smi))
    print("[mixed] the phase, its checks included: %.1f s"
          % (time.perf_counter() - t_phase))

    checks = [
        ("Ecorr", ok_mixed and abs(ecc - eccsd_ref) < 1e-9),
        ("resume", res_stages == ["refine"] and cc.e_sp_floor == e_floor
         and abs(e_res - ecc) < 1e-10 and saves[0] >= 2),
        ("E(T)", abs(et - et_ref) < 1e-9 and k2_launches == cc.no),
        ("Lambda", lam.converged and abs(lemx - le64) < 1e-9),
        ("density", abs(eone + etwo - ecc) < 1e-9),
        ("EOM", eom_ok(E, post_E, rn, rel_eom)),
        # [resp]'s MU_Z solve is over [real]'s amplitudes, which differ
        # from these at their own 1e-10 convergence: the pseudo-response
        # moves ~50x that (4.7e-9 on H2O/cc-pVDZ on the CPU), so the 1e-9
        # hold is against float64 solves on this object
        ("response", right_ok and left_ok and abs(px - px64) < 1e-9
         and abs(py - py64) < 1e-9 and abs(px - muz) < 1e-7
         and max(res_x, res_y) <= 10 * RESP_CONV),
        ("residual", res_gap < 1e-11),
        ("ladders", all(r < tol for r, tol in ladder_rel.values())),
        ("K1 modes", all(modes[m] > 0 for m in modes)
         and post_modes["f32"] > 0 and post_modes["f64"] > 0),
        ("K1 stages", modes["bf16"] == stages[0][4]
         and modes["f32"] == stages[0][2] - stages[0][4]
         and modes["f64"] == stages[1][2]),
    ]
    bad = [what for what, ok in checks if not ok]
    if bad:
        raise AssertionError("[mixed] checks failed: %s" % bad)
    return dict(modes, post=post_launches, t_row=k2_launches)


def eom_ok(E, ref, rn, rel):
    """A mixed EOM run's roots against a float64 run's, its recomputed
    residual norms and its sigma through K1 against the plain one."""
    return (np.abs(E - ref).max() < 1e-7 and max(rn) <= 1e-6
            and rel <= 1e-12)


def _density(cc, lam):
    dens = pycc_tpu_torch.ccdensity(cc, lam)
    dens.compute_energy()
    return dens.eone, dens.etwo


def _cc3_residual_split(cc):
    """One CC3 residual at cc's amplitudes, in ms by part: the CCSD
    residual (K1 in its ladder), the rest of the prep (the T1-dressed
    intermediates and their slab layouts), and the T3 slab loop; then
    max|diff| / max|plain| against the residual with the plain ladder, and
    max|r / D| of the residual."""
    H, t1, t2, no = cc.H, cc.t1, cc.t2, cc.no
    ccsd_ms, _ = _event_ms(lambda: residuals_ccsd(H.F, H.ERI, H.L, H.vvvv,
                                                  t1, t2, no))
    prep_ms, prep = _event_ms(lambda: cc3.cc3_scan_prep(
        H.F, H.ERI, H.L, H.vvvv, t1, t2, no))
    rows_ms, (r1, r2) = _event_ms(lambda: cc3._cc3_xs_rows(*prep, t2, no,
                                                           False))
    del prep
    p1, p2 = cc3.residuals_cc3_scan(H.F, H.ERI, H.L, H.vvvv, t1, t2, no,
                                    ladder=vvvv_nt_reference)
    rel = max(_rel(r1, p1), _rel(r2, p2))
    rd = max((r1 / cc.Dia).abs().max().item(),
             (r2 / cc.Dijab).abs().max().item())
    return ccsd_ms, prep_ms - ccsd_ms, rows_ms, rel, rd


def _cc3_lambda_split(cc, hb, lam):
    """One Lambda-CC3 step's residual at the converged (t, l), in ms by
    part: the CCSD form (K1 in its 'ijef,efab' ladder), the extras' prep,
    the t3 side and the l3 side; then max|diff| / max|plain| of the whole
    residual against the one whose CCSD form takes the plain ladder (the
    extras, which hold no ladder, are shared)."""
    H, t1, t2, no = cc.H, cc.t1, cc.t2, cc.no
    l1, l2 = lam.l1, lam.l2

    def ccsd(ladder=vvvv_nt):
        return lambda_residuals("CC3", hb.hbar, H.F, H.ERI, H.L, t1, t2, l1,
                                l2, no, ladder=ladder)
    ccsd_ms, (r1, r2) = _event_ms(ccsd)
    p1, p2 = ccsd(vvvv_nt_reference)
    prep_ms, prep = _event_ms(lambda: cc3.cc3_lambda_prep(H.F, H.ERI, H.L,
                                                          t1, t2, no))
    t3_ms, Y1 = _event_ms(lambda: cc3._cc3_lambda_t3_rows(prep, t2, l2, no,
                                                          False))
    l3_ms, (Y1l, Y2) = _event_ms(lambda: cc3._cc3_lambda_l3_rows(
        prep, t2, l1, l2, no))
    del prep
    Y1 = Y1 + Y1l
    Y2 = Y2 + Y2.permute(1, 0, 3, 2)
    rel = max(_rel(r1 + Y1, p1 + Y1), _rel(r2 + Y2, p2 + Y2))
    return ccsd_ms, prep_ms, t3_ms, l3_ms, rel


def phase_cc3(smi, name=CC3_SIZE):
    """CC3 at a real size on full storage: SCF, ccwfn(model="CC3"), the
    solve, HBAR, Lambda-CC3, the CC3 one-pdm and dipole, each timed, with
    K1's launches counted from 0 over the CC3 solve and over Lambda."""
    escf_ref, eccsd_ref, et_ref = FROZEN[name]
    ecc3_ref, lcc3_ref = FROZEN_CC3[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wfn = run_rhf(moldict[name], "cc-pvdz", freeze_core=True)
    t_scf = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc = pycc_tpu_torch.ccwfn(wfn, model="CC3", device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    vvvv_nt.launches = 0
    ecc, t_solve = _solve(cc, 1e-10, 1e-10)
    cc_launches = vvvv_nt.launches
    s_iter = cc.timers.total["ccwfn.iteration"] / cc.niter
    hb, t_hbar = _synced(lambda: pycc_tpu_torch.cchbar(cc))
    lam = pycc_tpu_torch.cclambda(cc, hb)
    vvvv_nt.launches = 0
    lecc, t_lam = _synced(lambda: lam.solve_lambda(1e-10, 1e-10))
    lam_launches = vvvv_nt.launches
    l_iter = cc.timers.total["lambda.iteration"] / lam.niter
    mu, t_pdm = _synced(lambda: cc3_dipole(cc, lam))
    peak = torch.cuda.max_memory_allocated()
    scan = (cc._residual_fn is cc3.residuals_cc3_scan
            and cc3_extra_fn(cc) is cc3.cc3_lambda_extra_scan)
    r_ccsd, r_prep, r_rows, r_rel, rd = _cc3_residual_split(cc)
    l_ccsd, l_prep, l_t3, l_l3, l_rel = _cc3_lambda_split(cc, hb, lam)
    dt = ecc - (eccsd_ref + et_ref)

    print("[cc3] %s/cc-pVDZ CC3  nbf=%d (no, nv)=(%d, %d)  o^3 v^3 = %.2e "
          "(slab forms: %s)  | %s"
          % (name, wfn.basisset().nbf, cc.no, cc.nv,
             float(cc.no ** 3 * cc.nv ** 3), scan, smi))
    print("[cc3] E(SCF) = %.12f  |dE(SCF)| = %.2e  SCF %.1f s (host)  "
          "Hamiltonian + ccwfn init %.1f s"
          % (wfn.energy(), abs(wfn.energy() - escf_ref), t_scf, t_init))
    print("[cc3] CC3 solve %.1f s  %d iterations  %.3f s/iter  K1 launches "
          "%d | HBAR %.2f s | Lambda-CC3 %.1f s  %d iterations  %.3f s/iter  "
          "K1 launches %d | one-pdm + dipole %.2f s | peak device memory "
          "%.2f GB" % (t_solve, cc.niter, s_iter, cc_launches, t_hbar, t_lam,
                       lam.niter, l_iter, lam_launches, t_pdm, peak / 1e9))
    print("[cc3] one CC3 residual: CCSD part %.1f ms, intermediates %.1f ms, "
          "T3 slab loop %.1f ms; K1 vs plain ladder rel diff %.1e; max|r/D| "
          "at the returned amplitudes %.2e" % (r_ccsd, r_prep, r_rows, r_rel,
                                              rd))
    print("[cc3] one Lambda-CC3 step: CCSD form %.1f ms, intermediates %.1f "
          "ms, t3 side %.1f ms, l3 side %.1f ms; K1 vs plain ladder rel diff "
          "%.1e  | %s" % (l_ccsd, l_prep, l_t3, l_l3, l_rel, smi))
    print("[cc3] Ecorr(CC3) = %.12f  |dE| from frozen = %.2e | Lambda "
          "pseudo-E = %.12f  |dE| from frozen = %.2e | dipole (a.u.) %s | "
          "E(CC3) - (Ecorr(CCSD) + E(T)) = %.6f Eh"
          % (ecc, abs(ecc - ecc3_ref), lecc, abs(lecc - lcc3_ref),
             np.array2string(mu, precision=8), dt))

    if not abs(wfn.energy() - escf_ref) < 1e-9:
        raise AssertionError("E(SCF) missed the frozen value")
    if not (scan and cc.converged and lam.converged):
        raise AssertionError("CC3: slab forms %s, converged %s, Lambda %s"
                             % (scan, cc.converged, lam.converged))
    if cc_launches < cc.niter or lam_launches < lam.niter:
        raise AssertionError("CC3: %d K1 launches in %d iterations, Lambda "
                             "%d in %d" % (cc_launches, cc.niter,
                                           lam_launches, lam.niter))
    if not (r_rel <= 1e-12 and l_rel <= 1e-12):
        raise AssertionError("K1 and the plain ladder differ: residual "
                             "%.2e, Lambda %.2e" % (r_rel, l_rel))
    if not rd <= 10 * 1e-10:
        raise AssertionError("max|r/D| at the returned amplitudes %.2e" % rd)
    if not (abs(dt) < 5e-3 and np.all(np.isfinite(mu))):
        raise AssertionError("E(CC3) lands %.2e Eh from E(CCSD(T)), dipole "
                             "%s" % (dt, mu))
    if not (abs(ecc - ecc3_ref) < 1e-9 and abs(lecc - lcc3_ref) < 1e-9):
        raise AssertionError("E(CC3) or the Lambda pseudo-energy missed the "
                             "frozen value")
    return {"cc3": cc_launches, "cc3_lambda": lam_launches}, wfn


def _event_ms(fn):
    """fn's time on the card between two CUDA events, and its result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _ladder_split(cc):
    """One dressed ladder and one residual at cc's amplitudes, in ms: the
    W assembly of every a-block (`dfccsd.ladder_W`) and their K1 products
    apart, then one whole `ladder_df` and one whole residual."""
    dfb, t1, t2, no, nv = cc.dfb, cc.t1, cc.t2, cc.no, cc.nv
    blk = -(-nv // dfccsd._ladder_blocks(nv, cc.naux))
    tau2 = build_tau(t1, t2).reshape(no * no, nv * nv)
    BL = 0.5 * dfb.Bvv - torch.einsum("ma,Pme->Pae", t1, dfb.Bov)
    assembly = k1 = 0.0
    for a0 in range(0, nv, blk):
        ms, W = _event_ms(lambda: dfccsd.ladder_W(BL[:, a0:a0 + blk],
                                                  dfb.Bvv))
        assembly += ms
        k1 += _event_ms(lambda: vvvv_nt(tau2, W))[0]
        del W
    del tau2, BL
    ladder = _event_ms(lambda: dfccsd.ladder_df(dfb, t1, t2))[0]
    residual = _event_ms(lambda: cc.residuals(cc.H.F, t1, t2))[0]
    return assembly, k1, ladder, residual


# the [df] wavefunction's worker: the host threads it may use (its AO
# Cholesky runs on one), so that the main process keeps the rest
DF_WORKER_THREADS = "2"


def _df_wavefunction(conn, name):
    """[df]'s DF-SCF and the AO property integrals ccwfn's init reads (kept
    on the wavefunction), in a worker process; the wavefunction and the
    seconds of each go back through `conn`."""
    t0 = time.perf_counter()
    wfn = run_rhf(moldict[name], "aug-cc-pvdz", freeze_core=True, df=True,
                  df_tol=DF_TOL)
    t_scf = time.perf_counter() - t0
    ao_properties(wfn)
    conn.send((wfn, t_scf, time.perf_counter() - t0 - t_scf))
    conn.close()


class DFWorker:
    """[df]'s host work, started at the top of the script in a spawned
    process, so that its one-thread AO Cholesky and its DF-SCF run while
    the card works through the earlier phases.  `result()` waits for the
    wavefunction (an exception if the worker failed); `stop()` ends the
    process if it still runs."""

    def __init__(self, name=DF_SIZE):
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=False)
        keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
        saved = {k: os.environ.get(k) for k in keys}
        os.environ.update({k: DF_WORKER_THREADS for k in keys})
        try:
            self._proc = ctx.Process(target=_df_wavefunction,
                                     args=(child, name), daemon=True)
            self._proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        child.close()

    def result(self):
        t0 = time.perf_counter()
        try:
            out = self._conn.recv()
        except EOFError:
            self._proc.join(10)
            raise RuntimeError("[df] the DF-SCF worker died (exit code %s)"
                               % self._proc.exitcode) from None
        self._proc.join(60)
        return out + (time.perf_counter() - t0,)

    def stop(self):
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(10)
        self._conn.close()


def phase_df(smi, worker, name=DF_SIZE):
    escf_ref, eccsd_ref, et_ref = FROZEN_DF[name]
    torch.cuda.reset_peak_memory_stats()
    wfn, t_scf, t_props, t_wait = worker.result()
    t_chol = wfn.timers.total["rhf.ao_cholesky"]
    t0 = time.perf_counter()
    cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD(T)", storage="df",
                              df_tol=DF_TOL, device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init = {k: cc.timers.total[k] for k in (
        "ccwfn.hamiltonian", "ccwfn.df_factors_to_mo", "ccwfn.df_recompress")}
    nblocks = dfccsd._ladder_blocks(cc.nv, cc.naux)
    vvvv_nt.launches = 0
    t_energy_row.launches = 0
    e, t_solve = _solve(cc, 1e-10, 1e-10)
    launches = {"vvvv_nt": vvvv_nt.launches, "t_row": t_energy_row.launches}
    peak = torch.cuda.max_memory_allocated()
    t_t = cc.timers.total["ccwfn.triples"]
    eccsd = float(cc.cc_energy(cc.t1, cc.t2))
    et = e - eccsd
    s_iter = (t_solve - t_t) / cc.niter
    print("[df] %s/aug-cc-pVDZ DF-CCSD(T)  nbf=%d (no, nv)=(%d, %d)  naux "
          "AO %d, recompressed %d (df_tol %.0e)  | %s"
          % (name, wfn.basisset().nbf, cc.no, cc.nv, wfn.B_ao.shape[0],
             cc.naux, DF_TOL, smi))
    print("[df] host, in a worker process beside the earlier phases (%s "
          "threads): SCF %.1f s (AO Cholesky %.1f s, the rest %.1f s), AO "
          "property integrals %.1f s; the script waited %.1f s for them; "
          "ccwfn init %.1f s (F and the property transforms %.1f s, MO "
          "transform %.1f s, recompression on the card %.1f s)"
          % (DF_WORKER_THREADS, t_scf, t_chol, t_scf - t_chol, t_props,
             t_wait, t_init, init["ccwfn.hamiltonian"],
             init["ccwfn.df_factors_to_mo"], init["ccwfn.df_recompress"]))
    print("[df] E(SCF) = %.12f  |dE(SCF)| = %.2e"
          % (wfn.energy(), abs(wfn.energy() - escf_ref)))
    print("[df] CCSD solve %.1f s  %d iterations  %.3f s/iter  (T) %.1f s  "
          "peak device memory %.2f GB  K1 launches %d (%d ladder blocks)  "
          "K2 launches %d" % (t_solve - t_t, cc.niter, s_iter, t_t,
                              peak / 1e9, launches["vvvv_nt"], nblocks,
                              launches["t_row"]))
    print("[df] Ecorr(CCSD) = %.12f  |dE| = %.2e"
          % (eccsd, abs(eccsd - eccsd_ref)))
    print("[df] E(T) = %.12f  |dE| = %.2e" % (et, abs(et - et_ref)))
    assembly, k1, ladder, residual = _ladder_split(cc)
    print("[df] one iteration's ladder at the converged amplitudes: W "
          "assembly %.1f ms + K1 %.1f ms over %d blocks; ladder_df %.1f ms; "
          "whole residual %.1f ms; solve %.1f ms an iteration  | %s"
          % (assembly, k1, nblocks, ladder, residual, 1e3 * s_iter, smi))

    ok_shapes = (cc.t2.shape == (cc.no, cc.no, cc.nv, cc.nv)
                 and bool(torch.isfinite(cc.t2).all()) and math.isfinite(et))
    if not (ok_shapes and cc.converged):
        raise AssertionError("DF: not converged, t2 or E(T) not finite, or "
                             "t2 of the wrong shape")
    for what, got, want in (("E(SCF)", wfn.energy(), escf_ref),
                            ("Ecorr(CCSD)", eccsd, eccsd_ref),
                            ("E(T)", et, et_ref)):
        if not abs(got - want) < 1e-9:
            raise AssertionError("DF %s missed the frozen value" % what)
    if (launches["vvvv_nt"] != cc.niter * nblocks
            or launches["t_row"] != cc.no):
        raise AssertionError("DF: %d K1 launches in %d iterations of %d "
                             "blocks, %d K2 launches for no = %d"
                             % (launches["vvvv_nt"], cc.niter, nblocks,
                                launches["t_row"], cc.no))
    return launches, _factors_of(cc), dict(eccsd=eccsd, s_iter=s_iter)


def _factors_of(cc):
    """What [dfpost] takes from a DF ccwfn: its MO factors B (naux, nact,
    nact) reassembled from the blocks, F, the dipole integrals, no and
    E(SCF)."""
    no, dfb = cc.no, cc.dfb
    naux, nact = cc.naux, cc.nact
    B = torch.empty((naux, nact, nact), dtype=dfb.Bov.dtype,
                    device=dfb.Bov.device)
    B[:, :no, :no] = dfb.Boo
    B[:, :no, no:] = dfb.Bov
    B[:, no:, :no] = dfb.Bov.transpose(1, 2)
    B[:, no:, no:] = dfb.Bvv
    return B, cc.H.F, cc.H.mu, no, cc.eref


# the guess of [dfpost]'s EOM: CIS, a host eigh of the (o v)^2 = 5184^2
# CIS matrix (HBAR_SS, a nonsymmetric eig of the same size, took 42.9-48.8
# s on the host); the roots are held to those the HBAR_SS guess converged
# to (chip_smoke on the H100, an earlier revision of this script)
DFPOST_EOM_GUESS = "CIS"
DFPOST_EOM_ROOTS_HBAR_SS = np.array([0.2858885915, 0.2891793821,
                                     0.2917545505, 0.2926803958,
                                     0.2963651533, 0.3016116753])


def _dfpost_ladder_checks(cc, hb, lam, resp, A, X, Y):
    """Each [dfpost] K1 caller against the plain ladder (`_rel_plain`):
    Lambda's Hvvvv ladder on the converged l2 (the residual itself is ~0
    there), the density energy's two-electron part, and the response's
    (`_resp_ladder_checks`; its in_Y is inY2_df's ladder)."""
    no, t1, t2 = cc.no, cc.t1, cc.t2
    rels = {
        "lambda": _rel_plain(lambda ld: (hvvvv_x2_df(hb, t2, lam.l2,
                                                     ladder=ld),)),
        "density": _rel_plain(lambda ld: density_energy_df(
            cc.H.F, cc.dfb, t1, t2, lam.l1, lam.l2, no, ladder=ld)[1:]),
    }
    rels.update(_resp_ladder_checks(resp, A, X, Y))
    return rels


def phase_dfpost(factors, smi, name=DF_SIZE):
    """The DF post-convergence stack at [df]'s size on its factors, F and
    dipole integrals: a CCSD ccwfn from ccwfn.from_df_factors, its solve,
    HBAR, Lambda, the densities and their energy, EOM-CCSD for the
    DFPOST_EOM_ROOTS lowest roots,
    and one right and one left MU_Z solve with that polarizability
    element, each timed, K1's launches counted from 0 for each caller and
    checked against its iterations x ladder blocks."""
    B, F, mu, no, escf = factors
    eccsd_ref = FROZEN_DF[name][1]
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cc, t_init = _synced(lambda: pycc_tpu_torch.ccwfn.from_df_factors(
        B, F, no, escf=escf, model="CCSD", mu=mu, device=DEVICE))
    del B
    nblocks = dfccsd._ladder_blocks(cc.nv, cc.naux)
    vvvv.reset_launches()
    ecc, t_solve = _synced(lambda: cc.solve_cc_mixed(
        1e-10, 1e-10, sp_kwargs={"bf16_until": BF16_UNTIL}))
    cc_launches, cc_modes = vvvv_nt.launches, dict(vvvv_nt.launches_by_mode)
    (_, _, n_floor, t_floor, n_bf16), (_, _, n_refine, t_refine, _) = \
        cc.stages
    cc_iters = {"bf16": n_bf16, "f32": n_floor - n_bf16, "f64": n_refine}
    hb, t_hbar = _synced(lambda: pycc_tpu_torch.cchbar(cc))
    lam = pycc_tpu_torch.cclambda(cc, hb)
    (lecc, t_lam), lam_launches = _launched(lambda: _synced(
        lambda: lam.solve_lambda(1e-10, 1e-10)))
    peak_lam = torch.cuda.max_memory_allocated()

    def densities():
        dens = pycc_tpu_torch.ccdensity(cc, lam)
        dens.compute_energy()
        return dens.eone, dens.etwo
    ((eone, etwo), t_den), den_launches = _launched(lambda: _synced(
        densities))

    eom = pycc_tpu_torch.cceom(hb)
    ((E, C), t_eom), eom_launches = _launched(lambda: _synced(
        lambda: eom.solve_eom(N=DFPOST_EOM_ROOTS, e_conv=1e-8, r_conv=1e-6,
                              guess=DFPOST_EOM_GUESS)))
    n_sigma = cc.timers.count["eom.sigma"]
    peak_eom = torch.cuda.max_memory_allocated()
    eom_iters, subspace, eom_ok = eom.niter, C.shape[0], eom.converged
    rn, rel_eom, dw, t_k1, t_plain = _eom_checks(eom, C, E, DFPOST_EOM_ROOTS)
    del eom, C

    resp, t_resp = _synced(lambda: pycc_tpu_torch.ccresponse(
        pycc_tpu_torch.ccdensity(cc, lam, onlyone=True)))
    A = resp.pertbar["MU_Z"]
    (sigma, t_probe), probe_launches = _launched(lambda: _synced(
        lambda: resp.estimate_conditioning(RESP_OMEGA)))
    ((X1, X2, _), t_right), right_launches = _launched(lambda: _synced(
        lambda: resp.solve_right(A, RESP_OMEGA, RESP_CONV, RESP_CONV)))
    right = (resp.converged, resp.niter)
    ((Y1, Y2, _), t_left), left_launches = _launched(lambda: _synced(
        lambda: resp.solve_left(A, RESP_OMEGA, RESP_CONV, RESP_CONV)))
    left = (resp.converged, resp.niter)
    alpha = complex(resp.linresp_asym("MU_Z", X1, X2, Y1, Y2)).real
    peak = torch.cuda.max_memory_allocated()

    res_x = _resp_residual(resp, A, RESP_OMEGA, (X1, X2))
    res_y = _resp_residual(resp, A, RESP_OMEGA, (X1, X2), (Y1, Y2))
    rels = _dfpost_ladder_checks(cc, hb.hbar, lam, resp, A, (X1, X2),
                                 (Y1, Y2))
    rels["eom sigma"] = rel_eom
    resp_launches = probe_launches + right_launches + left_launches
    want = {"ccsd": sum(cc_iters.values()), "lambda": lam.niter,
            "density": 2,
            "eom": n_sigma, "response": 24 + right[1] + left[1] + 1}
    got = {"ccsd": cc_launches, "lambda": lam_launches,
           "density": den_launches, "eom": eom_launches,
           "response": resp_launches}

    print("[dfpost] %s/aug-cc-pVDZ DF-CCSD post-convergence on [df]'s "
          "factors: (no, nv) = (%d, %d) naux %d, %d ladder blocks  | %s"
          % (name, cc.no, cc.nv, cc.naux, nblocks, smi))
    print("[dfpost] from_df_factors %.1f s  CCSD solve_cc_mixed (bf16_until "
          "%.0e) %.1f s: floor %d iterations (%d bf16) %.1f s, refinement %d "
          "iterations %.1f s; K1 launches by mode %s; Ecorr = %.12f |dE| "
          "from frozen = %.2e"
          % (t_init, BF16_UNTIL, t_solve, n_floor, n_bf16, t_floor, n_refine,
             t_refine, cc_modes, ecc, abs(ecc - eccsd_ref)))
    print("[dfpost] HBAR %.2f s  Lambda %.1f s %d iterations %.3f s/iter "
          "pseudo-E = %.12f  peak device memory through Lambda %.2f GB"
          % (t_hbar, t_lam, lam.niter, t_lam / lam.niter, lecc,
             peak_lam / 1e9))
    print("[dfpost] densities + compute_energy %.2f s: eone + etwo = %.12f "
          "Ecorr(CCSD) = %.12f |diff| = %.2e"
          % (t_den, eone + etwo, ecc, abs(eone + etwo - ecc)))
    print("[dfpost] EOM-CCSD %d roots %.1f s (the %s guess on the host %.1f "
          "s): %s Eh (|E - HBAR_SS guess's| %.2e)  %d iterations  subspace "
          "%d  sigma blocks %d  residual norms %s  |Ritz - E| %.2e  peak "
          "device memory %.2f GB"
          % (DFPOST_EOM_ROOTS, t_eom, DFPOST_EOM_GUESS,
             cc.timers.total["eom.guess"], np.array2string(E, precision=10),
             np.abs(E - DFPOST_EOM_ROOTS_HBAR_SS).max(), eom_iters, subspace,
             n_sigma, ", ".join("%.2e" % r for r in rn), dw,
             peak_eom / 1e9))
    print("[dfpost] sigma of the %d Ritz vectors: through K1 %.3f s, through "
          "the plain ladder %.3f s" % (DFPOST_EOM_ROOTS, t_k1, t_plain))
    print("[dfpost] ccresponse %.2f s  conditioning probe %.1f s (sigma_min "
          "<= %.6f)  solve_right MU_Z %.1f s %d iterations %.3f s/iter  "
          "solve_left MU_Z %.1f s %d iterations %.3f s/iter  alpha_zz(%.4f) "
          "= %.10f  max|r/(D + omega)| right %.1e left %.1e  peak device "
          "memory %.2f GB"
          % (t_resp, t_probe, sigma, t_right, right[1], t_right / right[1],
             t_left, left[1], t_left / left[1], RESP_OMEGA, alpha, res_x,
             res_y, peak / 1e9))
    print("[dfpost] K1 launches by caller (want iterations x %d blocks): %s"
          % (nblocks, ", ".join("%s %d (%d)" % (k, got[k], nblocks * want[k])
                                for k in got)))
    print("[dfpost] K1 vs the plain ladder, max|diff|/max|plain|: %s  | %s"
          % ("  ".join("%s %.1e" % kv for kv in rels.items()), smi))
    print("[dfpost] the phase, its checks included: %.1f s"
          % (time.perf_counter() - t_phase))

    if not (cc.converged and abs(ecc - eccsd_ref) < 1e-9):
        raise AssertionError("[dfpost] Ecorr(CCSD) missed the frozen value")
    if not (lam.converged and math.isfinite(lecc)):
        raise AssertionError("[dfpost] Lambda did not converge")
    if not abs(eone + etwo - ecc) < 1e-9:
        raise AssertionError("[dfpost] the density energy missed Ecorr")
    if not (eom_ok and np.all(np.isfinite(E)) and np.all(E > 0)
            and max(rn) <= 1e-6):
        raise AssertionError("[dfpost] EOM-CCSD: converged %s, roots %s, "
                             "residual norms %s" % (eom_ok, E, rn))
    if not np.abs(E - DFPOST_EOM_ROOTS_HBAR_SS).max() < 1e-6:
        raise AssertionError("[dfpost] EOM-CCSD roots from the %s guess %s "
                             "differ from the HBAR_SS guess's %s"
                             % (DFPOST_EOM_GUESS, E,
                                DFPOST_EOM_ROOTS_HBAR_SS))
    if not (right[0] and left[0] and max(res_x, res_y) <= 10 * RESP_CONV
            and math.isfinite(alpha) and alpha > 0):
        raise AssertionError("[dfpost] response: right %s left %s, residuals "
                             "%.2e %.2e, alpha %r" % (right, left, res_x,
                                                      res_y, alpha))
    if not max(rels.values()) <= 1e-12:
        raise AssertionError("[dfpost] K1 and the plain ladder differ: %s"
                             % rels)
    bad = {k: (got[k], nblocks * want[k]) for k in got
           if got[k] != nblocks * want[k]}
    bad.update({"ccsd " + m: (cc_modes[m], nblocks * n)
                for m, n in cc_iters.items()
                if not cc_modes[m] == nblocks * n > 0})
    if bad:
        raise AssertionError("[dfpost] K1 launches (got, want): %s" % bad)
    out = {k: got[k] for k in ("lambda", "eom", "density", "response")}
    out.update(ccsd_bf16=cc_modes["bf16"], ccsd_f32=cc_modes["f32"])
    lam.hbar = None
    return out, (cc, lam, ecc)


# ---------------------------------------------------------------------------
# real-time CC
# ---------------------------------------------------------------------------

# tests/test_008 (He vode mu_z at t = 1, H2O/cc-pVDZ rk4 mu_z at t = 0 and
# after the loop to 0.1), test_013 (He autocorrelation), test_015 ((H2)_2
# electric and magnetic dipoles, the SCF part removed)
RT_HE_MUZ = 0.008400738202694
RT_HE_AUTOCORR = -0.967109840555436 + 0.250976568630115j
RT_H2O_MUZ0, RT_H2O_MUZ = -0.07800691, -0.0780067603267549
RT_H22_MU = (0.0, 0.0, -0.0007395036977002)
RT_H22_M = (0.0, 0.0, -2.3037968376087573e-5)

# [rt]: the pulse, rk4's step and steps (10 steps, 40 right-hand sides)
RT_PULSE = (0.01, 0.0, 0.01, 0.05)
RT_H, RT_STEPS = 0.01, 10
RT_CONV = 1e-10

# (H2O)_4/cc-pVDZ, frozen core: mu (all three axes) and the Lagrangian at
# t = 0.02 after two rk4(0.01) steps under RT_PULSE, from pycc_tpu in
# float64 on a CPU host:
#   cc = pycc_tpu.ccwfn(run_rhf(moldict["(H2O)_4"], "cc-pvdz",
#                               freeze_core=True))
#   cc.solve_cc(1e-10, 1e-10)
#   lam = pycc_tpu.cclambda(cc, pycc_tpu.cchbar(cc))
#   lam.solve_lambda(1e-10, 1e-10)
#   rt = pycc_tpu.rtcc(cc, lam, None, gaussian_laser(0.01, 0, 0.01,
#                                                    center=0.05))
#   y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
#   y = rk4(0.01)(rt.f, 0.0, y); y = rk4(0.01)(rt.f, 0.01, y)
#   t1, t2, l1, l2, _ = rt.extract_amps(y)
#   rt.dipole(t1, t2, l1, l2), rt.lagrangian(0.02, t1, t2, l1, l2)
# (Ecorr -0.861900803787839, pseudo-E -0.848164239003946 there).  The
# (H2O)_6 trajectory of [rt] does not fit that host's memory in pycc_tpu.
FROZEN_RT = {
    "(H2O)_4": dict(
        mu=(0.00034136081003775977 - 2.4870558896830995e-10j,
            0.0011795607779308335 + 9.026436005222197e-11j,
            -0.0005793820505273618 + 1.5844423687018368e-10j),
        lagrangian=-163.1318518593916 + 1.6292886698812342e-19j),
}


def _rt_pipeline(wfn, model="CCSD", conv=1e-13):
    """A converged ccwfn on the card, its Lambda and ccdensity."""
    cc = pycc_tpu_torch.ccwfn(wfn, model=model, device=DEVICE)
    cc.solve_cc(conv, conv, 200)
    lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
    lam.solve_lambda(conv, conv)
    return cc, lam, pycc_tpu_torch.ccdensity(cc, lam)


def _counted_rhs(rt):
    """Count rt's right-hand sides and K1's launches in each of its two
    ladders (the T residuals and the Lambda residuals): rt's methods are
    wrapped on the instance, and the counts returned as a dict."""
    counts = {"rhs": 0, "t": 0, "lambda": 0}

    def ladder_side(fn, key):
        def run(*args):
            n0 = vvvv_nt.launches
            out = fn(*args)
            counts[key] += vvvv_nt.launches - n0
            return out
        return run

    f = rt.f

    def rhs(t, y):
        counts["rhs"] += 1
        return f(t, y)
    rt.t_residuals = ladder_side(rt.t_residuals, "t")
    rt.lambda_residuals = ladder_side(rt.lambda_residuals, "lambda")
    rt.f = rhs
    return counts


def _eref(cc):
    """The reference energy of the active space from the Hamiltonian,
    2 tr F[o,o] - sum_ij L[ijij]: E(SCF) - E_nuc when no core is frozen."""
    o = cc.o
    return float(2.0 * torch.trace(cc.H.F[o, o])
                 - torch.einsum("ijij->", cc.H.L[o, o, o, o]))


def phase_rt_oracles(wfn_sto3g):
    """The reference suite's real-time oracles on device="cuda": He under
    tests/test_008's sine^2 pulse through scipy's vode (mu_z(1.0), and
    test_013's autocorrelation of the same trajectory), H2O/cc-pVDZ's rk4
    dipoles (test_008), (H2)_2/cc-pVDZ's electric and magnetic dipoles
    (test_015), He's checkpoint/restart equality (test_008) and
    H2O/STO-3G's DF right-hand side against the dense one (test_025),
    each with its K1 launches = 2 x right-hand sides held."""
    from scipy.integrate import complex_ode
    t0 = time.perf_counter()
    he = run_rhf(moldict["He"], "cc-pvdz", freeze_core=False)
    cc, lam, dens = _rt_pipeline(he)
    eref_gap = abs(_eref(cc) - (he.energy() - he.mol.nuclear_repulsion()))
    rt = pycc_tpu_torch.rtcc(cc, lam, dens, sine_square_laser(1.0, 2.87, 5.0))
    counts = _counted_rhs(rt)
    y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0).cpu().numpy()
    vvvv_nt.launches = 0
    ODE = complex_ode(rt.f).set_integrator("vode", atol=1e-13, rtol=1e-13)
    ODE.set_initial_value(y0, 0)
    while ODE.successful() and ODE.t < 1.0:
        y = ODE.integrate(ODE.t + 0.01)
    he_launches = vvvv_nt.launches
    muz = rt.dipole(*rt.extract_amps(y)[:4])[2].real
    A = rt.autocorrelation(y0, y)
    t_vode = time.perf_counter() - t0

    # checkpoint/restart: a run to 0.05 with checkpoints, restarted to 0.1
    rt = pycc_tpu_torch.rtcc(cc, lam, dens, gaussian_laser(*RT_PULSE))
    y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            full = rt.propagate(rk4(0.01), y0.clone(), 0.1)
            rt.propagate(rk4(0.01), y0.clone(), 0.05, chk=True)
            import pickle
            with open("chk.pk", "rb") as fh:
                chkp = pickle.load(fh)
            resumed = rt.propagate(rk4(0.01), chkp["y"], 0.1,
                                   ti=chkp["time"], chk=True)
        finally:
            os.chdir(cwd)
    key = sorted(full)[-1]
    chk_gap = max(abs(full[key][k] - resumed[key][k]) for k in ("ecc",
                                                                "mu_z"))
    del cc, lam, dens, rt

    # H2O/cc-pVDZ, all electrons, rk4 (test_008)
    cc, lam, dens = _rt_pipeline(run_rhf(moldict["H2O"], "cc-pvdz",
                                         freeze_core=False))
    rt = pycc_tpu_torch.rtcc(cc, lam, dens, gaussian_laser(*RT_PULSE))
    counts_h2o = _counted_rhs(rt)
    muz0 = rt.dipole(cc.t1, cc.t2, lam.l1, lam.l2)[2].real
    y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    vvvv_nt.launches = 0
    t = 0.0
    while t < 0.1:
        y = rk4(0.01)(rt.f, t, y)
        t += 0.01
    h2o_launches = vvvv_nt.launches
    muz_h2o = rt.dipole(*rt.extract_amps(y)[:4])[2].real
    del cc, lam, dens, rt, y

    # (H2)_2/cc-pVDZ dipoles (test_015)
    cc, lam, dens = _rt_pipeline(run_rhf(moldict["(H2)_2"], "cc-pvdz",
                                         freeze_core=False))
    rt = pycc_tpu_torch.rtcc(cc, lam, dens, None, magnetic=True)
    amps = rt.extract_amps(rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2,
                                           cc.cc_energy(cc.t1, cc.t2)))[:4]
    mu_gap = max(abs(a - b) for a, b in zip(RT_H22_MU, rt.dipole(*amps)))
    m_gap = max(abs(1j * a - b) for a, b in zip(
        RT_H22_M, rt.dipole(*amps, magnetic=True)))
    del cc, lam, dens, rt

    # H2O/STO-3G over exact factors against dense storage (test_025)
    H = build_hamiltonian(wfn_sto3g, device=DEVICE)
    B = cholesky_factor_eri(H.ERI, tol=1e-14, device=DEVICE)
    ccd, lamd, _ = _rt_pipeline(wfn_sto3g, conv=1e-12)
    ccf = pycc_tpu_torch.ccwfn.from_df_factors(
        B, H.F, H.no, mu=torch.stack(H.mu), device=DEVICE)
    ccf.solve_cc(1e-12, 1e-12)
    lamf = pycc_tpu_torch.cclambda(ccf, pycc_tpu_torch.cchbar(ccf))
    lamf.solve_lambda(1e-12, 1e-12)
    V = gaussian_laser(0.05, 0.0, 0.01, 0.05)
    rtd = pycc_tpu_torch.rtcc(ccd, lamd, None, V)
    rtf = pycc_tpu_torch.rtcc(ccf, lamf, None, V)
    y0 = rtd.collect_amps(ccd.t1, ccd.t2, lamd.l1, lamd.l2, 0)
    vvvv_nt.launches = 0
    df_gap = (rtd.f(0.02, y0) - rtf.f(0.02, y0)).abs().max().item()
    df_launches = vvvv_nt.launches
    del H, B, ccd, lamd, ccf, lamf, rtd, rtf

    print("[oracle] RT He/cc-pVDZ vode to t = 1 (%d right-hand sides, %d K1 "
          "launches): mu_z = %.15f |d| = %.2e  autocorrelation %s |d| = "
          "%.2e; 2 tr F_oo - L_ijij - (E(SCF) - E_nuc) = %.1e; checkpoint "
          "restart |d| = %.1e  %.1f s"
          % (counts["rhs"], he_launches, muz, abs(muz - RT_HE_MUZ),
             np.round(A, 12), abs(A - RT_HE_AUTOCORR), eref_gap, chk_gap,
             t_vode))
    print("[oracle] RT H2O/cc-pVDZ rk4: mu_z(0) = %.10f |d| = %.1e, mu_z = "
          "%.13f |d| = %.1e (%d right-hand sides, %d K1 launches) | (H2)_2/"
          "cc-pVDZ |mu - frozen| %.1e |m - frozen| %.1e | H2O/STO-3G DF "
          "right-hand side - dense %.1e (%d K1 launches)"
          % (muz0, abs(muz0 - RT_H2O_MUZ0), muz_h2o,
             abs(muz_h2o - RT_H2O_MUZ), counts_h2o["rhs"], h2o_launches,
             mu_gap, m_gap, df_gap, df_launches))
    checks = [
        ("He mu_z", abs(muz - RT_HE_MUZ) < 1e-10),
        ("He autocorrelation", abs(A - RT_HE_AUTOCORR) < 1e-9),
        ("He reference energy", eref_gap < 1e-10),
        ("He checkpoint", chk_gap < 1e-12),
        ("H2O mu_z(0)", abs(muz0 - RT_H2O_MUZ0) < 1e-6),
        ("H2O mu_z", abs(muz_h2o - RT_H2O_MUZ) < 1e-4),
        ("(H2)_2 dipoles", mu_gap < 1e-10 and m_gap < 1e-10),
        ("DF", df_gap < 1e-10),
        ("K1 launches", he_launches == 2 * counts["rhs"] > 0
         and counts["t"] == counts["lambda"] == counts["rhs"]
         and h2o_launches == 2 * counts_h2o["rhs"] == 2 * 44
         and df_launches == 4),
    ]
    bad = [what for what, ok in checks if not ok]
    if bad:
        raise AssertionError("[oracle] RT checks failed: %s" % bad)
    gc.collect()    # _counted_rhs's wrappers hold their rtcc in a cycle


def _rel_c(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def phase_rt(real, smi, name=REAL_SIZE):
    """[rt]: real-time CCSD at [real]'s size on its wavefunction (no second
    SCF): a CCSD ccwfn on full storage, its solve and Lambda to RT_CONV,
    then rtcc under RT_PULSE and RT_STEPS rk4 steps from t = 0 (y on the
    card), each timed.  Checked: the field-free right-hand side at the
    converged state (the T and Lambda parts ~0, the phase's -i times the
    reference plus correlation energy), the Lagrangian and dipole at
    t = 0, one right-hand side through K1 against the plain ladder, and
    K1's launches in each of the two complex ladders = the right-hand
    sides (counted from 0 over the propagation)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cc, t_init = _synced(lambda: pycc_tpu_torch.ccwfn(
        real["wfn"], model="CCSD", device=DEVICE))
    ecc, t_solve = _synced(lambda: cc.solve_cc(RT_CONV, RT_CONV))
    lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
    lecc, t_lam = _synced(lambda: lam.solve_lambda(RT_CONV, RT_CONV))
    lam.hbar = None
    no, nv = cc.no, cc.nv
    eref = _eref(cc)
    efc = real["wfn"].energy() - real["wfn"].mol.nuclear_repulsion() - eref

    # the field-free right-hand side at the converged state
    rt0 = pycc_tpu_torch.rtcc(cc, lam, None, gaussian_laser(
        0.0, *RT_PULSE[1:]))
    y0 = rt0.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    f0 = rt0.f(0.0, y0)
    r1, r2, s1, s2, dphase = rt0.extract_amps(f0)
    d1 = cc.Dia
    d2 = cc.Dijab
    r_free = max((r1 / d1).abs().max().item(), (r2 / d2).abs().max().item(),
                 (s1 / d1).abs().max().item(), (s2 / d2).abs().max().item())
    r_abs = max(x.abs().max().item() for x in (r1, r2, s1, s2))
    phase_gap = abs(complex(dphase) - (-1j) * (eref + ecc))
    del f0, r1, r2, s1, s2

    # the start values (the pulse's tail at t = 0 moves F by 4e-10 a.u.,
    # so the Lagrangian is taken field-free)
    L0 = rt0.lagrangian(0.0, cc.t1, cc.t2, lam.l1, lam.l2)
    rt = pycc_tpu_torch.rtcc(cc, lam, None, gaussian_laser(*RT_PULSE))
    mu0 = rt.dipole(cc.t1, cc.t2, lam.l1, lam.l2)
    opdm = pycc_tpu_torch.ccdensity(cc, lam, onlyone=True).compute_onepdm(
        cc.t1, cc.t2, lam.l1, lam.l2)
    mu_dens = [float(torch.sum(m * opdm)) for m in cc.H.mu]
    dip_gap = max(abs(a - b) for a, b in zip(mu0, mu_dens))
    del opdm, rt0

    counts = _counted_rhs(rt)
    vvvv_nt.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ret = rt.propagate(rk4(RT_H), y0, RT_H * RT_STEPS - 1e-12)
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t0
    launches = vvvv_nt.launches
    main = dict(counts)
    peak = torch.cuda.max_memory_allocated()
    keys = sorted(ret)
    t_end = float(keys[-1])

    # at the final state: one right-hand side split by part, K1 against
    # the plain ladder, the observables' time
    y = rt.y
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    F = rt._field(t_end, y.dtype)
    rhs_s = statistics.median(_synced(lambda: rt.f(t_end, y))[1]
                              for _ in range(3))
    t_ms, _ = _event_ms(lambda: rt.t_residuals(F, t1, t2))
    lam_ms, _ = _event_ms(lambda: rt.lambda_residuals(F, t1, t2, l1, l2))
    ERI, L = cc.H.ERI, cc.H.L
    hbar_ms, hb = _event_ms(lambda: build_hbar("CCSD", F, ERI, L, t1, t2, no))
    stack_ms, _ = _event_ms(lambda: hb.Hvvvv_efab)
    tau = build_tau(t1, t2)
    lad_t_ms, _ = _event_ms(lambda: vvvv_contract(tau, cc.vvvv()))
    lad_l_ms, _ = _event_ms(lambda: vvvv_contract_efab(l2, hb.Hvvvv_efab))
    del hb, tau
    obs_s = _synced(lambda: rt._observables(t_end, y))[1]
    f_k1 = rt.f(t_end, y)
    f_plain = pycc_tpu_torch.rtcc(cc, lam, None, rt.V,
                                  ladder=vvvv_nt_reference).f(t_end, y)
    rel_plain = _rel_c(f_k1, f_plain)
    finite = bool(torch.isfinite(torch.view_as_real(y)).all())
    del f_k1, f_plain, F, y, t1, t2, l1, l2

    mz = [ret[k]["mu_z"].real for k in keys]
    print("[rt] %s/cc-pVDZ real-time CCSD  (no, nv) = (%d, %d), y %d complex"
          "128 (%.0f MB), gaussian_laser%s, rk4(%g) x %d  | %s"
          % (name, no, nv, y0.numel(), y0.numel() * 16 / 1e6, RT_PULSE, RT_H,
             RT_STEPS, smi))
    print("[rt] ccwfn init %.1f s  CCSD solve %.2f s (%d iterations) Ecorr "
          "= %.12f  Lambda %.2f s (%d iterations) pseudo-E = %.12f"
          % (t_init, t_solve, cc.niter, ecc, t_lam, lam.niter, lecc))
    print("[rt] field-free right-hand side at the converged state: max|r/D| "
          "%.1e (max|r| %.1e); |dphase/dt + i (E_ref + Ecorr)| = %.1e with "
          "E_ref = 2 tr F_oo - L_ijij = %.10f (E(SCF) - E_nuc - E_ref = "
          "%.10f, the frozen core's)"
          % (r_free, r_abs, phase_gap, eref, efc))
    print("[rt] t = 0: Lagrangian %.12f (E_ref + Ecorr %.12f, |d| %.1e); "
          "dipole %s, |d| from the ccdensity one-pdm dipole %.1e"
          % (L0.real, eref + ecc, abs(L0 - (eref + ecc)),
             np.round(np.array(mu0).real, 10), dip_gap))
    print("[rt] propagate %.2f s: %.3f s a step (4 right-hand sides and the "
          "observables); one right-hand side %.3f s (T residuals %.1f ms, "
          "Lambda residuals %.1f ms: HBAR rebuild %.1f ms + stacked Hvvvv "
          "%.1f ms + the rest); observables %.3f s a step; peak device "
          "memory %.2f GB"
          % (t_prop, t_prop / RT_STEPS, rhs_s, t_ms, lam_ms, hbar_ms,
             stack_ms, obs_s, peak / 1e9))
    print("[rt] K1: %d launches over %d right-hand sides (T ladder %d, "
          "Lambda ladder %d); one T ladder %.2f ms, one Lambda ladder %.2f "
          "ms (stacking included); K1 vs the plain ladder, one right-hand "
          "side at t = %.2f: max|diff|/max|plain| = %.1e"
          % (launches, main["rhs"], main["t"], main["lambda"],
             lad_t_ms, lad_l_ms, t_end, rel_plain))
    print("[rt] mu_z(t): %s  Lagrangian(t_end) %.12f"
          % (", ".join("%s %.12f" % (k, v) for k, v in zip(keys, mz)),
             ret[keys[-1]]["ecc"].real))
    print("[rt] the phase, its checks included: %.1f s  | %s"
          % (time.perf_counter() - t_phase, smi))

    checks = [
        ("solve", cc.converged and lam.converged
         and abs(ecc - FROZEN[name][1]) < 1e-9),
        ("field-free residuals", r_free <= 10 * RT_CONV),
        ("phase", phase_gap < 1e-9),
        ("Lagrangian(0)", abs(L0 - (eref + ecc)) < 1e-9),
        ("dipole(0)", dip_gap < 1e-10),
        ("K1 vs plain", rel_plain <= 1e-12),
        ("K1 launches", main["rhs"] == 4 * RT_STEPS
         and launches == 2 * main["rhs"]
         and main["t"] == main["lambda"] == main["rhs"]),
        ("finite", finite and len(keys) == RT_STEPS + 1
         and all(np.isfinite(v) for v in mz)),
    ]
    bad = [what for what, ok in checks if not ok]
    if bad:
        raise AssertionError("[rt] checks failed: %s" % bad)
    del rt, cc, lam
    gc.collect()    # _counted_rhs's wrappers hold their rtcc in a cycle
    return {"rt_t": main["t"], "rt_lambda": main["lambda"]}


def phase_rt_frozen(wfn, smi, name=CC3_SIZE):
    """[rt]'s check against pycc_tpu's frozen trajectory, on [cc3]'s
    (H2O)_4 wavefunction: CCSD and Lambda to RT_CONV, two rk4(RT_H) steps
    under RT_PULSE, mu and the Lagrangian at t = 0.02 (1e-8)."""
    ref = FROZEN_RT[name]
    t0 = time.perf_counter()
    cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD", device=DEVICE)
    cc.solve_cc(RT_CONV, RT_CONV)
    lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
    lam.solve_lambda(RT_CONV, RT_CONV)
    rt = pycc_tpu_torch.rtcc(cc, lam, None, gaussian_laser(*RT_PULSE))
    y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    vvvv_nt.launches = 0
    y = rk4(RT_H)(rt.f, 0.0, y)
    y = rk4(RT_H)(rt.f, RT_H, y)
    launches = vvvv_nt.launches
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    mu = rt.dipole(t1, t2, l1, l2)
    lag = rt.lagrangian(2 * RT_H, t1, t2, l1, l2)
    mu_gap = max(abs(a - b) for a, b in zip(mu, ref["mu"]))
    lag_gap = abs(lag - ref["lagrangian"])
    print("[rt] %s/cc-pVDZ CCSD (no, nv) = (%d, %d), two rk4 steps: mu_z = "
          "%s |mu - pycc_tpu's frozen| = %.1e, Lagrangian %s |d| = %.1e, K1 "
          "launches %d; %.1f s with the CCSD and Lambda solves  | %s"
          % (name, cc.no, cc.nv, mu[2], mu_gap, lag, lag_gap, launches,
             time.perf_counter() - t0, smi))
    if not (mu_gap < 1e-8 and lag_gap < 1e-8 and launches == 16):
        raise AssertionError("[rt] %s missed pycc_tpu's frozen trajectory: "
                             "|mu| %.2e, |Lagrangian| %.2e, K1 launches %d"
                             % (name, mu_gap, lag_gap, launches))


# [dfrt]: real-time CCSD over [dfpost]'s factors, rk4(RT_H) steps
DFRT_STEPS = 2

# (H2O)_4/cc-pVDZ, frozen core, storage="df" (the MO ERI's Cholesky at
# df_tol 1e-8, naux 1222): mu and the Lagrangian at t = 0.02 after two
# rk4(0.01) steps under RT_PULSE, from pycc_tpu in float64 on a CPU host
# (8 cores, 5.7 min):
#   wfn = run_rhf(moldict["(H2O)_4"], "cc-pvdz", freeze_core=True)
#   cc = pycc_tpu.ccwfn(wfn, storage="df")
#   cc.solve_cc(1e-12, 1e-12)
#   lam = pycc_tpu.cclambda(cc, pycc_tpu.cchbar(cc))
#   lam.solve_lambda(1e-12, 1e-12)
#   rt = pycc_tpu.rtcc(cc, lam, None, gaussian_laser(0.01, 0, 0.01,
#                                                    center=0.05))
#   y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
#   y = rk4(0.01)(rt.f, 0.0, y); y = rk4(0.01)(rt.f, 0.01, y)
#   t1, t2, l1, l2, _ = rt.extract_amps(y)
#   rt.dipole(t1, t2, l1, l2), rt.lagrangian(0.02, t1, t2, l1, l2)
# (Ecorr -0.861900770407978, pseudo-E -0.848164207742988 there)
FROZEN_DFRT = {
    "(H2O)_4": dict(
        mu=(0.0003413604450032191 - 2.4870877397185026e-10j,
            0.0011795608312944073 + 9.027165471130334e-11j,
            -0.0005793823593332123 + 1.5843711042227774e-10j),
        lagrangian=-163.13185205274723 - 5.016430362479301e-22j),
}
DFRT_CONV = 1e-12


def _w_assembly_ms(BL, BR, nblocks):
    """ms on the card to assemble every a-block of one complex ladder's W
    as K1's B operand, [Re W; Im W] (`dfhbar.ladder_apply`'s complex
    route: `dfccsd.ladder_W`, then `stack_rows`)."""
    dt = torch.promote_types(BL.dtype, BR.dtype)
    BL, BR = BL.to(dt), BR.to(dt)
    blk = -(-BL.shape[1] // nblocks)
    total = 0.0
    for a0 in range(0, BL.shape[1], blk):
        ms, W = _event_ms(lambda: stack_rows(dfccsd.ladder_W(
            BL[:, a0:a0 + blk], BR)))
        total += ms
        del W
    return total


def phase_dfrt(post, smi, name=DF_SIZE):
    """[dfrt]: real-time CCSD at [df]'s size over its factors, on
    [dfpost]'s converged CCSD and Lambda (no new SCF, no new solve): rtcc
    under RT_PULSE for DFRT_STEPS rk4(RT_H) steps from t = 0, y on the
    card.  Checked: the field-free right-hand side at the converged state
    (max|r/D| and the quasienergy, as [rt] holds them), the Lagrangian at
    t = 0 against E_ref + Ecorr and the dipole against the ccdensity
    one-pdm's, one right-hand side through K1 against the plain ladder,
    and K1's launches in each of the two complex ladders = DFRT_BLOCKS a
    right-hand side (counted from 0 over the propagation).  Printed: the
    right-hand side split into the T side, the DF-HBAR rebuild, the W
    assembly of both ladders and the Lambda side, and the peak."""
    cc, lam, ecc = post
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    no, nv, o = cc.no, cc.nv, cc.o

    rt0 = pycc_tpu_torch.rtcc(cc, lam, None, gaussian_laser(
        0.0, *RT_PULSE[1:]))
    y0 = rt0.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    f0 = rt0.f(0.0, y0)
    r1, r2, s1, s2, dphase = rt0.extract_amps(f0)
    d1, d2 = cc.Dia, cc.Dijab
    r_free = max((r1 / d1).abs().max().item(), (r2 / d2).abs().max().item(),
                 (s1 / d1).abs().max().item(), (s2 / d2).abs().max().item())
    eref = float(2.0 * torch.trace(cc.H.F[o, o]) - rt0._loooo_tr)
    phase_gap = abs(complex(dphase) - (-1j) * (eref + ecc))
    del f0, r1, r2, s1, s2
    L0 = rt0.lagrangian(0.0, cc.t1, cc.t2, lam.l1, lam.l2)
    rt = pycc_tpu_torch.rtcc(cc, lam, None, gaussian_laser(*RT_PULSE))
    mu0 = rt.dipole(cc.t1, cc.t2, lam.l1, lam.l2)
    opdm = pycc_tpu_torch.ccdensity(cc, lam, onlyone=True).compute_onepdm(
        cc.t1, cc.t2, lam.l1, lam.l2)
    mu_dens = [float(torch.sum(m * opdm)) for m in cc.H.mu]
    dip_gap = max(abs(a - b) for a, b in zip(mu0, mu_dens))
    del opdm, rt0

    counts = _counted_rhs(rt)
    vvvv_nt.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ret = rt.propagate(rk4(RT_H), y0, RT_H * DFRT_STEPS - 1e-12)
    torch.cuda.synchronize()
    t_prop = time.perf_counter() - t0
    launches = vvvv_nt.launches
    main = dict(counts)
    peak = torch.cuda.max_memory_allocated()
    keys = sorted(ret)
    t_end = float(keys[-1])

    # at the final state: one right-hand side split by part, K1 against
    # the plain ladder, the observables' time
    y = rt.y
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    F = rt._field(t_end, y.dtype)
    f_k1, rhs_s = _synced(lambda: rt.f(t_end, y))
    t_ms, _ = _event_ms(lambda: rt.t_residuals(F, t1, t2))
    lam_ms, _ = _event_ms(lambda: rt.lambda_residuals(F, t1, t2, l1, l2))
    hbar_ms, hb = _event_ms(lambda: build_hbar_df(F, cc.dfb, t1, t2, no))
    dfb = cc.dfb
    w_t_ms = _w_assembly_ms(0.5 * dfb.Bvv - torch.einsum(
        "ma,Pme->Pae", t1, dfb.Bov.to(t1.dtype)), dfb.Bvv, DFRT_BLOCKS)
    BLl = hb.Bd_ae.transpose(1, 2)
    w_l_ms = _w_assembly_ms(BLl, BLl, DFRT_BLOCKS)
    del hb, BLl
    obs_s = _synced(lambda: rt._observables(t_end, y))[1]
    f_plain = pycc_tpu_torch.rtcc(cc, lam, None, rt.V,
                                  ladder=vvvv_nt_reference).f(t_end, y)
    rel_plain = _rel_c(f_k1, f_plain)
    finite = bool(torch.isfinite(torch.view_as_real(y)).all())
    del f_k1, f_plain, F, y, t1, t2, l1, l2
    peak_all = torch.cuda.max_memory_allocated()

    mz = [ret[k]["mu_z"].real for k in keys]
    n_obs = launches - main["t"] - main["lambda"]
    print("[dfrt] %s/aug-cc-pVDZ real-time CCSD over [dfpost]'s factors  "
          "(no, nv) = (%d, %d) naux %d, y %d complex128 (%.0f MB), "
          "gaussian_laser%s, rk4(%g) x %d  | %s"
          % (name, no, nv, cc.naux, y0.numel(), y0.numel() * 16 / 1e6,
             RT_PULSE, RT_H, DFRT_STEPS, smi))
    print("[dfrt] field-free right-hand side at the converged state: max|r/D|"
          " %.1e; |dphase/dt + i (E_ref + Ecorr)| = %.1e (E_ref = 2 tr F_oo "
          "- L_ijij = %.10f)" % (r_free, phase_gap, eref))
    print("[dfrt] t = 0: Lagrangian %.12f (E_ref + Ecorr %.12f, |d| %.1e); "
          "dipole %s, |d| from the ccdensity one-pdm dipole %.1e"
          % (L0.real, eref + ecc, abs(L0 - (eref + ecc)),
             np.round(np.array(mu0).real, 10), dip_gap))
    print("[dfrt] propagate %.2f s: %.3f s a step (4 right-hand sides and the"
          " observables); one right-hand side %.3f s: T side %.1f ms (its W "
          "assembly %.1f ms), Lambda side %.1f ms (DF-HBAR rebuild %.1f ms, "
          "its W assembly %.1f ms); observables %.3f s a step; peak device "
          "memory %.2f GB through the propagation (%.2f GB above [dfpost]'s "
          "state), %.2f GB with the checks"
          % (t_prop, t_prop / DFRT_STEPS, rhs_s, t_ms, w_t_ms, lam_ms,
             hbar_ms, w_l_ms, obs_s, peak / 1e9, (peak - base) / 1e9,
             peak_all / 1e9))
    print("[dfrt] K1: %d launches over %d right-hand sides: T ladder %d (%.0f "
          "a right-hand side), Lambda ladder %d (%.0f), the observables' "
          "density ladders %d; K1 vs the plain ladder, one right-hand side "
          "at t = %.2f: max|diff|/max|plain| = %.1e"
          % (launches, main["rhs"], main["t"], main["t"] / main["rhs"],
             main["lambda"], main["lambda"] / main["rhs"], n_obs, t_end,
             rel_plain))
    print("[dfrt] mu_z(t): %s  Lagrangian(t_end) %.12f"
          % (", ".join("%s %.12f" % (k, v) for k, v in zip(keys, mz)),
             ret[keys[-1]]["ecc"].real))
    print("[dfrt] the phase, its checks included: %.1f s  | %s"
          % (time.perf_counter() - t_phase, smi))

    checks = [
        ("field-free residuals", r_free <= 10 * RT_CONV),
        ("phase", phase_gap < 1e-9),
        ("Lagrangian(0)", abs(L0 - (eref + ecc)) < 1e-9),
        ("dipole(0)", dip_gap < 1e-10),
        ("K1 vs plain", rel_plain <= 1e-12),
        ("K1 launches", main["rhs"] == 4 * DFRT_STEPS
         and main["t"] == main["lambda"] == DFRT_BLOCKS * main["rhs"]),
        ("finite", finite and len(keys) == DFRT_STEPS + 1
         and all(np.isfinite(v) for v in mz)),
    ]
    bad = [what for what, ok in checks if not ok]
    if bad:
        raise AssertionError("[dfrt] checks failed: %s" % bad)
    del rt, cc, lam, post
    gc.collect()    # _counted_rhs's wrappers hold their rtcc in a cycle
    return {"dfrt_t": main["t"], "dfrt_lambda": main["lambda"]}


def phase_dfrt_frozen(wfn, smi, name=CC3_SIZE):
    """[dfrt]'s check against pycc_tpu's frozen trajectory on [cc3]'s
    (H2O)_4 wavefunction over factors: ccwfn(storage="df") (the MO ERI's
    Cholesky), CCSD and Lambda to DFRT_CONV, two rk4(RT_H) steps under
    RT_PULSE, mu and the Lagrangian at t = 0.02 (1e-10)."""
    ref = FROZEN_DFRT[name]
    t0 = time.perf_counter()
    cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD", storage="df", device=DEVICE)
    cc.solve_cc(DFRT_CONV, DFRT_CONV)
    lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
    lam.solve_lambda(DFRT_CONV, DFRT_CONV)
    lam.hbar = None
    rt = pycc_tpu_torch.rtcc(cc, lam, None, gaussian_laser(*RT_PULSE))
    y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    vvvv_nt.launches = 0
    y = rk4(RT_H)(rt.f, 0.0, y)
    y = rk4(RT_H)(rt.f, RT_H, y)
    launches = vvvv_nt.launches
    t1, t2, l1, l2, _ = rt.extract_amps(y)
    mu = rt.dipole(t1, t2, l1, l2)
    lag = rt.lagrangian(2 * RT_H, t1, t2, l1, l2)
    mu_gap = max(abs(a - b) for a, b in zip(mu, ref["mu"]))
    lag_gap = abs(lag - ref["lagrangian"])
    blocks = 2 * 8 * dfccsd._ladder_blocks(cc.nv, cc.naux,
                                           dfccsd.LADDER_MAX_ELEMS // 4)
    print("[dfrt] %s/cc-pVDZ DF-CCSD (no, nv) = (%d, %d) naux %d, two rk4 "
          "steps: mu_z = %s |mu - pycc_tpu's frozen| = %.1e, Lagrangian %s "
          "|d| = %.1e, K1 launches %d (want %d); %.1f s with the CCSD and "
          "Lambda solves  | %s"
          % (name, cc.no, cc.nv, cc.naux, mu[2], mu_gap, lag, lag_gap,
             launches, blocks, time.perf_counter() - t0, smi))
    if not (mu_gap < 1e-10 and lag_gap < 1e-10 and launches == blocks):
        raise AssertionError("[dfrt] %s missed pycc_tpu's frozen trajectory:"
                             " |mu| %.2e, |Lagrangian| %.2e, K1 launches %d"
                             % (name, mu_gap, lag_gap, launches))


# ---------------------------------------------------------------------------
# local correlation
# ---------------------------------------------------------------------------

# the (H2)_4 chain of tests/test_010 (angstrom)
H2_4 = """
H 0.000000 0.000000 0.000000
H 0.750000 0.000000 0.000000
H 0.000000 1.500000 0.000000
H 0.375000 1.500000 -0.649520
H 0.000000 3.000000 0.000000
H -0.375000 3.000000 -0.649520
H 0.000000 4.500000 -0.000000
H -0.750000 4.500000 -0.000000
symmetry c1
noreorient
nocom
"""

# tests/test_010's filter-path oracles (all electrons): (molecule, basis,
# ccwfn keywords, E(CCSD), Lambda pseudo-energy or None), at its 1e-7
LOCAL_ORACLES = [
    ("H2O", "cc-pvdz", dict(local="PNO", local_cutoff=1e-5, it2_opt=False),
     -0.218394869543943, -0.214461441319427),
    ("H2O", "cc-pvdz", dict(local="PNO", local_cutoff=1e-5),
     -0.221156413159672, -0.217144045119534),
    ("H2O", "cc-pvdz", dict(local="PNO++", local_cutoff=1e-7,
                            it2_opt=False),
     -0.216064367834782, -0.211938482158711),
    ("H2O", "cc-pvdz", dict(local="CPNO++", local_cutoff=1e-7,
                            it2_opt=False),
     -0.22303320613504354, -0.21890326836263854),
    ("(H2)_4", "dz", dict(local="PAO", local_cutoff=2e-2),
     -0.108914240219735, None),
    ("H2O", "6-31g", dict(local="PAO", local_cutoff=2e-2),
     -0.149361947815815, None),
]
# tests/test_013's local real-time trajectories: H2O/cc-pVDZ, all
# electrons, 25 rk4(0.02) steps under gaussian_laser(0.001, 0, 0.01,
# center=0.05), the observables at t = 0.5
LOCAL_RT = {
    ("PNO", 1e-5): {"ecc": -84.21331867940133,
                    "mu_x": -5.106207671158796e-05,
                    "mu_y": -5.001503722097678e-05,
                    "mu_z": -0.06905411053873889},
    ("PAO", 1e-2): {"ecc": -84.21540972040579,
                    "mu_x": -4.987717148832141e-05,
                    "mu_y": -4.707786986481166e-05,
                    "mu_z": -0.0783037960868978},
}

# [local]: the PNO filter path as test_010's test_pno_ccsd runs it
LOCAL_KW = dict(local="PNO", local_cutoff=1e-5, it2_opt=False)
LOCAL_CONV = 1e-10
LOCAL_PAIR_CUTOFF = 1e-4
# bytes the native solver's padded stacks may take on the card
LOCAL_STACK_MAX = 60e9
# name/cc-pVDZ, frozen core, LOCAL_KW on the filter path: E(PNO-CCSD), the
# filtered Lambda pseudo-energy and the pair dimensions' mean and maximum,
# from pycc_tpu in float64 on a CPU host (17 CCSD and 16 Lambda iterations
# at (H2O)_6, 14 GB of host memory):
#   cc = pycc_tpu.ccwfn(run_rhf(moldict[name], "cc-pvdz",
#                               freeze_core=True), local="PNO",
#                       local_cutoff=1e-5, it2_opt=False, filter=True)
#   cc.solve_cc(1e-10, 1e-10)
#   pycc_tpu.cclambda(cc, pycc_tpu.cchbar(cc)).solve_lambda(1e-10, 1e-10)
FROZEN_LOCAL = {
    "(H2O)_4": dict(e=-0.852722311287850, lam=-0.839971580869090,
                    dim_mean=3.921875, dim_max=14),
    "(H2O)_6": dict(e=-1.280241098608399, lam=-1.261002882638200,
                    dim_mean=1635 / 576, dim_max=14),
}


def _local_wfn(mol, basis):
    geom = H2_4 if mol == "(H2)_4" else moldict[mol]
    return run_rhf(geom, basis, freeze_core=False)


def _local_step(cc):
    """One filter-path iteration at cc's amplitudes: the dense residuals
    (K1 in the ladder) and the pair-space step."""
    r1, r2 = cc.residuals(cc.H.F, cc.t1, cc.t2)
    return cc.Local.filter_amps(r1, r2)


def _top_ops(prof, n=3):
    """The n operations with the most device time in a torch.profiler
    run, as (name, ms, calls); host time where the trace has no device
    time."""
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0))
        rows.append((dev, ev.self_cpu_time_total, ev.key, ev.count))
    on_dev = any(r[0] > 0 for r in rows)
    rows.sort(key=lambda r: r[0] if on_dev else r[1], reverse=True)
    return on_dev, [(k, (d if on_dev else c) / 1e3, m)
                    for d, c, k, m in rows[:n]]


def phase_local_oracles():
    """tests/test_010's filter-path oracles (K1 launches = iterations in
    CCSD and in Lambda), its native cases (native CCD/CCSD = the filter
    path, native CC2 = its dense backend, pair_cutoff = 0 = unscreened,
    a real cutoff freezing the weak pairs at MP2), test_028's DLPNO-MP2
    oracles and test_013's two local real-time trajectories (K1 launches
    in each complex ladder = right-hand sides), all on device="cuda"."""
    t0 = time.perf_counter()
    wfns = {}

    def wfn(mol, basis):
        if (mol, basis) not in wfns:
            wfns[mol, basis] = _local_wfn(mol, basis)
        return wfns[mol, basis]

    bad = []
    for mol, basis, kw, e_ref, l_ref in LOCAL_ORACLES:
        cc = pycc_tpu_torch.ccwfn(wfn(mol, basis), filter=True,
                                  device=DEVICE, **kw)
        vvvv_nt.launches = 0
        e = cc.solve_cc(1e-12, 1e-12, maxiter=100)
        k1 = vvvv_nt.launches
        line = ("[oracle] local %s %s/%s filter: E = %.12f |d| %.1e, %d "
                "iterations, %d K1 launches"
                % (kw["local"], mol, basis, e, abs(e - e_ref), cc.niter, k1))
        ok = cc.converged and abs(e - e_ref) < 1e-7 and k1 == cc.niter
        if l_ref is not None:
            lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
            vvvv_nt.launches = 0
            le = lam.solve_lambda(1e-12, 1e-12, maxiter=100)
            k1l = vvvv_nt.launches
            line += ("; Lambda %.12f |d| %.1e, %d iterations, %d K1 launches"
                     % (le, abs(le - l_ref), lam.niter, k1l))
            ok = ok and abs(le - l_ref) < 1e-7 and k1l == lam.niter
        print(line)
        if not ok:
            bad.append("%s %s/%s" % (kw["local"], mol, basis))

    # the native solvers (test_010)
    w = wfn("H2O", "cc-pvdz")
    kw = LOCAL_KW

    def native(model, **extra):
        cc = pycc_tpu_torch.ccwfn(w, model=model, device=DEVICE, **kw,
                                  **extra)
        return cc.lccwfn, cc.lccwfn.solve_lcc(1e-12, 1e-12, maxiter=100)

    gaps = {}
    for model in ("CCD", "CCSD"):
        sim = pycc_tpu_torch.ccwfn(w, model=model, filter=True, device=DEVICE,
                                   **kw)
        e_sim = sim.solve_cc(1e-12, 1e-12, maxiter=100)
        lw, e_n = native(model)
        gaps[model + " native - filter"] = (abs(e_n - e_sim), 1e-12)
        l0, e0 = native(model, pair_cutoff=0.0)
        gaps[model + " pair_cutoff=0 - unscreened"] = (
            abs(e0 - e_n), 1e-14 if model == "CCD" else 1e-12)
        if l0._pre["P"] != l0.no ** 2:
            bad.append("%s pair_cutoff=0 dropped pairs" % model)
        l3, e3 = native(model, pair_cutoff=1e-3)
        no, nv = l3.no, l3.nv
        weak = l3._pre["pidx"].reshape(-1) < 0
        QLp = l3.Local.QLp
        t2_mp2 = -(QLp.mT @ l3.H.ERI[l3.o, l3.o, l3.v, l3.v].reshape(
            no * no, nv, nv) @ QLp) / l3._Dloc
        frozen = (l3.t2[weak] - t2_mp2[weak]).abs().max().item()
        gaps[model + " weak pairs - MP2"] = (frozen, 1e-13)
        if not (l3._pre["P"] < no ** 2 and 0 < abs(e3 - e_n) < 2e-2):
            bad.append("%s pair_cutoff=1e-3: P %d, dE %.1e"
                       % (model, l3._pre["P"], e3 - e_n))
    cc = pycc_tpu_torch.ccwfn(run_rhf(moldict["H2O"], "cc-pvdz",
                                      freeze_core=True), model="CC2",
                              device=DEVICE, local="PNO", local_cutoff=1e-5)
    e_n = cc.lccwfn.solve_lcc(1e-10, 1e-10)
    cc = pycc_tpu_torch.ccwfn(cc.ref, model="CC2", device=DEVICE,
                              local="PNO", local_cutoff=1e-5)
    cc.lccwfn._use_local_eqs = False
    e_d = cc.lccwfn.solve_lcc(1e-10, 1e-10)
    gaps["CC2 native - dense backend"] = (abs(e_n - e_d), 1e-12)
    print("[oracle] local native (test_010): %s" % ", ".join(
        "%s %.1e (< %.0e)" % (k, v, t) for k, (v, t) in gaps.items()))
    bad += [k for k, (v, t) in gaps.items() if not v < t]

    # DLPNO-MP2 (test_028)
    sto = wfn("H2O", "sto-3g")

    def lo(cutoff, kind="PNO"):
        return pycc_tpu_torch.ccwfn(sto, local=kind, local_cutoff=cutoff,
                                    it2_opt=False, filter=True,
                                    device=DEVICE).Local

    def mp2(l):
        return (l.local_mp2(e_conv=1e-12, r_conv=1e-10),
                l.sim_mp2(e_conv=1e-12, r_conv=1e-10)[0])

    l0 = lo(0.0)
    l0.it2_opt = True
    t2h = l0._mp2_t2()
    no, nv = l0.no, l0.nv
    Lh = l0.H.L[:no, :no, no:, no:].cpu().numpy()
    (e0, ep0, _), _ = mp2(l0)
    e_hyl = float(np.einsum("ijab,ijab->", t2h, Lh))
    ep_hyl = np.einsum("ijab,ijab->ij", t2h, Lh)
    (e6, ep6, _), s6 = mp2(lo(1e-6))
    (ea, _, _), sa = mp2(lo(0.02, "PAO"))
    (epp, eppp, _), spp = mp2(lo(1e-7, "PNO++"))
    (efull, _, _), _ = mp2(lo(0.0, "PNO++"))
    mp2_checks = {
        "complete space = Hylleraas": abs(e0 - e_hyl) < 1e-10
        and abs(float(ep0.sum()) - e0) < 1e-12,
        "pair energies = Hylleraas": np.abs(ep0 - ep_hyl).max() < 1e-10,
        "PNO local = sim": abs(e6 - s6) < 1e-10
        and np.abs(ep6 - ep6.T).max() < 1e-10,
        "PAO local = sim": abs(ea - sa) < 1e-10,
        "PNO++ local = sim, recovery": abs(epp - spp) < 1e-10
        and abs(epp) < abs(efull) + 1e-12
        and abs(epp - efull) < 0.02 * abs(efull),
    }
    print("[oracle] local MP2 (test_028): E(complete) %.12f - Hylleraas "
          "%.1e; PNO 1e-6 local - sim %.1e; PAO %.1e; PNO++ %.1e; %s"
          % (e0, e0 - e_hyl, e6 - s6, ea - sa, epp - spp,
             "all hold" if all(mp2_checks.values()) else mp2_checks))
    bad += [k for k, ok in mp2_checks.items() if not ok]

    # local real-time CC (test_013)
    rt_counts = {"rhs": 0, "t": 0, "lambda": 0}
    for (local, cutoff), ref in LOCAL_RT.items():
        cc, lam, dens = _rt_pipeline_local(w, local, cutoff)
        rt = pycc_tpu_torch.rtcc(cc, lam, dens, gaussian_laser(
            0.001, 0, 0.01, center=0.05))
        counts = _counted_rhs(rt)
        y0 = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
        vvvv_nt.launches = 0
        ret = rt.propagate(rk4(0.02), y0, 0.5, ti=0)
        k1 = vvvv_nt.launches
        r = ret["0.50"]
        gap = max(abs(complex(r[k]).real - v) for k, v in ref.items())
        print("[oracle] local RT %s (test_013): 25 rk4 steps, %d right-hand "
              "sides, K1 %d launches (T %d, Lambda %d); |observables - "
              "frozen| %.1e" % (local, counts["rhs"], k1, counts["t"],
                                counts["lambda"], gap))
        if not (gap < 1e-8 and counts["rhs"] == 100 and k1 == 200
                and counts["t"] == counts["lambda"] == 100):
            bad.append("RT %s" % local)
        for key in rt_counts:
            rt_counts[key] += counts[key]
        del rt
        gc.collect()    # _counted_rhs's wrappers hold their rtcc in a cycle
    print("[oracle] local correlation oracles %.1f s" % (time.perf_counter()
                                                       - t0))
    if bad:
        raise AssertionError("[oracle] local checks failed: %s" % bad)
    return {"local_rt_t": rt_counts["t"],
            "local_rt_lambda": rt_counts["lambda"]}


def _rt_pipeline_local(wfn, local, cutoff, conv=1e-13):
    """A converged local (filter path) ccwfn on the card, its Lambda and
    ccdensity, as tests/test_013 builds them."""
    cc = pycc_tpu_torch.ccwfn(wfn, local=local, local_cutoff=cutoff,
                              filter=True, device=DEVICE)
    cc.solve_cc(conv, conv, 200)
    lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
    lam.solve_lambda(conv, conv)
    return cc, lam, pycc_tpu_torch.ccdensity(cc, lam)


def _local_stack_bytes(no, D):
    """Bytes of lccwfn_local.precompute_ccsd's stacks in float64, reckoned
    from the pair dimension D (Local.D2) before any is made: the o^4 D^2
    pair-pair ones (Sp and its kin: TL, BE, XE, XL, XE2, XE3, TLnn, TE2,
    XEjj, XE5, XE6), the o^3 D^3 ones (TLm, EovvvP, Eovvv_iijj, TE_mbe,
    TE_bFe, TE_bFe_mj) and the o^2 D^4 ladders (VV, VV2)."""
    return 8 * (12 * no ** 4 * D ** 2 + 6 * no ** 3 * D ** 3
                + 2 * no ** 2 * D ** 4)


def _native_local(wfn, dim, pair_cutoff=None):
    """The native pair-space CCSD through the entry point a user calls,
    ccwfn(..., filter=False, pair_cutoff=) -> .lccwfn, its set-up timed
    (localization, H, pair spaces and the solver's precompute); its pair
    dimensions held equal to the filter run's (dim), so that both solve
    in the same spaces."""
    nat, t_pre = _synced(lambda: pycc_tpu_torch.ccwfn(
        wfn, model="CCSD", filter=False, pair_cutoff=pair_cutoff,
        device=DEVICE, **LOCAL_KW))
    if not np.array_equal(np.asarray(nat.Local.dim), dim):
        raise AssertionError("[local] the native run's pair dimensions "
                             "differ from the filter run's")
    return nat.lccwfn, t_pre


def phase_local(real, smi, name=REAL_SIZE):
    """[local] at [real]'s size on its wavefunction (no second SCF): the
    PNO filter path (LOCAL_KW) through ccwfn -> solve_cc -> cchbar ->
    cclambda, each step timed, E(PNO-CCSD), the Lambda pseudo-energy and
    the pair dimensions held to pycc_tpu's frozen values, K1 launches =
    iterations in CCSD and in Lambda, one filter iteration traced; then
    the native pair-space CCSD through ccwfn(filter=False) in the same
    pair spaces, its energy held to the filter path's."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cc, t_init = _synced(lambda: pycc_tpu_torch.ccwfn(
        real["wfn"], model="CCSD", filter=True, device=DEVICE, **LOCAL_KW))
    tm = cc.timers.total
    vvvv_nt.launches = 0
    ecc, t_solve = _synced(lambda: cc.solve_cc(LOCAL_CONV, LOCAL_CONV))
    k1_cc = vvvv_nt.launches
    s_iter = tm["ccwfn.iteration"] / cc.niter
    hb, t_hbar = _synced(lambda: pycc_tpu_torch.cchbar(cc))
    lam = pycc_tpu_torch.cclambda(cc, hb)
    vvvv_nt.launches = 0
    lecc, t_lam = _synced(lambda: lam.solve_lambda(LOCAL_CONV, LOCAL_CONV))
    k1_lam = vvvv_nt.launches
    l_niter = lam.niter
    l_iter = tm["lambda.iteration"] / l_niter
    peak = torch.cuda.max_memory_allocated()
    del hb, lam
    lo = cc.Local
    dim = np.asarray(lo.dim)

    # one filter iteration under torch.profiler
    _local_step(cc)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            _local_step(cc)
            torch.cuda.synchronize()
        on_dev, top = _top_ops(prof)
    step_ms, _ = _event_ms(lambda: _local_step(cc))

    # the native pair-space CCSD through ccwfn(filter=False) on the same
    # wavefunction and pair spaces
    no, nv, D1, D2 = cc.no, cc.nv, lo.D1, lo.D2
    niter, converged = cc.niter, cc.converged
    del cc, lo
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lw, t_pre = _native_local(real["wfn"], dim)
    e_nat, t_nat = _synced(lambda: lw.solve_lcc(LOCAL_CONV, LOCAL_CONV))
    n_nat = lw.niter
    peak_nat = torch.cuda.max_memory_allocated()
    reckoned = _local_stack_bytes(no, D2)
    del lw

    print("[local] %s/cc-pVDZ PNO-CCSD filter path  (no, nv) = (%d, %d), "
          "%s  | %s" % (name, no, nv, LOCAL_KW, smi))
    print("[local] ccwfn init %.1f s: localize (Pipek-Mezey, host) %.2f s, "
          "H rebuild %.2f s, Local (PNO spaces, host eigh) %.2f s; pair "
          "dimension mean %.4f max %d (D1, D2) = (%d, %d)"
          % (t_init, tm["ccwfn.localize"], tm["ccwfn.hamiltonian"],
             tm["ccwfn.local"], dim.mean(), dim.max(), D1, D2))
    print("[local] CCSD %.2f s, %d iterations, %.4f s/iter, K1 %d launches;"
          " HBAR %.2f s; Lambda %.2f s, %d iterations, %.4f s/iter, K1 %d "
          "launches; peak device memory %.2f GB"
          % (t_solve, niter, s_iter, k1_cc, t_hbar, t_lam, l_niter,
             l_iter, k1_lam, peak / 1e9))
    ref = FROZEN_LOCAL[name]
    print("[local] E(PNO-CCSD) = %.12f |d| from pycc_tpu's frozen %.1e; "
          "Lambda pseudo-E = %.12f |d| %.1e; pair dimension mean %.10f max "
          "%d (frozen %.10f, %d)"
          % (ecc, abs(ecc - ref["e"]), lecc, abs(lecc - ref["lam"]),
             dim.mean(), dim.max(), ref["dim_mean"], ref["dim_max"]))
    print("[local] one filter iteration %.2f ms (residual + filter); its "
          "torch.profiler trace, the three longest operations by %s time: "
          "%s" % (step_ms, "device" if on_dev else "host",
                  "; ".join("%s %.2f ms x%d" % t for t in top)))
    print("[local] native pair-space CCSD on the same spaces, through "
          "ccwfn(filter=False): set-up %.2f s (stacks reckoned %.3f GB), "
          "solve %.2f s (%d iterations, %.4f s/iter), peak %.2f GB; "
          "E = %.12f, |native - filter| = %.1e"
          % (t_pre, reckoned / 1e9, t_nat, n_nat, t_nat / n_nat,
             peak_nat / 1e9, e_nat, abs(e_nat - ecc)))
    print("[local] the phase, its checks included: %.1f s  | %s"
          % (time.perf_counter() - t_phase, smi))
    checks = [
        ("converged", converged),
        ("K1 launches", k1_cc == niter and k1_lam == l_niter),
        ("native = filter", abs(e_nat - ecc) < 1e-9),
        ("frozen E", abs(ecc - ref["e"]) < 1e-9),
        ("frozen Lambda", abs(lecc - ref["lam"]) < 1e-9),
        ("dimensions", abs(dim.mean() - ref["dim_mean"]) < 1e-12
         and dim.max() == ref["dim_max"]),
    ]
    bad = [what for what, ok in checks if not ok]
    if bad:
        raise AssertionError("[local] checks failed: %s" % bad)
    native = dict(e=e_nat, s_iter=t_nat / n_nat, niter=n_nat, peak=peak_nat,
                  dim=dim)
    return {"local_ccsd": k1_cc, "local_lambda": k1_lam}, native


def phase_local_native(wfn, smi, name=CC3_SIZE):
    """[local] on [cc3]'s wavefunction (no second SCF): the filter path
    against pycc_tpu's frozen E(PNO-CCSD), Lambda pseudo-energy and pair
    dimensions; the padded stacks' bytes reckoned from D2 before the
    native solver makes them; then the native pair-space CCSD (= the
    filter path), pair_cutoff = 0 (= unscreened, every pair strong) and
    pair_cutoff = LOCAL_PAIR_CUTOFF (fewer pairs, E within 1e-3)."""
    ref = FROZEN_LOCAL[name]
    t_phase = time.perf_counter()
    cc, t_init = _synced(lambda: pycc_tpu_torch.ccwfn(
        wfn, model="CCSD", filter=True, device=DEVICE, **LOCAL_KW))
    vvvv_nt.launches = 0
    ecc, t_solve = _synced(lambda: cc.solve_cc(LOCAL_CONV, LOCAL_CONV))
    k1 = vvvv_nt.launches
    lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
    lecc = lam.solve_lambda(LOCAL_CONV, LOCAL_CONV)
    del lam
    lo = cc.Local
    dim = np.asarray(lo.dim)
    no, D = cc.no, lo.D2
    reckoned = _local_stack_bytes(no, D)
    if not reckoned < LOCAL_STACK_MAX:
        raise AssertionError("[local] the native stacks at %s would take "
                             "%.1f GB" % (name, reckoned / 1e9))
    runs = {}
    for cut in (None, 0.0, LOCAL_PAIR_CUTOFF):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lw, t_pre = _native_local(wfn, dim, cut)
        e, t = _synced(lambda: lw.solve_lcc(LOCAL_CONV, LOCAL_CONV))
        P = no * no if cut is None else lw._pre["P"]
        runs[cut] = dict(e=e, pre=t_pre, s_iter=t / lw.niter, niter=lw.niter,
                         P=P, peak=torch.cuda.max_memory_allocated())
        del lw
    print("[local] %s/cc-pVDZ PNO (no, nv) = (%d, %d): filter path init "
          "%.1f s, CCSD %.2f s (%d iterations, K1 %d launches) E = %.12f "
          "|d| from pycc_tpu's frozen %.1e; Lambda pseudo-E = %.12f |d| "
          "%.1e; pair dimension mean %.6f max %d (frozen %.6f, %d); (D1, D2)"
          " = (%d, %d)" % (name, no, cc.nv, t_init, t_solve, cc.niter, k1,
                           ecc, abs(ecc - ref["e"]), lecc,
                           abs(lecc - ref["lam"]), dim.mean(), dim.max(),
                           ref["dim_mean"], ref["dim_max"], lo.D1, D))
    print("[local] native stacks reckoned from D2 = %d: %.3f GB (o^4 D^2 "
          "%.3f, o^3 D^3 %.3f, o^2 D^4 %.3f GB each; limit %.0f GB)"
          % (D, reckoned / 1e9, 8 * no ** 4 * D ** 2 / 1e9,
             8 * no ** 3 * D ** 3 / 1e9, 8 * no ** 2 * D ** 4 / 1e9,
             LOCAL_STACK_MAX / 1e9))
    for cut, r in runs.items():
        print("[local] native CCSD pair_cutoff=%s: P = %d of %d pairs, "
              "set-up %.2f s, %d iterations, %.4f s/iter, peak %.3f GB, "
              "E = %.12f, |E - filter| = %.1e"
              % (cut, r["P"], no * no, r["pre"], r["niter"], r["s_iter"],
                 r["peak"] / 1e9, r["e"], abs(r["e"] - ecc)))
    print("[local] %s, its checks included: %.1f s  | %s"
          % (name, time.perf_counter() - t_phase, smi))
    e0, e_pc = runs[None]["e"], runs[LOCAL_PAIR_CUTOFF]["e"]
    checks = [
        ("frozen E", cc.converged and abs(ecc - ref["e"]) < 1e-9),
        ("frozen Lambda", abs(lecc - ref["lam"]) < 1e-9),
        ("dimensions", abs(dim.mean() - ref["dim_mean"]) < 1e-12
         and dim.max() == ref["dim_max"]),
        ("K1 launches", k1 == cc.niter),
        ("native = filter", abs(e0 - ecc) < 1e-9),
        ("pair_cutoff=0", runs[0.0]["P"] == no * no
         and abs(runs[0.0]["e"] - e0) < 1e-12),
        ("pair_cutoff", runs[LOCAL_PAIR_CUTOFF]["P"] < no * no
         and abs(e_pc - e0) < 1e-3),
    ]
    bad = [what for what, ok in checks if not ok]
    if bad:
        raise AssertionError("[local] %s checks failed: %s" % (name, bad))
    return dict(runs[LOCAL_PAIR_CUTOFF], dim=dim)


def _mesh_devices():
    """The [mesh] grid's devices: cuda:(i % n) for the four cells over the
    n visible cards, so on one card the four shards share cuda:0."""
    n = torch.cuda.device_count()
    return ["cuda:%d" % (i % n) for i in range(MESH_SHAPE[0] * MESH_SHAPE[1])]


def _check_init_peak(what, grew, stored, largest):
    """A mesh solver's integrals are cut into their pieces from host
    memory: what its init adds to the home card's peak is what the card
    then holds (every piece, on one card) and a few o^2 v^2 transients of
    the MP2 guess, never the largest sharded operand whole on top of its
    pieces (`largest`: that operand's bytes)."""
    held = stored.get(str(torch.device(DEVICE)), 0)
    print("[mesh] %s init: the home card's peak rose %.3f GB; it holds %.3f "
          "GB of storage (the largest sharded operand whole: %.3f GB)"
          % (what, grew / 1e9, held / 1e9, largest / 1e9))
    if grew > held + largest:
        raise AssertionError("[mesh] %s init peaked %.3f GB above the %.3f "
                             "GB it keeps" % (what, grew / 1e9, held / 1e9))


def _mesh_native_local(wfn, ref, smi, name, pair_cutoff=None):
    """The native pair-space CCSD over a MESH_SHAPE mesh through the entry
    point a user calls, ccwfn(local=, filter=False, pair_cutoff=, mesh=)
    -> .lccwfn: its stacks cut over the mesh, its energy held to [local]'s
    unsharded native run (ref) at 1e-11, its pair dimensions to [local]'s.
    Returns the printed numbers."""
    from pycc_tpu_torch.parallel import Sharded, make_mesh
    mesh = make_mesh(devices=_mesh_devices(), shape=MESH_SHAPE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    nat, t_pre = _synced(lambda: pycc_tpu_torch.ccwfn(
        wfn, model="CCSD", filter=False, pair_cutoff=pair_cutoff,
        device=DEVICE, mesh=mesh, **LOCAL_KW))
    if not np.array_equal(np.asarray(nat.Local.dim), ref["dim"]):
        raise AssertionError("[mesh] the native run's pair dimensions "
                             "differ from [local]'s")
    lw = nat.lccwfn
    cut = {k: x for k, x in lw._pre.items() if isinstance(x, Sharded)}
    whole = sum(x.numel() * x.element_size() for x in cut.values())
    cells = sorted(next(iter(cut.values())).pieces)
    a_cell = max(sum(x.cell_bytes()[c] for x in cut.values()) for c in cells)
    big = max(cut, key=lambda k: cut[k].numel())
    big_cell = max(cut[big].cell_bytes().values())
    mesh.gathered_bytes = 0
    e, t = _synced(lambda: lw.solve_lcc(LOCAL_CONV, LOCAL_CONV))
    s_iter = t / lw.niter
    peak = torch.cuda.max_memory_allocated()
    gathered = mesh.gathered_bytes / lw.niter
    P = lw._pre["P"] if pair_cutoff is not None else lw.no ** 2
    print("[mesh] %s native PNO-CCSD on the mesh (pair_cutoff=%s, P = %d of "
          "%d pairs): %d stacks cut, %.3f GB whole, %.3f GB on the largest "
          "cell (%.0f%%); the largest, %s (%s), %.3f GB whole, %.3f GB a "
          "cell; set-up %.2f s; %d iterations, %.4f s/iter ([local]'s "
          "unsharded %.4f); %.3f GB gathered onto the home device an "
          "iteration; peak %.2f GB; E = %.12f |d[local]| = %.1e  | %s"
          % (name, pair_cutoff, P, lw.no ** 2, len(cut), whole / 1e9,
             a_cell / 1e9, 100.0 * a_cell / whole, big, cut[big].spec[:2],
             cut[big].numel() * cut[big].element_size() / 1e9,
             big_cell / 1e9, t_pre, lw.niter, s_iter, ref["s_iter"],
             gathered / 1e9, peak / 1e9, e, abs(e - ref["e"]), smi))
    if not abs(e - ref["e"]) < 1e-11:
        raise AssertionError("[mesh] %s native local E %.12f missed [local]'s"
                             " %.12f" % (name, e, ref["e"]))
    del lw, nat
    gc.collect()
    torch.cuda.empty_cache()
    return dict(e=e, s_iter=s_iter, whole=whole, a_cell=a_cell, peak=peak)


def phase_mesh(wfn, real_e, post_ref, factors, df_ref, local_ref, smi,
               name=REAL_SIZE):
    """[mesh]: the sharded paths at full width on [real]'s wavefunction and
    [df]'s factors (no new SCF).  (H2O)_6/cc-pVDZ CCSD(T) through
    ccwfn(mesh=) on full storage (E(CCSD) and E(T) held to [real]'s at
    1e-11, K1 one launch a shard an iteration, K2 on slices assembled from
    the shards), the (T) density, HBAR and Lambda (held to [post]'s
    pseudo-energy at 1e-10) and 3 EOM roots from the CIS guess (held to
    [post]'s at 1e-7); one sharded ladder timed against one launch on the
    whole W and held to the plain ladder; then DF-CCSD at (24, 216) through
    from_df_factors(mesh=) (held to [df]'s E(CCSD) at 1e-10, K1 one launch
    an a-block a shard); each init's peak through `_check_init_peak`.
    Each caller's K1 launches are counted from 0.  Last, the native local
    solver over the mesh (`_mesh_native_local`): (H2O)_6 PNO CCSD on
    [real]'s wavefunction and (H2O)_4 at pair_cutoff LOCAL_PAIR_CUTOFF on
    [cc3]'s (local_ref: that wavefunction and [local]'s two native runs),
    each held to [local]'s unsharded energy at 1e-11."""
    from pycc_tpu_torch.parallel import device_bytes, make_mesh
    devices = _mesh_devices()
    mesh = make_mesh(devices=devices, shape=MESH_SHAPE)
    print("[mesh] devices %s  distinct %d  shape %s%s  | %s"
          % (devices, len(mesh.distinct), mesh.shape,
             "  (one card: the four shards share cuda:0)"
             if len(mesh.distinct) == 1 else "", smi))
    eccsd_ref, et_ref = real_e
    lecc_ref, roots_ref = post_ref
    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cc, t_init = _synced(lambda: pycc_tpu_torch.ccwfn(
        wfn, model="CCSD(T)", device=DEVICE, mesh=mesh))
    init_grew = torch.cuda.max_memory_allocated() - base
    no = cc.no
    stored = device_bytes(cc.H)
    _check_init_peak("full storage", init_grew, stored,
                     cc.H.ERI.numel() * cc.H.ERI.element_size())
    shard_bytes = [sum(s.cell_bytes()[c] for s in (cc.H.ERI, cc.H.L,
                                                   cc.vvvv()))
                   for c in sorted(cc.H.ERI.pieces)]
    vvvv_nt.launches = 0
    t_energy_row.launches = 0
    mesh.gathered_bytes = 0
    e, t_solve = _solve(cc, 1e-10, 1e-10)
    launches = {"vvvv_nt": vvvv_nt.launches, "t_row": t_energy_row.launches}
    niter, converged = cc.niter, cc.converged
    gathered = mesh.gathered_bytes
    t_t = cc.timers.total["ccwfn.triples"]
    eccsd = float(cc.cc_energy(cc.t1, cc.t2))
    et = e - eccsd
    peak_cc = torch.cuda.max_memory_allocated()

    # one sharded ladder against one launch on the whole W, and the plain
    tau = build_tau(cc.t1, cc.t2)
    W = cc.vvvv()
    Wfull = W.full()
    lad = vvvv_contract(tau, W)
    rel_lad = ((lad - vvvv_contract(tau, W, vvvv_nt_reference)).abs().max()
               / lad.abs().max()).item()
    same = (lad - vvvv_contract(tau, Wfull)).abs().max().item()
    shard_ms = _median_ms(lambda: vvvv_contract(tau, W))
    one_ms = _median_ms(lambda: vvvv_contract(tau, Wfull))
    del Wfull, lad, tau, W

    et_d, t_dens = _synced(lambda: float(cc.t3_density()))
    hb, t_hbar = _synced(lambda: pycc_tpu_torch.cchbar(cc))
    lam = pycc_tpu_torch.cclambda(cc, hb)
    (lecc, t_lam), lam_launches = _launched(lambda: _synced(
        lambda: lam.solve_lambda(1e-10, 1e-10)))
    lam_ok, lam_iters = lam.converged, lam.niter
    eom = pycc_tpu_torch.cceom(hb)
    n_sigma0 = cc.timers.count["eom.sigma"]
    ((E, C), t_eom), eom_launches = _launched(lambda: _synced(
        lambda: eom.solve_eom(N=EOM_ROOTS, e_conv=1e-8, r_conv=1e-6,
                              guess="CIS")))
    eom_ok, eom_iters = eom.converged, eom.niter
    n_sigma = cc.timers.count["eom.sigma"] - n_sigma0
    peak = torch.cuda.max_memory_allocated()
    del eom, C, lam, hb, cc
    torch.cuda.empty_cache()
    droots = float(np.abs(np.asarray(E) - np.asarray(roots_ref)).max())

    print("[mesh] %s/cc-pVDZ CCSD(T) on the mesh: init %.1f s (stored %s "
          "GB; a shard's ERI + L + W %s GB)  CCSD %.1f s  %d iterations  "
          "%.3f s/iter  (T) %.1f s  K1 launches %d (%.2f a shard an "
          "iteration)  K2 launches %d  gathered onto the home device %.2f "
          "GB an iteration  peak %.2f GB"
          % (name, t_init, {d: round(b / 1e9, 3) for d, b in stored.items()},
             [round(b / 1e9, 3) for b in shard_bytes], t_solve - t_t, niter,
             (t_solve - t_t) / niter, t_t, launches["vvvv_nt"],
             launches["vvvv_nt"] / (mesh.size * niter), launches["t_row"],
             gathered / (niter + 1) / 1e9, peak_cc / 1e9))
    print("[mesh] Ecorr(CCSD) = %.12f  |d[real]| = %.2e  E(T) = %.12f  "
          "|d[real]| = %.2e" % (eccsd, abs(eccsd - eccsd_ref), et,
                                abs(et - et_ref)))
    print("[mesh] one ladder: %d shards %.3f ms vs one K1 launch on the whole "
          "W %.3f ms; max|sharded - whole| = %.2e, vs the plain ladder rel "
          "%.2e  | %s" % (mesh.size, shard_ms, one_ms, same, rel_lad, smi))
    print("[mesh] (T) density %.1f s (E(T) |d K2's| = %.2e)  HBAR %.2f s  "
          "Lambda %.2f s %d iterations pseudo-E = %.12f |d[post]| = %.2e  K1 "
          "launches %d  EOM %d roots (CIS guess) %.1f s %d iterations, %d "
          "sigma blocks, K1 launches %d, |d[post]| = %.2e  peak %.2f GB  "
          "full-storage part %.1f s"
          % (t_dens, abs(et_d - et), t_hbar, t_lam, lam_iters, lecc,
             abs(lecc - lecc_ref), lam_launches, EOM_ROOTS, t_eom, eom_iters,
             n_sigma, eom_launches, droots, peak / 1e9,
             time.perf_counter() - t_phase))

    if not (converged and abs(eccsd - eccsd_ref) < 1e-11
            and abs(et - et_ref) < 1e-11):
        raise AssertionError("[mesh] CCSD(T) missed [real]'s")
    if (launches["vvvv_nt"] != mesh.size * niter
            or launches["t_row"] != no):
        raise AssertionError("[mesh] %d K1 launches in %d iterations of %d "
                             "shards, %d K2 launches"
                             % (launches["vvvv_nt"], niter, mesh.size,
                                launches["t_row"]))
    if not (same == 0.0 and rel_lad < 1e-12):
        raise AssertionError("[mesh] the sharded ladder differs from one "
                             "launch (%.2e) or the plain one (%.2e)"
                             % (same, rel_lad))
    if not (abs(et_d - et) < 1e-10 and lam_ok
            and abs(lecc - lecc_ref) < 1e-10
            and lam_launches == mesh.size * lam_iters):
        raise AssertionError("[mesh] the (T) density or Lambda missed, or %d "
                             "K1 launches in %d Lambda iterations"
                             % (lam_launches, lam_iters))
    if not (eom_ok and droots < 1e-7
            and eom_launches == mesh.size * n_sigma):
        raise AssertionError("[mesh] EOM roots %s vs [post]'s %s, %d K1 "
                             "launches for %d sigma blocks"
                             % (E, roots_ref, eom_launches, n_sigma))

    # DF-CCSD at (24, 216) on [df]'s factors, Bvv over the mesh
    B, F, _, no, escf = factors
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    dmesh = make_mesh(devices=devices, shape=MESH_SHAPE)
    base = torch.cuda.memory_allocated()
    dcc, t_dinit = _synced(lambda: pycc_tpu_torch.ccwfn.from_df_factors(
        B, F, no, escf=escf, model="CCSD", device=DEVICE, mesh=dmesh))
    _check_init_peak("DF", torch.cuda.max_memory_allocated() - base,
                     device_bytes(dcc.dfb, dcc.H, dcc.t2, dcc.Dijab),
                     dcc.dfb.Bvv.numel() * dcc.dfb.Bvv.element_size())
    bvv = dcc.dfb.Bvv.cell_bytes()
    vvvv_nt.launches = 0
    de, t_dsolve = _solve(dcc, 1e-10, 1e-10)
    df_launches = vvvv_nt.launches
    dn, d_ok = dcc.niter, dcc.converged
    per_iter = dmesh.size * MESH_DF_BLOCKS
    d_peak = torch.cuda.max_memory_allocated()
    del dcc
    torch.cuda.empty_cache()
    print("[mesh] %s/aug-cc-pVDZ DF-CCSD on the mesh (from_df_factors): init "
          "%.1f s (Bvv a shard %s GB)  solve %.1f s  %d iterations  %.3f "
          "s/iter (the unsharded [df]: %.3f)  K1 launches %d (%d an "
          "iteration: %d a-blocks a shard)  Ecorr = %.12f  |d[df]| = %.2e  "
          "peak %.2f GB  DF part %.1f s  | %s"
          % (name, t_dinit, [round(b / 1e9, 3) for b in bvv.values()],
             t_dsolve, dn, t_dsolve / dn, df_ref["s_iter"], df_launches,
             per_iter, MESH_DF_BLOCKS, de, abs(de - df_ref["eccsd"]),
             d_peak / 1e9, time.perf_counter() - t0, smi))
    if not (d_ok and abs(de - df_ref["eccsd"]) < 1e-10):
        raise AssertionError("[mesh] DF-CCSD missed [df]'s")
    if df_launches != per_iter * dn:
        raise AssertionError("[mesh] DF: %d K1 launches in %d iterations of "
                             "%d" % (df_launches, dn, per_iter))

    # the native local solver over the mesh
    wfn4, native6, native4 = local_ref
    t0 = time.perf_counter()
    _mesh_native_local(wfn, native6, smi, name)
    _mesh_native_local(wfn4, native4, smi, CC3_SIZE, LOCAL_PAIR_CUTOFF)
    print("[mesh] native local part %.1f s" % (time.perf_counter() - t0))
    print("[mesh] phase %.1f s" % (time.perf_counter() - t_phase))
    return {"mesh": launches["vvvv_nt"], "mesh_t_row": launches["t_row"],
            "mesh_lambda": lam_launches, "mesh_eom": eom_launches,
            "mesh_df": df_launches}


def _kernel_entries(k1_cells, k2_cells, full, post, resp, cc3_, df, dfpost,
                    mixed, rt, local, mesh, dfrt):
    """The kernels line: each kernel on each path, with that path's
    launches and the timed cell at the shape the path launches it at."""
    k1 = dict(route="cuda", source="pycc_tpu_torch/csrc/vvvv_nt.cu",
              replaces="pycc_tpu/ops/kernels/vvvv.py:38")
    k2 = dict(route="cuda", source="pycc_tpu_torch/csrc/t_row.cu",
              replaces="pycc_tpu/ops/kernels/triples.py:170")
    return [
        dict(name="vvvv_nt", **k1, launches=full["vvvv_nt"],
             **k1_cells[K1_FULL_SHAPE, "f64"]),
        dict(name="t_row", **k2, launches=full["t_row"],
             **k2_cells[(24, 114), "f64"]),
        dict(name="t_row/bf16", **k2, launches=full["t_row_bf16"],
             **k2_cells[(24, 114), "bf16->f32"]),
        dict(name="vvvv_nt/lambda", **k1, launches=post["lambda"],
             **k1_cells[K1_FULL_SHAPE, "f64"]),
        dict(name="vvvv_nt/eom", **k1, launches=post["eom"],
             **k1_cells[K1_EOM_SHAPE, "f64"]),
        dict(name="vvvv_nt/response", **k1, launches=resp["response"],
             **k1_cells[K1_FULL_SHAPE, "f64"]),
        dict(name="vvvv_nt/response_complex", **k1,
             launches=resp["response_complex"],
             **k1_cells[K1_RESP_SHAPE, "f64"]),
        dict(name="vvvv_nt/cc3", **k1, launches=cc3_["cc3"],
             **k1_cells[K1_CC3_SHAPE, "f64"]),
        dict(name="vvvv_nt/cc3_lambda", **k1, launches=cc3_["cc3_lambda"],
             **k1_cells[K1_CC3_SHAPE, "f64"]),
        dict(name="vvvv_nt/ladder_df", **k1, launches=df["vvvv_nt"],
             **k1_cells[K1_DF_SHAPE, "f64"]),
        dict(name="t_row/df_slices", **k2, launches=df["t_row"],
             **k2_cells[(DF_NO, DF_NV), "f64"]),
        dict(name="vvvv_nt/df_lambda", **k1, launches=dfpost["lambda"],
             **k1_cells[K1_DF_SHAPE, "f64"]),
        dict(name="vvvv_nt/df_eom", **k1, launches=dfpost["eom"],
             **k1_cells[K1_DF_EOM_SHAPE, "f64"]),
        dict(name="vvvv_nt/df_density", **k1, launches=dfpost["density"],
             **k1_cells[K1_DF_SHAPE, "f64"]),
        dict(name="vvvv_nt/df_response", **k1, launches=dfpost["response"],
             **k1_cells[K1_DF_SHAPE, "f64"]),
        dict(name="vvvv_nt/blocked_bf16", **k1, launches=mixed["bf16"],
             **k1_cells[K1_FULL_SHAPE, "bf16->f32"]),
        dict(name="vvvv_nt/blocked_f32", **k1, launches=mixed["f32"],
             **k1_cells[K1_FULL_SHAPE, "f32"]),
        dict(name="vvvv_nt/blocked_f64", **k1, launches=mixed["f64"],
             **k1_cells[K1_FULL_SHAPE, "f64"]),
        dict(name="vvvv_nt/df_bf16", **k1, launches=dfpost["ccsd_bf16"],
             **k1_cells[K1_DF_SHAPE, "bf16->f32"]),
        dict(name="vvvv_nt/df_f32", **k1, launches=dfpost["ccsd_f32"],
             **k1_cells[K1_DF_SHAPE, "f32"]),
        dict(name="vvvv_nt/mixed_post", **k1, launches=mixed["post"],
             **k1_cells[K1_FULL_SHAPE, "f32"]),
        dict(name="t_row/blocked", **k2, launches=mixed["t_row"],
             **k2_cells[(24, 114), "f64"]),
        dict(name="vvvv_nt/rt_t", **k1, launches=rt["rt_t"],
             **k1_cells[K1_RESP_SHAPE, "f64"]),
        dict(name="vvvv_nt/rt_lambda", **k1, launches=rt["rt_lambda"],
             **k1_cells[K1_RT_SHAPE, "f64"]),
        dict(name="vvvv_nt/local_ccsd", **k1, launches=local["local_ccsd"],
             **k1_cells[K1_FULL_SHAPE, "f64"]),
        dict(name="vvvv_nt/local_lambda", **k1,
             launches=local["local_lambda"],
             **k1_cells[K1_FULL_SHAPE, "f64"]),
        dict(name="vvvv_nt/local_rt", **k1, launches=local["local_rt_t"],
             **k1_cells[K1_LOCAL_RT_SHAPE, "f64"]),
        dict(name="vvvv_nt/local_rt_lambda", **k1,
             launches=local["local_rt_lambda"],
             **k1_cells[K1_LOCAL_RT_LAMBDA_SHAPE, "f64"]),
        dict(name="vvvv_nt/mesh", **k1, launches=mesh["mesh"],
             **k1_cells[K1_MESH_SHAPE, "f64"]),
        dict(name="t_row/mesh", **k2, launches=mesh["mesh_t_row"],
             **k2_cells[(24, 114), "f64"]),
        dict(name="vvvv_nt/mesh_lambda", **k1, launches=mesh["mesh_lambda"],
             **k1_cells[K1_MESH_SHAPE, "f64"]),
        dict(name="vvvv_nt/mesh_eom", **k1, launches=mesh["mesh_eom"],
             **k1_cells[K1_MESH_EOM_SHAPE, "f64"]),
        dict(name="vvvv_nt/mesh_df", **k1, launches=mesh["mesh_df"],
             **k1_cells[K1_MESH_DF_SHAPE, "f64"]),
        dict(name="vvvv_nt/df_rt_t", **k1, launches=dfrt["dfrt_t"],
             **k1_cells[K1_DFRT_SHAPE, "f64"]),
        dict(name="vvvv_nt/df_rt_lambda", **k1, launches=dfrt["dfrt_lambda"],
             **k1_cells[K1_DFRT_SHAPE, "f64"]),
    ]


def main():
    t_script = time.perf_counter()
    name, smi = phase_device()
    pycc_tpu_torch.set_verbosity("quiet")
    worker = DFWorker()
    try:
        _main(t_script, name, smi, worker)
    finally:
        worker.stop()


def _main(t_script, name, smi, worker):
    phase_build()
    k1_cells = phase_kernel(smi)
    k2_cells = phase_k2(smi)
    local = phase_oracles()
    full, cc, eccsd, et, real = phase_real_size(smi)
    post, lam, eom_roots = phase_post(cc, eccsd, et, smi)
    resp, muz = phase_resp(cc, lam, smi)
    del cc, lam
    torch.cuda.empty_cache()
    rt = phase_rt(real, smi)
    torch.cuda.empty_cache()
    local_k1, native6 = phase_local(real, smi)
    local.update(local_k1)
    torch.cuda.empty_cache()
    mixed = phase_mixed(real, eom_roots, muz, smi)
    wfn_real = real["wfn"]
    del real
    torch.cuda.empty_cache()
    cc3_launches, wfn_cc3 = phase_cc3(smi)
    torch.cuda.empty_cache()
    phase_rt_frozen(wfn_cc3, smi)
    torch.cuda.empty_cache()
    native4 = phase_local_native(wfn_cc3, smi)
    torch.cuda.empty_cache()
    df, factors, df_ref = phase_df(smi, worker)
    torch.cuda.empty_cache()
    dfpost, dfpost_state = phase_dfpost(factors, smi)
    torch.cuda.empty_cache()
    dfrt = phase_dfrt(dfpost_state, smi)
    del dfpost_state
    torch.cuda.empty_cache()
    phase_dfrt_frozen(wfn_cc3, smi)
    torch.cuda.empty_cache()
    mesh = phase_mesh(wfn_real, (eccsd, et), (post["pseudo_e"], eom_roots),
                      factors, df_ref, (wfn_cc3, native6, native4), smi)
    del wfn_cc3
    print("the whole script: %.1f s" % (time.perf_counter() - t_script))
    print(smi)
    print(json.dumps({"kernels": _kernel_entries(
        k1_cells, k2_cells, full, post, resp, cc3_launches, df, dfpost,
        mixed, rt, local, mesh, dfrt)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
