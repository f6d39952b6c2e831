#!/usr/bin/env python3
"""The device mesh (pycc_tpu_torch/parallel/mesh.py) across the cards of
one host: a 2 x 2 mesh of cuda:(i % n) over the n visible cards.

    python3 probes/mesh_cards.py      (from the repository root; about
                                       five minutes, two of them the
                                       (H2O)_6 SCF on the host; four cards
                                       to span cards)

1. H2O/cc-pVDZ (frozen core) CCSD(T), HBAR, Lambda and 3 EOM roots (CIS
   guess) on full and blocked storage, and H2O/cc-pVDZ DF-CCSD, each on
   the mesh against the unsharded run on cuda:0, with the bytes the
   shards hold on each card and K1's launches;
2. one ladder at [real]'s width, (o, v) = (24, 114) on random operands:
   one K1 launch on the whole W on cuda:0, the four shards of W on
   cuda:0 alone, and the four shards on the mesh's cards, each the
   median of 5 host-clock timings that end in a synchronize of every
   card, with the shards' results held to the whole one;
3. (H2O)_6/cc-pVDZ, (o, v) = (24, 114), CCSD(T) on full storage on the
   mesh against the unsharded run on cuda:0 (E(CCSD) + E(T) at 1e-11),
   with what the mesh init added to each card's peak beside what each
   card then holds: the integrals are made in host memory and cut into
   their pieces from there, so no card, the home one included, holds a
   whole v^4 operand at any point.
"""

import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pycc_tpu_torch  # noqa: E402
from pycc_tpu_torch.data import moldict  # noqa: E402
from pycc_tpu_torch.models.ccsd import vvvv_contract  # noqa: E402
from pycc_tpu_torch.ops.kernels import triples as k2  # noqa: E402
from pycc_tpu_torch.ops.kernels import vvvv  # noqa: E402
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt  # noqa: E402
from pycc_tpu_torch.parallel import (Sharded, device_bytes,  # noqa: E402
                                     make_mesh)
from pycc_tpu_torch.scf import run_rhf  # noqa: E402


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def median_ms(fn, reps=5):
    fn()
    sync_all()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync_all()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def pipeline(wfn, mesh, storage):
    kw = {"df_tol": 1e-10} if storage == "df" else {}
    model = "CCSD" if storage == "df" else "CCSD(T)"
    cc = pycc_tpu_torch.ccwfn(wfn, model=model, storage=storage,
                              device="cuda:0", mesh=mesh, **kw)
    vvvv_nt.launches = 0
    e = cc.solve_cc(1e-11, 1e-11)
    out = {"E": e, "K1 solve": vvvv_nt.launches, "iterations": cc.niter}
    if mesh is not None:
        out["held"] = {d: round(b / 1e6, 3) for d, b in device_bytes(
            cc.dfb if storage == "df" else
            (cc.blocks if storage == "blocked" else cc.H)).items()}
    if storage != "df":
        hb = pycc_tpu_torch.cchbar(cc)
        lam = pycc_tpu_torch.cclambda(cc, hb)
        out["lambda"] = lam.solve_lambda(1e-11, 1e-11)
        E, _ = pycc_tpu_torch.cceom(hb).solve_eom(N=3, e_conv=1e-9,
                                                  r_conv=1e-7, guess="CIS")
        out["eom"] = np.asarray(E)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    n = torch.cuda.device_count()
    devices = ["cuda:%d" % (i % n) for i in range(4)]
    print("cards %d: %s" % (n, smi.replace("\n", " | ")))
    print("mesh devices %s" % devices)
    vvvv.build()
    k2.build()
    pycc_tpu_torch.set_verbosity("quiet")

    wfn = run_rhf(moldict["H2O"], "cc-pvdz", freeze_core=True)
    for storage in ("full", "blocked", "df"):
        ref = pipeline(wfn, None, storage)
        got = pipeline(wfn, make_mesh(devices=devices), storage)
        diffs = {k: float(np.max(np.abs(np.asarray(got[k]) - ref[k])))
                 for k in ("E", "lambda", "eom") if k in ref}
        print("%-7s mesh - unsharded %s  K1 %d (unsharded %d) in %d "
              "iterations  held by card (MB) %s"
              % (storage, {k: "%.2e" % v for k, v in diffs.items()},
                 got["K1 solve"], ref["K1 solve"], got["iterations"],
                 got["held"]))
        if not (diffs["E"] < 1e-11 and diffs.get("lambda", 0) < 1e-10
                and diffs.get("eom", 0) < 1e-7):
            raise AssertionError("%s: the mesh missed the unsharded run"
                                 % storage)

    g = torch.Generator(device="cuda:0").manual_seed(7)
    no, nv = 24, 114
    W = torch.randn((nv,) * 4, generator=g, device="cuda:0",
                    dtype=torch.float64)
    tau = torch.randn((no, no, nv, nv), generator=g, device="cuda:0",
                      dtype=torch.float64)
    one_card = Sharded.put(W, make_mesh(devices=["cuda:0"] * 4), ("va", "vb"))
    cards = Sharded.put(W, make_mesh(devices=devices), ("va", "vb"))
    whole = vvvv_contract(tau, W)
    for name, Ws in (("4 shards on cuda:0", one_card),
                     ("4 shards on %d card(s)" % n, cards)):
        out = vvvv_contract(tau, Ws)
        sync_all()
        if not torch.equal(out, whole):
            raise AssertionError("%s differs from one launch" % name)
    t_whole = median_ms(lambda: vvvv_contract(tau, W))
    t_one = median_ms(lambda: vvvv_contract(tau, one_card))
    t_cards = median_ms(lambda: vvvv_contract(tau, cards))
    print("ladder (576, 12996, 12996) f64: one launch %.3f ms; 4 shards on "
          "cuda:0 %.3f ms; 4 shards on the mesh's %d card(s) %.3f ms (a "
          "shard's W %.3f GB a card); every result = the one launch's  | %s"
          % (t_whole, t_one, n, t_cards,
             max(cards.cell_bytes().values()) / 1e9, smi.splitlines()[0]))
    print("peak allocated by card (GB): %s"
          % [round(torch.cuda.max_memory_allocated(i) / 1e9, 3)
             for i in range(n)])
    del W, tau, one_card, cards, whole, out
    full_width(devices, n, smi.splitlines()[0])


def full_width(devices, n, smi):
    wfn = run_rhf(moldict["(H2O)_6"], "cc-pvdz", freeze_core=True)
    cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD(T)", device="cuda:0")
    e0 = cc.solve_cc(1e-10, 1e-10)
    del cc
    torch.cuda.empty_cache()
    sync_all()
    base = [torch.cuda.memory_allocated(i) for i in range(n)]
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    cc = pycc_tpu_torch.ccwfn(wfn, model="CCSD(T)", device="cuda:0",
                              mesh=make_mesh(devices=devices))
    sync_all()
    t_init = time.perf_counter() - t0
    grew = [(torch.cuda.max_memory_allocated(i) - base[i]) / 1e9
            for i in range(n)]
    held = device_bytes(cc.H)
    vvvv_nt.launches = 0
    t0 = time.perf_counter()
    e = cc.solve_cc(1e-10, 1e-10)
    sync_all()
    print("(H2O)_6/cc-pVDZ CCSD(T) (24, 114) on the mesh: init %.1f s, the "
          "peak it added by card (GB) %s, storage held by card (GB) %s; "
          "solve %.1f s, %d iterations, K1 %d; E(CCSD) + E(T) = %.12f, "
          "|mesh - unsharded| = %.2e  | %s"
          % (t_init, [round(g, 3) for g in grew],
             {d: round(b / 1e9, 3) for d, b in held.items()},
             time.perf_counter() - t0, cc.niter, vvvv_nt.launches, e,
             abs(e - e0), smi))
    if abs(e - e0) > 1e-11:
        raise AssertionError("(H2O)_6: the mesh missed the unsharded run")


if __name__ == "__main__":
    main()
