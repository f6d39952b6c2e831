"""Helpers of the benchmark's CPU tests: a copy of the benchmark whose
configurations are cut to a tiny size, and one run of a cell in it."""

import json
import os
import shutil
import time

import torch

from portbench.harness.cell import run_cell
from portbench.harness.spec import ROOT, Spec

# (nbf, nfzc, ndocc): (o, v) = (4, 15) full, (4, 17) over factors
TINY = {"h2o6_vdz": dict(nbf=20, nfzc=1, ndocc=5),
        "h2o6_avdz_df": dict(nbf=22, nfzc=1, ndocc=5, naux=60)}
SEED = 2 ** 31 + 7


def tiny_copy(dest):
    """BENCHMARK.json and portbench/ copied into `dest`, every
    configuration cut to TINY.  Returns dest's Spec."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, sizes in TINY.items():
        path = os.path.join(dest, "portbench", "configs", name + ".json")
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(sizes)
        if "rank" in cfg["generator"]:
            cfg["generator"]["rank"] = 80
        cfg["generator"]["scale"] = 0.5
        with open(path, "w") as f:
            json.dump(cfg, f)
    return Spec(str(dest))


def run_tiny(spec, cell, precision=None, seconds=0.0, trace=False):
    """One run of `cell` on the CPU: (result, the judge's numbers)."""
    result, rows, _, _ = run_cell(spec, spec.workload(cell), SEED, seconds,
                                  trace, torch.device("cpu"),
                                  time.perf_counter(), precision=precision)
    return result, {name: value for name, value, _ in rows}
