"""Helpers of the benchmark's CPU tests: a copy of the benchmark whose
configurations are cut to a tiny size, a four-card cell added to it by
files alone, and one run of a cell in it."""

import json
import os
import shutil
import time

import torch

from portbench.harness.cell import run_cell
from portbench.harness.spec import ROOT, Spec

# (nbf, nfzc, ndocc): (o, v) = (4, 15) full, (4, 17) over factors
TINY = {"h2o6_vdz": dict(nbf=20, nfzc=1, ndocc=5),
        "h2o6_avdz_df": dict(nbf=22, nfzc=1, ndocc=5, naux=60),
        "h2o6_avdz_full": dict(nbf=20, nfzc=1, ndocc=5)}
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


MESH_CELL = "h2o6_vdz.ccsd_mesh"


def add_mesh_cell(root, config="h2o6_vdz"):
    """<config>.ccsd_mesh (MESH_CELL for h2o6_vdz), CCSD jobs of the copy
    at `root`'s configuration on four cards, which kind 'cc' lays over a
    2 x 2 mesh, added by files and entries alone: the mix
    traffic/ccsd_mesh.json (a copy of ccsd.json, so that the pair of
    configuration and mix is new), the limits of <config>.ccsd and an
    entry of "chips": 4.  Returns the copy's Spec."""
    bdir = os.path.join(str(root), "portbench")
    cell = config + ".ccsd_mesh"
    shutil.copy(os.path.join(bdir, "traffic", "ccsd.json"),
                os.path.join(bdir, "traffic", "ccsd_mesh.json"))
    shutil.copy(os.path.join(bdir, "limits", config + ".ccsd.json"),
                os.path.join(bdir, "limits", cell + ".json"))
    bench = Spec(str(root)).bench
    bench["workloads"].append(dict(name=cell, config=config,
                                   traffic="ccsd_mesh", chips=4,
                                   why="a test"))
    with open(os.path.join(str(root), "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return Spec(str(root))


def run_tiny(spec, cell, precision=None, seconds=0.0, trace=False):
    """One run of `cell` on the CPU, one CPU device for each of the cell's
    chips: (result, the judge's numbers)."""
    result, rows, _, _ = run_tiny_units(spec, cell, precision, seconds,
                                        trace)
    return result, {name: value for name, value, _ in rows}


def run_tiny_units(spec, cell, precision=None, seconds=0.0, trace=False):
    """run_cell's (result, rows, units, judge seconds) of run_tiny's run."""
    w = spec.workload(cell)
    return run_cell(spec, w, SEED, seconds, trace,
                    [torch.device("cpu")] * w["chips"], time.perf_counter(),
                    precision=precision)
