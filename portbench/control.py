"""The readings that the limits of `correct` are set from, on the card.

    python portbench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--t32-seeds 201 202 203] \
        [--seconds 0]

runs the cell in one process, as a run of portbench/run.py does (seeded
inputs, set-up, a window of --seconds, at least one job or step, then the
judge), once per seed: the program as its configuration states (--seeds),
and the control, the program's own float32 path (precision 'SP') in place
of the configuration's float64 (--control-seeds).  --t32-seeds runs the
program as configured but for its (T) energy, which K2 streams in
float32 (`t_vikings_scan(slab_dtype=torch.float32)`): a float32 (T) after
a float64 CCSD, which the float32 solve of the control cannot reach, since
it stops at its noise floor and returns E(CCSD) alone.  It prints one
JSON line a run with every number the judge compared, then the lower
reading of each number (the largest that the program gave), the upper
(the smallest that the control gave) and the smallest of the float32 (T)
runs.  The limits in limits/<cell>.json lie between.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--t32-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()

    import functools

    import torch

    import pycc_tpu_torch
    from pycc_tpu_torch import triples
    from portbench.harness.cell import run_cell
    from portbench.harness.spec import Spec
    pycc_tpu_torch.set_verbosity("quiet")
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(ROOT)
    workload = spec.workload(args.workload)
    dev = [torch.device("cuda", i) for i in range(workload["chips"])]
    readings = {"program": {}, "control": {}, "t32": {}}
    runs = ([(s, "program", None) for s in args.seeds]
            + [(s, "control", "SP") for s in args.control_seeds]
            + [(s, "t32", None) for s in args.t32_seeds])
    scan = triples.t_vikings_scan
    for seed, path, precision in runs:
        triples.t_vikings_scan = (
            functools.partial(scan, slab_dtype=torch.float32)
            if path == "t32" else scan)
        t0 = time.perf_counter()
        result, rows, units, t_judge = run_cell(
            spec, workload, seed, args.seconds, False, dev, t0,
            precision=precision)
        numbers = {name: value for name, value, _ in rows}
        for name, value in numbers.items():
            readings[path].setdefault(name, []).append(value)
        extra = {}
        if units and "niter" in units[0]:
            extra["niter"] = [u["niter"] for u in units]
            extra["converged"] = [u["converged"] for u in units]
        print(json.dumps(dict(seed=seed, path=path, correct=result["correct"],
                              attempted=result["attempted"],
                              failed=result["failed"], numbers=numbers,
                              seconds=time.perf_counter() - t0,
                              judge_s=t_judge, **extra)),
              flush=True)
    triples.t_vikings_scan = scan
    names = sorted(set().union(*readings.values()))
    print(json.dumps({name: dict(
        lower=max(readings["program"].get(name, [float("nan")])),
        upper=min(readings["control"].get(name, [float("nan")])),
        t32=min(readings["t32"].get(name, [float("nan")])))
        for name in names}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
