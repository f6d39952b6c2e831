"""The benchmark of pycc_tpu_torch on NVIDIA GPUs.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout on the
cell's `chips` cards, cuda:0 ... cuda:<chips - 1> (cuda:0 the home card,
which holds the inputs and the judge): the seeded inputs, the set-up
(every shape the window uses, warmed once), the window of `--seconds`,
then the judge against the plain reference.  Standard output ends in one
JSON line: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics, read from a
torch.profiler trace of the window), device, with --trace 1 a breakdown,
and last the checks, each number beside its limit; the line before it
holds each job's or step's record.  Standard error ends in the same
checks, a line each.  Without a CUDA device, or with fewer than the cell
asks for, it exits 2 and prints no result; if JAX or pycc_tpu was
loaded, it exits 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "pycc_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (pycc_tpu_torch is not pycc_tpu)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness.spec import Spec
    spec = Spec(ROOT)
    workload = spec.workload(args.workload)

    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < workload["chips"]:
        print("portbench: %s needs %d devices, %d present"
              % (args.workload, workload["chips"],
                 torch.cuda.device_count()), file=sys.stderr)
        return 2

    import pycc_tpu_torch
    from portbench.harness.cell import run_cell
    # the solvers' progress lines would bury the result
    pycc_tpu_torch.set_verbosity("quiet")
    devices = [torch.device("cuda", i) for i in range(workload["chips"])]
    result, rows, units, t_judge = run_cell(
        spec, workload, args.seed, args.seconds, bool(args.trace), devices,
        T_START)
    bad = forbidden_modules()
    if bad:
        print("portbench: forbidden modules loaded: %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    print("portbench units: %s" % json.dumps(units, default=str))
    print("portbench judged in %.3f s" % t_judge)
    sys.stdout.flush()
    for name, value, limit in rows:
        print("check %s %r limit %r" % (name, value, limit),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
