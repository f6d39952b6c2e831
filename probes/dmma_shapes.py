#!/usr/bin/env python3
"""Which float64 mma.sync shape to use: checks the fragment layouts of
m8n8k4, m16n8k4, m16n8k8 and m16n8k16 (.f64) against A @ B.T with one
warp, then times each shape issued back to back from registers.

    python3 probes/dmma_shapes.py      (needs an sm_90 card and nvcc)

It builds probes/dmma_shapes.cu into probes/_build/.
"""

import ctypes
import os
import subprocess

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(8, 8, 4), (16, 8, 4), (16, 8, 8), (16, 8, 16)]


def _build():
    """Compile dmma_shapes.cu for sm_90a and load it."""
    from torch.utils.cpp_extension import CUDA_HOME
    out = os.path.join(HERE, "_build")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libdmma_shapes.so")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(HERE, "dmma_shapes.cu")], check=True)
    return ctypes.CDLL(so)


def main():
    lib = _build()
    lib.probe_layout.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.probe_rate.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
    g = torch.Generator(device="cuda").manual_seed(0)
    for s, (m, n, k) in enumerate(SHAPES):
        A = torch.randn(m, k, generator=g, device="cuda", dtype=torch.float64)
        B = torch.randn(n, k, generator=g, device="cuda", dtype=torch.float64)
        D = torch.full((m, n), float("nan"), device="cuda", dtype=torch.float64)
        rc = lib.probe_layout(s, A.data_ptr(), B.data_ptr(), D.data_ptr())
        torch.cuda.synchronize()
        print("layout m%dn%dk%d rc=%d max|err|=%.1e"
              % (m, n, k, rc, (D - A @ B.T).abs().max().item()))
    out = torch.zeros(1, device="cuda", dtype=torch.float64)
    blocks, threads, iters = 132 * 4, 256, 4096
    for s, (m, n, k) in enumerate(SHAPES):
        lib.probe_rate(s, out.data_ptr(), blocks, threads, 64)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        lib.probe_rate(s, out.data_ptr(), blocks, threads, iters)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        flop = blocks * threads / 32 * iters * 6 * 2 * m * n * k
        print("rate m%dn%dk%d: %.3f ms, %.1f TFLOP/s" % (m, n, k, ms,
                                                        flop / ms / 1e9))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
