"""nvcc builds of the hand-written CUDA kernels in `pycc_tpu_torch/csrc`.

Each kernel source has a plain C interface.  It is compiled for sm_90a on
first use into the package's git-ignored `_build/` directory and loaded
with ctypes (no PyTorch headers, so a build takes seconds).  A library is
rebuilt only when it is missing or older than its source.
"""

import ctypes
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")


def paths(name):
    """(source, library) paths of the kernel `name` (csrc/<name>.cu)."""
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD, "lib%s.so" % name))


def build(name):
    """Compile csrc/<name>.cu if its library is missing or older than the
    source.  Returns nvcc's output (ptxas' register and shared-memory
    report), or '' when the library was up to date."""
    src, so = paths(name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return ""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: %s needs nvcc" % name)
    os.makedirs(BUILD, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"),
           "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed for %s (%d):\n%s%s"
                           % (name, res.returncode, res.stdout, res.stderr))
    os.replace(tmp, so)
    return res.stdout + res.stderr


def load(name, entries, argtypes):
    """Build csrc/<name>.cu if needed and bind it: every function in
    `entries` takes `argtypes` and returns an int (a cudaError_t), and
    `<name>_error_string(int)` names an error code."""
    build(name)
    lib = ctypes.CDLL(paths(name)[1])
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = getattr(lib, name + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib
