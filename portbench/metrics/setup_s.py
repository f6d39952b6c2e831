"""setup_s: process start to the window's start (imports, CUDA context,
the seeded inputs, the kernels built or loaded, the warm-up), host clock."""


def read(run):
    return run.setup_s
