"""Amplitude checkpoints for the iterative solvers, as compressed .npz.

The counterpart of pycc_tpu/utils/checkpoint.py, with the same format and
keys (t1, t2, niter, ecc and the DIIS ring diis_amps/diis_errs/diis_count
for solve_cc; l1, l2 for Lambda; C, E, niter for EOM), so a checkpoint
written by either package resumes in the other.
"""

import os

import numpy as np
import torch


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_amps(path, **amps):
    """save_amps('ccsd.npz', t1=t1, t2=t2, niter=7)

    Atomic: the archive is written through a file handle to a sibling
    `path + ".tmp"` and moved over `path` with os.replace, so a kill
    mid-write never leaves a truncated archive where the last good one
    was.  Tensors are copied to the host first."""
    path = str(path)
    tmp = path + ".tmp"
    # a file handle: np.savez_compressed appends '.npz' to a bare path
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **{k: _host(v) for k, v in amps.items()})
    os.replace(tmp, path)


def load_amps(path, device=None):
    """The arrays of a checkpoint by key: numpy arrays when device is None,
    else tensors on `device`."""
    with np.load(str(path), allow_pickle=False) as data:
        out = {k: data[k] for k in data.files}
    if device is None:
        return out
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}
