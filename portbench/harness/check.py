"""What the judges of the kinds (kinds/<kind>.py) share, and the verdict.

Every number a judge compares is a gap between the program and the plain
reference (`portbench/reference`), which recomputes from the run's own
inputs what the program derived and reads the program's outputs only to
judge them.  A run is correct when every number is at or under its limit
(limits/<cell>.json) and no unit of work failed.
"""

import math

import torch

from portbench.reference.hamiltonian import mo_eri, mo_fock

F64 = torch.float64


def gap(x, ref):
    """max |x - ref| / max |ref|, x cast to ref's dtype.  An x that is no
    tensor (the port's mesh storage, `parallel.Sharded`) is read whole
    through its __getitem__."""
    if not isinstance(x, torch.Tensor) and hasattr(x, "shape"):
        x = x[(slice(None),) * len(x.shape)]
    x = torch.as_tensor(x).to(ref.device, ref.dtype)
    return float((x - ref).abs().max() / ref.abs().max())


def gap_rows(x, key, ref, chunk_bytes=2 ** 30):
    """(max |x[key] - ref|, max |ref|), x[key] cast to ref's dtype, for
    `key` a tuple of slices of x: the two halves of gap(x[key], ref), so
    that a gap over several blocks is the largest of the first over the
    largest of the second.  x (a tensor, or the port's mesh storage, read
    through its __getitem__) is read a few indices of key's first slice
    at a time, about `chunk_bytes` a read, so that a large block of x is
    never assembled whole."""
    first = key[0]
    lo = first.start or 0
    n = ref.shape[0]
    rows = max(1, chunk_bytes // max(1, ref[0].numel() * ref.element_size()))
    num = den = 0.0
    for i in range(0, n, rows):
        j = min(n, i + rows)
        part = x[(slice(lo + i, lo + j),) + tuple(key[1:])]
        part = torch.as_tensor(part).to(ref.device, ref.dtype)
        num = max(num, float((part - ref[i:j]).abs().max()))
        den = max(den, float(ref[i:j].abs().max()))
        del part
    return num, den


def as_f64(x, device):
    return torch.as_tensor(x, dtype=F64, device=device)


def full_hamiltonian(wfn, device):
    """(F, ERI, C) of the reference from the seeded SCF output."""
    C = as_f64(wfn.Ca_subset("AO", "ACTIVE"), device)
    F = mo_fock(C, as_f64(wfn.Fa(), device))
    ERI = mo_eri(C, as_f64(wfn.ERI_ao, device))
    return F, ERI, C


def norm(pairs):
    """sqrt(sum |r / d|^2) over the (residual, denominator) pairs."""
    return math.sqrt(sum(float(torch.sum((r / d).abs() ** 2))
                         for r, d in pairs))


def verdict(numbers, limits, failed):
    """(correct, [(name, value, limit)]): every number at or under its
    limit (a NaN is not), a limit for every number, and no failed unit."""
    rows = [(name, value, limits.get(name, float("nan")))
            for name, value in numbers.items()]
    ok = all(value <= limit for _, value, limit in rows)
    return ok and failed == 0 and set(limits) <= set(numbers), rows
