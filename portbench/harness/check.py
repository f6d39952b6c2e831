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
    """max |x - ref| / max |ref|, x cast to ref's dtype."""
    x = torch.as_tensor(x).to(ref.device, ref.dtype)
    return float((x - ref).abs().max() / ref.abs().max())


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
