"""pycc_tpu_torch: the PyTorch/CUDA port of pycc_tpu.

RHF (host numpy and the native C++ ERI engine) -> MO Hamiltonian (torch)
-> CCD / CC2 / CCSD / CCSD(T) / CC3 on one torch device, then HBAR,
Lambda, densities, EOM-CCSD, linear response and real-time CC, on full
or blocked storage or over Cholesky/DF factors, with the
particle-particle ladders and the (T) rows through hand-written CUDA
kernels on NVIDIA Hopper.  Every entry point
takes a `device` (default "cuda", which raises without a card; the CPU is
used only when asked for) and dtype or precision; nothing picks a device
by itself.  pycc_tpu, beside it, is the
reference the port is tested against; this package never imports JAX.
"""

from . import scf
from .ccwfn import ccwfn
from .cchbar import cchbar
from .cclambda import cclambda
from .ccdensity import ccdensity
from .cceom import cceom
from .ccresponse import ccresponse, pertbar
from .hamiltonian import Hamiltonian, build_hamiltonian
from .rt.rtcc import rtcc
from .utils.log import set_verbosity

__all__ = ["scf", "ccwfn", "cchbar", "cclambda", "ccdensity", "cceom",
           "ccresponse", "pertbar", "rtcc", "Hamiltonian",
           "build_hamiltonian", "set_verbosity"]

__version__ = "0.1.0"
