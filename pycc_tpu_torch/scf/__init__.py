"""Host-side SCF layer: basis sets, integrals, RHF reference.

numpy, scipy and the native C++ ERI engine; no torch.  A copy of
pycc_tpu.scf's host modules with only the imports changed, so that the
port runs where JAX is not installed.
"""

from .mol import Molecule
from .basis import BasisSet
from .rhf import run_rhf, RHFWavefunction
from . import integrals

__all__ = ["Molecule", "BasisSet", "run_rhf", "RHFWavefunction", "integrals"]
