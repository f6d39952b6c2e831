from .contract import contract
from .diis import DIIS

__all__ = ["contract", "DIIS"]
