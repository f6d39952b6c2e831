from . import ccsd

__all__ = ["ccsd"]
