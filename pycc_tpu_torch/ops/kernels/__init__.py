from .vvvv import vvvv_nt, vvvv_nt_reference

__all__ = ["vvvv_nt", "vvvv_nt_reference"]
