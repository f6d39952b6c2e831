from .log import set_verbosity
from .timing import Timers

__all__ = ["set_verbosity", "Timers"]
