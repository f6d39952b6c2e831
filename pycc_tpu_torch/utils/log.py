"""Leveled logging for solver progress.

Every module of the port logs through the ``pycc_tpu_torch`` logger:

    import pycc_tpu_torch
    pycc_tpu_torch.set_verbosity("quiet")   # warnings only
    pycc_tpu_torch.set_verbosity("info")    # solver progress (default)
    pycc_tpu_torch.set_verbosity("debug")

The default handler writes bare messages to stdout.  Attach your own
``logging`` handlers to the "pycc_tpu_torch" logger for structured capture.
"""

import logging
import sys


class _StdoutProxy:
    """Write through the CURRENT sys.stdout (not the one bound at import),
    so contextlib.redirect_stdout captures solver output."""

    def write(self, s):
        sys.stdout.write(s)

    def flush(self):
        sys.stdout.flush()


logger = logging.getLogger("pycc_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(_StdoutProxy())
    _h.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False

_LEVELS = {"quiet": logging.WARNING, "warning": logging.WARNING,
           "info": logging.INFO, "debug": logging.DEBUG}


def set_verbosity(level):
    """Set the package-wide log level: 'quiet' | 'info' | 'debug',
    or any ``logging`` level number."""
    logger.setLevel(_LEVELS.get(level, level))
