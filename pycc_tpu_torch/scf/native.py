"""ctypes bridge to the native C++ McMurchie-Davidson ERI engine.

Builds the shared engine source `native/mdints.cpp` with g++ on first use,
into this package's git-ignored `_build/` directory, and exposes
`eri_native(basis)` and, for the integral-direct Cholesky of scf/df.py,
`ERIContext`.  A failed build raises: at 100+ basis functions the
pure-Python engine (`integrals._eri_python`) is about 90x slower, so a
silent fallback would look like a hang.
"""

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "mdints.cpp")
_BUILD = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD, "libmdints.so")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_SO) or os.path.getmtime(_SRC) > os.path.getmtime(_SO):
        os.makedirs(_BUILD, exist_ok=True)
        # build under a private name, then rename: concurrent test workers
        # never load a half-written library
        tmp = "%s.%d.tmp" % (_SO, os.getpid())
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-o", tmp, _SRC], check=True)
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(_SO)
    lib.md_eri.restype = ctypes.c_int
    lib.md_eri.argtypes = [
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64),
    ]
    lib.md_ctx_new.restype = ctypes.c_void_p
    lib.md_ctx_new.argtypes = lib.md_eri.argtypes[:-1]
    lib.md_ctx_free.restype = None
    lib.md_ctx_free.argtypes = [ctypes.c_void_p]
    lib.md_ctx_npairs.restype = ctypes.c_int
    lib.md_ctx_npairs.argtypes = [ctypes.c_void_p]
    lib.md_ctx_pair.restype = ctypes.c_int
    lib.md_ctx_pair.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
    lib.md_eri_diag.restype = ctypes.c_int
    lib.md_eri_diag.argtypes = [ctypes.c_void_p,
                                np.ctypeslib.ndpointer(np.float64)]
    lib.md_eri_cols.restype = ctypes.c_int
    lib.md_eri_cols.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                np.ctypeslib.ndpointer(np.float64),
                                ctypes.c_double,
                                np.ctypeslib.ndpointer(np.float64)]
    _LIB = lib
    return lib


def _basis_arrays(basis):
    """Flatten a BasisSet into the arrays md_ctx_new/md_eri take."""
    shells = basis.shells
    nsh = len(shells)
    ls = np.array([sh.l for sh in shells], dtype=np.int32)
    nprim = np.array([len(sh.exps) for sh in shells], dtype=np.int32)
    poff = np.zeros(nsh, dtype=np.int32)
    for i in range(1, nsh):
        poff[i] = poff[i - 1] + nprim[i - 1]
    exps = np.concatenate([sh.exps for sh in shells]).astype(np.float64)
    coefs = np.concatenate([sh.coefs for sh in shells]).astype(np.float64)
    centers = np.array([sh.center for sh in shells], dtype=np.float64).ravel()
    cart_off = np.zeros(nsh, dtype=np.int32)
    n = 0
    for i, sh in enumerate(shells):
        cart_off[i] = n
        n += sh.ncart
    return ls, nprim, poff, exps, coefs, centers, cart_off, n


class ERIContext:
    """Persistent native shell-pair context: on-demand diagonal blocks and
    (ab|kl) column batches for the integral-direct Cholesky (scf/df.py)."""

    def __init__(self, basis):
        self.lib = _load()
        self.basis = basis
        arrs = _basis_arrays(basis)
        self.ncart = arrs[-1]
        self._h = self.lib.md_ctx_new(len(basis.shells), *arrs)
        if not self._h:
            raise RuntimeError("md_ctx_new failed")
        self.npairs = self.lib.md_ctx_npairs(self._h)
        self.pair_shells = []
        i = ctypes.c_int()
        j = ctypes.c_int()
        for p in range(self.npairs):
            self.lib.md_ctx_pair(self._h, p, ctypes.byref(i), ctypes.byref(j))
            self.pair_shells.append((i.value, j.value))

    def __del__(self):
        if getattr(self, "_h", None):
            self.lib.md_ctx_free(self._h)
            self._h = None

    def diag_blocks(self):
        """List of per-pair (ncab, ncab) cartesian blocks (p|p)."""
        shells = self.basis.shells
        sizes = [shells[i].ncart * shells[j].ncart
                 for (i, j) in self.pair_shells]
        total = sum(s * s for s in sizes)
        out = np.zeros(total, dtype=np.float64)
        ret = self.lib.md_eri_diag(self._h, out)
        if ret != 0:
            raise RuntimeError("md_eri_diag failed")
        blocks = []
        off = 0
        for s in sizes:
            blocks.append(out[off:off + s * s].reshape(s, s))
            off += s * s
        return blocks

    def cols(self, pair_idx, schwarz=None, thresh=0.0):
        """(ab|kl) cartesian columns for ket pair `pair_idx`:
        (ncart_tot, ncart_tot, ncab_ket), bra-symmetrized."""
        shells = self.basis.shells
        i, j = self.pair_shells[pair_idx]
        nck = shells[i].ncart * shells[j].ncart
        out = np.zeros((self.ncart, self.ncart, nck), dtype=np.float64)
        if schwarz is None:
            schwarz = np.ones(self.npairs)
            thresh = 0.0
        ret = self.lib.md_eri_cols(self._h, pair_idx,
                                   np.ascontiguousarray(schwarz, np.float64),
                                   float(thresh), out.reshape(-1))
        if ret != 0:
            raise RuntimeError("md_eri_cols failed")
        return out


def available():
    """True when the native engine builds and loads here."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def cart_to_ao_matrix(basis):
    """Block-diagonal transform (nbf x ncart_tot) from raw cartesian shell
    components to the final (spherical/normalized) AO functions."""
    from .integrals import shell_transform

    shells = basis.shells
    n = sum(sh.ncart for sh in shells)
    T = np.zeros((basis.nbf, n))
    offc = 0
    for sh, offf in zip(shells, basis.offsets):
        T[offf:offf + sh.nfunc, offc:offc + sh.ncart] = shell_transform(sh)
        offc += sh.ncart
    return T


def eri_native(basis):
    """Full (ab|cd) tensor over final AO functions via the C++ engine."""
    lib = _load()
    arrs = _basis_arrays(basis)
    n = arrs[-1]
    out = np.zeros((n, n, n, n), dtype=np.float64)
    ret = lib.md_eri(len(basis.shells), *arrs, out.reshape(-1))
    if ret != 0:
        raise RuntimeError("md_eri failed with code %d" % ret)

    # cartesian -> final AO functions per shell
    T = cart_to_ao_matrix(basis)
    out = np.einsum("ai,ijkl->ajkl", T, out, optimize=True)
    out = np.einsum("bj,ajkl->abkl", T, out, optimize=True)
    out = np.einsum("ck,abkl->abcl", T, out, optimize=True)
    out = np.einsum("dl,abcl->abcd", T, out, optimize=True)
    return out
