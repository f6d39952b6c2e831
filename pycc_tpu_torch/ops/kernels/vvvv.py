"""K1 on Hopper: the particle-particle-ladder product C = A @ B.T.

The hottest CCSD term is r2 += 0.5 * tau_ijef <ab|ef>: an (o^2, v^2) x
(v^2, v^2)^T product.  `vvvv_nt` runs it through the hand-written CUDA
kernel in `pycc_tpu_torch/csrc/vvvv_nt.cu`, which replaces the TPU kernel
pycc_tpu/ops/kernels/vvvv.py::vvvv_pallas (see the source for its design
and what bounds it).  `vvvv_nt_reference` beside it is the plain version.

On CPU tensors `vvvv_nt` takes the plain version; on CUDA tensors it
launches the kernel or raises.  The kernel is compiled with nvcc for sm_90a
on first use and bound with ctypes, by `build.py` beside this module.
"""

import ctypes
from typing import NamedTuple

import torch

from . import build as _build

_LIB = None

_MAX_GRID_Y = 65535
_BN = 128           # the kernels' block-tile columns (csrc/vvvv_nt.cu: BN)
_INT_MAX = 2 ** 31 - 1
# the widest copy each kernel takes, and the narrowest it can fall to
_COPY_BYTES = {torch.float64: (16, 8), torch.float32: (16, 4),
               torch.bfloat16: (16, 2)}


def build():
    """Compile csrc/vvvv_nt.cu for sm_90a if the library is missing or older
    than the source.  Returns nvcc's output (ptxas' register and shared-
    memory report), or '' when the library was up to date."""
    return _build.build("vvvv_nt")


def _library():
    global _LIB
    if _LIB is None:
        _LIB = _build.load(
            "vvvv_nt", ("vvvv_nt_f64", "vvvv_nt_f32", "vvvv_nt_bf16"),
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p])
    return _LIB


def copy_bytes(A, B):
    """The widest shared-memory copy (bytes) the kernel may use for these
    operands: each row starts at an offset of K * element bytes, so a
    16-byte copy needs that, and both pointers, 16-byte aligned."""
    K, elem = A.shape[1], A.element_size()
    n, low = _COPY_BYTES[A.dtype]
    while n > low and ((K * elem) % n or A.data_ptr() % n
                       or B.data_ptr() % n):
        n //= 2
    return n


def vvvv_nt_reference(A, B, bf16=False):
    """The plain version: A @ B.T.  bf16=True rounds both operands to
    bfloat16 and multiplies in float32 (float32 result)."""
    if bf16:
        return A.to(torch.bfloat16).float() @ B.to(torch.bfloat16).float().T
    return A @ B.T


def vvvv_nt(A, B, bf16=False):
    """C[m, n] = sum_k A[m, k] B[n, k] for A (M, K) and B (N, K).

    float64 and float32 operands give a result of the same dtype.  With
    bf16=True the operands (float32 or bfloat16) are rounded to bfloat16,
    accumulated in float32, and the result is float32.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (`vvvv_nt.launches`
    counts the launches, `vvvv_nt.launches_by_mode` them by mode: "f64",
    "f32" or "bf16")."""
    if A.device.type == "cpu" and B.device.type == "cpu":
        return vvvv_nt_reference(A, B, bf16)
    if A.device.type != "cuda" or A.device != B.device:
        raise ValueError("vvvv_nt: A and B must both be CPU tensors or both "
                         "on one CUDA device (got %s, %s)"
                         % (A.device, B.device))
    if A.dim() != 2 or B.dim() != 2 or A.shape[1] != B.shape[1]:
        raise ValueError("vvvv_nt: need A (M, K) and B (N, K), got %s and %s"
                         % (tuple(A.shape), tuple(B.shape)))
    if not (A.is_contiguous() and B.is_contiguous()):
        raise ValueError("vvvv_nt: A and B must be contiguous")
    if A.dtype != B.dtype:
        raise TypeError("vvvv_nt: A is %s but B is %s" % (A.dtype, B.dtype))
    if bf16:
        if A.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("vvvv_nt(bf16=True) takes float32 or bfloat16, "
                            "got %s" % A.dtype)
        A = A.to(torch.bfloat16)
        B = B.to(torch.bfloat16)
        mode, out_dtype = "bf16", torch.float32
    elif A.dtype == torch.float64:
        mode, out_dtype = "f64", torch.float64
    elif A.dtype == torch.float32:
        mode, out_dtype = "f32", torch.float32
    else:
        raise TypeError("vvvv_nt takes float64 or float32 (or bf16=True), "
                        "got %s" % A.dtype)
    M, K = A.shape
    N = B.shape[0]
    if max(M, N, K) > _INT_MAX or -(-N // _BN) > _MAX_GRID_Y:
        raise ValueError("vvvv_nt: shape (M, N, K) = (%d, %d, %d) exceeds the "
                         "kernel's grid" % (M, N, K))
    C = torch.empty((M, N), dtype=out_dtype, device=A.device)
    if M == 0 or N == 0:
        return C
    lib = _library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = getattr(lib, "vvvv_nt_" + mode)(A.data_ptr(), B.data_ptr(), C.data_ptr(),
                             M, N, K, copy_bytes(A, B), stream)
    if rc != 0:
        raise RuntimeError("vvvv_nt launch failed: %s"
                           % lib.vvvv_nt_error_string(rc).decode())
    vvvv_nt.launches += 1
    vvvv_nt.launches_by_mode[mode] += 1
    return C


vvvv_nt.launches = 0
vvvv_nt.launches_by_mode = {"f64": 0, "f32": 0, "bf16": 0}


def reset_launches():
    """Set K1's launch counts (total and by mode) to 0."""
    vvvv_nt.launches = 0
    for mode in vvvv_nt.launches_by_mode:
        vvvv_nt.launches_by_mode[mode] = 0


def ladder_product(ladder, A, B):
    """`ladder(A, B)` = A @ B.T in A's dtype, the one place every ladder
    caller goes through: bfloat16 operands take the bf16 mode (float32
    accumulation) and the product is rounded back to bfloat16, as
    pycc_tpu's dot with preferred_element_type=tau.dtype gives; float64
    and float32 operands go as they are.  `ladder` is `vvvv_nt` (K1) or
    `vvvv_nt_reference`."""
    if A.dtype == torch.bfloat16:
        return ladder(A, B, bf16=True).to(torch.bfloat16)
    return ladder(A, B)


# ---------------------------------------------------------------------------
# complex operands: one real product on stacked real and imaginary rows
# ---------------------------------------------------------------------------

class StackedComplex(NamedTuple):
    """A complex operand laid out for K1 once and reused by every product
    with it: ri = [Re X; Im X], real, of shape (2, *X.shape).  Its (2n, k)
    matrix is K1's B operand for the complex X (n, k)."""
    ri: torch.Tensor

    @property
    def shape(self):
        return self.ri.shape[1:]


def stack_complex(X):
    """X as a `StackedComplex` (one copy of X's bytes)."""
    return StackedComplex(torch.stack([X.real, X.imag]))


def stack_rows(X):
    """The (m, k) matrix X as K1's operand: itself when real, its real and
    imaginary rows stacked as one real (2m, k) matrix when complex."""
    if X.is_complex():
        return torch.cat([X.real, X.imag])
    return X


def unstack_product(out, a_complex, b_complex):
    """The complex A @ B.T from out = stack_rows(A) @ stack_rows(B).T:
    with both complex out holds the four real products as a 2 x 2 block
    matrix, re = ArBr^T - AiBi^T and im = ArBi^T + AiBr^T (the work of a
    complex GEMM, with the rounding of four real products)."""
    if a_complex and b_complex:
        m, n = out.shape[0] // 2, out.shape[1] // 2
        return torch.complex(out[:m, :n] - out[m:, n:],
                             out[:m, n:] + out[m:, :n])
    if a_complex:
        m = out.shape[0] // 2
        return torch.complex(out[:m], out[m:])
    if b_complex:
        n = out.shape[1] // 2
        return torch.complex(out[:, :n], out[:, n:])
    return out


def complex_product(ladder, A, B):
    """A @ B.T for real or complex A (m, k) and B (n, k), or B a
    `StackedComplex` whose ri is (2, n, k), in ONE `ladder_product` call:
    complex operands go in as stacked real and imaginary rows
    (`stack_rows`) and the real product is recombined
    (`unstack_product`).  bfloat16 never meets a complex operand: a
    complex64 operand takes K1's f32 mode."""
    b_complex = isinstance(B, StackedComplex) or B.is_complex()
    if isinstance(B, StackedComplex):
        Bs = B.ri.reshape(-1, B.ri.shape[-1])
    else:
        Bs = stack_rows(B)
    out = ladder_product(ladder, stack_rows(A), Bs)
    return unstack_product(out, A.is_complex(), b_complex)
