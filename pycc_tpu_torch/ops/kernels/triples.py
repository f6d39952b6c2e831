"""K2 on Hopper: the (T) energy projections of one occupied row.

For a row i, `t_energy_row` returns the seven projections of the connected
triples t3[i, j, k] that the (T) energy needs (X1a, X1m, Z1, Z1m, Z2a, Z2m,
X2l; defined in `pycc_tpu_torch/csrc/t_row.cu`), and `t_row_finalize` turns
them into the row's energy.  On CUDA tensors the projections come from the
hand-written kernel in `csrc/t_row.cu`, which replaces the TPU kernel
pycc_tpu/ops/kernels/triples.py::t_energy_row_pallas and never writes t3
to device memory; `t_energy_row_reference` beside it is the plain version,
and CPU tensors take it.  `t_vikings_rows` is the whole (T) energy through
them, one launch per row.

Against the Pallas kernel, X1a and X1m come out as (o, v), already summed
over the axis that its Mosaic lowering kept and `t_row_finalize` summed.
"""

import ctypes

import torch

from ...triples import _t3c_slab_ij
from ..contract import contract
from . import build as _build

_LIB = None
_ENTRIES = {torch.float64: "t_row_f64", torch.float32: "t_row_f32",
            torch.bfloat16: "t_row_bf16"}
_SMEM_MAX = 232448          # bytes of shared memory a Hopper block can use
# what the dynamic layout may take: less the kernel's static arrays
_SMEM_BUDGET = _SMEM_MAX - 1024


def build():
    """Compile csrc/t_row.cu for sm_90a if the library is missing or older
    than the source.  Returns nvcc's output, or '' when it was up to date."""
    return _build.build("t_row")


def _library():
    global _LIB
    if _LIB is None:
        p = ctypes.c_void_p
        _LIB = _build.load("t_row", tuple(_ENTRIES.values()),
                           [ctypes.c_int] + [p] * 17
                           + [ctypes.c_int] * 3 + [p])
        _LIB.t_row_smem_bytes.argtypes = [ctypes.c_int] * 3
        _LIB.t_row_smem_bytes.restype = ctypes.c_longlong
        _LIB.t_row_chunk.argtypes = [ctypes.c_int] * 3
        _LIB.t_row_chunk.restype = ctypes.c_int
    return _LIB


def t_row_layout_bytes(lc, nv, acc_bytes):
    """Bytes of the kernel's shared-memory layout (csrc/t_row.cu `Layout`)
    for chunks of lc occupied indices: the t3 tile, the operand ring and
    the fixed sums (7048 elements), Eo and the three X2l sums of the chunk
    (216 lc), and Z1/Z1m (16 nv)."""
    return (7048 + 216 * lc + 16 * nv) * acc_bytes


def t_row_chunk(no, nv, acc_bytes):
    """The occupied indices l that one block stages at once: all no when
    they fit in `_SMEM_BUDGET`, else the most that fit; 0 when not even
    one does (the mirror of csrc/t_row.cu `chunk_of`)."""
    room = _SMEM_BUDGET // acc_bytes - 7048 - 16 * nv
    return max(0, min(no, room // 216))


def t_row_smem_bytes(no, nv, acc_bytes):
    """Bytes of dynamic shared memory one block takes (the mirror of the
    library's t_row_smem_bytes): past `_SMEM_BUDGET` only when
    t_row_chunk is 0."""
    return t_row_layout_bytes(max(t_row_chunk(no, nv, acc_bytes), 1), nv,
                              acc_bytes)


def _types(dtype, stream_dtype):
    """(streamed operand dtype, tile/output dtype) for operands of `dtype`."""
    sd = dtype if stream_dtype is None else stream_dtype
    if sd not in _ENTRIES:
        raise TypeError("t_energy_row streams float64, float32 or bfloat16, "
                        "got %s" % sd)
    return sd, (torch.float32 if sd == torch.bfloat16 else sd)


def t_energy_row_reference(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov,
                           eps, t2, no, stream_dtype=None):
    """The plain version: for each j, the (k, a, b, c) slab of t3[i, j]
    from `triples._t3c_slab_ij`, then the seven projections by einsum.
    stream_dtype=torch.bfloat16 rounds the streamed operands (Wv, Wo, Ev,
    Eo, L, t2) to bfloat16 and computes in float32, with Fov and eps in
    float32, as the Pallas kernel does."""
    sd, acc = _types(Wvvvo_o.dtype, stream_dtype)
    Wv, Wo, Ev, Eo, L, t2 = (x.to(sd).to(acc) for x in
                             (Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, t2))
    Fov, eps = Fov.to(acc), eps.to(acc)
    Ev1 = 2.0 * Ev - Ev.swapaxes(2, 3)
    rows = []
    for j in range(no):
        t3 = _t3c_slab_ij(i, j, Wv, Wo, t2, eps[:no], eps[no:])
        T = 2.0 * t3 - t3.swapaxes(2, 3) - t3.swapaxes(1, 3)
        rows.append((contract("kabc,kbc->a", t3, L[j]),
                     contract("kabc,kba->c", t3, L[j]),
                     contract("kabc,dkbc->ad", t3, Ev1),
                     contract("kabc,dkba->cd", t3, Ev),
                     contract("kabc,kc->ab", t3, Fov),
                     contract("kabc,ka->bc", t3, Fov),
                     contract("kabc,klc->lab", T, Eo[j])))
    return tuple(torch.stack(x) for x in zip(*rows))


def t_row_derived(Wovoo_t, Evovv, t2, stream_dtype=None):
    """(t2m, Otm, G): the operands the kernel derives from Wovoo_t, Evovv
    and t2, in the streamed type.  t2 and Wovoo_t get the occupied
    contraction index last, so that the kernel streams every build operand
    along its contraction index, and Otm carries the minus sign of the six
    Wovoo terms; G = 2 Ev[d,k,b,c] - Ev[d,k,c,b] is the Z1 operand, in the
    streamed type as the Pallas kernel forms it.  None depends on the row,
    so `t_vikings_rows` forms them once for all rows."""
    sd, _ = _types(t2.dtype, stream_dtype)
    Wo, Ev, t2s = (x.to(sd) for x in (Wovoo_t, Evovv, t2))
    return (t2s.permute(0, 2, 3, 1).contiguous(),
            Wo.permute(0, 1, 3, 2).neg().contiguous(),
            (2.0 * Ev - Ev.transpose(2, 3)).contiguous())


def t_energy_row(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps, t2, no,
                 stream_dtype=None, derived=None):
    """(X1a (o,v), X1m (o,v), Z1, Z1m, Z2a, Z2m (o,v,v), X2l (o,o,v,v)) of
    row i.  Operands of one dtype, float64 or float32; stream_dtype=None
    keeps it, float32 or bfloat16 streams them in that type (bfloat16 is
    accumulated in float32, with Fov and eps in float32).  The cast is
    made on each call.  derived, if given, is `t_row_derived` of the same
    operands and stream_dtype; else it is formed here.  The outputs are in
    the accumulate type.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (`t_energy_row.launches` counts the launches)."""
    ops = (Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps, t2)
    if all(x.device.type == "cpu" for x in ops):
        return t_energy_row_reference(i, *ops, no, stream_dtype=stream_dtype)
    dev = Wvvvo_o.device
    if dev.type != "cuda" or any(x.device != dev for x in ops):
        raise ValueError("t_energy_row: the operands must all be CPU tensors "
                         "or all on one CUDA device (got %s)"
                         % sorted({str(x.device) for x in ops}))
    dtypes = {x.dtype for x in ops}
    if len(dtypes) != 1 or Wvvvo_o.dtype not in (torch.float64,
                                                 torch.float32):
        raise TypeError("t_energy_row takes operands of one dtype, float64 "
                        "or float32, got %s" % sorted(map(str, dtypes)))
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("t_energy_row: the operands must be contiguous")
    nv = t2.shape[-1]
    want = ((no, nv, nv, nv), (no, no, no, nv), (nv, no, nv, nv),
            (no, no, no, nv), (no, no, nv, nv), (no, nv), (no + nv,),
            (no, no, nv, nv))
    got = tuple(tuple(x.shape) for x in ops)
    if got != want:
        raise ValueError("t_energy_row: shapes %s do not fit (no, nv) = "
                         "(%d, %d): want %s" % (got, no, nv, want))
    if not 0 <= i < no:
        raise ValueError("t_energy_row: row %d outside [0, %d)" % (i, no))
    sd, acc = _types(Wvvvo_o.dtype, stream_dtype)
    lib = _library()
    smem = lib.t_row_smem_bytes(no, nv, torch.finfo(acc).bits // 8)
    if smem > _SMEM_BUDGET:
        raise ValueError("t_energy_row: nv = %d needs %d bytes of shared "
                         "memory a block for one occupied index (the "
                         "kernel has %d)" % (nv, smem, _SMEM_BUDGET))
    if derived is None:
        derived = t_row_derived(Wovoo_t, Evovv, t2, stream_dtype)
    want = ((no, nv, nv, no), (no, no, nv, no), (nv, no, nv, nv))
    if (tuple(tuple(x.shape) for x in derived) != want
            or any(x.dtype != sd or x.device != dev or not x.is_contiguous()
                   for x in derived)):
        raise ValueError("t_energy_row: derived is not t_row_derived of "
                         "these operands")
    t2m, Otm, G = derived
    Wv, Ev, Eo, L, t2s = (x.to(sd) for x in (Wvvvo_o, Evovv, Eooov, Loovv,
                                             t2))
    Fa, ea = Fov.to(acc), eps.to(acc)
    outs = tuple(torch.zeros(s, dtype=acc, device=dev) for s in
                 ((no, nv), (no, nv), (no, nv, nv), (no, nv, nv),
                  (no, nv, nv), (no, nv, nv), (no, no, nv, nv)))
    # two elements a copy when every staged row starts on an even element
    pair = 2 * Wv.element_size()
    vec = 2 if (no % 2 == 0 and nv % 2 == 0 and all(
        x.data_ptr() % pair == 0 for x in (Wv, t2m, Otm, Ev, G, t2s))) else 1
    # the launch goes to the current device: make it the operands'
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, _ENTRIES[sd])(
            i, *(x.data_ptr() for x in (Wv, t2m, Otm, Ev, G, Eo, L, Fa, ea,
                                        t2s) + outs),
            no, nv, vec, stream)
    if rc != 0:
        raise RuntimeError("t_row launch failed: %s"
                           % lib.t_row_error_string(rc).decode())
    t_energy_row.launches += 1
    return outs


t_energy_row.launches = 0


def t_row_finalize(i, outs, t1, t2w):
    """The (T) energy of row i from its projections; t2w = 4 t2 - 2 t2^T
    (ab swapped), made once by the caller."""
    X1a, X1m, Z1, Z1m, Z2a, Z2m, X2l = outs
    t1i, t2wi = t1[i].to(X1a.dtype), t2w[i].to(X1a.dtype)
    X2 = (Z1 - Z1m) + (Z2a - Z2m.swapaxes(1, 2))
    e = 2.0 * contract("a,ja->", t1i, X1a - X1m)
    e = e + contract("jab,jab->", t2wi, X2)
    # the X2l term pairs t2w[i, l] with X2l[j, l]
    return e - contract("lab,jlab->", t2wi, X2l)


def t_vikings_rows(Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps, t1, t2,
                   no):
    """The (T) energy, one `t_energy_row` per occupied row: the port of
    pycc_tpu's t_vikings_pallas.  The row energies are summed on the
    device; the result is a 0-d tensor for the caller's one host read."""
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    derived = (None if t2.device.type == "cpu"
               else t_row_derived(Wovoo_t, Evovv, t2))
    e = None
    for i in range(no):
        outs = t_energy_row(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov,
                            eps, t2, no, derived=derived)
        ei = t_row_finalize(i, outs, t1, t2w)
        e = ei if e is None else e + ei
    return e
