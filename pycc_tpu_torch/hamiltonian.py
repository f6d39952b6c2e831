"""MO-basis normal-ordered Hamiltonian as a dataclass of torch tensors.

Fock matrix F, Dirac-notation ERI <pq|rs>, spin-adapted L = 2<pq|rs> -
<pq|sr>, and one-electron property integrals (electric dipole mu, magnetic
dipole m, linear momentum p, traceless quadrupole Q) over the active MO
space.  The counterpart of pycc_tpu/hamiltonian.py.  A mesh solver's full
storage starts as an `AOSource` (the host AO ERI and C), from which
parallel/mesh.py makes each card's pieces on that card.  The AO ERI goes
from host memory to a card through an `Uplink`, pinned staging buffers
filled by several host threads.
"""

import contextlib
from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from .utils.device import init_device
from .utils.timing import span


@dataclass(frozen=True, eq=False)
class Hamiltonian:
    F: torch.Tensor
    ERI: torch.Tensor     # None under storage='df' (the factors carry it)
    L: torch.Tensor
    mu: tuple = ()        # 3 (nact,nact) real matrices (electric dipole, -r)
    m: tuple = ()         # 3 complex matrices (magnetic dipole)
    p: tuple = ()         # 3 complex matrices (linear momentum)
    Q: tuple = ()         # 6 real matrices (traceless quadrupole, XX..ZZ)
    no: int = 0

    @property
    def o(self):
        return slice(0, self.no)

    @property
    def v(self):
        return slice(self.no, None)

    @cached_property
    def vvvv(self):
        """<ab|ef> as one contiguous (v,v,v,v) tensor, made once.
        ERI[v,v,v,v] is a strided view of the (nact)^4 tensor, and the
        ladder's (v^2, v^2) matrix would otherwise copy v^4 elements on
        every residual evaluation.  None when ERI is None."""
        if self.ERI is None:
            return None
        v = self.v
        return self.ERI[v, v, v, v].contiguous()

    @classmethod
    def from_numpy(cls, F, ERI, L, no, device="cuda", dtype=torch.float64,
                   mu=(), m=(), p=(), Q=()):
        """Carry host arrays (e.g. pycc_tpu's Hamiltonian, via numpy) onto
        `device`: F/ERI/L and the real property matrices in `dtype`, the
        complex ones (m, p) in complex128."""
        dev = init_device(device)
        F, ERI, L = _tensors((F, ERI, L), dtype, dev)
        return cls(F=F, ERI=ERI, L=L, no=int(no),
                   **_properties(mu, m, p, Q, dtype, dev))


class AOSource(NamedTuple):
    """Full storage not made yet: the AO ERI in host memory (the SCF's
    `ERI_ao`), the active MO coefficients C (nbf, nact, float64, host)
    and the dtype of ERI and L.  A mesh solver's Hamiltonian holds one in
    place of ERI (L None) until `parallel.mesh.shard_hamiltonian` makes
    each card's pieces on that card."""
    ERI_ao: object
    C: torch.Tensor
    dtype: torch.dtype


def ao_source(wfn, dtype=torch.float64):
    """The AOSource of wfn's active space: its kept AO ERI (computed here
    when it has none) and C, as build_hamiltonian reads them."""
    from .scf import integrals as ints

    ERI_ao = getattr(wfn, "ERI_ao", None)
    if ERI_ao is None:
        ERI_ao = ints.eri(wfn.basisset())
    C = torch.as_tensor(np.asarray(wfn.Ca_subset("AO", "ACTIVE")),
                        dtype=torch.float64)
    return AOSource(ERI_ao=ERI_ao, C=C, dtype=dtype)


# an Uplink's staging buffers: at most STAGE_BYTES each, STAGE_BUFFERS a
# card; STAGE_BYTES is also a mesh build's default chunk
STAGE_BYTES = 2 ** 29
STAGE_BUFFERS = 2


class Uplink:
    """Copies from host memory to one card through a ring of staging
    buffers.

    From pageable memory CUDA copies through a small pinned buffer of
    its own, filled by one host thread: about 6 GB/s on an H100's host,
    whatever the link allows.  An Uplink cuts what it sends
    into pieces of at most STAGE_BYTES.  The host copies a piece into the
    ring's next buffer (`copy_` between CPU tensors, on torch's intra-op
    threads; the span 'hamiltonian.stage', with its bytes).  The card's
    copy stream then takes it from there (`non_blocking`), and an event
    after that copy frees the buffer: the host refills a buffer only once
    its event has completed, so it stages piece k + 1 while piece k
    crosses the link.  Before its first piece the copy stream waits until
    the destination may be written; after the last, the card's current
    stream waits on the copy stream, so no reader there sees a piece that
    has not landed.  A copy is exact: the destination holds the source's
    bytes.

    The ring is STAGE_BUFFERS pinned buffers of at most STAGE_BYTES (1 GiB
    a card, 4 GiB for a mesh of four), made at first use by torch's
    caching host allocator.  Dropped with the Uplink, they go back to that
    allocator's cache, which hands them to the next upload of the same
    size, as the CUDA caching allocator does device memory; nothing in
    them is read again.  An Uplink keeps no copy of its source and no
    registration of its memory.

    On a CPU device the buffers are not pinned and every copy ends before
    the next begins (no stream, no event): the CPU tests run the ring that
    way, though `uplink` gives a CPU target no Uplink."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.ring, self.copied = [], []   # buffers; their last copy's event
        self.slots, self.freed = [], []   # `take`'s; their readers' event
        self.staged = self.taken = 0
        self.last = None                  # the last `take`'s slot

    def _current(self):
        if self.stream is None:
            return None
        return torch.cuda.current_stream(self.device)

    def _record(self, stream):
        """An event at the end of the work queued on `stream` so far."""
        if stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def _copying(self):
        """The copy stream as the current one, on a card."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _dma(self, dst, buf):
        """Queue the copy of a staged buffer into dst; its event."""
        if self.stream is None:
            dst.copy_(buf)
            return None
        dst.copy_(buf, non_blocking=True)
        return self._record(self.stream)

    def _sync(self, ev):
        """The host waits for the copy that recorded `ev`."""
        if ev is not None:
            ev.synchronize()

    def _join(self, ev):
        """The current stream waits for the copy that recorded `ev`."""
        if ev is not None:
            self._current().wait_event(ev)

    def _stage(self, piece, size):
        """(index, buffer) of the ring's next buffer, of at least `size`
        elements, holding piece, once its last copy is done."""
        i = self.staged % STAGE_BUFFERS
        self.staged += 1
        if i == len(self.ring):
            self.ring.append(None)
            self.copied.append(None)
        self._sync(self.copied[i])
        buf = self.ring[i]
        if buf is None or buf.numel() < piece.numel():
            buf = self.ring[i] = torch.empty(
                size, dtype=piece.dtype, pin_memory=self.stream is not None)
        buf = buf[:piece.numel()]
        with span("hamiltonian.stage", nbytes=piece.nbytes):
            buf.copy_(piece)
        return i, buf

    def send(self, src, dst, ready=None, name=None):
        """Copy src, a contiguous CPU tensor, into dst, a contiguous tensor
        of its shape and dtype on this card, piece by piece through the
        ring.  The copy stream first waits on the event `ready` (None: the
        current stream's work queued so far), after which dst may be
        written; each piece's copy is the span `name`, if one is given, on
        the copy stream."""
        src, out = src.reshape(-1), dst.view(-1)
        per = max(1, STAGE_BYTES // src.element_size())
        size = min(per, src.numel())
        if ready is None:
            ready = self._record(self._current())
        ev = None
        for a in range(0, src.numel(), per):
            piece = src[a:a + per]
            i, buf = self._stage(piece, size)
            with self._copying():
                if ready is not None:
                    self.stream.wait_event(ready)
                    ready = None
                with (span(name, nbytes=piece.nbytes) if name
                      else contextlib.nullcontext()):
                    ev = self.copied[i] = self._dma(out[a:a + per], buf)
        self._join(ev)

    def take(self, src, name=None):
        """src, a contiguous CPU tensor, sent (`send`) to a slot of this
        card: a device tensor of the ring's, one a buffer, reused in turn.
        Call `release()` once every reader of the returned tensor is
        queued: the slot's next copy waits for them."""
        j = self.taken % STAGE_BUFFERS
        self.taken += 1
        if j == len(self.slots):
            self.slots.append(None)
            self.freed.append(None)
        slot = self.slots[j]
        if slot is None or slot.numel() < src.numel():
            # a new block may be one that the current stream still reads
            slot = self.slots[j] = torch.empty(src.numel(), dtype=src.dtype,
                                               device=self.device)
            self.freed[j] = None
        X = slot[:src.numel()].view(src.shape)
        self.send(src, X, ready=self.freed[j], name=name)
        self.last = j
        return X

    def release(self):
        """The last `take`'s slot may be written again once the current
        stream's work queued so far is done."""
        self.freed[self.last] = self._record(self._current())


def uplink(device, src):
    """An Uplink for copies of the CPU tensor src to `device`, or None where
    a plain copy is as fast: a target other than a CUDA card, or a source
    already on a device or already pinned."""
    device = torch.device(device)
    if device.type != "cuda" or src.device.type != "cpu" or src.is_pinned():
        return None
    return Uplink(device)


def ao_eri_to(ERI_ao, device):
    """The AO ERI (host array or tensor) on `device`, equal to
    torch.as_tensor(ERI_ao, device=device) bit for bit: through an Uplink
    where `uplink` gives one, else that plain copy."""
    src = torch.as_tensor(ERI_ao)
    link = uplink(device, src)
    if link is None:
        return torch.as_tensor(src, device=device)
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    link.send(src, out)
    return out


def _tensors(arrays, dtype, dev):
    return tuple(torch.tensor(np.asarray(x), dtype=dtype, device=dev)
                 for x in arrays)


def _properties(mu, m, p, Q, dtype, dev):
    return dict(mu=_tensors(mu, dtype, dev),
                m=_tensors(m, torch.complex128, dev),
                p=_tensors(p, torch.complex128, dev),
                Q=_tensors(Q, dtype, dev))


def _mo_eri_dirac(ERI_ao, C):
    """AO (ab|cd) -> MO <pq|rs> (physicists') by four quarter transforms.
    Each tensordot contracts the leading AO index and appends the new MO
    index last, so after four the order is (pr|qs)."""
    t = ERI_ao
    for _ in range(4):
        t = torch.tensordot(t, C, dims=([0], [0]))
    return t.swapaxes(1, 2).contiguous()


def mo_eri_blocks(wfn, device="cuda", dtype=torch.float64):
    """The six canonical Dirac blocks of the active-space ERI
    (models/blocked.ERIBlocks: oooo, ooov, oovv, ovov, ovvv, vvvv), each
    transformed straight from the AO ERI by four quarter transforms with
    the occupied or the virtual columns of C, in float64 on `device`, then
    cast to `dtype`.  The nact^4 MO ERI is never formed.  A partial
    transform that several blocks share is made once, and dropped as soon
    as no block left needs it.  The AO ERI is the wavefunction's (`ERI_ao`), or
    is computed here."""
    from .models.blocked import CANONICAL, ERIBlocks
    from .scf import integrals as ints

    dev = init_device(device)
    no = wfn.doccpi()[0] - wfn.frzcpi()[0]
    C = torch.as_tensor(np.asarray(wfn.Ca_subset("AO", "ACTIVE")),
                        dtype=torch.float64, device=dev)
    cols = {"o": C[:, :no], "v": C[:, no:]}
    ERI_ao = getattr(wfn, "ERI_ao", None)
    if ERI_ao is None:
        ERI_ao = ints.eri(wfn.basisset())
    # <pq|rs> = (pr|qs): block pat transforms the AO indices in the
    # chemists' order p, r, q, s
    chem = [pat[0] + pat[2] + pat[1] + pat[3] for pat in CANONICAL]
    done = {"": ao_eri_to(ERI_ao, dev)}
    del ERI_ao
    blocks = []
    for k, order in enumerate(chem):
        for depth in range(1, 5):
            key = order[:depth]
            if key not in done:
                done[key] = torch.tensordot(done[key[:-1]], cols[key[-1]],
                                            dims=([0], [0]))
            # a partial transform goes as soon as no later block needs it
            if not any(c.startswith(key[:-1]) for c in chem[k + 1:]):
                done.pop(key[:-1], None)
        blocks.append(done.pop(order).permute(0, 2, 1, 3).to(dtype)
                      .contiguous())
    return ERIBlocks(*blocks)


def ao_properties(wfn):
    """(dipole, angular momentum, nabla, traceless quadrupole) AO integral
    matrices of wfn's basis, computed on the host once and kept on the
    wavefunction (`wfn.ao_props`), as run_rhf keeps the AO ERI: every
    Hamiltonian built from one wavefunction (another storage, a localized
    basis) transforms the same matrices, and at 144 basis functions they
    take seconds of host time each build."""
    from .scf import integrals as ints

    props = getattr(wfn, "ao_props", None)
    if props is None:
        basis = wfn.basisset()
        props = (ints.dipole(basis), ints.angular_momentum(basis),
                 ints.nabla(basis), ints.traceless_quadrupole(basis))
        wfn.ao_props = props
    return props


def build_hamiltonian(wfn, C=None, device="cuda", dtype=torch.float64,
                      eri=True):
    """Build the active-space Hamiltonian from an SCF wavefunction.

    `wfn` is a pycc_tpu_torch.scf.RHFWavefunction.  `C` (AO x active,
    numpy) overrides its active MO coefficients, e.g. with localized
    occupied orbitals: F, ERI, L and every property integral are then in
    that basis, as in pycc_tpu's build_hamiltonian(wfn, C=).  The AO
    property integrals are `ao_properties(wfn)`.  The AO integrals come
    from the host engine; the four-index MO transform runs in float64 on
    `device`, and F/ERI/L are then cast to `dtype`, as are the real
    property integrals (mu, Q); the complex ones (m, p) stay complex128,
    as in pycc_tpu.  A Hamiltonian without property integrals holds the
    empty tuple `()` for each of them (never None): the response code
    tests them for emptiness.

    The AO ERI is the one run_rhf kept on the wavefunction (`ERI_ao`), or
    is computed here when there is none.  eri=False skips the four-index
    tensors entirely (ERI = L = None) and never computes the AO ERI:
    ccwfn(storage='df') carries the two-electron integrals as Cholesky
    factors instead."""
    from .scf import integrals as ints

    dev = init_device(device)
    f64 = torch.float64
    C_np = np.asarray(wfn.Ca_subset("AO", "ACTIVE") if C is None else C)
    C = torch.as_tensor(C_np, dtype=f64, device=dev)
    F = C.T @ torch.as_tensor(np.asarray(wfn.Fa()), dtype=f64, device=dev) @ C

    basis = wfn.basisset()
    ERI = L = None
    if eri:
        ERI_ao = getattr(wfn, "ERI_ao", None)
        if ERI_ao is None:
            ERI_ao = ints.eri(basis)
        # the span ends once the current stream has waited for the copy
        with span("hamiltonian.h2d", nbytes=ERI_ao.nbytes):
            ERI = ao_eri_to(ERI_ao, dev)
        del ERI_ao
        ERI = _mo_eri_dirac(ERI, C)
        L = (2.0 * ERI - ERI.swapaxes(2, 3)).to(dtype)
        ERI = ERI.to(dtype)

    def mo(M):
        return C_np.T @ M @ C_np

    dip, ang, nab, quad = ao_properties(wfn)
    mu = tuple(mo(M) for M in dip)
    m = tuple(mo(M * -0.5) * 1.0j for M in ang)
    p = tuple(mo(M) * 1.0j for M in nab)
    Q = tuple(mo(M) for M in quad)
    no = wfn.doccpi()[0] - wfn.frzcpi()[0]
    return Hamiltonian(F=F.to(dtype), ERI=ERI, L=L, no=no,
                       **_properties(mu, m, p, Q, dtype, dev))
