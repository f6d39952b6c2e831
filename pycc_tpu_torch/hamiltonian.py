"""MO-basis normal-ordered Hamiltonian as a dataclass of torch tensors.

Fock matrix F, Dirac-notation ERI <pq|rs>, spin-adapted L = 2<pq|rs> -
<pq|sr>, and one-electron property integrals (electric dipole mu, magnetic
dipole m, linear momentum p, traceless quadrupole Q) over the active MO
space.  The counterpart of pycc_tpu/hamiltonian.py.

Every four-index MO integral of the port is made by one transform,
`mo_eri_cells`: one pass over the AO ERI (mn|ls) in chunks of its first
index m (about 512 MiB a chunk, STAGE_BYTES), into the accumulators of a
list of cells.  A cell (`Cell`) is a device and the windows of the MO
indices (p, q, r, s) of <pq|rs> = (pr|qs) that it needs.  One device's
full storage is one cell that covers every index (build_hamiltonian),
the blocked storage six, one a canonical block (mo_eri_blocks), and a
mesh's full storage one a distinct piece (parallel/mesh.build_full).
A mesh solver's full storage starts as an `AOSource` (the host AO ERI
and C), from which build_full makes each card's pieces on that card.

The chunks go round the cells' distinct devices, so each card takes its
share from the host over its own link: chunk k is copied from host
memory to device k mod n once, through that card's `Uplink` (pinned
staging buffers filled by several host threads; the card's copy stream
takes a chunk from there while the host stages the next), and from that
card to each other device (card to card).  Each card holds at most two
received chunks and one forwarded chunk at a time, and the host two
pinned buffers a card (1 GiB), which go back to torch's pinned-memory
cache when the transform ends.  Each cell keeps an accumulator
acc[p, s, q, r] over the hull of its windows; a chunk adds its part of
the sum over m by three quarter transforms (s, then q, then r; GEMMs)
and one GEMM with C[m, p].  No device ever holds the whole AO ERI.

Arithmetic: at (H2O)_6/cc-pVDZ (nbf 144, nact 138) one cell, 7 chunks of
22 values of m; the accumulator is 2.9 GB, and the card's peak is about
two nact^4 tensors (the accumulator and ERI, then ERI and L), where the
four whole-tensor quarter transforms held the AO ERI and two
intermediates (9.9 GB).  At (H2O)_6/aug-cc-pVDZ (nbf 246, nact 240,
(o, v) = (24, 216)) on a 2 x 2 mesh the AO ERI is 29.3 GB (62 chunks of
4 values of m, 476 MB each): 7.3 GB on each card's link and 3 x 29.3 GB
card to card.  A mesh cell's columns r and s are 132 or 120 a side
(ERI's ranges 120 + 120 of nact, W's 108 + 108 of v, shifted by 24); the
fullest, (132, 132), does 2 x 246 (246^3 132 + 246^2 132 240 + 246 132
240 132 + 240 132 240 132) = 2.9 TFLOP in float64 GEMMs, and holds its
accumulator (8.0 GB), then its pieces: ERI and L 6.6 GB each, W 4.35 GB;
its peak is about 19 GB beside about 2 GB of chunk transients.  The
host's staging copies bound the transform.
"""

import contextlib
from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from .utils.device import init_device, on_device
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


def ao_source(wfn, dtype=torch.float64, C=None):
    """The AOSource of wfn's active space, or of the columns C (AO x
    active) in its place: its kept AO ERI (computed here when it has
    none) and C."""
    from .scf import integrals as ints

    ERI_ao = getattr(wfn, "ERI_ao", None)
    if ERI_ao is None:
        ERI_ao = ints.eri(wfn.basisset())
    if C is None:
        C = np.asarray(wfn.Ca_subset("AO", "ACTIVE"))
    return AOSource(ERI_ao=ERI_ao, C=torch.as_tensor(C, dtype=torch.float64),
                    dtype=dtype)


# an Uplink's staging buffers: at most STAGE_BYTES each, STAGE_BUFFERS a
# card; STAGE_BYTES is also mo_eri_cells' default chunk
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


class Cell(NamedTuple):
    """What one cell of `mo_eri_cells` makes on `device`: the Dirac piece
    <pq|rs> on the windows `eri`, one (start, stop) of nact for each of p,
    q, r and s; with L=True also 2 <pq|rs> - <qp|rs> on them (which is
    2 <pq|rs> - <pq|sr> for real orbitals where the p and q windows are
    one); with `W`, windows (p, q, r, s) too, that Dirac piece laid out
    as (r, s, p, q): the ladder's W[a, b, e, f] = <ef|ab>."""
    device: torch.device
    eri: tuple
    L: bool = False
    W: tuple = None


class _Cell:
    """A cell's accumulator acc[p, s, q, r] over the hull of its windows,
    on its device."""

    def __init__(self, spec, C):
        self.spec = spec
        self.device = torch.device(spec.device)
        wins = (spec.eri,) if spec.W is None else (spec.eri, spec.W)
        self.hull = tuple((min(w[k][0] for w in wins),
                           max(w[k][1] for w in wins)) for k in range(4))
        hp, hq, hr, hs = (hi - lo for lo, hi in self.hull)
        self.C = C
        self.acc = torch.zeros((hp, hs, hq, hr), dtype=torch.float64,
                               device=self.device)

    def add(self, X, m0):
        """The chunk X = (m0 + m, n, l, s) of the AO ERI's part of the sum
        over m, three quarter transforms and one GEMM."""
        C = self.C
        hp, hq, hr, hs = (slice(*h) for h in self.hull)
        Y = torch.tensordot(X, C[:, hs], dims=([3], [0]))
        Y = torch.tensordot(Y, C[:, hq], dims=([2], [0]))
        Y = torch.tensordot(Y, C[:, hr], dims=([1], [0]))
        m = X.shape[0]
        self.acc.view(self.acc.shape[0], -1).addmm_(C[m0:m0 + m, hp].T,
                                                    Y.reshape(m, -1))

    def _cut(self, windows, order, dtype):
        """A contiguous copy, in `dtype`, of the accumulator's part on the
        windows (p, q, r, s), its axes in `order` of acc's (p, s, q, r)."""
        p, q, r, s = (slice(lo - h[0], hi - h[0])
                      for (lo, hi), h in zip(windows, self.hull))
        x = self.acc[p, s, q, r].permute(order)
        return torch.empty(x.shape, dtype=dtype,
                           device=self.device).copy_(x)

    def pieces(self, dtype):
        """(ERI, L, W) pieces from the accumulator, cast to `dtype`, None
        where the cell asks for none; the accumulator goes before L is
        made."""
        W = None
        if self.spec.W is not None:
            W = self._cut(self.spec.W, (3, 1, 0, 2), dtype)
        E = self._cut(self.spec.eri, (0, 2, 3, 1), torch.float64)
        self.acc = None
        L = None
        if self.spec.L:
            L = torch.empty_like(E)
            torch.neg(E.transpose(0, 1), out=L)
            L.add_(E, alpha=2.0)
        if dtype != E.dtype:
            E = E.to(dtype)
            L = None if L is None else L.to(dtype)
        return E, L, W


def mo_eri_cells(src, cells, chunk_bytes=None):
    """[(ERI, L, W)] of each `Cell` in `cells`, on its device, from src
    (an `AOSource`) in one pass over the AO ERI in chunks of its first
    index, about `chunk_bytes` a chunk (None: STAGE_BYTES), in float64,
    then cast to src.dtype (the module's text).  The chunks go round the
    cells' distinct devices: each is copied from the host to one of them
    once, through its `Uplink` where `uplink` gives one (the span
    'hamiltonian.h2d', its bytes, one a staged piece on the copy stream;
    else one a chunk around the plain copy), and from there to each other
    device, where each cell adds it to its accumulator (the span
    'hamiltonian.shard' on the cell's device); then each cell makes its
    pieces (the same span)."""
    chunk_bytes = STAGE_BYTES if chunk_bytes is None else chunk_bytes
    C = src.C.to(torch.float64)
    nbf = C.shape[0]
    Cs, made = {}, []
    for spec in cells:
        dev = torch.device(spec.device)
        if dev not in Cs:
            Cs[dev] = C.to(dev)
        made.append(_Cell(spec, Cs[dev]))
    eri = torch.as_tensor(src.ERI_ao)
    links = {d: uplink(d, eri) for d in dict.fromkeys(c.device for c in made)}
    receivers = list(links)
    step = max(1, chunk_bytes // (nbf ** 3 * eri.element_size()))
    for k, m0 in enumerate(range(0, nbf, step)):
        dev = receivers[k % len(receivers)]
        part, link = eri[m0:m0 + step], links[dev]
        if link is None:
            with on_device(dev), span("hamiltonian.h2d", nbytes=part.nbytes):
                X = part.to(dev, torch.float64)
        else:
            X = link.take(part, name="hamiltonian.h2d").to(torch.float64)
        on = {dev: X}
        for cell in made:
            d = cell.device
            if d not in on:
                on[d] = X.to(d)
            with on_device(d), span("hamiltonian.shard"):
                cell.add(on[d], m0)
        if link is not None:
            link.release()
        del X, on, link
    # the device slots go before the pieces are made
    del links
    out = []
    for cell in made:
        with on_device(cell.device), span("hamiltonian.shard"):
            out.append(cell.pieces(src.dtype))
    return out


def _tensors(arrays, dtype, dev):
    return tuple(torch.tensor(np.asarray(x), dtype=dtype, device=dev)
                 for x in arrays)


def _properties(mu, m, p, Q, dtype, dev):
    return dict(mu=_tensors(mu, dtype, dev),
                m=_tensors(m, torch.complex128, dev),
                p=_tensors(p, torch.complex128, dev),
                Q=_tensors(Q, dtype, dev))


def mo_eri_blocks(wfn, device="cuda", dtype=torch.float64):
    """The six canonical Dirac blocks of the active-space ERI
    (models/blocked.ERIBlocks: oooo, ooov, oovv, ovov, ovvv, vvvv), each
    one cell of `mo_eri_cells` on `device`, in float64, then cast to
    `dtype`.  The nact^4 MO ERI is never formed.  The AO ERI is the
    wavefunction's (`ERI_ao`), or is computed here."""
    from .models.blocked import CANONICAL, ERIBlocks

    dev = init_device(device)
    src = ao_source(wfn, dtype)
    no = wfn.doccpi()[0] - wfn.frzcpi()[0]
    space = {"o": (0, no), "v": (no, src.C.shape[1])}
    cells = [Cell(dev, tuple(space[c] for c in pat)) for pat in CANONICAL]
    return ERIBlocks(*(E for E, _, _ in mo_eri_cells(src, cells)))


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
    from the host engine; the four-index MO transform is one cell of
    `mo_eri_cells` on `device` that covers every index, in float64, and
    F/ERI/L are then cast to `dtype`, as are the real
    property integrals (mu, Q); the complex ones (m, p) stay complex128,
    as in pycc_tpu.  A Hamiltonian without property integrals holds the
    empty tuple `()` for each of them (never None): the response code
    tests them for emptiness.

    The AO ERI is the one run_rhf kept on the wavefunction (`ERI_ao`), or
    is computed here when there is none.  eri=False skips the four-index
    tensors entirely (ERI = L = None) and never computes the AO ERI:
    ccwfn(storage='df') carries the two-electron integrals as Cholesky
    factors instead."""
    dev = init_device(device)
    f64 = torch.float64
    C_np = np.asarray(wfn.Ca_subset("AO", "ACTIVE") if C is None else C)
    C = torch.as_tensor(C_np, dtype=f64, device=dev)
    F = C.T @ torch.as_tensor(np.asarray(wfn.Fa()), dtype=f64, device=dev) @ C

    ERI = L = None
    if eri:
        whole = ((0, C.shape[1]),) * 4
        ERI, L, _ = mo_eri_cells(ao_source(wfn, dtype, C),
                                 [Cell(dev, whole, L=True)])[0]

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
