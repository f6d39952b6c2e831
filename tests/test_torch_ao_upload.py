"""The AO ERI's staged upload (pycc_tpu_torch/hamiltonian.Uplink, and
the chunks of `mo_eri_cells` that go round the receiving cards).

On the CPU the ring runs through the same code with ordinary (unpinned)
staging buffers, in an Uplink whose copies land only when they are waited
for, as a card's copy stream runs behind the host: a buffer refilled
before its copy were done would send the wrong bytes.  On the card the
staged upload is held to `torch.as_tensor` bit for bit, its buffers are
pinned, two inits make two uploads, and the init's peak device memory is
below the whole-tensor transform's.

This file imports no JAX, so the card tests also run where JAX is absent:
    python -m pytest --noconftest tests/test_torch_ao_upload.py -q -m cuda
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

import pycc_tpu_torch
import pycc_tpu_torch.hamiltonian as ham
from pycc_tpu_torch.hamiltonian import Uplink, build_hamiltonian
from pycc_tpu_torch.parallel import make_mesh
from pycc_tpu_torch.parallel.mesh import build_full
from pycc_tpu_torch.utils import timing

from portbench.harness.inputs import make_inputs
from portbench.harness.spec import Spec

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class Deferred(Uplink):
    """An Uplink on the CPU whose copies land only when the host or the
    current stream waits for them, in the order they were queued.  Each
    copy checks that its staging buffer still holds what was staged for
    it; `most` is the most copies ever queued and not done."""

    def __init__(self, device=CPU):
        super().__init__(device)
        self.queue, self.most, self.copies = [], 0, 0

    def _dma(self, dst, buf):
        job = dict(dst=dst, buf=buf, staged=buf.clone())
        self.queue.append(job)
        self.most = max(self.most, len(self.queue))
        return job

    def _land(self, until):
        while until is not None and self.queue:
            job = self.queue.pop(0)
            assert torch.equal(job["buf"], job["staged"]), (
                "a staging buffer was refilled before its copy was done")
            job["dst"].copy_(job["buf"])
            self.copies += 1
            if job is until:
                return

    _sync = _join = _land


def _eri(nbf, seed=5):
    return np.random.default_rng(seed).standard_normal((nbf,) * 4)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, timing.spans()


@pytest.mark.parametrize("slices, pieces", [(12, 1), (2, 6), (5, 3)],
                         ids=["one-chunk", "more-chunks-than-buffers",
                              "short-last-chunk"])
def test_the_ring_sends_every_byte_once(monkeypatch, slices, pieces):
    """An AO ERI of 12 slices of its first index sent in pieces of
    `slices` slices (one piece; six through two buffers; 5 + 5 + 2) equals
    torch.as_tensor bit for bit, no buffer is refilled before its copy is
    done, at most two copies wait at once, and the 'hamiltonian.stage'
    spans count the pieces and sum to the AO ERI's bytes."""
    nbf = 12
    ERI_ao = _eri(nbf)
    monkeypatch.setattr(ham, "STAGE_BYTES", slices * nbf ** 3 * 8)
    link = Deferred()
    out = torch.empty((nbf,) * 4, dtype=torch.float64)
    _, rows = _traced(lambda: link.send(torch.as_tensor(ERI_ao), out))
    assert torch.equal(out, torch.as_tensor(ERI_ao))
    assert link.copies == pieces and not link.queue
    assert link.most <= ham.STAGE_BUFFERS
    assert len(link.ring) == min(pieces, ham.STAGE_BUFFERS)
    assert all(b.numel() == min(slices, nbf) * nbf ** 3 for b in link.ring)
    assert rows["hamiltonian.stage"]["count"] == pieces
    assert rows["hamiltonian.stage"]["bytes"] == ERI_ao.nbytes


def test_the_ring_never_holds_more_than_its_buffers(monkeypatch):
    """Ten pieces through the two buffers: the ring makes two buffers,
    and every refill waited for that buffer's last copy."""
    nbf = 10
    ERI_ao = _eri(nbf, seed=6)
    monkeypatch.setattr(ham, "STAGE_BYTES", nbf ** 3 * 8)
    link = Deferred()
    out = torch.empty((nbf,) * 4, dtype=torch.float64)
    link.send(torch.as_tensor(ERI_ao), out)
    assert torch.equal(out, torch.as_tensor(ERI_ao))
    assert link.copies == 10 and len(link.ring) == 2 and link.most == 2


def test_taken_slots_wait_for_their_release(monkeypatch):
    """`take` hands out two device slots in turn, each holding its chunk
    bit for bit; a third take reuses the first slot."""
    nbf = 8
    eri = torch.as_tensor(_eri(nbf, seed=7))
    monkeypatch.setattr(ham, "STAGE_BYTES", 3 * nbf ** 3 * 8)
    link = Deferred()
    seen = []
    for m0 in range(0, nbf, 3):
        X = link.take(eri[m0:m0 + 3])
        assert torch.equal(X, eri[m0:m0 + 3])
        seen.append(X.data_ptr())
        link.release()
    assert seen[2] == seen[0] != seen[1] and len(link.slots) == 2


def _wfn(seed=2 ** 31 + 7):
    cfg = dict(Spec().config("h2o6_vdz"), nbf=14, nfzc=1, ndocc=4)
    cfg["generator"] = dict(cfg["generator"], rank=60, scale=0.5)
    return make_inputs(cfg, seed, CPU)


@functools.lru_cache(maxsize=None)
def _cpu_wfn():
    return _wfn()


def test_the_cpu_target_takes_the_plain_copy(monkeypatch):
    """On a CPU target `uplink` gives no Uplink: build_hamiltonian makes
    one 'hamiltonian.h2d' (one chunk holds the tiny AO ERI) and no
    'hamiltonian.stage', and the chunk its cell adds is the AO ERI's own
    memory (no copy)."""
    w = _cpu_wfn()
    assert ham.uplink(CPU, torch.as_tensor(w.ERI_ao)) is None
    seen, add = [], ham._Cell.add

    def spy(cell, X, m0):
        seen.append(X.data_ptr())
        return add(cell, X, m0)
    monkeypatch.setattr(ham._Cell, "add", spy)
    _, rows = _traced(lambda: build_hamiltonian(w, device="cpu"))
    assert seen == [w.ERI_ao.ctypes.data]
    assert rows["hamiltonian.h2d"]["count"] == 1
    assert "hamiltonian.stage" not in rows


def test_staged_build_equals_the_plain_one(monkeypatch):
    """build_hamiltonian through the ring (two chunks, unpinned, on the
    CPU) gives the plain build's F, ERI and L bit for bit at the same
    chunking (two chunkings sum in two orders); one 'hamiltonian.h2d' and
    one 'hamiltonian.stage' a chunk, each summing to the AO ERI's
    bytes."""
    w = _cpu_wfn()
    nbf = w.ERI_ao.shape[0]
    monkeypatch.setattr(ham, "STAGE_BYTES", 8 * nbf ** 3 * 8)
    H0 = build_hamiltonian(w, device="cpu")
    monkeypatch.setattr(ham, "uplink", lambda dev, src: Deferred(dev))
    H, rows = _traced(lambda: build_hamiltonian(w, device="cpu"))
    for a, b in ((H.F, H0.F), (H.ERI, H0.ERI), (H.L, H0.L)):
        assert torch.equal(a, b)
    for name in ("hamiltonian.h2d", "hamiltonian.stage"):
        assert rows[name]["count"] == 2
        assert rows[name]["bytes"] == w.ERI_ao.nbytes


def test_staged_blocks_equal_the_plain_ones(monkeypatch):
    """mo_eri_blocks through the ring gives the plain blocks bit for
    bit, in chunks of 5 slices on both sides."""
    w = _cpu_wfn()
    monkeypatch.setattr(ham, "STAGE_BYTES", 5 * 14 ** 3 * 8)
    B0 = ham.mo_eri_blocks(w, device="cpu")
    monkeypatch.setattr(ham, "uplink", lambda dev, src: Deferred(dev))
    B = ham.mo_eri_blocks(w, device="cpu")
    for a, b in zip(B, B0):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- the card

@functools.lru_cache(maxsize=None)
def _card_wfn():
    cfg = Spec().config("h2o6_vdz")
    return make_inputs(cfg, 2 ** 31 + 3, torch.device("cuda"))


@pytest.mark.cuda
def test_card_upload_equals_as_tensor(cuda_device, monkeypatch):
    """At (H2O)_6/cc-pVDZ's nbf 144 (3.4 GB) the staged upload equals
    torch.as_tensor bit for bit, in 512-MiB pieces and in pieces of 7
    slices, which do not divide nbf; the ring's buffers are pinned; and
    every chunk that build_hamiltonian's cell adds is the AO ERI's part
    bit for bit."""
    ERI_ao = _card_wfn().ERI_ao
    src = torch.as_tensor(ERI_ao)
    ref = torch.as_tensor(ERI_ao, device=cuda_device)
    nbf = ERI_ao.shape[0]
    for stage in (ham.STAGE_BYTES, 7 * nbf ** 3 * 8):
        monkeypatch.setattr(ham, "STAGE_BYTES", stage)
        link = ham.uplink(cuda_device, src)
        assert isinstance(link, Uplink)
        out = torch.empty_like(ref)
        link.send(src, out)
        assert torch.equal(out, ref)
        assert len(link.ring) == 2
        assert all(b.is_pinned() for b in link.ring)
        del out, link
    monkeypatch.setattr(ham, "STAGE_BYTES", 7 * nbf ** 3 * 8)
    same, add = [], ham._Cell.add

    def spy(cell, X, m0):
        same.append(torch.equal(X, ref[m0:m0 + X.shape[0]]))
        return add(cell, X, m0)
    monkeypatch.setattr(ham._Cell, "add", spy)
    build_hamiltonian(_card_wfn(), device=cuda_device)
    assert same == [True] * -(-nbf // 7)


@pytest.mark.cuda
def test_card_two_inits_make_two_uploads(cuda_device):
    """Two ccwfn objects in a row stage and copy the whole AO ERI twice,
    one 'hamiltonian.h2d' a chunk: the second job gets nothing from the
    first."""
    w = _card_wfn()
    nbf = w.ERI_ao.shape[0]
    chunks = -(-nbf // (ham.STAGE_BYTES // (nbf ** 3 * 8)))

    def two():
        for _ in range(2):
            cc = pycc_tpu_torch.ccwfn(w, device=cuda_device)
            del cc
        torch.cuda.synchronize()
    _, rows = _traced(two)
    assert rows["hamiltonian.h2d"]["count"] == 2 * chunks
    assert rows["hamiltonian.h2d"]["bytes"] == 2 * w.ERI_ao.nbytes
    assert rows["hamiltonian.stage"]["bytes"] == 2 * w.ERI_ao.nbytes
    assert rows["hamiltonian.h2d"]["device_s"] > 0


@pytest.mark.cuda
def test_card_build_peak_equals_the_plain_copy(cuda_device, monkeypatch):
    """max_memory_allocated over build_hamiltonian, through the ring and
    with the plain copy, is at most what the whole-tensor transform held
    at its second quarter transform: the AO ERI and two intermediates."""
    w = _card_wfn()
    nbf = w.ERI_ao.shape[0]
    nact = w.Ca_subset("AO", "ACTIVE").shape[1]
    whole = 8 * (nbf ** 4 + nbf ** 3 * nact + nbf ** 2 * nact ** 2)

    def peak():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda_device)
        base = torch.cuda.memory_allocated(cuda_device)
        H = build_hamiltonian(w, device=cuda_device)
        torch.cuda.synchronize()
        del H
        return torch.cuda.max_memory_allocated(cuda_device) - base
    peak()
    staged = peak()
    monkeypatch.setattr(ham, "uplink", lambda dev, src: None)
    plain = peak()
    assert max(staged, plain) <= whole


@pytest.mark.cuda
def test_card_mesh_build_equals_the_plain_rounds(cuda_device, monkeypatch):
    """A mesh build over the visible cards (cuda:0 four times on one
    card) through the uplinks gives the plain copies' pieces bit for bit,
    in chunks of 3 slices."""
    w = _cpu_wfn()
    n = torch.cuda.device_count()
    mesh = make_mesh(devices=["cuda:%d" % (i % n) for i in range(4)])
    src = ham.ao_source(w)
    no = w.doccpi()[0] - w.frzcpi()[0]
    step = 3 * w.ERI_ao.shape[0] ** 3 * 8
    staged = build_full(src, no, mesh, chunk_bytes=step)
    monkeypatch.setattr(ham, "uplink", lambda dev, src: None)
    plain = build_full(src, no, mesh, chunk_bytes=step)
    for a, b in zip(staged, plain):
        for c in a.pieces:
            assert torch.equal(a.pieces[c], b.pieces[c])
