"""Full storage of a mesh solver made on its devices
(pycc_tpu_torch/parallel/mesh.build_full): each cell's ERI, L and <ab|ef>
pieces from the host AO ERI, on meshes of CPU devices, against the
unsharded build and the plain reference of the benchmark
(portbench/reference, plain PyTorch).

The wavefunction is the benchmark's seeded SCF output at a tiny size whose
nact (21) and v (17) split unevenly over the mesh axes.  This file imports
no JAX.
"""

import contextlib
import functools
import importlib
import io
import math
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

import pycc_tpu_torch
import pycc_tpu_torch.hamiltonian as ham
from pycc_tpu_torch.hamiltonian import ao_source, build_hamiltonian
from pycc_tpu_torch.parallel import Sharded, make_mesh
from pycc_tpu_torch.parallel.mesh import build_full, split_ranges
from pycc_tpu_torch.utils import timing

from portbench.harness.inputs import make_inputs
from portbench.harness.spec import Spec
from portbench.reference import ccsd as rcc
from portbench.reference.hamiltonian import FullERI, mo_eri, spin_adapted

# the module: the package's `ccwfn` is the class
ccwfn_mod = importlib.import_module("pycc_tpu_torch.ccwfn")
CPU = torch.device("cpu")
CONV = 1e-12


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


@functools.lru_cache(maxsize=None)
def _wfn(seed=2 ** 31 + 11):
    cfg = dict(Spec().config("h2o6_avdz_full"), nbf=22, nfzc=1, ndocc=5)
    cfg["generator"] = dict(cfg["generator"], rank=80, scale=0.5)
    return make_inputs(cfg, seed, CPU)


@functools.lru_cache(maxsize=None)
def _unsharded(precision="DP"):
    dtype = torch.float64 if precision == "DP" else torch.float32
    return build_hamiltonian(_wfn(), device="cpu", dtype=dtype)


def _mesh(n=4):
    return make_mesh(devices=["cpu"] * n)


@functools.lru_cache(maxsize=None)
def _solved(mesh_n=0):
    kw = {"mesh": _mesh(mesh_n)} if mesh_n else {}
    cc = _quiet(pycc_tpu_torch.ccwfn, _wfn(), device="cpu", **kw)
    return cc, _quiet(cc.solve_cc, CONV, CONV)


def _no():
    w = _wfn()
    return w.doccpi()[0] - w.frzcpi()[0]


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("chunk_bytes", [2 ** 30, 3 * 22 ** 3 * 8],
                         ids=["one-chunk", "chunks-of-3"])
def test_pieces_equal_the_unsharded_build(n, chunk_bytes):
    """Every cell's ERI, L and <ab|ef> piece equals the unsharded build's
    part at 1e-12, in one chunk of the AO ERI or in chunks of three of
    its first index, on a 2 x 2 and a 2 x 4 mesh."""
    H = _unsharded()
    no = _no()
    nact = H.ERI.shape[0]
    assert nact % 2 and (nact - no) % 2
    m = _mesh(n)
    ERI, L, W = build_full(ao_source(_wfn()), no, m,
                           chunk_bytes=chunk_bytes)
    whole = {id(ERI): H.ERI, id(L): H.L, id(W): H.vvvv}
    for s in (ERI, L, W):
        assert isinstance(s, Sharded) and s.dtype == torch.float64
        for i, j, dev in m.cells():
            sl = s.cell_slices(i, j)
            piece = s.pieces[(i, j)]
            assert piece.device == dev and piece.is_contiguous()
            gap = (piece - whole[id(s)][sl]).abs().max()
            assert gap < 1e-12, (i, j, float(gap))
    assert ERI.spec == L.spec == (None, None, "va", "vb")
    assert W.spec == ("va", "vb", None, None)


def _storages(kind):
    """[(built tensor, the reference's part)] of one storage: one CPU
    device's ERI and L, the six blocks, or a 2 x 2 CPU mesh's pieces."""
    w, no = _wfn(), _no()
    C = torch.as_tensor(w.Ca_subset("AO", "ACTIVE"))
    ref = mo_eri(C, torch.as_tensor(w.ERI_ao))
    if kind == "one-device":
        H = build_hamiltonian(w, device="cpu")
        return [(H.ERI, ref), (H.L, spin_adapted(ref))]
    if kind == "blocks":
        sl = {"o": slice(0, no), "v": slice(no, None)}
        B = ham.mo_eri_blocks(w, device="cpu")
        return [(b, ref[tuple(sl[c] for c in name)])
                for name, b in zip(B._fields, B)]
    m = _mesh()
    v = slice(no, None)
    out = []
    for s, whole in zip(build_full(ao_source(w), no, m),
                        (ref, spin_adapted(ref), ref[v, v, v, v])):
        for i, j, _ in m.cells():
            out.append((s.pieces[(i, j)], whole[s.cell_slices(i, j)]))
    return out


@pytest.mark.parametrize("kind", ["one-device", "blocks", "mesh"])
def test_every_storage_equals_the_reference(kind):
    """Each storage's integrals, made by the one transform, equal the
    plain reference's (portbench/reference/hamiltonian.mo_eri) at 1e-13
    relative."""
    for x, ref in _storages(kind):
        assert x.shape == ref.shape
        gap = float((x - ref).abs().max())
        assert gap <= 1e-13 * float(ref.abs().max()), (kind, gap)


def test_no_piece_is_whole():
    """No piece has the shape of a whole ERI, L or <ab|ef>: each is its
    cell's ranges, nact split 11 + 10 and v 9 + 8 on a 2 x 2 mesh."""
    cc, _ = _solved(4)
    nact, nv = cc.nact, cc.nv
    assert split_ranges(nact, 2) == [(0, 11), (11, 21)]
    assert split_ranges(nv, 2) == [(0, 9), (9, 17)]
    for s, n in ((cc.H.ERI, nact), (cc.H.L, nact), (cc.vvvv(), nv)):
        shapes = {tuple(p.shape) for p in s.pieces.values()}
        assert (n,) * 4 not in shapes and len(shapes) == 4
        assert sum(p.numel() for _, p in s.shards()) == n ** 4
    assert {tuple(p.shape) for p in cc.H.ERI.pieces.values()} == {
        (nact, nact, a, b) for a in (11, 10) for b in (11, 10)}
    assert {tuple(p.shape) for p in cc.vvvv().pieces.values()} == {
        (a, b, nv, nv) for a in (9, 8) for b in (9, 8)}


def test_the_mesh_init_makes_no_host_eri(monkeypatch):
    """A mesh solver's init calls build_hamiltonian only with eri=False,
    runs the one MO transform (mo_eri_cells) on cells none of which is a
    whole nact^4 tensor, and leaves no AO source behind; the one-device
    init runs the same transform on one cell that covers every index."""
    calls, transforms = [], []
    real_build, real_mo = ham.build_hamiltonian, ham.mo_eri_cells

    def spy(wfn, *a, **kw):
        calls.append((str(kw.get("device", "cuda")), kw.get("eri", True)))
        return real_build(wfn, *a, **kw)

    def mo_spy(src, cells, *a, **kw):
        transforms.append(list(cells))
        return real_mo(src, cells, *a, **kw)
    monkeypatch.setattr(ccwfn_mod, "build_hamiltonian", spy)
    monkeypatch.setattr(ham, "mo_eri_cells", mo_spy)
    cc = _quiet(pycc_tpu_torch.ccwfn, _wfn(), device="cpu", mesh=_mesh())
    nact = cc.nact
    assert calls == [("cpu", False)] and len(transforms) == 1
    assert len(transforms[0]) == 4
    for cell in transforms[0]:
        assert math.prod(hi - lo for lo, hi in cell.eri) < nact ** 4
        assert cell.W is not None
    assert isinstance(cc.H.ERI, Sharded) and isinstance(cc.H.L, Sharded)
    _quiet(pycc_tpu_torch.ccwfn, _wfn(), device="cpu")
    assert calls[-1] == ("cpu", True) and len(transforms) == 2
    (cell,) = transforms[1]
    assert cell.eri == ((0, nact),) * 4 and cell.L and cell.W is None


def test_energy_matches_unsharded_and_the_reference():
    """E(CCSD) of the mesh solver equals the unsharded port's at 1e-10;
    the plain reference's residual vanishes at the mesh solver's
    amplitudes and its energy there is the solver's, at 1e-10."""
    cc, e = _solved(4)
    _, e0 = _solved(0)
    assert abs(e - e0) < 1e-10
    w = _wfn()
    C = torch.as_tensor(w.Ca_subset("AO", "ACTIVE"))
    F = C.T @ torch.as_tensor(w.Fa()) @ C
    ERIt = mo_eri(C, torch.as_tensor(w.ERI_ao))
    no = cc.no
    v = slice(no, None)
    ERI, L = FullERI(ERIt), FullERI(spin_adapted(ERIt))
    r1, r2 = rcc.residuals_ccsd(F, ERI, L, ERIt[v, v, v, v], cc.t1, cc.t2,
                                no)
    D1, D2 = rcc.denominators(F, no)
    res = float(torch.sqrt(((r1 / D1) ** 2).sum() + ((r2 / D2) ** 2).sum()))
    assert res < 1e-9
    assert abs(float(rcc.cc_energy(F, L, cc.t1, cc.t2, no)) - e) < 1e-10


def test_float32_pieces_are_cast_from_float64():
    """precision='SP': the pieces are float32, cast from the float64
    build, so they equal the unsharded float32 build's to its rounding."""
    cc = _quiet(pycc_tpu_torch.ccwfn, _wfn(), device="cpu", precision="SP",
                mesh=_mesh())
    H = _unsharded("SP")
    for s, ref in ((cc.H.ERI, H.ERI), (cc.H.L, H.L), (cc.vvvv(), H.vvvv)):
        assert s.dtype == torch.float32
        full = s.full()
        assert float((full - ref).abs().max()) <= 1e-6 * float(
            ref.abs().max())


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, timing.spans()


def test_build_spans_count_the_host_bytes(monkeypatch):
    """Under a profiler the build records one 'hamiltonian.h2d' a chunk,
    whose bytes sum to the AO ERI's, and one 'hamiltonian.shard' a cell
    a chunk and a cell for its pieces.  A CPU mesh takes the plain copy,
    with no 'hamiltonian.stage'; through the staging ring (unpinned
    buffers, as on the CPU) it records one a chunk, whose bytes also sum
    to the AO ERI's, and gives the same pieces bit for bit."""
    src = ao_source(_wfn())
    nbf = src.C.shape[0]
    step = 3
    build = lambda: build_full(src, _no(), _mesh(),
                               chunk_bytes=step * nbf ** 3 * 8)
    plain, rows = _traced(build)
    chunks = -(-nbf // step)
    assert rows["hamiltonian.h2d"]["count"] == chunks
    assert rows["hamiltonian.h2d"]["bytes"] == src.ERI_ao.nbytes
    assert rows["hamiltonian.shard"]["count"] == 4 * chunks + 4
    assert rows["hamiltonian.h2d"]["device_s"] is None
    assert "hamiltonian.stage" not in rows
    monkeypatch.setattr(ham, "uplink",
                        lambda dev, x: ham.Uplink(dev))
    staged, rows = _traced(build)
    for name in ("hamiltonian.h2d", "hamiltonian.stage"):
        assert rows[name]["count"] == chunks
        assert rows[name]["bytes"] == src.ERI_ao.nbytes
    assert rows["hamiltonian.shard"]["count"] == 4 * chunks + 4
    for a, b in zip(staged, plain):
        for c in a.pieces:
            assert torch.equal(a.pieces[c], b.pieces[c])


def test_chunks_go_round_the_cards(monkeypatch):
    """Over four distinct devices (cpu:0 to cpu:3) chunk k goes from the
    host to device k mod 4, through that device's own ring: each device
    takes its share, no chunk crosses twice, every cell still adds every
    chunk (the pieces equal the unsharded build's), and every ring is
    gone before the cells make their pieces."""
    src = ao_source(_wfn())
    nbf = src.C.shape[0]
    m = make_mesh(devices=["cpu:%d" % i for i in range(4)])
    assert len(m.distinct) == 4
    taken, links, alive = [], [], []

    class Counted(ham.Uplink):
        def __init__(self, device):
            super().__init__(device)
            links.append(weakref.ref(self))

        def take(self, x, name=None):
            taken.append((self.device, x.data_ptr()))
            return super().take(x, name)
    monkeypatch.setattr(ham, "uplink", lambda dev, x: Counted(dev))
    pieces = ham._Cell.pieces

    def spy(cell, *a):
        alive.append(sum(r() is not None for r in links))
        return pieces(cell, *a)
    monkeypatch.setattr(ham._Cell, "pieces", spy)
    step = 2
    ERI, L, W = build_full(src, _no(), m, chunk_bytes=step * nbf ** 3 * 8)
    chunks = -(-nbf // step)
    eri = torch.as_tensor(src.ERI_ao)
    assert [p for _, p in taken] == [eri[m0].data_ptr()
                                     for m0 in range(0, nbf, step)]
    assert [d for d, _ in taken] == [m.distinct[k % 4]
                                     for k in range(chunks)]
    # no uplink, and so no device slot, is left when the pieces are made
    assert len(links) == 4 and alive == [0] * 4
    share = {d: sum(1 for e, _ in taken if e == d) for d in m.distinct}
    assert sorted(share.values()) == [chunks // 4] * (4 - chunks % 4) + [
        chunks // 4 + 1] * (chunks % 4)
    H = _unsharded()
    for s, whole in ((ERI, H.ERI), (L, H.L), (W, H.vvvv)):
        for i, j, _ in m.cells():
            gap = (s.pieces[(i, j)] - whole[s.cell_slices(i, j)]).abs().max()
            assert gap < 1e-12


def test_each_accumulator_goes_before_its_l(monkeypatch):
    """A cell's accumulator is freed before its L piece is allocated, on
    a 2 x 2 mesh (whose cells also cut W from it) and on one device: no
    view of it outlives the pieces cut from it."""
    current, freed = [], []
    pieces, empty_like = ham._Cell.pieces, torch.empty_like

    def spy_pieces(cell, *a):
        current[:] = [weakref.ref(cell.acc)]
        return pieces(cell, *a)

    def spy_empty_like(x, *a, **kw):
        if current:
            freed.append(current[0]() is None)
        return empty_like(x, *a, **kw)
    monkeypatch.setattr(ham._Cell, "pieces", spy_pieces)
    monkeypatch.setattr(torch, "empty_like", spy_empty_like)
    build_full(ao_source(_wfn()), _no(), _mesh())
    build_hamiltonian(_wfn(), device="cpu")
    assert freed == [True] * 5


def test_gather_span_bytes_equal_the_count():
    """Over one residual the bytes of the spans 'mesh.gather' are the
    increment of Mesh.gathered_bytes, and the sharded ladder is one
    'mesh.ladder'."""
    cc, _ = _solved(4)
    m = cc.mesh
    before = m.gathered_bytes
    _, rows = _traced(lambda: cc.residuals(cc.H.F, cc.t1, cc.t2))
    grown = m.gathered_bytes - before
    assert grown > 0 and rows["mesh.gather"]["bytes"] == grown
    assert rows["mesh.ladder"]["count"] == 1
    # o v^3 reads: ERI[o,v,v,v] four times, ERI[v,v,v,o] and L[o,v,v,v]
    # once each
    no, nv = cc.no, cc.nv
    assert grown > 6 * no * nv ** 3 * 8


def test_spans_change_no_energy():
    """A mesh solve traced gives the untraced solve's energy and
    amplitudes bit for bit."""
    cc, e = _solved(4)

    def solve():
        c = _quiet(pycc_tpu_torch.ccwfn, _wfn(), device="cpu",
                   mesh=_mesh())
        return c, _quiet(c.solve_cc, CONV, CONV)
    (ct, et), rows = _traced(solve)
    assert et == e and torch.equal(ct.t2, cc.t2)
    assert rows["mesh.gather"]["count"] > 0
    assert rows["mesh.ladder"]["count"] == ct.niter
    assert rows["ccwfn.residual"]["count"] == ct.niter
