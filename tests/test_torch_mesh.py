"""The port's single-process device mesh (pycc_tpu_torch/parallel/mesh.py)
against pycc_tpu's GSPMD mesh (tests/conftest.py gives JAX 8 CPU devices)
and against the port's own unsharded paths, on meshes of CPU devices
(make_mesh(devices=["cpu"] * n)).

The sharded ladders sum nothing across shards, so most results equal the
unsharded port's exactly; the tolerances are the ones the counterparts in
test_012/test_016 hold, or the solver's convergence where a solve is
compared.  K1 on sharded operands on a card is tested in
test_torch_vvvv_kernel.py, which imports no JAX.
"""

import contextlib
import functools
import io

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu
import pycc_tpu.parallel as jpar
import pycc_tpu_torch
from pycc_tpu.models import ccsd as jeqs
from pycc_tpu.utils.synth import mp2_guess as jmp2
from pycc_tpu.utils.synth import synthetic_hamiltonian as jsynth
from pycc_tpu_torch.cchbar import HBar, build_hbar
from pycc_tpu_torch.cclambda import lambda_residuals_from_F
from pycc_tpu_torch.models import ccsd as teqs
from pycc_tpu_torch.models.blocked import blocked_views, blocks_from_full
from pycc_tpu_torch.models.dfccsd import df_blocks
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference
from pycc_tpu_torch.parallel import (Sharded, device_bytes, make_mesh,
                                     shard_blocks, shard_df,
                                     shard_hamiltonian, shard_hbar)
from pycc_tpu_torch.scf import run_rhf
from pycc_tpu_torch.utils.synth import synthetic_hamiltonian as tsynth

from .common import H2O

E_CCSD_DZ = -0.222029814166783      # frozen Psi4 (reference test_002)


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _cpu_mesh(n=4):
    return make_mesh(devices=["cpu"] * n)


def _counting():
    calls = []

    def ladder(A, B, bf16=False):
        calls.append((tuple(A.shape), tuple(B.shape)))
        return vvvv_nt_reference(A, B, bf16)
    return ladder, calls


def _gap(a, b):
    a = a.full() if isinstance(a, Sharded) else a
    b = b.full() if isinstance(b, Sharded) else b
    return float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())


@functools.lru_cache(maxsize=None)
def _wfn(basis):
    return run_rhf(H2O, basis, freeze_core=True)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_matches_pycc_tpu(n):
    """The most square factorisation, pycc_tpu's, for n = 1 ... 8."""
    want = jpar.make_mesh(devices=jax.devices()[:n]).devices.shape
    m = make_mesh(devices=["cpu"] * n)
    assert m.shape == want and m.size == n
    cpu = torch.device("cpu")
    assert m.home == cpu and m.distinct == [cpu]
    assert make_mesh(devices=["cpu"] * n, shape=(1, n)).shape == (1, n)


def test_make_mesh_never_repeats_a_device_by_itself():
    """n_devices past the visible CUDA devices raises; only a devices list
    may repeat one; a shape must hold every device."""
    k = torch.cuda.device_count()
    with pytest.raises(ValueError, match="devices= to build a mesh"):
        make_mesh(n_devices=k + 1)
    with pytest.raises(ValueError, match="n_devices=3 but 4"):
        make_mesh(n_devices=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_mesh(devices=["cpu"] * 4, shape=(2, 3))
    if k == 0:
        with pytest.raises(ValueError):
            make_mesh()


def test_ccwfn_mesh_argument_checks():
    """mesh= takes a Mesh (TypeError naming make_mesh otherwise), runs on
    its home device, and local + mesh raises as pycc_tpu's does on the
    filter path; the native pair solver (item 13b, ported) lays its
    stacks over the mesh and keeps H whole."""
    wfn = _wfn("sto-3g")
    with pytest.raises(TypeError, match="make_mesh"):
        pycc_tpu_torch.ccwfn(wfn, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="home device"):
        pycc_tpu_torch.ccwfn(wfn, device="cuda:1", mesh=_cpu_mesh())
    with pytest.raises(ValueError, match="native pair-space solver"):
        pycc_tpu_torch.ccwfn(wfn, device="cpu", local="PNO", filter=True,
                             mesh=_cpu_mesh())
    cc = pycc_tpu_torch.ccwfn(wfn, device="cpu", local="PNO",
                              mesh=_cpu_mesh())
    assert cc.lccwfn.mesh is not None and not isinstance(cc.H.ERI, Sharded)
    assert any(isinstance(x, Sharded) for x in cc.lccwfn._pre.values())


def test_sharded_reads_assemble_on_the_home_device():
    """Slices and full() read the assembled tensor; an operator, a torch
    function or a tensor method on the whole raises instead of copying it;
    to(dtype) and transpose stay sharded, put(dtype=) casts piece by piece;
    an uneven split keeps every element once."""
    m = _cpu_mesh(4)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 5, 7, 4)))
    s = Sharded.put(x, m, (None, "va", "vb"))
    assert s.full().equal(x) and s[1:, 2:4, :5].equal(x[1:, 2:4, :5])
    m.gathered_bytes = 0
    s[:, :2]
    assert m.gathered_bytes == 3 * 2 * 7 * 4 * 8
    with pytest.raises(TypeError):
        2.0 * s
    with pytest.raises(TypeError):
        x - s
    with pytest.raises(TypeError):
        torch.einsum("abcd,abcd->", s, x)
    with pytest.raises(AttributeError):
        s.permute(3, 2, 1, 0)
    with pytest.raises(TypeError, match="full"):
        s.to("cpu")
    assert Sharded.put(x, m, ("va",), torch.float32).full().equal(x.float())
    s32 = s.to(torch.float32)
    assert isinstance(s32, Sharded) and s32.full().equal(x.float())
    st = s.transpose(1, 2)
    assert isinstance(st, Sharded) and st.full().equal(x.transpose(1, 2))
    sizes = sorted(s.cell_bytes().values())
    assert sum(sizes) == x.numel() * 8
    # 5 = 3 + 2 rows over 'va', 7 = 4 + 3 over 'vb'
    assert sizes == sorted(3 * a * b * 4 * 8 for a in (3, 2) for b in (4, 3))
    with pytest.raises(TypeError, match="slices only"):
        s[0]


def test_mesh_uses_no_torch_distributed_and_no_jax():
    """One process drives the mesh: nothing in the port or chip_smoke.py
    names torch.distributed, and importing the mesh loads no JAX."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "pycc_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            assert "torch.distributed" not in fh.read(), f
    code = ("import sys, pycc_tpu_torch.parallel, pycc_tpu_torch.scf.atomic; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "False"


# ---------------------------------------------------------------------------
# the storage layouts: about 1/n of each v^4 and o v^3 operand a shard
# ---------------------------------------------------------------------------

def _assert_split(s, n):
    """s holds its tensor once over n cells, each about 1/n of it."""
    total = s.numel() * s.element_size()
    cells = s.cell_bytes()
    assert len(cells) == n and sum(cells.values()) == total
    assert max(cells.values()) <= 1.5 * total / n


@pytest.mark.parametrize("n", [4, 8])
def test_shard_layouts_hold_a_share_per_shard(n):
    m = _cpu_mesh(n)
    no, nv = 4, 16
    H = tsynth(no, nv, seed=3, device="cpu")
    Hs = shard_hamiltonian(H, m)
    for s in (Hs.ERI, Hs.L, Hs.vvvv):
        _assert_split(s, n)
    assert Hs.vvvv.spec == ("va", "vb", None, None)
    assert Hs.vvvv.full().equal(H.ERI[no:, no:, no:, no:])
    assert Hs.ERI.full().equal(H.ERI) and Hs.F is H.F
    blocks = shard_blocks(blocks_from_full(H.ERI, no), m)
    _assert_split(blocks.vvvv, n)
    _assert_split(blocks.ovvv, n)
    assert not isinstance(blocks.oovv, Sharded)
    B = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (30, no + nv, no + nv)))
    dfb = shard_df(df_blocks(B, no), m)
    _assert_split(dfb.Bvv, n)
    assert not isinstance(dfb.Bov, Sharded)
    t1 = 0.01 * torch.ones(no, nv, dtype=torch.float64)
    t2 = H.ERI[:no, :no, no:, no:] * 0.1
    hb = shard_hbar(build_hbar("CCSD", H.F, H.ERI, H.L, t1, t2, no), m)
    for s in (hb.Hvvvv, hb.Hvovv, hb.Hvvvo):
        _assert_split(s, n)
    assert not isinstance(hb.Hovvo, Sharded)
    # the byte report: the sharded storage of the full Hamiltonian is its
    # ERI, L and ladder operand once each, F and the rest on the home device
    got = device_bytes(Hs)
    want = sum(x.numel() * 8 for x in (H.ERI, H.L, H.vvvv, H.F))
    assert got == {"cpu": want}


# ---------------------------------------------------------------------------
# the residual steps
# ---------------------------------------------------------------------------

def test_sharded_ccsd_step_matches_pycc_tpu_and_unsharded():
    """test_012's sharded step: synthetic (4, 16), pycc_tpu on its 8-device
    GSPMD mesh and the port on an 8-cell mesh, at 1e-12; the ladder is one
    call a shard."""
    no = 4
    jH = jsynth(no, 16, seed=3)
    t1, t2, _ = jmp2(jH)
    t1 = np.asarray(t1) + 0.01
    jm = jpar.make_mesh(n_devices=8)
    jHs = jpar.shard_hamiltonian(jH, jm)
    jt1, jt2 = jpar.shard_amps(t1, t2, jm)
    jr1, jr2 = jax.jit(lambda F, E, L, a, b: jeqs.residuals_ccsd(
        F, E, L, a, b, no))(jHs.F, jHs.ERI, jHs.L, jt1, jt2)

    H = tsynth(no, 16, seed=3, device="cpu")
    tt1, tt2 = torch.from_numpy(t1), torch.tensor(np.asarray(t2))
    m = _cpu_mesh(8)
    Hs = shard_hamiltonian(H, m)
    ladder, calls = _counting()
    r1, r2 = teqs.residuals_ccsd(Hs.F, Hs.ERI, Hs.L, Hs.vvvv, tt1, tt2, no,
                                 ladder=ladder)
    assert len(calls) == 8
    assert np.abs(r1.numpy() - np.asarray(jr1)).max() < 1e-12
    assert np.abs(r2.numpy() - np.asarray(jr2)).max() < 1e-12
    u1, u2 = teqs.residuals_ccsd(H.F, H.ERI, H.L, H.vvvv, tt1, tt2, no)
    assert _gap(r1, u1) < 1e-12 and _gap(r2, u2) < 1e-12


def test_sharded_blocked_step_matches():
    """test_016's sharded blocked step: the blocked residual over sharded
    blocks equals the unsharded blocks' and pycc_tpu's at 1e-12."""
    no, nv = 4, 16
    jH = jsynth(no, nv, seed=9)
    t1, t2, _ = jmp2(jH)
    t1 = np.asarray(t1) + 0.01
    from pycc_tpu.models.blocked import blocked_views as jviews
    from pycc_tpu.models.blocked import blocks_from_full as jcut
    jb = jcut(jH.ERI, no)
    jm = jpar.make_mesh(n_devices=8)
    jr1, jr2 = jax.jit(lambda F, b, a, c: jeqs.residuals_ccsd(
        F, *jviews(b, no), a, c, no))(jH.F, jpar.shard_blocks(jb, jm),
                                      *jpar.shard_amps(t1, t2, jm))

    H = tsynth(no, nv, seed=9, device="cpu")
    tt1, tt2 = torch.from_numpy(t1), torch.tensor(np.asarray(t2))
    blocks = blocks_from_full(H.ERI, no)
    sb = shard_blocks(blocks, _cpu_mesh(4))
    r1, r2 = teqs.residuals_ccsd(H.F, *blocked_views(sb, no), sb.vvvv,
                                 tt1, tt2, no)
    u1, u2 = teqs.residuals_ccsd(H.F, *blocked_views(blocks, no),
                                 blocks.vvvv, tt1, tt2, no)
    assert _gap(r1, u1) < 1e-12 and _gap(r2, u2) < 1e-12
    assert np.abs(r1.numpy() - np.asarray(jr1)).max() < 1e-12
    assert np.abs(r2.numpy() - np.asarray(jr2)).max() < 1e-12


@pytest.mark.parametrize("model", ["CCSD", "CCD", "CC2"])
def test_sharded_blocked_complex_rt_rhs(model):
    """test_016's composed case without the ri split: complex amplitudes
    through the T and the Lambda residuals (HBAR rebuilt from F, Hvvvv shard
    by shard) over sharded blocks equal the unsharded ones at 1e-12, each
    ladder one call a shard."""
    no, nv = 4, 16
    H = tsynth(no, nv, seed=11, device="cpu")
    rng = np.random.default_rng(2)
    t1 = torch.from_numpy(0.01 + 0.003 * rng.standard_normal((no, nv))
                          + 0.003j * rng.standard_normal((no, nv)))
    t2 = torch.from_numpy(0.02 * rng.standard_normal((no, no, nv, nv))
                          + 0.002j * rng.standard_normal((no, no, nv, nv)))
    t2 = 0.5 * (t2 + t2.permute(1, 0, 3, 2))
    l1, l2 = 2.0 * t1, 2.0 * (2.0 * t2 - t2.swapaxes(2, 3))
    F = H.F.to(torch.complex128)
    blocks = blocks_from_full(H.ERI, no)
    sb = shard_blocks(blocks, _cpu_mesh(4))
    res = {"CCSD": teqs.residuals_ccsd, "CCD": teqs.residuals_ccd,
           "CC2": teqs.residuals_cc2}[model]

    def rhs(b, vvvv, ladder):
        E, L = blocked_views(b, no)
        kw = {} if model == "CC2" else {"ladder": ladder}
        rt = res(F, E, L, b.vvvv, t1, t2, no, **kw)
        rl = lambda_residuals_from_F(model, F, E, L, t1, t2, l1, l2, no,
                                     ladder=ladder, vvvv=vvvv)
        return rt + rl

    ladder, calls = _counting()
    got = rhs(sb, sb.vvvv, ladder)
    want = rhs(blocks, None, vvvv_nt_reference)
    # CC2's residuals have no ladder; every other ladder is one call a
    # shard
    assert len(calls) == (0 if model == "CC2" else 8)
    for a, b in zip(got, want):
        assert a.dtype == torch.complex128 and _gap(a, b) < 1e-12


# ---------------------------------------------------------------------------
# the solvers on a mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _solved(storage, mesh_n=0, basis="cc-pvdz", model="CCSD", conv=1e-12):
    kw = {"mesh": _cpu_mesh(mesh_n)} if mesh_n else {}
    if storage == "df":
        kw["df_tol"] = 1e-12
    cc = _quiet(pycc_tpu_torch.ccwfn, _wfn(basis), model=model,
                storage=storage, device="cpu", **kw)
    e = _quiet(cc.solve_cc, conv, conv)
    return cc, e


@functools.lru_cache(maxsize=None)
def _jax_mesh_stack():
    """pycc_tpu's own mesh solve of test_012's integrated case, on its
    8-device mesh: E(CCSD), the Lambda pseudo-energy and two EOM roots
    (the CIS guess, as the port's below)."""
    from .common import scf
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu.ccwfn(scf("H2O", "cc-pvdz"),
                            mesh=jpar.make_mesh(n_devices=8))
        e = cc.solve_cc(e_conv=1e-12, r_conv=1e-12)
        hb = pycc_tpu.cchbar(cc)
        p = pycc_tpu.cclambda(cc, hb).solve_lambda(e_conv=1e-11,
                                                   r_conv=1e-11)
        E, _ = pycc_tpu.cceom(hb).solve_eom(N=2, e_conv=1e-10, r_conv=1e-8,
                                            guess="CIS")
    return float(e), float(p), np.asarray(E)


@pytest.mark.parametrize("storage", ["full", "blocked"])
def test_mesh_integrated_solve_matches_single_device(storage):
    """test_012's integrated case: H2O/cc-pVDZ solve_cc, HBAR, Lambda and
    two EOM roots on a 2 x 2 mesh, held to the unsharded port (E 1e-11,
    pseudo-energy 1e-10, roots 1e-7), to pycc_tpu's own mesh solve (E
    and pseudo-energy 1e-10, roots 1e-7) and E to the frozen oracle."""
    cc0, e0 = _solved(storage)
    cc, e = _solved(storage, 4)
    je, jp, jroots = _jax_mesh_stack()
    assert isinstance(cc.vvvv(), Sharded)
    assert abs(e - e0) < 1e-11 and abs(e - E_CCSD_DZ) < 1e-10
    assert abs(e - je) < 1e-10
    hb0, hb = _quiet(pycc_tpu_torch.cchbar, cc0), \
        _quiet(pycc_tpu_torch.cchbar, cc)
    assert isinstance(hb.Hvvvv, Sharded) and isinstance(hb.Hvovv, Sharded)
    for name in ("Hvvvv", "Hvovv", "Hvvvo", "Hovoo", "Hovvo"):
        assert _gap(getattr(hb, name), getattr(hb0, name)) < 1e-12
    lam0, lam = (pycc_tpu_torch.cclambda(cc0, hb0),
                 pycc_tpu_torch.cclambda(cc, hb))
    p0 = _quiet(lam0.solve_lambda, 1e-11, 1e-11)
    p = _quiet(lam.solve_lambda, 1e-11, 1e-11)
    assert abs(p - p0) < 1e-10 and abs(p - jp) < 1e-10
    eom0, eom = pycc_tpu_torch.cceom(hb0), pycc_tpu_torch.cceom(hb)
    ladder, calls = _counting()
    C = torch.eye(eom.D.numel(), dtype=torch.float64)[:3]
    assert _gap(eom.sigma(C, ladder=ladder), eom0.sigma(C)) < 1e-12
    assert len(calls) == 4
    r0 = _quiet(eom0.solve_eom, 2, 1e-10, 1e-8, guess="CIS")[0]
    r = _quiet(eom.solve_eom, 2, 1e-10, 1e-8, guess="CIS")[0]
    assert np.abs(np.asarray(r) - np.asarray(r0)).max() < 1e-7
    assert np.abs(np.asarray(r) - jroots).max() < 1e-7


def test_mesh_ccsd_t_matches_single_device():
    """CCSD(T) on a mesh: the (T) rows read slices assembled from the
    shards; E(CCSD) + E(T) equals the unsharded solve's at 1e-11."""
    _, e0 = _solved("full", 0, "sto-3g", "CCSD(T)")
    cc, e = _solved("full", 4, "sto-3g", "CCSD(T)")
    assert isinstance(cc.H.ERI, Sharded) and abs(e - e0) < 1e-11


def test_mesh_df_solve_matches():
    """test_012's DF case: H2O/STO-3G over factors with Bvv on a 2 x 2 mesh
    equals the unsharded DF solve at 1e-12 and pycc_tpu's mesh solve at
    1e-10; the ladder is a call an a-block a shard."""
    cc0, e0 = _solved("df", 0, "sto-3g")
    cc, e = _solved("df", 4, "sto-3g")
    assert isinstance(cc.dfb.Bvv, Sharded)
    assert abs(e - e0) < 1e-12
    ladder, calls = _counting()
    cc.residuals(cc.H.F, cc.t1, cc.t2, ladder=ladder)
    # v = 2: one a and one b a cell, one a-block a shard
    assert cc.nv == 2 and len(calls) == 4
    jw = pycc_tpu.scf.run_rhf(H2O, "sto-3g", freeze_core=True)
    jcc = _quiet(pycc_tpu.ccwfn, jw, storage="df", df_tol=1e-12,
                 mesh=jpar.make_mesh(n_devices=8))
    je = _quiet(jcc.solve_cc, 1e-12, 1e-12)
    assert abs(e - float(je)) < 1e-10


def test_mesh_df_post_convergence_matches():
    """The DF HBAR over a mesh (Bd_ae dressed shard by shard), its Lambda
    and an EOM sigma block equal the unsharded ones."""
    cc0, _ = _solved("df", 0, "sto-3g")
    cc, _ = _solved("df", 4, "sto-3g")
    hb0, hb = _quiet(pycc_tpu_torch.cchbar, cc0), \
        _quiet(pycc_tpu_torch.cchbar, cc)
    assert isinstance(hb.hbar.Bd_ae, Sharded)
    assert _gap(hb.hbar.Bd_ae, hb0.hbar.Bd_ae) < 1e-14
    p0 = _quiet(pycc_tpu_torch.cclambda(cc0, hb0).solve_lambda, 1e-11, 1e-11)
    p = _quiet(pycc_tpu_torch.cclambda(cc, hb).solve_lambda, 1e-11, 1e-11)
    assert abs(p - p0) < 1e-10
    eom0, eom = pycc_tpu_torch.cceom(hb0), pycc_tpu_torch.cceom(hb)
    C = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, eom.D.numel())))
    assert _gap(eom.sigma(C), eom0.sigma(C)) < 1e-12


def test_from_df_factors_and_solve_cc_mixed_keep_their_shards():
    """from_df_factors(mesh=) lays Bvv over the mesh; solve_cc_mixed's
    stages re-lay the storage each time (blocked and DF), and land on the
    unsharded mixed solve's energy."""
    cc0, e0 = _solved("df", 0, "sto-3g")
    B = torch.cat([torch.cat([cc0.dfb.Boo, cc0.dfb.Bov], 2),
                   torch.cat([cc0.dfb.Bov.transpose(1, 2), cc0.dfb.Bvv], 2)],
                  1)
    m = _cpu_mesh(4)
    cc = pycc_tpu_torch.ccwfn.from_df_factors(B.numpy(), cc0.H.F.numpy(),
                                              cc0.no, device="cpu", mesh=m)
    assert cc.mesh is m and isinstance(cc.dfb.Bvv, Sharded)
    e = _quiet(cc.solve_cc_mixed, 1e-12, 1e-12)
    assert isinstance(cc.dfb.Bvv, Sharded)
    assert cc.dfb.Bvv.dtype == torch.float64
    assert abs(e - e0) < 1e-11
    ccb = _quiet(pycc_tpu_torch.ccwfn, _wfn("sto-3g"), storage="blocked",
                 device="cpu", mesh=_cpu_mesh(4))
    eb = _quiet(ccb.solve_cc_mixed, 1e-12, 1e-12,
                sp_kwargs={"bf16_until": 1e-3})
    assert isinstance(ccb.blocks.vvvv, Sharded)
    assert [s[0] for s in ccb.stages] == ["floor", "refine"]
    assert abs(eb - e0) < 1e-9


def test_mesh_response_and_rt_match_single_device():
    """The response residuals (r_X, in_Y1 and r_Y over the sharded HBAR)
    and one real-time right-hand side (both complex ladders a call a
    shard) equal the unsharded ones."""
    from pycc_tpu_torch.rt.lasers import gaussian_laser
    outs = []
    for n in (0, 4):
        cc, _ = _solved("full", n, "sto-3g")
        hb = _quiet(pycc_tpu_torch.cchbar, cc)
        lam = pycc_tpu_torch.cclambda(cc, hb)
        _quiet(lam.solve_lambda, 1e-11, 1e-11)
        dens = _quiet(pycc_tpu_torch.ccdensity, cc, lam)
        resp = pycc_tpu_torch.ccresponse(dens)
        pol = _quiet(resp.linresp, "MU", "MU", 0.05, 1e-10, 1e-10)
        rt = pycc_tpu_torch.rtcc(cc, lam, dens,
                                 gaussian_laser(0.05, 0.0, 0.01, 0.05))
        y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
        y = y + 0.01 * torch.from_numpy(np.random.default_rng(3)
                                        .standard_normal(y.shape))
        outs.append((np.asarray(pol), rt.f(0.02, y), dens.compute_energy()))
    (p0, f0, d0), (p, f, d) = outs
    assert np.abs(p - p0).max() < 1e-9
    assert _gap(f, f0) < 1e-12 and abs(d - d0) < 1e-12


@pytest.mark.parametrize("storage", ["full", "blocked", "df"])
@pytest.mark.parametrize("model", ["CCD", "CC2", "CCSD(T)", "CC3"])
def test_every_model_and_storage_on_a_mesh(storage, model):
    """H2O/STO-3G through solve_cc, HBAR, Lambda and the density energy
    (and one real-time right-hand side where rtcc takes the model) on a
    2 x 2 mesh equals the unsharded run: the readers that take an o v^3
    block or Bvv whole do so explicitly, and nothing else reads a
    Sharded."""
    from pycc_tpu_torch.rt.lasers import gaussian_laser
    out = []
    for n in (0, 4):
        cc, e = _solved(storage, n, "sto-3g", model)
        hb = _quiet(pycc_tpu_torch.cchbar, cc)
        lam = pycc_tpu_torch.cclambda(cc, hb)
        p = _quiet(lam.solve_lambda, 1e-11, 1e-11)
        dens = _quiet(pycc_tpu_torch.ccdensity, cc, lam)
        got = [e, p, float(_quiet(dens.compute_energy))]
        if model != "CCSD(T)":
            rt = pycc_tpu_torch.rtcc(cc, lam, dens,
                                     gaussian_laser(0.05, 0.0, 0.01, 0.05))
            y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
            got.append(rt.f(0.02, y))
        out.append(got)
    assert isinstance((cc.dfb.Bvv if storage == "df" else cc.vvvv()),
                      Sharded)
    for a, b in zip(*out):
        assert _gap(a, b) < 1e-10


def test_hbar_dataclass_keeps_its_efab_cache_field():
    """shard_hbar resets the left-ladder cache, so a sharded HBAR lays out
    its own Hvvvv_efab (over (a, b) of the (e, f, a, b) layout)."""
    no = 3
    H = tsynth(no, 6, seed=1, device="cpu")
    t1 = torch.zeros(no, 6, dtype=torch.float64)
    t2 = 0.1 * H.ERI[:no, :no, no:, no:]
    hb = build_hbar("CCSD", H.F, H.ERI, H.L, t1, t2, no)
    _ = hb.Hvvvv_efab
    hs = shard_hbar(hb, _cpu_mesh(4))
    assert isinstance(hs, HBar) and hs._efab is None
    assert isinstance(hs.Hvvvv_efab, Sharded)
    assert _gap(hs.Hvvvv_efab, hb.Hvvvv_efab) == 0
