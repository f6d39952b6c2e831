"""The plain reference agrees with the port's plain paths at a tiny size on
the CPU, and the port's float32 path (the control) fails the judge."""

import math

import pytest
import torch

import pycc_tpu_torch
from pycc_tpu_torch.cclambda import lambda_residuals_from_F
from pycc_tpu_torch.hamiltonian import build_hamiltonian
from pycc_tpu_torch.models.ccsd import cc_energy, residuals_ccsd
from pycc_tpu_torch.ops.kernels.vvvv import vvvv_nt_reference
from pycc_tpu_torch.parallel import Sharded, make_mesh
from pycc_tpu_torch.rt.lasers import gaussian_laser
from pycc_tpu_torch.triples import t_vikings_scan

from portbench.harness.inputs import make_inputs
from portbench.reference import ccsd as rcc
from portbench.reference import triples as rtr
from portbench.reference.hamiltonian import (FactorERI, FullERI, mo_eri,
                                             mo_fock, spin_adapted)
from portbench.reference.lam import build_hbar, lambda_residuals
from portbench.reference.rt import RT, Gaussian
from portbench.reference.rt_df import factor_rt
from portbench.tests.common import SEED, run_tiny

CPU = torch.device("cpu")
F64 = torch.float64


@pytest.fixture(scope="module")
def system(tiny):
    """A tiny seeded wavefunction, the port's Hamiltonian of it and the
    reference's, and random amplitudes near the MP2 guess."""
    cfg = tiny.config("h2o6_vdz")
    wfn = make_inputs(cfg, SEED, CPU)
    H = build_hamiltonian(wfn, device="cpu")
    C = torch.as_tensor(wfn.Ca_subset("AO", "ACTIVE"))
    F = mo_fock(C, torch.as_tensor(wfn.Fa()))
    ERI = mo_eri(C, torch.as_tensor(wfn.ERI_ao))
    no = H.no
    nv = F.shape[0] - no
    g = torch.Generator().manual_seed(5)
    t1 = 0.05 * torch.randn((no, nv), generator=g, dtype=F64)
    t2 = 0.05 * torch.randn((no, no, nv, nv), generator=g, dtype=F64)
    t2 = 0.5 * (t2 + t2.permute(1, 0, 3, 2))
    return dict(wfn=wfn, H=H, F=F, ERI=ERI, L=spin_adapted(ERI), no=no,
                t1=t1, t2=t2, g=g)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_hamiltonian_agrees(system):
    s = system
    assert _rel(s["H"].F, s["F"]) < 1e-14
    assert _rel(s["H"].ERI, s["ERI"]) < 1e-14
    assert _rel(s["H"].L, s["L"]) < 1e-14


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_ccsd_residuals_and_energy_agree(system, cplx):
    s = system
    no, v = s["no"], slice(s["no"], None)
    t1, t2 = s["t1"], s["t2"]
    F = s["F"]
    if cplx:
        t1 = t1 * (1 + 0.3j)
        t2 = t2 * (1 - 0.2j)
        F = F.to(torch.complex128)
    ERIv = s["ERI"][v, v, v, v].contiguous()
    r1, r2 = rcc.residuals_ccsd(F, FullERI(s["ERI"]), FullERI(s["L"]), ERIv,
                                t1, t2, no)
    p1, p2 = residuals_ccsd(F, s["H"].ERI, s["H"].L, s["H"].vvvv, t1, t2, no,
                            ladder=vvvv_nt_reference)
    assert _rel(p1, r1) < 1e-12 and _rel(p2, r2) < 1e-12
    e = rcc.cc_energy(F, FullERI(s["L"]), t1, t2, no)
    assert abs(complex(cc_energy(F, s["H"].L, t1, t2, no)) - complex(e)) \
        < 1e-13 * abs(complex(e))


def test_lambda_residuals_agree(system):
    s = system
    no, v = s["no"], slice(s["no"], None)
    g = s["g"]
    t1, t2 = s["t1"] * (1 + 0.1j), s["t2"] * (1 - 0.1j)
    l1 = 2 * t1 + 0.01j
    l2 = 2 * (2 * t2 - t2.swapaxes(2, 3)) + 0.01 * torch.randn(
        t2.shape, generator=g, dtype=F64)
    F = s["F"].to(torch.complex128)
    ERIv = s["ERI"][v, v, v, v].contiguous()
    H = build_hbar(F, FullERI(s["ERI"]), FullERI(s["L"]), ERIv, t1, t2, no)
    r1, r2 = lambda_residuals(H, FullERI(s["L"]), t2, l1, l2, no)
    p1, p2 = lambda_residuals_from_F("CCSD", F, s["H"].ERI, s["H"].L, t1,
                                     t2, l1, l2, no,
                                     ladder=vvvv_nt_reference)
    assert _rel(p1, r1) < 1e-12 and _rel(p2, r2) < 1e-12


def test_triples_energy_agrees(system):
    s = system
    cc = pycc_tpu_torch.ccwfn(s["wfn"], model="CCSD(T)", device="cpu")
    cc.solve_cc(1e-10, 1e-10)
    e_port = float(t_vikings_scan(cc))
    e_ref = float(rtr.t_energy(s["F"], FullERI(s["ERI"]), FullERI(s["L"]),
                               cc.t1, cc.t2, s["no"]))
    assert e_ref < 0 and abs(e_port - e_ref) < 1e-13 * abs(e_ref)


def test_factor_blocks_agree(tiny):
    x = make_inputs(tiny.config("h2o6_avdz_df"), SEED, CPU)
    B = torch.as_tensor(x.B)
    full = torch.einsum("Ppr,Pqs->pqrs", B, B)
    L = spin_adapted(full)
    E = FactorERI(B, x.no)
    LE = FactorERI(B, x.no, L=True, eri=E)
    o, v = slice(0, x.no), slice(x.no, None)
    for key in ((o, o, v, v), (o, v, v, v), (v, v, v, o), (o, v, o, o),
                (v, v, v, v)):
        assert _rel(E[key], full[key]) < 1e-14
        assert _rel(LE[key], L[key]) < 1e-14


def test_rt_rhs_and_dipole_agree(system):
    s = system
    no, v = s["no"], slice(s["no"], None)
    cc = pycc_tpu_torch.ccwfn(s["wfn"], model="CCSD", device="cpu")
    cc.solve_cc(1e-9, 1e-9)
    lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
    lam.solve_lambda(1e-9, 1e-9)
    pulse = (0.01, 0.3, 0.01, 0.05)
    rt = pycc_tpu_torch.rtcc(cc, lam, None, gaussian_laser(
        *pulse[:3], center=pulse[3]), ladder=vvvv_nt_reference)
    y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    y = y + 0.001 * torch.randn(y.shape, generator=s["g"], dtype=F64)
    mu = [torch.as_tensor(m) for m in cc.H.mu]
    ref = RT(s["F"], FullERI(s["ERI"]), FullERI(s["L"]),
             s["ERI"][v, v, v, v].contiguous(), mu, no, Gaussian(*pulse))
    for t in (0.0, 0.047):
        assert _rel(rt.f(t, y), ref.f(t, y)) < 1e-12
    mu_port = rt.dipole(*rt.extract_amps(y)[:4])
    mu_ref = ref.dipole(y).tolist()
    assert max(abs(a - b) for a, b in zip(mu_port, mu_ref)) < 1e-14


@pytest.mark.parametrize("blk", [3, 5, 17])
def test_factor_rt_agrees(tiny, blk):
    """The reference over factors, its v^4 terms in blocks of `blk` a's
    (v = 17: ragged blocks, and one block), gives the right-hand side and
    the dipole of the full reference on the ERI assembled from the same
    factors, and of the port's DF right-hand side, to 1e-12."""
    x = make_inputs(tiny.config("h2o6_avdz_df"), SEED, CPU)
    B = torch.as_tensor(x.B)
    F = torch.as_tensor(x.F)
    mu = [torch.as_tensor(m) for m in x.mu]
    no = x.no
    v = slice(no, None)
    ERI = torch.einsum("Ppr,Pqs->pqrs", B, B)
    pulse = (0.01, 0.3, 0.01, 0.02)
    full = RT(F, FullERI(ERI), FullERI(spin_adapted(ERI)),
              ERI[v, v, v, v].contiguous(), mu, no, Gaussian(*pulse))
    fac = factor_rt(B, F, mu, no, Gaussian(*pulse), blk=blk)
    cc = pycc_tpu_torch.ccwfn.from_df_factors(x.B, x.F, no, mu=x.mu,
                                              device="cpu")
    cc.solve_cc(1e-9, 1e-9)
    lam = pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))
    lam.solve_lambda(1e-9, 1e-9)
    rt = pycc_tpu_torch.rtcc(cc, lam, None, gaussian_laser(
        *pulse[:3], center=pulse[3]), ladder=vvvv_nt_reference)
    y = rt.collect_amps(cc.t1, cc.t2, lam.l1, lam.l2, 0)
    g = torch.Generator().manual_seed(11)
    y = y + 0.001 * torch.randn(y.shape, generator=g, dtype=F64)
    for t in (0.0, 0.017):
        ref = full.f(t, y)
        assert _rel(fac.f(t, y), ref) < 1e-12
        assert _rel(rt.f(t, y), fac.f(t, y)) < 1e-12
    mu_fac = fac.dipole(y)
    assert float((mu_fac - full.dipole(y)).abs().max()) < 1e-14
    mu_port = rt.dipole(*rt.extract_amps(y)[:4])
    assert max(abs(a - b) for a, b in zip(mu_port, mu_fac.tolist())) < 1e-14
    y1 = fac.rk4(0.0, y, 0.01)
    assert _rel(y1 - y, full.rk4(0.0, y, 0.01) - y) < 1e-12


@pytest.mark.parametrize("cell", ["h2o6_vdz.ccsd_t", "h2o6_avdz_df.ccsd",
                                  "h2o6_vdz.ccsd", "h2o6_vdz.rt",
                                  "h2o6_avdz_df.rt_df"])
def test_program_passes_and_float32_control_fails(tiny, cell):
    """The cell's own limits (limits/<cell>.json): the program in its
    configuration's float64 passes; its float32 path, the control, fails
    at least one number."""
    result, numbers = run_tiny(tiny, cell)
    assert result["correct"], numbers
    assert all(math.isfinite(x) for x in numbers.values())
    control, numbers = run_tiny(tiny, cell, precision="SP")
    assert not control["correct"], numbers


def test_blocked_judge_equals_the_whole_judge(tiny, monkeypatch):
    """The judge in blocks (the port's ERI and L no tensors, as on a mesh)
    reads, on one job's output with a block of ERI and one of L altered,
    what the whole judge reads: ham (not 0), res and e_gap within 1e-12,
    with every block made in two passes over the AO ERI (none made
    twice)."""
    kind = tiny.kind("cc")
    cfg = tiny.config("h2o6_vdz")
    traffic = tiny.traffic("ccsd")
    wfn = make_inputs(cfg, SEED, CPU)
    runner = kind.Runner(cfg, traffic, wfn, CPU)
    runner.job()
    out = runner.outputs()
    no = out["no"]
    o, v = slice(0, no), slice(no, None)
    ERI, L = out["ERI"].clone(), out["L"].clone()
    ERI[o, v, v, v] *= 1.0 + 1e-6
    L[v, v, v, v] *= 1.0 + 3e-6
    mesh = make_mesh(devices=[CPU] * 4)
    spec4 = (None, None, "va", "vb")
    sharded = dict(out, ERI=Sharded.put(ERI, mesh, spec4),
                   L=Sharded.put(L, mesh, spec4))
    stores = []

    class Counted(kind.SpaceERI):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            stores.append(self)
    monkeypatch.setattr(kind, "SpaceERI", Counted)
    whole = kind.judge(cfg, traffic, wfn, dict(out, ERI=ERI, L=L), CPU)
    assert stores == []
    blocked = kind.judge(cfg, traffic, wfn, sharded, CPU)
    assert set(whole) == set(blocked) == {"ham", "res", "e_gap"}
    for name in whole:
        assert abs(whole[name] - blocked[name]) < 1e-12, (whole, blocked)
    assert whole["ham"] > 1e-7
    assert [st.passes for st in stores] == [2, 0]
