"""A run with the timed path broken underneath reads `correct` false.

Each test drives everything of a run but the command's look for a card
(`run_cell`, at the tiny size on the CPU, with the cell's own limits) with
one fault planted in the program: a step that returns its state
unchanged; half of the batch left out and the rest doubled (the mean
taken over it); an answer altered where it is produced; for real-time
CC (on full storage and over factors), the field term of the Fock matrix dropped, its sign flipped or its
size doubled; on a four-card cell (a mesh over the CPU), one card's
piece of the sharded ERI scaled, and the exchange between cards left
out: one shard's columns of the sharded ladder never copied home.
"""

import pytest
import torch

import pycc_tpu_torch.models.ccsd as ccsd_model
import pycc_tpu_torch.ops.kernels.triples as k2
import pycc_tpu_torch.parallel.mesh as meshmod
from pycc_tpu_torch.ccwfn import ccwfn
from pycc_tpu_torch.rt import integrators
from pycc_tpu_torch.rt.rtcc import rtcc

from portbench.tests.common import (MESH_CELL, add_mesh_cell, run_tiny,
                                    tiny_copy)

CC_CELLS = ["h2o6_vdz.ccsd_t", "h2o6_avdz_df.ccsd", "h2o6_vdz.ccsd"]
RT_CELLS = ["h2o6_vdz.rt", "h2o6_avdz_df.rt_df"]


def _half_batch(r):
    """The first half of the occupied rows doubled, the rest left out."""
    h = r.shape[0] // 2
    out = torch.zeros_like(r)
    out[:h] = 2.0 * r[:h]
    return out


@pytest.mark.parametrize("cell", CC_CELLS)
def test_cc_step_returns_state_unchanged(tiny, monkeypatch, cell):
    monkeypatch.setattr(ccwfn, "residuals", lambda self, F, t1, t2, **kw: (
        torch.zeros_like(t1), torch.zeros_like(t2)))
    result, numbers = run_tiny(tiny, cell)
    assert not result["correct"], numbers


@pytest.mark.parametrize("cell", CC_CELLS)
def test_cc_half_of_the_pairs_left_out(tiny, monkeypatch, cell):
    real = ccwfn.residuals

    def half(self, F, t1, t2, **kw):
        r1, r2 = real(self, F, t1, t2, **kw)
        return r1, _half_batch(r2)
    monkeypatch.setattr(ccwfn, "residuals", half)
    result, numbers = run_tiny(tiny, cell)
    assert not result["correct"], numbers


def test_triples_half_of_the_rows_left_out(tiny, monkeypatch):
    def half(Wv, Wo, Ev, Eo, L, Fov, eps, t1, t2, no, stream_dtype=None):
        t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
        h = no // 2
        e = sum(k2.t_row_finalize(i, k2.t_energy_row(
            i, Wv, Wo, Ev, Eo, L, Fov, eps, t2, no,
            stream_dtype=stream_dtype), t1, t2w) for i in range(h))
        return e * (no / h)
    monkeypatch.setattr(k2, "t_vikings_rows", half)
    result, numbers = run_tiny(tiny, "h2o6_vdz.ccsd_t")
    assert not result["correct"], numbers


@pytest.mark.parametrize("cell", CC_CELLS)
def test_cc_energy_altered(tiny, monkeypatch, cell):
    real = ccwfn.solve_cc

    def altered(self, *args, **kw):
        return real(self, *args, **kw) + 1e-6
    monkeypatch.setattr(ccwfn, "solve_cc", altered)
    result, numbers = run_tiny(tiny, cell)
    assert not result["correct"], numbers


@pytest.mark.parametrize("cell", RT_CELLS)
def test_rt_step_returns_state_unchanged(tiny, monkeypatch, cell):
    monkeypatch.setattr(integrators.rk4, "__call__",
                        lambda self, f, t, y: y)
    result, numbers = run_tiny(tiny, cell)
    assert not result["correct"], numbers


@pytest.mark.parametrize("cell", RT_CELLS)
def test_rt_half_of_the_pairs_left_out(tiny, monkeypatch, cell):
    real = rtcc.lambda_residuals

    def half(self, *args):
        r1, r2 = real(self, *args)
        return r1, _half_batch(r2)
    monkeypatch.setattr(rtcc, "lambda_residuals", half)
    result, numbers = run_tiny(tiny, cell)
    assert not result["correct"], numbers


@pytest.mark.parametrize("cell", RT_CELLS)
def test_rt_dipole_altered(tiny, monkeypatch, cell):
    real = rtcc.dipole

    def altered(self, *args, **kw):
        mu = real(self, *args, **kw)
        return (mu[0] + 1e-6,) + tuple(mu[1:])
    monkeypatch.setattr(rtcc, "dipole", altered)
    result, numbers = run_tiny(tiny, cell)
    assert not result["correct"], numbers


@pytest.mark.parametrize("cell", RT_CELLS)
@pytest.mark.parametrize("scale", [0.0, -1.0, 2.0],
                         ids=["dropped", "sign-flipped", "doubled"])
def test_rt_field_term_wrong(tiny, monkeypatch, scale, cell):
    """F0 + scale mu_tot V(t) in place of F0 + mu_tot V(t)."""
    def field(self, t, dtype):
        F0 = self.ccwfn.H.F.to(dtype)
        return F0 + scale * self.mu_tot.to(dtype) * float(self.V(t))
    monkeypatch.setattr(rtcc, "_field", field)
    result, numbers = run_tiny(tiny, cell)
    assert not result["correct"], numbers
    assert numbers["step_pulse"] > 1e3 * 1e-10, numbers


def test_mesh_eri_piece_scaled(tmp_path, monkeypatch):
    """One card's piece of the sharded ERI scaled by (1 + 1e-6) where it
    is laid over the mesh: the blocked judge's ham reads it."""
    tiny_copy(tmp_path)
    spec = add_mesh_cell(tmp_path)
    real = meshmod.shard_hamiltonian

    def scaled(H, mesh, dtype=None):
        out = real(H, mesh, dtype)
        out.ERI.pieces[(1, 1)].mul_(1.0 + 1e-6)
        return out
    monkeypatch.setattr(meshmod, "shard_hamiltonian", scaled)
    result, numbers = run_tiny(spec, MESH_CELL)
    assert not result["correct"], numbers
    assert numbers["ham"] > spec.limits(MESH_CELL)["ham"], numbers


def test_mesh_ladder_shard_left_out(tmp_path, monkeypatch):
    """The exchange between cards left out: the last shard's (a, b)
    columns of the sharded CCSD ladder are not copied into the result on
    the home card (read as zeros).  The solver converges to another
    fixed point, which the reference residual `res` reads."""
    tiny_copy(tmp_path)
    spec = add_mesh_cell(tmp_path)
    real = ccsd_model.ladder_sharded
    calls = []

    def dropped(tau, W, fn):
        out = real(tau, W, fn)
        sl, _ = list(getattr(W, "ri", W).shards())[-1]
        out[:, :, sl[-4], sl[-3]] = 0
        calls.append(1)
        return out
    monkeypatch.setattr(ccsd_model, "ladder_sharded", dropped)
    result, numbers = run_tiny(spec, MESH_CELL)
    assert calls
    assert not result["correct"], numbers
    assert not numbers["res"] <= spec.limits(MESH_CELL)["res"], numbers


def test_mesh_float32_control_fails(tmp_path):
    """On a four-card cell the port's float32 path, the control, fails
    the blocked judge; the configuration's float64 passes it."""
    tiny_copy(tmp_path)
    spec = add_mesh_cell(tmp_path)
    result, numbers = run_tiny(spec, MESH_CELL)
    assert result["correct"], numbers
    control, numbers = run_tiny(spec, MESH_CELL, precision="SP")
    assert not control["correct"], numbers
