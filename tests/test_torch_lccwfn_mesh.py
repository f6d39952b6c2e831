"""The native local solver over a device mesh (`lccwfn(mesh=)`) in the
port, on CPU meshes.

The precomputed pair stacks are cut by pycc_tpu's rule
(`parallel.mesh.shard_pair_stacks`, held to pycc_tpu's own function
stack by stack), every contraction that reads a piece runs through
`contract_pieces` (held to `contract` on each kind of case the residuals
hold) and every cross-pair gather through `take`; then the sharded
CCD, CCSD and CC2 solvers and the pair-screened CCD and CCSD ones equal
the unsharded solvers at 1e-12, on test_010's H2O/cc-pVDZ (all
electrons, PNO 1e-5, (no, D) = (5, 14)) over a 2 x 2 mesh of the CPU,
which splits no = 5 unevenly.
"""

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu.parallel.mesh as jmesh
import pycc_tpu_torch
import pycc_tpu_torch.lccwfn_local as tleq
import pycc_tpu_torch.lccwfn_screened as tseq
from pycc_tpu.ops.contract import contract as jcontract
from pycc_tpu_torch.ops.contract import contract
from pycc_tpu_torch.parallel import (Sharded, contract_pieces, make_mesh,
                                     shard_pair_stacks, take)

from .common import scf

KW = dict(local="PNO", local_cutoff=1e-5, it2_opt=False)


def _quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def _mesh(shape=(2, 2)):
    return make_mesh(devices=["cpu"] * (shape[0] * shape[1]), shape=shape)


@functools.lru_cache(maxsize=None)
def _wfn():
    return scf("H2O", "cc-pvdz", freeze_core=False)


@functools.lru_cache(maxsize=None)
def _solved(model, pair_cutoff=None, sharded=False):
    cc = _quiet(pycc_tpu_torch.ccwfn, _wfn(), model=model, device="cpu",
                pair_cutoff=pair_cutoff, mesh=_mesh() if sharded else None,
                **KW)
    e = _quiet(cc.lccwfn.solve_lcc, 1e-12, 1e-12, maxiter=100)
    return cc, e


@pytest.mark.parametrize("model,pair_cutoff", [
    ("CCD", None), ("CCSD", None), ("CC2", None), ("CCD", 1e-3),
    ("CCSD", 1e-3)])
def test_sharded_solver_equals_the_unsharded(model, pair_cutoff):
    cc, e = _solved(model, pair_cutoff, sharded=True)
    ref, e_ref = _solved(model, pair_cutoff)
    lw = cc.lccwfn
    big = "Sr" if pair_cutoff is None else "Sg"
    assert isinstance(lw._pre[big], Sharded)
    assert not isinstance(cc.H.ERI, Sharded)
    assert abs(e - e_ref) < 1e-12
    assert lw.niter == ref.lccwfn.niter
    assert (lw.t2 - ref.lccwfn.t2).abs().max().item() < 1e-10


@functools.lru_cache(maxsize=None)
def _stacks(kind):
    cc, _ = _solved("CCSD")
    lw, H = cc.lccwfn, cc.H
    if kind == "local":
        return lw._pre, lw.no
    return tseq.precompute_ccsd_screened(H, lw.Local, lw.no, lw.nv,
                                         1e-3), lw.no


def _amps(no, D, seed=3):
    rng = np.random.default_rng(seed)
    t1 = torch.from_numpy(0.01 * rng.standard_normal((no, D)))
    t2 = 0.01 * rng.standard_normal((no, no, D, D))
    return t1, torch.from_numpy(t2 + t2.transpose(1, 0, 3, 2))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("kind", ["local", "screened"])
def test_residuals_over_the_pieces_equal_the_whole(kind, shape):
    """Every residual and energy over the pieces, on three grid shapes,
    equals the one over the whole stacks (the final pair symmetrisation
    r2 + r2^T crosses cells)."""
    pre, no = _stacks(kind)
    spre = shard_pair_stacks(pre, _mesh(shape), no)
    t1, t2 = _amps(no, pre["Fov_ii"].shape[1])
    if kind == "local":
        pairs = [(tleq.residuals_ccsd_local(pre, t1, t2),
                  tleq.residuals_ccsd_local(spre, t1, t2)),
                 (tleq.residuals_cc2_local(pre, t1, t2),
                  tleq.residuals_cc2_local(spre, t1, t2)),
                 ((tleq.residuals_ccd_local(pre, t2),),
                  (tleq.residuals_ccd_local(spre, t2),)),
                 ((tleq.energy_ccsd_local(pre, t1, t2),),
                  (tleq.energy_ccsd_local(spre, t1, t2),))]
    else:
        pairs = [(tseq.residuals_ccsd_screened(pre, t1, t2),
                  tseq.residuals_ccsd_screened(spre, t1, t2)),
                 ((tseq.residuals_ccd_screened(pre, t2),),
                  (tseq.residuals_ccd_screened(spre, t2),)),
                 ((tseq.energy_ccsd_screened(pre, t1, t2),),
                  (tseq.energy_ccsd_screened(spre, t1, t2),))]
    for whole, pieces in pairs:
        for a, b in zip(whole, pieces):
            assert not isinstance(b, Sharded) and b.shape == a.shape
            assert (a - b).abs().max().item() < 1e-15


@pytest.mark.parametrize("kind", ["local", "screened"])
def test_shard_pair_stacks_follows_pycc_tpus_rule(kind, monkeypatch):
    """Stack by stack, the layout pycc_tpu's shard_pair_stacks asks for
    (its `_put` recorded, on the port's stacks as numpy arrays): the
    (no, no)-leading stacks with a local-virtual payload over ('va',
    'vb'), the compact P-leading ones over 'va', the rest whole.  The one
    difference: integer and boolean tensors (pair index maps, masks) stay
    whole on the home device, where pycc_tpu lays those of leading dim P
    over 'va'."""
    pre, no = _stacks(kind)
    monkeypatch.setattr(jmesh, "_put", lambda x, mesh, spec: tuple(spec))
    asked = jmesh.shard_pair_stacks(
        {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in pre.items()}, None, no)
    got = shard_pair_stacks(pre, _mesh(), no)
    assert set(got) == set(pre)
    n_cut = 0
    for k, v in pre.items():
        g = got[k]
        if not isinstance(v, torch.Tensor):
            assert g == v == asked[k], k
            continue
        if isinstance(g, Sharded):
            n_cut += 1
            assert tuple(p for p in g.spec if p) == asked[k], k
            assert g.full().equal(v), k
        elif v.is_floating_point():
            assert asked[k] == (), k
            assert g.equal(v), k
        else:
            assert asked[k] in ((), ("va",)), k
            assert g.equal(v), k
    assert n_cut > 10
    # a stack under two keys is cut once
    if kind == "local":
        assert got["Sijnn"] is got["Sijmm"]


def _rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed + sum(shape))
    return torch.randn(*shape, dtype=torch.float64, generator=g)


NO, D, P = 5, 3, 11


# (subscripts, operands: ('spec', shape) cut over the mesh or ('whole',
# shape), keep) -- each kind of contraction the residuals run
CASES = {
    # Fmi: keeps j, sums the cells that differ in n
    "Fmi": ("jnab,jnmab->mj", [("whole", (NO, NO, D, D)),
                               (("va", "vb"), (NO, NO, NO, D, D))], False),
    # Wmbej: XE's leading pair (i, m) is not the output's (i, j)
    "Wmbej": ("ijnbf,imjnef->ijmbe", [("whole", (NO, NO, NO, D, D)),
                                      (("va", "vb"), (NO, NO, NO, NO, D, D))],
              False),
    # ST: stays on the pieces
    "keep": ("ijmnax,mnxy->ijmnay", [(("va", "vb"), (NO, NO, NO, NO, D, D)),
                                     ("whole", (NO, NO, D, D))], True),
    # two stacks of one layout and a whole operand between them
    "three": ("ijmax,imxy,ijmby->ijmab", [
        (("va", "vb"), (NO, NO, NO, D, D)), ("whole", (NO, NO, D, D)),
        (("va", "vb"), (NO, NO, NO, D, D))], False),
    # the diagonal of a stack (r2's seed, 0.5 BE[i, j, i, j])
    "diagonal": ("ijijab->ijab", [(("va", "vb"), (NO, NO, NO, NO, D, D))],
                 False),
    # an energy: every letter contracted
    "scalar": ("ijab,ijab->", [("whole", (NO, NO, D, D)),
                               (("va", "vb"), (NO, NO, D, D))], False),
    # compact screened stacks over 'va'
    "va": ("pqax,qxy->pqay", [(("va",), (P, P, D, D)),
                              ("whole", (P, D, D))], True),
    "va_second": ("pef,pqef->qp", [("whole", (P, D, D)),
                                   (("va",), (P, P, D, D))], False),
}


@pytest.mark.parametrize("shape", [(2, 2), (3, 1)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_contract_pieces_equals_contract(case, shape):
    sub, ops, keep = CASES[case]
    mesh = _mesh(shape)
    whole = [_rand(*s, seed=k) for k, (_, s) in enumerate(ops)]
    args = [x if spec == "whole" else Sharded.put(x, mesh, spec)
            for x, (spec, _) in zip(whole, ops)]
    out = contract_pieces(sub, *args, keep=keep)
    ref = contract(sub, *whole)
    if keep:
        assert isinstance(out, Sharded)
        out = out.full()
    assert out.shape == ref.shape
    assert (out - ref).abs().max().item() < 1e-13 * max(
        1.0, ref.abs().max().item())
    # and pycc_tpu's einsum on the same operands
    jref = np.asarray(jcontract(sub, *(x.numpy() for x in whole)))
    assert np.abs(out.numpy() - jref).max() < 1e-12 * max(1.0, np.abs(
        jref).max())


def test_contract_pieces_without_pieces_is_contract():
    a, b = _rand(NO, NO, D, D), _rand(NO, NO, NO, D, D, seed=1)
    assert contract_pieces("jnab,jnmab->mj", a, b).equal(
        contract("jnab,jnmab->mj", a, b))


def test_contract_pieces_refuses_what_it_cannot_cut():
    mesh = _mesh()
    x = Sharded.put(_rand(NO, NO, NO, D, D), mesh, ("va", "vb"))
    y = Sharded.put(_rand(NO, NO, NO, D, D, seed=1), mesh, ("va", "vb"))
    # the two stacks cut different letters: (i, j) and (i, m)
    with pytest.raises(ValueError, match="different letters"):
        contract_pieces("ijnbf,imnbf->ijm", x, y)
    # keep=True needs the cell letters leading the output
    with pytest.raises(ValueError, match="begin with the cell letters"):
        contract_pieces("ijnbf->nijbf", x, keep=True)


def test_take_equals_indexing():
    mesh = _mesh()
    x = _rand(P, P, D, D)
    s = Sharded.put(x, mesh, ("va",))
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, P, (P, 1), generator=g)
    cols = torch.randint(0, P, (P, NO), generator=g)
    assert take(s, rows, cols).equal(x[rows, cols])
    assert take(s, cols, rows).equal(x[cols, rows])
    r = torch.arange(P)
    assert take(s, r, 3).equal(x[:, 3])
    assert take(s, r, r).equal(x[r, r])
    assert take(s, torch.tensor([4, 0, 9])).equal(x[[4, 0, 9]])
    assert take(x, rows, cols).equal(x[rows, cols])
    with pytest.raises(ValueError, match="leading axis"):
        take(Sharded.put(x, mesh, ("va", "vb")), rows, cols)
