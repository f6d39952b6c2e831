"""pycc_tpu_torch as a package: no JAX, explicit devices, and every
option outside the ported slice refused by name."""

import ast
import contextlib
import inspect
import io
import os
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import pycc_tpu_torch
from pycc_tpu_torch.scf import run_rhf
from pycc_tpu_torch.triples import t_vikings

from .common import H2O

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wfn():
    return run_rhf(H2O, "sto-3g", freeze_core=True)


def test_import_loads_no_jax_or_triton():
    code = ("import sys, pycc_tpu_torch, pycc_tpu_torch.ops.kernels, "
            "pycc_tpu_torch.ops.kernels.triples, pycc_tpu_torch.triples, "
            "pycc_tpu_torch.utils.synth, pycc_tpu_torch.cceom, "
            "pycc_tpu_torch.ccresponse, pycc_tpu_torch.local, "
            "pycc_tpu_torch.lccwfn, pycc_tpu_torch.lccwfn_local, "
            "pycc_tpu_torch.lccwfn_screened, pycc_tpu_torch.scf.localize, "
            "pycc_tpu_torch.utils.timing; "
            "print(sorted(m for m in ('jax', 'triton') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "[]"


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_pycc_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "pycc_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "pycc_tpu")]
    assert bad == []


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pycc_tpu_torch.ccwfn(_wfn(), device="cuda")


def test_entry_points_default_to_the_card():
    from pycc_tpu_torch.hamiltonian import Hamiltonian, build_hamiltonian
    from pycc_tpu_torch.utils.synth import synthetic_hamiltonian
    for fn in (pycc_tpu_torch.ccwfn.__init__, build_hamiltonian,
               Hamiltonian.from_numpy, synthetic_hamiltonian):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pycc_tpu_torch.ccwfn(_wfn())


@pytest.mark.parametrize("kwargs", [
    {"storage": "df", "mesh": 4},
    {"model": "CC3", "real_time": True},
    {"real_time": True},
    {"storage": "blocked"}, {"local": "PNO"}, {"mesh": 4},
])
def test_options_outside_the_slice_raise(kwargs):
    """Each option outside the slice raises naming its ROADMAP.md item;
    storage='blocked' (ported with item 10), real_time=True (item 11),
    local='PNO' (item 12) and mesh= (item 13: here a 2 x 2 mesh of CPU
    devices, from make_mesh) build."""
    from pycc_tpu_torch.parallel import make_mesh
    kwargs = dict(kwargs)
    if "mesh" in kwargs:
        kwargs["mesh"] = make_mesh(devices=["cpu"] * kwargs["mesh"])
    _ran_or_raised(lambda: pycc_tpu_torch.ccwfn(_wfn(), device="cpu",
                                                **kwargs).t2, None)


@pytest.mark.parametrize("kwargs", [
    dict(local="PNO", filter=True),
    dict(local="PNO++", local_cutoff=1e-7, it2_opt=False, filter=True),
    dict(local="CPNO++", local_cutoff=1e-7, filter=True),
    dict(local="PAO", local_cutoff=2e-2, local_mos="BOYS", filter=True),
    dict(local="PNO", model="CCD", pair_cutoff=0.0),
    dict(local="PNO", model="CCSD", storage="blocked", filter=True),
])
def test_ccwfn_accepts_every_local_keyword(kwargs):
    """The local keywords (item 12) build on the CPU, as pycc_tpu's do;
    the initial amplitudes are the filtered MP2 guess."""
    with contextlib.redirect_stdout(io.StringIO()):
        cc = pycc_tpu_torch.ccwfn(_wfn(), device="cpu", **kwargs)
    assert cc.local == kwargs["local"] and cc.Local.dim.shape == (cc.no ** 2,)
    assert bool(torch.isfinite(cc.t2).all()) and cc.t2.abs().max() > 0
    assert hasattr(cc, "lccwfn") == (not kwargs.get("filter", False))


def test_mesh_names_item_13():
    """mesh= is item 13, ported: a mesh that is not a parallel.Mesh is a
    TypeError naming make_mesh; the native local solver over a mesh is
    item 13b, still to come."""
    from pycc_tpu_torch.parallel import make_mesh
    with pytest.raises(TypeError, match="make_mesh"):
        pycc_tpu_torch.ccwfn(_wfn(), device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="item 13b"):
        pycc_tpu_torch.ccwfn(_wfn(), device="cpu", local="PNO",
                             mesh=make_mesh(devices=["cpu"] * 2))


def test_trace_writes_a_profile(tmp_path):
    from pycc_tpu_torch.utils.timing import trace
    cc = pycc_tpu_torch.ccwfn(_wfn(), device="cpu")
    with trace(str(tmp_path)) as prof, \
            contextlib.redirect_stdout(io.StringIO()):
        cc.solve_cc(e_conv=1e-6, r_conv=1e-6)
    path = tmp_path / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_t3_scan_names_the_cc3_item():
    """t3_scan picks CC3's residual form: the slab form when True, the
    full-tensor form when False and, at this size, when None; DF storage
    always takes the slab form over factors."""
    from pycc_tpu_torch.models import cc3
    picked = {scan: pycc_tpu_torch.ccwfn(_wfn(), model="CC3", t3_scan=scan,
                                         device="cpu")._residual_fn
              for scan in (None, True, False)}
    assert picked == {None: cc3.residuals_cc3, True: cc3.residuals_cc3_scan,
                      False: cc3.residuals_cc3}
    cc = pycc_tpu_torch.ccwfn(_wfn(), model="CC3", storage="df",
                              device="cpu")
    assert cc._residual_fn is cc3.residuals_cc3_scan_df


@pytest.mark.parametrize("t3_scan", [None, True, False])
def test_make_t3_density_and_t3_scan_are_accepted_for_ccsd_t(t3_scan):
    cc = pycc_tpu_torch.ccwfn(_wfn(), model="CCSD(T)", make_t3_density=True,
                              t3_scan=t3_scan, device="cpu")
    assert cc.make_t3_density and cc.t3_scan is t3_scan
    with contextlib.redirect_stdout(io.StringIO()):
        e = cc.solve_cc(e_conv=1e-10, r_conv=1e-10)
    # the (T) came from the density, which left the Lambda sources
    assert cc.converged and cc.S1.shape == cc.t1.shape
    assert abs(e - float(cc.cc_energy(cc.t1, cc.t2))
               - float(t_vikings(cc))) < 1e-12


def _converged(**kw):
    cc = pycc_tpu_torch.ccwfn(_wfn(), device="cpu", **kw)
    with contextlib.redirect_stdout(io.StringIO()):
        cc.solve_cc(e_conv=1e-8, r_conv=1e-8)
    return cc


def _mesh_hbar():
    """The HBAR of a ccwfn on a 2 x 2 mesh of CPU devices (item 13)."""
    from pycc_tpu_torch.parallel import make_mesh
    cc = _converged(mesh=make_mesh(devices=["cpu"] * 4))
    with contextlib.redirect_stdout(io.StringIO()):
        return pycc_tpu_torch.cchbar(cc)


def _full_hbar():
    cc = _converged()
    with contextlib.redirect_stdout(io.StringIO()):
        return cc, pycc_tpu_torch.cchbar(cc)


def _lambda_chk():
    """A Lambda solve that checkpoints every iteration (ported with item
    10): the pseudo-energy, and the checkpoint's l2."""
    cc, hb = _full_hbar()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(io.StringIO()):
        path = os.path.join(d, "l.npz")
        lecc = pycc_tpu_torch.cclambda(cc, hb).solve_lambda(chk=path,
                                                            chk_every=1)
        return torch.tensor(lecc), torch.from_numpy(np.load(path)["l2"])


def _eom_resume():
    """An EOM solve cut after two iterations and resumed from its
    checkpoint (ported with item 10): the roots."""
    _, hb = _full_hbar()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(io.StringIO()):
        path = os.path.join(d, "eom.npz")
        with pytest.warns(UserWarning, match="did NOT converge"):
            pycc_tpu_torch.cceom(hb).solve_eom(maxiter=2, chk=path)
        return pycc_tpu_torch.cceom(hb).solve_eom(chk=path, resume=True)[0]


def _blocked_hbar():
    with contextlib.redirect_stdout(io.StringIO()):
        return pycc_tpu_torch.cchbar(_converged(storage="blocked")).Hovoo


def _mixed_lambda_df():
    _, lam = _df_lambda("CCSD")
    with contextlib.redirect_stdout(io.StringIO()):
        return torch.tensor(lam.solve_lambda_mixed())


def _cc3_onepdm():
    """The CC3 one-pdm of a DF ccwfn (ported with item 9)."""
    cc = _converged(model="CC3", storage="df")
    return pycc_tpu_torch.ccdensity(
        cc, types.SimpleNamespace(l1=cc.t1, l2=cc.t2),
        onlyone=True).compute_onepdm(cc.t1, cc.t2, cc.t1, cc.t2)


def _df_lambda(model):
    cc = _converged(model=model, storage="df")
    with contextlib.redirect_stdout(io.StringIO()):
        return cc, pycc_tpu_torch.cclambda(cc, pycc_tpu_torch.cchbar(cc))


def _cc3_lambda_residuals():
    """Lambda over a DF CC3 ccwfn (ported with item 9): two iterations."""
    _, lam = _df_lambda("CC3")
    with pytest.warns(UserWarning, match="did NOT converge"):
        return torch.tensor(lam.solve_lambda(maxiter=2))


def _df_lambda_from_F():
    """The DF-HBAR rebuilt from a field-dressed F each step
    (lambda_residuals_from_F_df), real-time CC's Lambda over factors: at
    the unperturbed F it is the solver's residual."""
    cc, lam = _df_lambda("CCSD")
    r = lam.residuals(cc.H.F, cc.t1, cc.t2, lam.l1, lam.l2)
    hb = pycc_tpu_torch.cchbar(cc)
    solver = lam._residual_fn(hb.hbar, None, None)[0](lam.l1, lam.l2)
    assert all((a - b).abs().max() < 1e-12 for a, b in zip(r, solver))
    return r


def _ran_or_raised(call, item):
    """item None: the call (ported since) runs and returns finite tensors;
    else it raises NotImplementedError naming the item."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            call()
        return
    out = call()
    out = out if isinstance(out, (tuple, list)) else (out,)
    assert out and all(bool(torch.isfinite(torch.as_tensor(x)).all())
                       for x in out)


@pytest.mark.parametrize("call,item", [
    (lambda: pycc_tpu_torch.cchbar(_converged(storage="df")).hbar.Hovoo,
     None),
    (lambda: _converged(storage="df").t3_density(), None),
    (_blocked_hbar, None),
    (lambda: _mesh_hbar().Hvvvv.full(), None),
    (_lambda_chk, None),
    (_eom_resume, None),
    (_cc3_onepdm, None),
    (_cc3_lambda_residuals, None),
    (_df_lambda_from_F, None),
    (_mixed_lambda_df, None),
], ids=["hbar-df", "t3-density-df", "hbar-blocked", "hbar-mesh", "lambda-chk", "eom-resume",
        "onepdm-cc3", "lambda-cc3", "lambda-from-F-df", "lambda-mixed-df"])
def test_post_convergence_options_outside_the_slice_name_their_item(call,
                                                                    item):
    """Options outside the slice raise naming their ROADMAP.md item; the
    DF cases item 9 ported and the blocked, checkpoint and mixed cases
    item 10 ported (item None) now run."""
    _ran_or_raised(call, item)


def test_post_convergence_entry_points_are_exported():
    for name in ("cchbar", "cclambda", "ccdensity", "cceom", "ccresponse",
                 "pertbar", "rtcc"):
        assert name in pycc_tpu_torch.__all__
        assert isinstance(getattr(pycc_tpu_torch, name), type)


def _response(storage="full"):
    if storage == "df":
        cc, lam = _df_lambda("CCSD")
    else:
        cc, hb = _full_hbar()
        lam = pycc_tpu_torch.cclambda(cc, hb)
    return pycc_tpu_torch.ccresponse(types.SimpleNamespace(
        ccwfn=cc, cclambda=lam))


def _df_right_solve():
    """A right solve over factors (ported with item 9): three iterations."""
    resp = _response("df")
    with pytest.warns(UserWarning, match="did NOT converge"):
        X1, X2, _ = resp.solve_right(resp.pertbar["MU_Z"], 0.1, maxiter=3,
                                     cond_check=False)
    return X1, X2


def _mixed_response(storage, sides):
    """Mixed-precision solves (ported with item 10): the pseudo-responses
    of a right solve and, for the left side, the left solve over it."""
    resp = _response(storage)
    out = []
    with contextlib.redirect_stdout(io.StringIO()):
        for side in sides:
            solve = getattr(resp, "solve_%s_mixed" % side)
            out.append(torch.tensor(solve("MU_X", 0.1, e_conv=1e-8,
                                          r_conv=1e-8)[2]))
    return out


@pytest.mark.parametrize("call,item", [
    (_df_right_solve, None),
    (lambda: _mixed_response("full", ["right"]), None),
    (lambda: _mixed_response("full", ["right", "left"]), None),
    (lambda: _mixed_response("df", ["right", "left"]), None),
], ids=["response-df", "right-mixed", "left-mixed", "left-mixed-df"])
def test_response_options_outside_the_slice_name_their_item(call, item):
    """As the post-convergence options; DF response and the mixed solvers
    (item None) run."""
    _ran_or_raised(call, item)


@pytest.mark.parametrize("kwargs", [
    {"bf16_until": 1e-3}, {"chk": "amps.npz"}, {"resume": True},
])
def test_solver_options_outside_the_slice_raise(kwargs, tmp_path,
                                                monkeypatch):
    """bf16_until on full storage raises as pycc_tpu's solve_cc does
    (naming blocked storage); chk and resume (ported with item 10) run."""
    monkeypatch.chdir(tmp_path)
    cc = pycc_tpu_torch.ccwfn(_wfn(), device="cpu")
    if "bf16_until" in kwargs:
        with pytest.raises(ValueError, match="blocked"):
            cc.solve_cc(**kwargs)
        return
    with contextlib.redirect_stdout(io.StringIO()):
        _ran_or_raised(lambda: torch.tensor(cc.solve_cc(**kwargs)), None)


def test_bad_values_raise():
    with pytest.raises(ValueError):
        pycc_tpu_torch.ccwfn(_wfn(), model="CCSDT-1")
    with pytest.raises(ValueError):
        pycc_tpu_torch.ccwfn(_wfn(), precision="HP")
    with pytest.raises(TypeError):
        pycc_tpu_torch.ccwfn(_wfn(), no_such_option=1)
