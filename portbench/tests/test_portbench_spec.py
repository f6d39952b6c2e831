"""BENCHMARK.json keeps the contract's names, keys and cross-references,
and the harness finds a new configuration, mix and metric by name."""

import json
import os
import re
import shutil

import pytest
import torch

from portbench.harness import cell as cellmod
from portbench.harness.spec import ROOT, Spec
from portbench.tests.common import (TINY, add_mesh_cell, run_tiny,
                                    run_tiny_units, tiny_copy)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    assert len(set(n for _, n in names)) == len(names)


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith(bench["paths"][0] + "/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_moves_and_workloads_agree(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(m):
        return set(m.get("workloads", cells))

    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", ())) <= cells, m["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert "workloads" in m
        assert set(m["workloads"]) <= reports(e2e[m["moves"]]), m["name"]
    for cell in cells:
        mine = [n for n, m in e2e.items() if cell in reports(m)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert any(cell in m["workloads"] for m in bench["per_layer"]), cell
    assert {w["config"] for w in bench["workloads"]} == {
        c["name"] for c in bench["configs"]}


def test_every_named_file_exists(bench):
    spec = Spec()
    for w in bench["workloads"]:
        spec.config(w["config"])
        kind = spec.kind(spec.traffic(w["traffic"])["kind"])
        assert callable(kind.Runner) and callable(kind.judge)
        assert spec.limits(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_a_new_config_mix_and_metric_need_no_code(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    and entries, in a copy, are found and run without a code edit."""
    spec = tiny_copy(tmp_path)
    bdir = tmp_path / "portbench"
    cfg = json.loads((bdir / "configs" / "h2o6_vdz.json").read_text())
    cfg.update(name="dummy_cfg", nbf=18, nfzc=0, ndocc=3)
    (bdir / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (bdir / "traffic" / "dummy_mix.json").write_text(json.dumps(
        dict(kind="cc", model="CCSD", e_conv=1e-8, r_conv=1e-8,
             maxiter=60)))
    (bdir / "metrics" / "dummy_jobs.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    (bdir / "limits" / "dummy_cfg.dummy_mix.json").write_text(
        (bdir / "limits" / "h2o6_avdz_df.ccsd.json").read_text())
    bench = spec.bench
    bench["configs"].append(dict(name="dummy_cfg", source="a test",
                                 file="portbench/configs/dummy_cfg.json",
                                 reduced=[], why="a test"))
    bench["workloads"].append(dict(name="dummy_cfg.dummy_mix",
                                   config="dummy_cfg", traffic="dummy_mix",
                                   chips=1, why="a test"))
    bench["end_to_end"].append(dict(
        name="dummy_jobs", unit="jobs", better="higher", bound=0.01,
        source="host_clock", workloads=["dummy_cfg.dummy_mix"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    result, numbers = run_tiny(Spec(str(tmp_path)), "dummy_cfg.dummy_mix")
    assert result["correct"], numbers
    assert result["metrics"]["dummy_jobs"]["value"] == result["attempted"]
    assert "setup_s" in result["metrics"]
    assert "ccsd_s" not in result["metrics"]
    assert set(TINY) == {c["name"] for c in Spec().bench["configs"]}


def test_metric_reader_falls_back_to_its_prefix():
    """metrics/<name>.py first, else the file of the name up to its last
    '.'; a name with neither has no reader."""
    spec = Spec()
    idle = spec.reader("device_idle_pct.some_cell")
    assert idle.__module__ != spec.reader("k1_roofline.rt").__module__
    assert "k1_roofline.rt" in spec.reader("k1_roofline.rt").__globals__[
        "__file__"]
    assert spec.reader("k1_roofline.full").__globals__["__file__"].endswith(
        "k1_roofline.py")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.ccsd")


DUMMY_KIND = """
import time

import pycc_tpu_torch

from portbench.harness.check import full_hamiltonian
from portbench.reference import ccsd as rcc
from portbench.reference.hamiltonian import FullERI, spin_adapted


class Runner:
    def __init__(self, cfg, traffic, inputs, device, precision=None):
        self.inputs, self.device = inputs, device
        self.units, self.failed = [], 0

    def setup(self):
        pass

    def window(self, seconds):
        t0 = time.perf_counter()
        self.cc = pycc_tpu_torch.ccwfn(self.inputs, device=self.device)
        e = self.cc.cc_energy(self.cc.t1, self.cc.t2)
        self.units.append(dict(energy=float(e)))
        self.window_s = time.perf_counter() - t0

    def outputs(self):
        cc, self.cc = self.cc, None
        return dict(t1=cc.t1, t2=cc.t2, no=cc.no,
                    energy=self.units[0]["energy"])


def judge(cfg, traffic, inputs, out, device):
    F, ERI, _ = full_hamiltonian(inputs, device)
    e = rcc.cc_energy(F, FullERI(spin_adapted(ERI)), out["t1"], out["t2"],
                      out["no"])
    return {"mp2_gap": abs(out["energy"] - float(e))}
"""


def test_a_new_kind_needs_no_code(tmp_path):
    """A kind of traffic added as a file (kinds/<kind>.py: its Runner and
    its judge), with a mix and a cell of it, is found and run without a
    code edit."""
    spec = tiny_copy(tmp_path)
    bdir = tmp_path / "portbench"
    (bdir / "kinds" / "mp2_only.py").write_text(DUMMY_KIND)
    (bdir / "traffic" / "mp2.json").write_text(json.dumps(
        dict(kind="mp2_only")))
    (bdir / "limits" / "h2o6_vdz.mp2.json").write_text(json.dumps(
        dict(mp2_gap=1e-12)))
    bench = spec.bench
    bench["workloads"].append(dict(name="h2o6_vdz.mp2", config="h2o6_vdz",
                                   traffic="mp2", chips=1, why="a test"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    result, numbers = run_tiny(Spec(str(tmp_path)), "h2o6_vdz.mp2")
    assert result["correct"], numbers
    assert result["attempted"] == 1 and set(numbers) == {"mp2_gap"}
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("config", ["h2o6_vdz", "h2o6_avdz_df"])
def test_a_four_card_cell_needs_no_code(tmp_path, config):
    """A cell of "chips": 4, added as files and entries, runs its jobs
    over a 2 x 2 mesh of four devices (the CPU four times) without a code
    edit, is judged (full storage: in blocks) and reads correct; its
    energies are the one-card cell's."""
    tiny_copy(tmp_path)
    spec = add_mesh_cell(tmp_path, config)
    result, rows, units, _ = run_tiny_units(spec, config + ".ccsd_mesh")
    assert result["correct"], rows
    assert result["device"]["memory_peak_bytes_by_card"] == [0] * 4
    assert "setup_s" in result["metrics"]
    _, _, one, _ = run_tiny_units(spec, config + ".ccsd")
    assert len(units) == len(one) >= 1
    for a, b in zip(units, one):
        assert abs(a["energy"] - b["energy"]) < 1e-12


def test_a_kind_of_one_card_refuses_four(tmp_path):
    """A cell of four chips whose kind runs on one card ('rt', whose
    Runner takes no `devices`) stops when its Runner is made, rather than
    leave three cards idle."""
    tiny_copy(tmp_path)
    limits = tmp_path / "portbench" / "limits"
    shutil.copy(limits / "h2o6_vdz.rt.json", limits / "h2o6_vdz.rt4.json")
    bench = Spec(str(tmp_path)).bench
    bench["workloads"].append(dict(name="h2o6_vdz.rt4", config="h2o6_vdz",
                                   traffic="rt", chips=4, why="a test"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(TypeError, match="devices"):
        run_tiny(Spec(str(tmp_path)), "h2o6_vdz.rt4")


def test_peak_mem_gb_reads_the_fullest_card(monkeypatch):
    """Each card's peak is read; `peak_mem_gb` and the device line's
    `memory_peak_bytes` are the fullest card's."""
    peaks = {0: 5e9, 1: 7.5e9, 2: 6e9, 3: 1e9}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peaks[d.index])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    cards = [torch.device("cuda", i) for i in range(4)]
    fullest, by_card = cellmod.card_peaks(cards)
    assert (fullest, by_card) == (7.5e9, [5e9, 7.5e9, 6e9, 1e9])
    run = cellmod.Run("cc", {}, {}, [{}], 1.0, 1.0, fullest, None, by_card)
    assert Spec().reader("peak_mem_gb")(run) == 7.5
    dev = cellmod._device_info(cards, by_card)
    assert dev["count"] == 4 and dev["memory_peak_bytes"] == 7.5e9
    assert dev["memory_peak_bytes_by_card"] == by_card
    one = cellmod.Run("cc", {}, {}, [{}], 1.0, 1.0, 5e9, None)
    assert one.peak_bytes_by_card == [5e9]
    assert Spec().reader("peak_mem_gb")(one) == 5.0


STEP_KIND = """
import time


class Runner:
    def __init__(self, cfg, traffic, inputs, device, precision=None):
        self.units, self.failed = [], 0

    def setup(self):
        pass

    def window(self, seconds):
        t0 = time.perf_counter()
        for k in range(3):
            self.units.append(dict(t=0.01 * (k + 1), rhs=4))
        self.window_s = time.perf_counter() - t0

    def outputs(self):
        return {}


def judge(cfg, traffic, inputs, out, device):
    return {"steps_gap": 0.0}
"""


def test_rt_step_s_reads_any_kind_with_an_integrator(tmp_path):
    """rt_step_s reads a run whose mix names an `integrator`, of a kind
    added as a file (kinds/steps_only.py), as the window over its steps;
    a run of kind 'cc' (no integrator) gives no reading."""
    spec = tiny_copy(tmp_path)
    bdir = tmp_path / "portbench"
    (bdir / "kinds" / "steps_only.py").write_text(STEP_KIND)
    (bdir / "traffic" / "steps.json").write_text(json.dumps(
        dict(kind="steps_only", integrator="rk4", h=0.01)))
    (bdir / "limits" / "h2o6_vdz.steps.json").write_text(json.dumps(
        dict(steps_gap=0.0)))
    bench = spec.bench
    bench["workloads"].append(dict(name="h2o6_vdz.steps", config="h2o6_vdz",
                                   traffic="steps", chips=1, why="a test"))
    for m in bench["end_to_end"]:
        if m["name"] == "rt_step_s":
            m["workloads"].append("h2o6_vdz.steps")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(str(tmp_path))
    result, rows, units, _ = run_tiny_units(spec, "h2o6_vdz.steps")
    assert result["correct"] and len(units) == 3, rows
    assert result["metrics"]["rt_step_s"]["value"] > 0
    read = spec.reader("rt_step_s")
    run = cellmod.Run("steps_only", {}, spec.traffic("steps"), units, 1.5,
                      1.0, 0, None)
    assert read(run) == 0.5
    cc = cellmod.Run("cc", {}, spec.traffic("ccsd"), units, 1.5, 1.0, 0,
                     None)
    assert read(cc) is None
