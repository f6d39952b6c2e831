"""The readers of the mesh's spans (metrics/gather_ms.py, ladder_ms.py):
each value from a table of spans, None untraced, None for a port without
spans or without the mesh's spans; and the four-card cell's per-layer
entries each find a reader."""

import pytest

from pycc_tpu_torch.utils import timing
from portbench.harness.cell import Run
from portbench.harness.spec import Spec

CELL = "h2o6_avdz_full.ccsd"


def _row(count, device_s, parent, nbytes=0):
    return dict(count=count, host_s=device_s, device_s=device_s,
                bytes=nbytes, parent=parent)


# one full-storage CCSD job over a mesh: 24 iterations, 646 gathers (the
# residuals', the energies' and the init's), one sharded ladder a residual
TABLE = {
    "ccwfn.iteration": _row(24, 6.0, None),
    "ccwfn.residual": _row(24, 4.8, "ccwfn.iteration"),
    "mesh.gather": _row(646, 2.4, "-|ccwfn.iteration|ccwfn.residual",
                        nbytes=24 * 14_200_000_000),
    "mesh.ladder": _row(24, 0.6, "ccwfn.residual"),
}

EXPECTED = {"gather_ms.mesh": 100.0, "ladder_ms.mesh": 25.0}


def _run(traced):
    return Run("cc", {}, {}, [{}], 1.0, 1.0, 0,
               object() if traced else None)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_value_from_a_table(monkeypatch, name):
    monkeypatch.setattr(timing, "spans", lambda: TABLE)
    read = Spec().reader(name)
    assert read(_run(True)) == pytest.approx(EXPECTED[name], rel=1e-12)
    assert read(_run(False)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_none_without_spans(monkeypatch, name):
    """A table without the mesh's spans (a one-card run, or a port that
    has none), an empty table and a port without `spans` give None."""
    read = Spec().reader(name)
    one_card = {k: v for k, v in TABLE.items() if not k.startswith("mesh.")}
    monkeypatch.setattr(timing, "spans", lambda: one_card)
    assert read(_run(True)) is None
    monkeypatch.setattr(timing, "spans", lambda: {})
    assert read(_run(True)) is None
    monkeypatch.delattr(timing, "spans")
    assert read(_run(True)) is None


def test_a_ladder_elsewhere_is_not_read(monkeypatch):
    """Sharded ladders under another parent (Lambda, EOM) are no CCSD
    residual's."""
    table = dict(TABLE, **{"mesh.ladder": _row(20, 0.5, "cclambda")})
    monkeypatch.setattr(timing, "spans", lambda: table)
    assert Spec().reader("ladder_ms.mesh")(_run(True)) is None


def test_the_four_card_cell_has_its_entries():
    """The cell runs on four chips, reports ccsd_s.full, and each of its
    per-layer metrics has a reader and moves ccsd_s.full."""
    spec = Spec()
    w = spec.workload(CELL)
    assert w["chips"] == 4 and w["traffic"] == "ccsd"
    assert spec.config(w["config"])["storage"] == "full"
    names = [m["name"] for m in spec.metrics(CELL, False)]
    assert "ccsd_s.full" in names and "setup_s" in names
    layer = spec.metrics(CELL, True)
    assert {m["name"] for m in layer} == {
        "init_s.mesh", "h2d_gbps.mesh", "ccsd_iter_ms.mesh",
        "residual_ms.mesh", "k1_roofline.mesh", "device_idle_pct.mesh",
        "gather_ms.mesh", "ladder_ms.mesh"}
    for m in layer:
        assert m["moves"] == "ccsd_s.full" and callable(
            spec.reader(m["name"]))
