"""The trace's reduction: busy time (each card's and their mean), kernel
time by name, idle gaps by what the host was doing, on hand-made
intervals."""

import pytest

from portbench.harness.trace import NoDeviceEvents, Trace


def _trace():
    window = (0, 1_000_000)
    device = [("k1::f64::kernel<16>", 100_000, 300_000),
              ("other", 250_000, 400_000),        # overlaps the first
              ("f64::kernel<16>", 600_000, 700_000),
              ("late", 950_000, 1_200_000)]       # cut at the window's end
    host = [("portbench.solve", 0, 1_000_000),
            ("aten::copy_", 420_000, 590_000),
            ("aten::mm", 700_000, 705_000)]
    return Trace(window, device, host)


def test_busy_and_kernel_seconds():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    # [100, 400] + [600, 700] + [950, 1000] us
    assert t.busy_s == pytest.approx(450e-6)
    assert t.kernel_seconds(("f64::kernel<",)) == pytest.approx(300e-6)
    assert t.device_ops(2)[0][0] == "late"


def test_idle_gaps_by_host_activity():
    gaps = dict(_trace().idle_gaps())
    # [0, 100], [400, 600], [700, 950] us
    assert gaps["solve / -"] == pytest.approx(100e-6 + 250e-6)
    assert gaps["solve / aten::copy_"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - 450e-6)


def test_no_device_event_is_refused():
    with pytest.raises(NoDeviceEvents):
        Trace((0, 10), [], [("x", 0, 10)])


def test_one_card_with_its_index_reads_as_before():
    """Intervals that name card 0 give exactly what intervals without a
    card give."""
    a = _trace()
    b = Trace((a.t0, a.t1), [r + (0,) for r in a.device], a.host, cards=[0])
    assert b.busy_s == a.busy_s and b.busy_s_by_card == [a.busy_s]
    assert b.idle_gaps() == a.idle_gaps()
    assert b.device_ops() == a.device_ops()


def test_two_cards_each_their_own_busy_time():
    """Each card's busy time is the union of its own intervals; busy_s is
    their mean; a card of the cell without an interval is idle all the
    window; kernel time sums over the cards; the idle gaps of every card
    are summed."""
    window = (0, 1_000_000)
    host = [("portbench.solve", 0, 1_000_000)]
    device = [("f64::kernel<16>", 0, 600_000, 0),
              ("f64::kernel<16>", 200_000, 500_000, 1),
              ("copy", 400_000, 700_000, 1)]
    t = Trace(window, device, host, cards=[0, 1])
    assert t.busy_s_by_card == [pytest.approx(600e-6),
                                pytest.approx(500e-6)]
    assert t.busy_s == pytest.approx(550e-6)
    assert t.kernel_seconds(("f64::kernel<",)) == pytest.approx(900e-6)
    assert sum(s for _, s in t.idle_gaps()) == pytest.approx(
        2e-3 - 1.1e-3)
    three = Trace(window, device, host, cards=[0, 1, 2])
    assert three.busy_s_by_card[2] == 0
    assert three.busy_s == pytest.approx(1.1e-3 / 3)
