"""The trace's reduction: busy time, kernel time by name, idle gaps by
what the host was doing, on hand-made intervals."""

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
