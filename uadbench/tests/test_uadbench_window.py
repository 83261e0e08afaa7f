"""The window's arithmetic: a rate is all the work over the time to the last
completion, so a stall lowers it; a percentile is over every unit."""
import pytest

from uadbench.harness.window import Window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("stall", [0.0, 2.0])
def test_rate_counts_a_stall(stall):
    clock = Clock()
    w = Window(5.0, clock)
    w.open()
    steps = 0
    while not w.due():
        clock.t += 0.5 + (stall if steps == 3 else 0.0)
        steps += 1
        w.mark(32)
    assert w.units == 32 * steps
    assert w.elapsed == pytest.approx(0.5 * steps + stall)
    assert w.rate() == pytest.approx(32 * steps / (0.5 * steps + stall))
    assert w.elapsed >= 5.0  # closes at the first completion at or after the length
    if stall:
        assert w.percentile_ms(100) == pytest.approx(2500.0)


def test_p90_over_every_interval():
    clock = Clock()
    w = Window(1.0, clock)
    w.open()
    for dt in [0.1] * 9 + [1.0]:
        clock.t += dt
        w.mark(1)
    assert len(w.intervals()) == 10
    assert w.percentile_ms(90) == pytest.approx(190.0)


def test_summary_finds_a_stall_and_a_drift():
    clock = Clock()
    w = Window(5.0, clock)
    w.open()
    for dt in [0.25] * 10 + [1.0] + [0.3] * 9:
        clock.t += dt
        w.mark(32)
    s = w.summary()
    assert s["n"] == 20 and s["over_2x_p50"] == 1 and s["max_ms"] == pytest.approx(1000.0)
    assert s["halves_p50_ms"] == pytest.approx([250.0, 300.0])
