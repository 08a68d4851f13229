"""The window: whole units only, and a rate that does not change where the
window would have cut a unit."""

import pytest

from portbench.window import Window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def drive(seconds, unit_s, obj_steps=1000, steps=100, limit=100, units=100):
    clock = Clock()
    w = Window(seconds, units, clock)
    w.open()
    for _ in range(limit):
        if not w.want_more():
            break
        clock.t += unit_s
        w.close_unit(obj_steps, steps)
    return w


@pytest.mark.parametrize("seconds", [10.0, 13.0, 19.99, 20.0, 29.5])
def test_rate_of_whole_units_only(seconds):
    w = drive(seconds, 5.0)
    assert len(w.units) == max(1, int(seconds // 5.0))
    assert w.window_s <= max(seconds, 5.0)
    assert w.rate() == pytest.approx(1000 / 5.0)
    assert w.step_seconds() == pytest.approx(5.0 / 100)


def test_first_unit_always_runs():
    w = drive(1.0, 5.0)
    assert len(w.units) == 1 and w.rate() == pytest.approx(200.0)


def test_unit_count_caps_the_window():
    w = drive(100.0, 5.0, units=3)
    assert len(w.units) == 3 and w.window_s == pytest.approx(15.0)


def test_rate_is_work_over_time_across_uneven_units():
    clock = Clock()
    w = Window(100.0, 10, clock)
    w.open()
    for dt, work in ((4.0, 800), (6.0, 900)):
        clock.t += dt
        w.close_unit(work, 10)
    assert w.rate() == pytest.approx(1700 / 10.0)
