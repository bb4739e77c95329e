"""train_ms and infer_ms.p95 from synthetic records: a stall inside the
window moves them."""

import itertools

import pytest

import gnnbench_cells  # noqa: F401
from gnnbench import window


class Clock:
    """A host clock that a fake device advances."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _train(step_s, stall_at=None, stall_s=0.0, seconds=1.0,
           lead=window.LEAD):
    clock = Clock()
    done = []  # device finish times of the steps enqueued

    def replay():
        start = max(clock.t, done[-1] if done else 0.0)
        k = len(done)
        done.append(start + step_s + (stall_s if k == stall_at else 0.0))

    def marker():
        k = len(done) - 1

        def wait():
            clock.t = max(clock.t, done[k])
        return wait

    steps, wall = window.train_window(replay, seconds, lead=lead,
                                      marker=marker, clock=clock)
    return steps, wall, window.train_ms(steps, wall)


def test_train_ms_steady():
    steps, wall, ms = _train(0.01)
    assert steps >= 100 and ms == pytest.approx(1e3 * wall / steps)
    assert ms == pytest.approx(10.0, rel=0.05)


@pytest.mark.parametrize("lead", [1, 2, window.LEAD])
def test_a_stall_moves_train_ms(lead):
    _, _, base = _train(0.01, lead=lead)
    _, _, stalled = _train(0.01, stall_at=30, stall_s=0.2, lead=lead)
    assert stalled > base * 1.1


def test_the_drain_is_in_the_window():
    """Steps enqueued ahead when the window closes are waited for and
    counted: a step's time does not depend on the lead."""
    ms = [_train(0.01, lead=lead)[2] for lead in (1, window.LEAD)]
    assert ms[0] == pytest.approx(ms[1], rel=1e-9)


def test_no_step_is_an_error():
    with pytest.raises(ValueError):
        window.train_ms(0, 1.0)


def _infer(lat_ms, seconds=10.0):
    clock = Clock()
    it = itertools.cycle(lat_ms)

    def request():
        ms = next(it)
        clock.t += ms / 1e3
        return ms

    return window.infer_window(request, seconds, clock=clock)


def test_p95_nearest_rank():
    assert window.percentile(list(range(1, 101)), 95) == 95
    assert window.percentile([5.0], 95) == 5.0
    assert window.percentile([3, 1, 2], 50) == 2


def test_a_stall_moves_p95():
    steady = _infer([100.0])
    # one request in ten stalls by 50 ms
    stalled = _infer([100.0] * 9 + [150.0])
    assert window.percentile(steady, 95) == pytest.approx(100.0)
    assert window.percentile(stalled, 95) == pytest.approx(150.0)
    assert len(stalled) < len(steady)


def test_a_request_is_timed_from_send_to_result():
    """The launch and the wait for the result are inside the time."""
    clock = Clock()

    def replay():  # the launch takes 1 ms of the host
        clock.t += 1e-3

    def wait():  # the device's work, then the wake-up
        clock.t += 85e-3 + 0.5e-3

    assert window.request(replay, wait, clock=clock) == pytest.approx(86.5)


def test_after_runs_outside_the_request():
    seen = []
    lat = window.infer_window(lambda: 1.0, 0.5, after=seen.append,
                              clock=iter([0.0, 0.0, 1.0]).__next__)
    assert lat == [1.0] and seen == [0]
