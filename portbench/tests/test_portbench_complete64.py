"""The readers of the device completion's span and of the host
completions' count (complete64_ms.call, host_completions.call) on the
hand-written traces of test_portbench_stages: the host route's, and the
device route's, where a ``hicpeaks.complete64`` span takes the place of
each call's host completions."""
import pytest

from portbench.tests.test_portbench_stages import STAGES
from portbench.tests.test_portbench_trace import EVENTS, ev, read, run_of
from portbench.trace import Trace

NEW = ('complete64_ms.call', 'host_completions.call')

# the device route over EVENTS' two calls: the completion 60-66 and
# 170-173, with its two reads 63-64, 65-66 and 171-172, 172-173
ON_DEVICE = EVENTS + [
    ev('user_annotation', 'hicpeaks.call', 5, 85),
    ev('user_annotation', 'hicpeaks.call', 105, 90),
    ev('user_annotation', 'hicpeaks.complete64', 60, 6),
    ev('user_annotation', 'hicpeaks.complete64', 170, 3),
    ev('user_annotation', 'hicpeaks.sync', 63, 1),
    ev('user_annotation', 'hicpeaks.sync', 65, 1),
    ev('user_annotation', 'hicpeaks.sync', 171, 1),
    ev('user_annotation', 'hicpeaks.sync', 172, 1),
]


def test_device_route():
    run = run_of(Trace(ON_DEVICE))
    assert read('complete64_ms.call', run) == pytest.approx((6 + 3) / 1e3 / 2)
    assert read('host_completions.call', run) == 0.0
    assert read('host_syncs.call', run) == pytest.approx(4 / 2)


def test_host_route():
    """The host route's trace: two host completions, and no device
    completion span to read."""
    run = run_of(Trace(STAGES))
    assert read('complete64_ms.call', run) is None
    assert read('host_completions.call', run) == pytest.approx(2 / 2)


@pytest.mark.parametrize('events', [None, EVENTS], ids=['untraced',
                                                         'no-stage-marks'])
def test_readers_without_stage_spans_return_none(events):
    run = run_of(None if events is None else Trace(events))
    for name in NEW:
        assert read(name, run) is None, name
