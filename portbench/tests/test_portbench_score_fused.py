"""The reader of the fused scorer's span (score_fused.call) on
hand-written traces: once a call where the span fires, nothing where the
program has no such span."""
import pytest

from portbench.tests.test_portbench_stages import STAGES
from portbench.tests.test_portbench_trace import EVENTS, ev, read, run_of
from portbench.trace import Trace

# one fused scorer a call in EVENTS' two calls (hicpeaks.call 5-90 and
# 105-195)
FUSED = STAGES + [
    ev('user_annotation', 'hicpeaks.score', 40, 10),
    ev('user_annotation', 'hicpeaks.score_fused', 41, 8),
    ev('user_annotation', 'hicpeaks.score', 150, 10),
    ev('user_annotation', 'hicpeaks.score_fused', 151, 8),
]


def test_score_fused_reader_counts_one_a_call():
    assert read('score_fused.call', run_of(Trace(FUSED))) == \
        pytest.approx(1.0)
    # a call whose scorer took the eager chain counts none
    assert read('score_fused.call', run_of(Trace(FUSED[:-1]))) == \
        pytest.approx(0.5)


@pytest.mark.parametrize('events', [None, EVENTS, STAGES],
                         ids=['untraced', 'no-stage-marks', 'parents-marks'])
def test_score_fused_reader_without_the_span_returns_none(events):
    """No trace, a trace without the program's marks, and the trace of a
    program whose marks lack the span read nothing."""
    run = run_of(None if events is None else Trace(events))
    assert read('score_fused.call', run) is None
