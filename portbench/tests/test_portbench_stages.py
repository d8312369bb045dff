"""The readers of the program's own stage spans (portbench/stages.py and
the five metrics that read it) on the hand-written trace of
test_portbench_trace, with the port's hicpeaks.* marks added."""
import pytest

from portbench.tests.test_portbench_trace import EVENTS, ev, read, run_of
from portbench.trace import Trace


# the program's own stage spans over EVENTS' two calls: each call, a copy's
# wait 38-45 (around the copy 40-44), reads 50-52, 55-56 and 182-185, the
# completion 60-80 and 170-180 with its ring sums 61-70, 171-175 and its
# tables 72-78, 176-179, clustering 85-88; idle 30-38 and 150-160 lie
# under hicpeaks.call alone, idle 72-78 under hicpeaks.qtab64
STAGES = EVENTS + [
    ev('user_annotation', 'hicpeaks.call', 5, 85),
    ev('user_annotation', 'hicpeaks.call', 105, 90),
    ev('user_annotation', 'hicpeaks.h2d', 38, 7),
    ev('user_annotation', 'hicpeaks.sync', 50, 2),
    ev('user_annotation', 'hicpeaks.sync', 55, 1),
    ev('user_annotation', 'hicpeaks.sync', 182, 3),
    ev('user_annotation', 'hicpeaks.host_complete', 60, 20),
    ev('user_annotation', 'hicpeaks.host_complete', 170, 10),
    ev('user_annotation', 'hicpeaks.exact_stats', 61, 9),
    ev('user_annotation', 'hicpeaks.exact_stats', 171, 4),
    ev('user_annotation', 'hicpeaks.qtab64', 72, 6),
    ev('user_annotation', 'hicpeaks.qtab64', 176, 3),
    ev('user_annotation', 'hicpeaks.clustering', 85, 3),
]
NEW_STAGE_METRICS = ('qtab64_ms.call', 'exact_stats_ms.call',
                     'host_syncs.call', 'sync_wait_ms.call',
                     'idle_unmarked_pct.call')


def test_stage_metric_readers():
    from portbench.stages import idle_by_stage
    from portbench.trace import OUTSIDE
    t = Trace(STAGES)
    by = idle_by_stage(t)
    # idle (us) by innermost hicpeaks mark: 0-5, 90-105, 195-200 none;
    # 5-10, 30-38, 45-50, 52-55, 56-60, 80-85, 88-90, 105-110, 150-160,
    # 161-170, 180-182, 185-195 the call alone
    want = {OUTSIDE: 5 + 15 + 5,
            'hicpeaks.call': 5 + 8 + 5 + 3 + 4 + 5 + 2 + 5 + 10 + 9 + 2 + 10,
            'hicpeaks.h2d': 2 + 1, 'hicpeaks.sync': 2 + 1 + 3,
            'hicpeaks.host_complete': 1 + 2 + 2 + 1 + 1 + 1,
            'hicpeaks.exact_stats': 9 + 4, 'hicpeaks.qtab64': 6 + 3,
            'hicpeaks.clustering': 3}
    assert set(by) == set(want)
    for k, v in want.items():
        assert by[k] == pytest.approx(v * 1e-6), k
    assert sum(by.values()) == pytest.approx((200 - t.busy_us()) * 1e-6)
    run = run_of(t)
    assert read('qtab64_ms.call', run) == pytest.approx((6 + 3) / 1e3 / 2)
    assert read('exact_stats_ms.call', run) == pytest.approx(
        (9 + 4) / 1e3 / 2)
    assert read('host_syncs.call', run) == pytest.approx(3 / 2)
    assert read('sync_wait_ms.call', run) == pytest.approx(
        (2 + 1 + 3) / 1e3 / 2)
    assert read('idle_unmarked_pct.call', run) == pytest.approx(
        100 * (68 + 25) / 135)
    # the benchmark's own breakdown now names the program's stages
    got = dict(t.idle_by_mark())
    assert got['hicpeaks.qtab64'] == pytest.approx(9e-6)
    assert got['hicpeaks.call'] == pytest.approx(68e-6)
    assert got['portbench.step'] == pytest.approx(25e-6)


@pytest.mark.parametrize('events', [None, EVENTS], ids=['untraced',
                                                         'no-stage-marks'])
def test_stage_readers_without_stage_spans_return_none(events):
    """A run without a trace, or with the trace of a program that has no
    stage spans (the benchmark's marks and Chrom: alone), reads None."""
    run = run_of(None if events is None else Trace(events))
    for name in NEW_STAGE_METRICS:
        assert read(name, run) is None, name
