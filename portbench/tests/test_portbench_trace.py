"""The trace readers and every per-layer metric's reader on a small
hand-written Chrome trace, and the roofline's bytes from the band's
shapes, term by term."""
import os
import types

import pytest

from portbench import roofline
from portbench.harness import load_module
from portbench.trace import Trace, union_us

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ev(cat, name, ts, dur):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


# two steps, 0-100 and 100-200 us; the device's work: pass A 10-20, an
# eager kernel 15-30 (overlapping pass A), a pageable copy 40-44, pass B
# 110-150, a memset 160-161; host marks: Chrom:1 over 5-90 and Chrom:2 over
# 105-195, completion 60-80 and 170-180, clustering 85-88
EVENTS = [
    ev('user_annotation', 'portbench.step', 0, 100),
    ev('user_annotation', 'portbench.step', 100, 100),
    ev('user_annotation', 'Chrom:1', 5, 85),
    ev('user_annotation', 'Chrom:2', 105, 90),
    ev('user_annotation', 'portbench.host_complete', 60, 20),
    ev('user_annotation', 'portbench.host_complete', 170, 10),
    ev('user_annotation', 'portbench.clustering', 85, 3),
    ev('kernel', 'void scan_pass_a_kernel<4>(float const*)', 10, 10),
    ev('kernel', 'elementwise_kernel', 15, 15),
    ev('gpu_memcpy', 'Memcpy HtoD (Pageable -> Device)', 40, 4),
    ev('kernel', 'scan_pass_b_kernel', 110, 40),
    ev('gpu_memset', 'Memset (Device)', 160, 1),
    ev('gpu_user_annotation', 'portbench.step', 0, 200),
    ev('cpu_op', 'aten::add', 12, 1),
    {'ph': 'i', 'name': 'instant', 'ts': 3},
]


@pytest.fixture
def trace():
    return Trace(EVENTS)


def test_union_window_busy_and_gaps(trace):
    assert union_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert trace.window == (0.0, 200.0)
    assert trace.busy_us() == 20 + 4 + 40 + 1     # 10-30, 40-44, ...
    assert trace.gaps() == [(0.0, 10.0), (30.0, 40.0), (44.0, 110.0),
                            (150.0, 160.0), (161.0, 200.0)]
    assert trace.uncovered_us('Chrom:') == 200 - 85 - 90
    top = dict(trace.top_device_ops())
    assert top['scan_pass_b_kernel'] == pytest.approx(40e-6)
    assert list(top)[0] == 'scan_pass_b_kernel'


def test_idle_gaps_by_innermost_mark(trace):
    got = dict(trace.idle_by_mark())
    # 0-5 step only, 5-10 Chrom:, 30-40 Chrom:, 44-60 Chrom:, 60-80
    # completion, 80-85 Chrom:, 85-88 clustering, 88-90 Chrom:, 90-100
    # step, 100-105 step, 105-110 Chrom:, 150-160 Chrom:, 161-170 Chrom:,
    # 170-180 completion, 180-195 Chrom:, 195-200 step
    want = {'portbench.step': 5 + 10 + 5 + 5, 'portbench.host_complete':
            20 + 10, 'portbench.clustering': 3,
            'Chrom:': 5 + 10 + 16 + 5 + 2 + 5 + 10 + 9 + 15}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-6), k


def run_of(trace, steps=2, **kw):
    shape = dict(L=1000, num=50, n_cand=400)
    entry = types.SimpleNamespace(
        caller='hiccups', shape=shape,
        settings=dict(pw=[2], ww=[5], maxww=10))
    return types.SimpleNamespace(trace=trace, walls=[0.1] * steps,
                                 window_s=0.25, setup_s=9.5, entry=entry,
                                 spans=kw.get('spans', {}),
                                 log=kw.get('log', []))


def read(name, run):
    return load_module(os.path.join(PKG, 'metrics', f'{name}.py'),
                       'm_' + name.replace('.', '_')).read(run)


def test_metric_readers(trace):
    run = run_of(trace, spans={'host_complete': [0.03], 'clustering':
                               [0.004]},
                 log=['Chrom:1, 5 band pixels scored in 0.10s (band build '
                      '0.25s, pipelined; 50 pixels/s), 3 peaks',
                      'Chrom:2, ... (band build 0.50s, pipelined; ...)'])
    assert read('device_idle_pct.call', run) == pytest.approx(
        100 * (1 - 65 / 200))
    assert read('device_idle_pct.genome', run) == pytest.approx(
        100 * (1 - 65 / 200))
    assert read('producer_wait_pct.genome', run) == pytest.approx(
        100 * 25 / 200)
    assert read('band_build_s.genome', run) == pytest.approx(0.375)
    assert read('h2d_copy_ms.call', run) == pytest.approx(0.002)
    assert read('eager_device_ms.call', run) == pytest.approx(0.0075)
    assert read('host_complete_ms.call', run) == pytest.approx(15.0)
    assert read('clustering_ms.call', run) == pytest.approx(2.0)
    bound_a, _ = roofline.kernel_work('scan_pass_a', 'hiccups',
                                      run.entry.settings, 1000, 50,
                                      400).bound_s()
    assert read('scan_pass_a_roofline', run) == pytest.approx(
        100 * bound_a / 10e-6)
    bound_b, _ = roofline.kernel_work('scan_pass_b', 'hiccups',
                                      run.entry.settings, 1000, 50,
                                      400).bound_s()
    assert read('scan_pass_b_roofline', run) == pytest.approx(
        100 * bound_b / 40e-6)
    assert read('call_ms', run) == pytest.approx(125.0)
    assert read('genome_s', run) == pytest.approx(0.125)
    assert read('setup_s', run) == 9.5


def test_readers_with_nothing_to_read_return_none():
    empty = run_of(None)
    untraced = ('device_idle_pct.call', 'device_idle_pct.genome',
                'producer_wait_pct.genome', 'band_build_s.genome',
                'h2d_copy_ms.call', 'eager_device_ms.call',
                'host_complete_ms.call', 'clustering_ms.call',
                'scan_pass_a_roofline', 'scan_pass_b_roofline')
    for name in untraced:
        assert read(name, empty) is None, name
    # a CPU trace: host marks, no device event, no Chrom: mark
    host_only = Trace([e for e in EVENTS
                       if e.get('cat') == 'user_annotation'
                       and not e['name'].startswith('Chrom:')])
    for name in untraced:
        assert read(name, run_of(host_only)) is None, name


def test_roofline_terms_from_the_band_shapes():
    hs = dict(pw=[2], ww=[5], maxww=10)
    # chr1 at 10 kb and 10 Mb: 24,896 bins, 1011 diagonals
    L, num, n_cand = 24896, 1011, 9_591_454
    positions = L * num
    a = roofline.kernel_work('scan_pass_a', 'hiccups', hs, L, num, n_cand)
    assert a.terms == {'raw_f32_in': 4 * positions,
                       'cand_mask_in': positions, 'counts_out': 4 * 6}
    assert a.ops == 3 * 10 * positions + 6 * n_cand
    b = roofline.kernel_work('scan_pass_b', 'hiccups', hs, L, num, n_cand)
    assert b.terms == {'bands_f32_in': 12 * positions,
                       'cand_mask_in': positions, 'gate_in': 6,
                       'captures_out': 16 * positions}
    t, by = b.bound_s()
    assert by == 'bytes' and t == pytest.approx(29 * positions / 3.35e12)
    bs = dict(pw=2, ww=5, maxww=10)
    assert roofline.plan_steps('bhfdr', bs) == 6
    assert roofline.plan_steps('hiccups', dict(pw=[1, 2], ww=[3, 5],
                                               maxww=8)) == 6 + 4
    assert roofline.pool_radii('hiccups', dict(pw=[1, 2, 2])) == 2
