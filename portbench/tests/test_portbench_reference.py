"""The benchmark's banded reference against its frozen dense oracle (bit
for bit) and against the program's CPU path (within the check's limit),
and the check's control: the program's dense route and the reference in
float32 both fail the limit."""
import json
import os

import numpy as np
import pytest
import torch

from portbench import compare, driver
from portbench.gen import synth
from portbench.reference import banded, dense
from portbench.tests.cards import card  # noqa: F401 (a fixture)
from portbench.tests.tiny import PKG, REPO

RES = 10000


def _gap_limit(caller):
    with open(os.path.join(PKG, 'configs', f'{caller}-k562-10kb.json')) as f:
        return json.load(f)['gap_limit']


#: each caller's limit on a table's gap (its configuration's gap_limit)
GAP_LIMIT = {c: _gap_limit(c) for c in ('hiccups', 'bhfdr')}
HICCUPS = dict(pw=(2,), ww=(5,), maxww=10, siglevel=0.05, sumq=0.01,
               double_fold=1.75, single_fold=2.0, use_raw=False,
               min_marginal_peaks=2, min_local_reads=16, only_anchors=False)
BHFDR = dict(pw=2, ww=5, maxww=10, siglevel=0.05, min_marginal_peaks=3,
             only_anchors=False)


def pixels(L, seed, num):
    syn = dict(depth=40.0, decay=0.75, bins_per_loop=12,
               max_loop_span_bins=num - 64)
    return synth.chrom_pixels(syn, L, RES, seed, 0)[:4]


def same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert tuple(map(float, got[k])) == tuple(map(float, want[k])), k


@pytest.mark.parametrize('L,seed,pw,ww,maxww,maxapart', [
    (420, 3, (2,), (5,), 10, 1_000_000),
    (500, 4, (1, 2), (3, 5), 8, 1_500_000),
    (400, 5, (2,), (5,), 10, 2_000_000)])
def test_banded_equals_dense_oracle(L, seed, pw, ww, maxww, maxapart):
    num = maxapart // RES + maxww + 1
    b1, b2, ct, w = pixels(L, seed, num)
    cfg = dict(HICCUPS, pw=pw, ww=ww, maxww=maxww, maxapart=maxapart)
    D = dense.dense_inputs(b1, b2, ct, w, L, num, min(ww))
    want = dense.hiccups(
        D['Md'], D['cMd'], D['B'], D['B'], D['IR'], L, num, pw=list(pw),
        ww=list(ww), maxww=maxww, sig=0.05, sumq=0.01, maxapart=maxapart,
        res=RES, min_marginal_peaks=2, onlyanchor=False, min_local_reads=16)
    assert len(want) > 0
    same(banded.hiccups((b1, b2, ct, w, L, RES), cfg, 'cpu'), want)

    bcfg = dict(BHFDR, pw=pw[-1], ww=ww[-1], maxww=maxww, maxapart=maxapart)
    D = dense.dense_inputs(b1, b2, ct, w, L, num, ww[-1])
    want = dense.bhfdr(
        D['Md'], D['cMd'], D['B'], D['B'], D['IR'], L, num, pw=pw[-1],
        ww=ww[-1], sig=0.05, maxww=maxww, maxapart=maxapart, res=RES,
        min_marginal_peaks=3, onlyanchor=False)
    assert len(want) > 0
    same(banded.bhfdr((b1, b2, ct, w, L, RES), bcfg, 'cpu'), want)


def _cell(caller, L, maxapart, seed):
    config = {'caller': caller, 'res': RES, 'chromsizes': {'1': L * RES},
              'program_config': 'HiccupsConfig' if caller == 'hiccups'
              else 'BHFDRConfig', 'reference': f'banded.{caller}',
              'settings': dict(HICCUPS if caller == 'hiccups' else BHFDR,
                               maxapart=maxapart),
              'synthesis': dict(depth=40.0, decay=0.75, bins_per_loop=12,
                                max_loop_span_bins=maxapart // RES - 53)}
    config['settings'] = {k: list(v) if isinstance(v, tuple) else v
                          for k, v in config['settings'].items()}
    entry = driver.make_entry(REPO, config, {'entry': 'chrom', 'chrom': '1'},
                              seed, torch.device('cpu'))
    entry.setup()
    return entry


@pytest.mark.parametrize('caller,maxapart', [('hiccups', 2_000_000),
                                             ('bhfdr', 1_000_000)])
@pytest.mark.parametrize('seed', [21, 2**40 + 3])
def test_program_within_limit_and_control_beyond(caller, maxapart, seed):
    """The program's CPU path is within the limit of the reference; the
    control, the program's dense route (float32 O, ICE and Fold), and the
    reference computed in float32 are beyond it."""
    entry = _cell(caller, 600, maxapart, seed)
    want = entry.reference()
    assert len(want) > 0
    limit = GAP_LIMIT[caller]
    gap, where = compare.table_gap(entry.step(), want)
    assert gap <= limit, (gap, where)
    gap, where = compare.table_gap(entry.step(bh_backend='host'), want)
    assert gap > limit, (gap, where)
    gap, where = compare.table_gap(entry.reference(np.float32), want)
    assert gap > limit, (gap, where)


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    """On the card: the program's table within the limit, its dense route
    and the float32 reference beyond it, at a small size."""
    from portbench import control
    from portbench.tests.tiny import make_root
    import tempfile
    from portbench.harness import Cell
    with tempfile.TemporaryDirectory() as tmp:
        root = make_root(tmp)
        for name in ('hiccups-k562-10kb.chr1', 'bhfdr-k562-10kb.chr1'):
            limit = GAP_LIMIT[name.split('-')[0]]
            r = control.readings(Cell(root, name), 5, card)
            assert r['program'] <= limit < r['program_dense'], r
            assert r['reference_f32'] > limit, r


def test_gap_rules():
    row = (10, 20, 0, 5.0, 3.0, 1e-4, 1e-3)
    assert compare.locus_gap(row, row) == 0.0
    assert compare.locus_gap((11,) + row[1:], row) == 1.0
    moved = row[:4] + (3.0 * (1 + 1e-6),) + row[5:]
    assert compare.locus_gap(moved, row) == pytest.approx(1e-6)
    # below the p floor, p and q are not compared unless p rises past 10x
    tiny = row[:5] + (1e-14, 0.3)
    assert compare.locus_gap(tiny[:5] + (2e-13, 0.9), tiny) == 0.0
    assert compare.locus_gap(tiny[:5] + (2e-11, 0.3), tiny) == 1.0
    assert compare.table_gap({(1, 2): row}, {}) == (1.0, (1, 2))
    assert compare.genome_gap({'1': {}}, {'1': {}, '2': {}})[0] == 1.0
