"""The benchmark's frozen generators: one seed gives the same pixels and
the same cooler bytes, another seed other pixels, the contacts beyond the
band and between chromosomes follow their law, and the program reads the
cooler back as written."""
import hashlib

import numpy as np

from portbench.gen import cooler, synth

SYN = dict(depth=40.0, decay=0.75, bins_per_loop=12, max_loop_span_bins=60)
SIZES = {'1': 2_500_000, '2': 1_800_000, 'X': 900_000}
RES = 10000


def genome(seed):
    chunks, weights, offset = [], [], 0
    for i, size in enumerate(SIZES.values()):
        n = -(-size // RES)
        b1, b2, ct, w, _ = synth.chrom_pixels(SYN, n, RES, seed, i)
        chunks.append({'bin1_id': b1 + offset, 'bin2_id': b2 + offset,
                       'count': ct})
        weights.append(w)
        offset += n
    return chunks, np.concatenate(weights)


def test_same_seed_same_pixels_other_seed_other_pixels():
    big = 2**33 + 5
    a = synth.chrom_pixels(SYN, 300, RES, big, 1)
    b = synth.chrom_pixels(SYN, 300, RES, big, 1)
    for x, y in zip(a, b):
        assert np.array_equal(x, y, equal_nan=True)
    c = synth.chrom_pixels(SYN, 300, RES, big + 1, 1)
    assert not np.array_equal(a[2][:1000], c[2][:1000])
    d = synth.chrom_pixels(SYN, 300, RES, big, 2)
    assert not np.array_equal(a[2][:1000], d[2][:1000])
    # weights are 1/bias, NaN exactly at the bins that hold no pixel
    b1, b2, ct, w, _ = a
    touched = np.zeros(300, bool)
    touched[b1] = touched[b2] = True
    assert np.isnan(w).any() and not touched[np.isnan(w)].any()


def test_cooler_bytes_repeat_and_read_back(tmp_path):
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    digests = []
    for k in range(2):
        chunks, weights = genome(7)
        path = str(tmp_path / f'g{k}.cool')
        cooler.create_cooler(path, SIZES, RES, chunks, weights,
                             assembly='hg38')
        with open(path, 'rb') as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    assert digests[0] == digests[1]
    clr = CoolerLite(path)
    assert clr.chromnames == list(SIZES) and clr.binsize == RES
    offset = 0
    for i, label in enumerate(SIZES):
        b1, b2, ct = clr.pixels_for_chrom(label)
        assert np.array_equal(b1 + offset, chunks[i]['bin1_id'])
        assert np.array_equal(b2 + offset, chunks[i]['bin2_id'])
        assert np.array_equal(ct, chunks[i]['count'])
        n = -(-SIZES[label] // RES)
        assert np.array_equal(clr.weights(label), weights[offset:offset + n],
                              equal_nan=True)
        offset += n


FAR = dict(SYN, depth=46.0, decay=1.08, trans_contacts=40_000)


def test_far_and_trans_contacts_follow_their_law():
    """Beyond the band: pixels only past it, none at a gap bin, the same
    for one seed, a total near its mean and a count falling with the
    distance by the decay; between chromosomes: every pair on two
    chromosomes, the total drawn around ``trans_contacts``."""
    big = 2**35 + 9
    L = 900
    _, _, _, w, bias = synth.chrom_pixels(FAR, L, RES, big, 0)
    f1, f2, fc = synth.far_pixels(FAR, bias, big, 0)
    again = synth.far_pixels(FAR, bias, big, 0)
    assert all(np.array_equal(x, y) for x, y in zip((f1, f2, fc), again))
    d = f2 - f1
    assert d.min() >= synth.band_span(FAR, L) and f2.max() < L
    assert not np.isnan(w[f1]).any() and not np.isnan(w[f2]).any()
    assert np.all(np.diff(f1 * L + f2) > 0) and fc.min() >= 1
    ok = bias > 0
    dist = np.arange(synth.band_span(FAR, L), L)
    mean = 46.0 * bias[ok].mean() * sum(
        (1.0 + dd) ** -1.08 * bias[:L - dd].sum() * ok[dd:].mean()
        for dd in dist)
    assert abs(fc.sum() - mean) < 5 * mean ** 0.5
    near = fc[d < 300].sum() / np.count_nonzero(dist < 300)
    far = fc[d >= 600].sum() / np.count_nonzero(dist >= 600)
    assert far < near

    biases = [synth.chrom_pixels(FAR, n, RES, big, i)[4]
              for i, n in enumerate((400, 300, 200))]
    t1, t2, tc = synth.trans_pixels(biases, FAR['trans_contacts'], big)
    chrom = np.repeat([0, 1, 2], [400, 300, 200])
    assert np.all(chrom[t1] < chrom[t2])
    assert abs(tc.sum() - 40_000) < 5 * 40_000 ** 0.5
    again = synth.trans_pixels(biases, FAR['trans_contacts'], big)
    assert np.array_equal(t2, again[1]) and np.array_equal(tc, again[2])
