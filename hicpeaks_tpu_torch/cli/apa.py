"""apa-analysis CLI on the PyTorch port: Aggregate Peak Analysis with the
window stage on a device (reference scripts/apa-analysis:12-140).

    python -m hicpeaks_tpu_torch.cli.apa -O apa.png -p data.cool::10000 \\
        -I loops.bedpe [--device cpu]

The flags are those of ``hicpeaks_tpu.cli.apa``, with ``--device`` taking a
torch device (default ``cuda``; a bare ``--device`` is ``cuda``, so the JAX
CLI's argv runs on the card).  The windows are bit-identical on every
device to the JAX CLI's float64 host path, so the figure is the same pixel
for pixel.  The count of windows goes to stdout; matplotlib is imported
only to draw.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import __version__
from ..ops.apa_ops import chrom_windows


def locate_peak_bins(clr, chrom, peaks, res, min_dis_bins, balance=False):
    """For each bedpe interval pair, pick the bin pair with the maximal
    contact value (reference scripts/apa-analysis:98-119).  ``balance``
    must match the matrix used for window extraction — the reference ranks
    candidates on the same (by default balanced) matrix it extracts from
    (scripts/apa-analysis:95,98-119); NaN entries never win the argmax
    but the first candidate is taken unconditionally, exactly as there."""
    M = clr.fetch_sparse(chrom, balance=balance)
    n = M.shape[0]
    pos = []
    for p in peaks:
        x, y = p[0], p[2]
        if abs(y - x) < min_dis_bins * res:
            continue
        s_l = range(p[0] // res, int(np.ceil(p[1] / float(res))))
        e_l = range(p[2] // res, int(np.ceil(p[3] / float(res))))
        si = ei = None
        for st in s_l:
            for et in e_l:
                if st < n and et < n:
                    if si is None or M[st, et] > M[si, ei]:
                        si, ei = st, et
        if si is not None:
            pos.append((si, ei) if si < ei else (ei, si))
    return pos


def apa_stats(clr, peaks, window=5, corner=3, correct='weight',
              device='cuda', min_dis=10):
    """APA of ``peaks`` ({chrom: [(s1, e1, s2, e2)]}, as parse_peakfile
    gives them) on the cooler: the windows on ``device``, the scores on
    the host.  ``correct`` names the weight column, or False for raw
    counts.  Returns (number of windows, avg, score, z, p, maxi)."""
    from ..core.engine import resolve_device
    from ..io.peakfile import find_chrom_pre
    from ..ops.apa_ops import apa_analysis
    device = resolve_device(device)
    res = clr.binsize
    pre = find_chrom_pre(clr.chromnames)
    stacks = []
    for c in peaks:
        chrom = pre + c
        if chrom not in clr.chromsizes:
            continue
        pos = locate_peak_bins(clr, chrom, peaks[c], res, min_dis,
                               balance=correct)
        if not pos:
            continue
        lo, hi = clr.bin_range(chrom)
        weights = clr.weights(chrom, correct) if correct else None
        stacks.append(chrom_windows(clr.pixels_for_chrom(chrom), weights,
                                    hi - lo, pos, window, device))
    apa = np.concatenate(stacks, axis=0) if stacks else np.zeros(
        (0, 2 * window + 1, 2 * window + 1))
    return (len(apa),) + tuple(apa_analysis(apa, w=window, cw=corner))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Perform Aggregate Peak Analysis (APA).',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-v', '--version', action='version',
                        version=' '.join(['%(prog)s', __version__]))
    parser.add_argument('-O', '--output', help='Output file name.')
    parser.add_argument('--dpi', default=200, type=int,
                        help='Figure resolution in DPI.')
    parser.add_argument('-p', '--path', help='Cooler URI.')
    parser.add_argument('-I', '--loop-file', help='Loop file in bedpe format.')
    parser.add_argument('-S', '--skip-rows', default=0, type=int,
                        help='Leading loop-file lines to skip.')
    parser.add_argument('-M', '--min-dis', default=10, type=int,
                        help='Minimum separation in bins.')
    parser.add_argument('-W', '--window', default=5, type=int,
                        help='APA window width.')
    parser.add_argument('-C', '--corner-size', default=3, type=int,
                        help='Corner size of the APA matrix.')
    parser.add_argument('--clr-weight-name', default='weight',
                        help='Weight column name ("raw" for raw signals).')
    parser.add_argument('--colormap-name', default='traditional',
                        help='Matplotlib colormap name.')
    parser.add_argument('--vmax', type=float,
                        help='Maximum of the colorbar.')
    parser.add_argument('--device', nargs='?', const='cuda', default='cuda',
                        help='Torch device the APA windows are gathered and '
                             'normalized on ("cuda", "cuda:1", "cpu"; bare '
                             '--device is "cuda"). The windows are '
                             'bit-identical to the float64 host path on '
                             'every device. A CUDA device without CUDA is '
                             'an error.')
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.output is None:
        parser.print_help()
        return 1

    from ..io.coolerlite import CoolerLite
    from ..io.peakfile import parse_peakfile

    correct = False if args.clr_weight_name.lower() == 'raw' else \
        args.clr_weight_name
    clr = CoolerLite(args.path)
    peaks = parse_peakfile(args.loop_file, args.skip_rows)
    n, avg, score, z, p, maxi = apa_stats(
        clr, peaks, window=args.window, corner=args.corner_size,
        correct=correct, device=args.device, min_dis=args.min_dis)
    print(n)

    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    cmap = LinearSegmentedColormap.from_list(
        'interaction', ['#FFFFFF', '#ff9292', '#ff6767', '#F70000'])
    vmax = maxi if args.vmax is None else args.vmax
    if args.colormap_name == 'traditional':
        plt.imshow(avg, cmap=cmap, vmax=vmax, interpolation='none')
    else:
        plt.imshow(avg, cmap=args.colormap_name, vmax=vmax,
                   interpolation='none')
    plt.tick_params(axis='both', bottom=False, top=False, left=False,
                    right=False, labelbottom=False, labeltop=False,
                    labelleft=False, labelright=False)
    plt.colorbar()
    plt.savefig(args.output, dpi=args.dpi, bbox_inches='tight')
    plt.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
