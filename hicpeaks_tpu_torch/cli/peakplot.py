"""peak-plot CLI: heatmap of a region with loop markers
(reference scripts/peak-plot:12-195).

    python -m hicpeaks_tpu_torch.cli.peakplot -O region.png \\
        -p data.cool::10000 -I loops.bedpe -C 21 -S 24200000 -E 24900000

The port's copy of ``hicpeaks_tpu/cli/peakplot.py``, with the same flags; it
runs on the host, reads the cooler through ``io/h5lite`` and imports
matplotlib only to draw.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import __version__


def print_coordinate(pos):
    if pos % 1000000 == 0:
        return '{0}M'.format(pos // 1000000)
    return '{0:.2f}M'.format(pos / 1000000)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Visualize peak calls on heatmap.',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-v', '--version', action='version',
                        version=' '.join(['%(prog)s', __version__]))
    parser.add_argument('-O', '--output', help='Output png file name.')
    parser.add_argument('--dpi', default=500, type=int)
    parser.add_argument('-p', '--path', help='Cooler URI.')
    parser.add_argument('-I', '--loop-file', help='Loop file in bedpe format.')
    parser.add_argument('-C', '--chrom', help='Chromosome label.')
    parser.add_argument('-S', '--start', type=int, help='Start site (bp).')
    parser.add_argument('-E', '--end', type=int, help='End site (bp).')
    parser.add_argument('--skip-rows', default=0, type=int)
    parser.add_argument('--clr-weight-name', default='weight',
                        help='Weight column ("raw" for raw signals).')
    parser.add_argument('--vmin', type=float)
    parser.add_argument('--vmax', type=float)
    parser.add_argument('--colormap-name', default='traditional')
    parser.add_argument('--marker-size', default=10, type=int)
    parser.add_argument('--marker-color', default='#1F78B4')
    parser.add_argument('--marker-alpha', default=1, type=float)
    parser.add_argument('--marker-linewidth', default=0.5, type=float)
    parser.add_argument('--nolabel', action='store_true')
    parser.add_argument('--log', action='store_true')
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.output is None:
        parser.print_help()
        return 1

    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap, LogNorm

    from ..io.coolerlite import CoolerLite
    from ..io.peakfile import parse_peakfile

    cmap = LinearSegmentedColormap.from_list(
        'interaction',
        ['#FFFFFF', '#FFDFDF', '#FF7575', '#FF2626', '#F70000'])
    correct = False if args.clr_weight_name.lower() == 'raw' else \
        args.clr_weight_name

    clr = CoolerLite(args.path)
    res = clr.binsize
    start = args.start // res * res
    end = args.end // res * res
    M = clr.fetch_dense_region(args.chrom, start, end, balance=correct)
    M[np.isnan(M)] = 0

    nonzero = M[np.nonzero(M)]
    vmin = nonzero.min() if args.vmin is None else args.vmin
    vmax = np.percentile(nonzero, 93) if args.vmax is None else args.vmax

    size = (2.2, 2)
    fig = plt.figure(figsize=size)
    width, Left = 0.7, 0.1
    HB = 0.1
    HH = width * size[0] / size[1]
    ax = fig.add_axes([Left, HB, width, HH])
    cm = cmap if args.colormap_name == 'traditional' else args.colormap_name
    if args.log:
        sc = ax.imshow(M, cmap=cm, aspect='auto', interpolation='none',
                       norm=LogNorm(vmin=vmin, vmax=vmax))
    else:
        sc = ax.imshow(M, cmap=cm, aspect='auto', interpolation='none',
                       vmax=vmax, vmin=vmin)
    xmin, xmax = ax.get_xlim()
    ymin, ymax = ax.get_ylim()

    chrom = args.chrom.lstrip('chr')
    if args.loop_file is not None:
        loops = parse_peakfile(args.loop_file, skip=args.skip_rows).get(
            chrom, [])
        for xs, xe, ys, ye in loops:
            s_l = range(xs // res, int(np.ceil(xe / float(res))))
            e_l = range(ys // res, int(np.ceil(ye / float(res))))
            si = ei = None
            for i in s_l:
                for j in e_l:
                    st = i - start // res
                    et = j - start // res
                    if 0 <= st < M.shape[0] and 0 <= et < M.shape[0]:
                        if si is None or M[st, et] > M[si, ei]:
                            si, ei = st, et
            if si is not None:
                for (a, b) in ((si, ei), (ei, si)):
                    ax.scatter(a, b, s=args.marker_size, c='none', marker='o',
                               edgecolors=args.marker_color,
                               alpha=args.marker_alpha,
                               linewidths=args.marker_linewidth)
    ax.set_xlim(xmin, xmax)
    ax.set_ylim(ymin, ymax)
    ax.tick_params(axis='both', bottom=False, top=False, left=False,
                   right=False, labelbottom=False, labeltop=False,
                   labelleft=False, labelright=False)
    for spine in ['right', 'top', 'bottom', 'left']:
        ax.spines[spine].set_linewidth(0.9)

    if not args.nolabel:
        fontsize = 6
        offset = 0.02 * (xmax - xmin)
        ax.text(xmin, ymin + offset, print_coordinate(start), va='top',
                ha='left', fontsize=fontsize)
        ax.text(xmax, ymin + offset, print_coordinate(end), va='top',
                ha='right', fontsize=fontsize)
        ax.text(-offset, ymax, print_coordinate(start), rotation=90, va='top',
                ha='right', fontsize=fontsize)
        ax.text(-offset, ymin, print_coordinate(end), rotation=90,
                va='bottom', ha='right', fontsize=fontsize)
        ax.text((xmin + xmax) / 2, ymin + 2 * offset, 'chr' + chrom, va='top',
                ha='center', fontsize=fontsize)
        ax.text(-2 * offset, (ymin + ymax) / 2, 'chr' + chrom, rotation=90,
                va='center', ha='right', fontsize=fontsize)

    ax2 = fig.add_axes([Left + width + 0.04, 0.72, 0.03, 0.15])
    fig.colorbar(sc, cax=ax2, ticks=[vmin, vmax], format='%.3g')
    ax2.tick_params(labelsize=5)
    plt.savefig(args.output, bbox_inches='tight', dpi=args.dpi)
    plt.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
