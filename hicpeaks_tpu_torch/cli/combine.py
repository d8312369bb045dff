"""combine-resolutions CLI (reference scripts/combine-resolutions:11-74).

    python -m hicpeaks_tpu_torch.cli.combine -O combined.bedpe \\
        -p peaks5K.bedpe peaks10K.bedpe -R 5000 10000 [--max-res 10000]

The port's copy of ``hicpeaks_tpu/cli/combine.py``, with the same flags and
defaults; it runs on the host and writes the same 6-column bedpe.
"""
from __future__ import annotations

import argparse
import sys

from .. import __version__


def main(argv=None):
    parser = argparse.ArgumentParser(
        usage='%(prog)s <-O output> [options]',
        description='Combine loop calls from different resolutions.',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-v', '--version', action='version',
                        version=' '.join(['%(prog)s', __version__]))
    parser.add_argument('-O', '--output', help='Output peak file name.')
    parser.add_argument('-p', '--paths', nargs='+',
                        help='List of peak file paths at different '
                             'resolutions.')
    parser.add_argument('-R', '--resolutions', type=int, nargs='+',
                        help='Resolutions matching the input peak files.')
    parser.add_argument('-S', '--skip-rows', type=int, default=0,
                        help='Number of leading lines to skip.')
    parser.add_argument('-G', '--good-res', type=int, default=20000,
                        help='Fine resolutions below this need coarse '
                             'confirmation unless the loci are close.')
    parser.add_argument('-M', '--min-dis', type=int, default=200000,
                        help='See --good-res.')
    parser.add_argument('--max-res', type=int, default=10000,
                        help='Largest resolution allowed in the output.')
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.output is None:
        parser.print_help()
        return 1

    from ..core.combine import combine_annotations
    from ..io.peakfile import parse_peakfile, write_combined_bedpe

    byres = {res: parse_peakfile(path, args.skip_rows)
             for res, path in zip(args.resolutions, args.paths)}
    peak_list = combine_annotations(byres, good_res=args.good_res,
                                    mindis=args.min_dis,
                                    max_res=args.max_res)
    with open(args.output, 'w') as out:
        write_combined_bedpe(out, peak_list)
    return 0


if __name__ == '__main__':
    sys.exit(main())
