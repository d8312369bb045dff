"""toCooler on the PyTorch port: TXT/NPZ -> cooler ingestion, then ICE
balancing on the device (reference scripts/toCooler:27-136).

    python -m hicpeaks_tpu_torch.cli.tocooler -O out.cool -d meta.txt \\
        --chromsizes-file sizes.txt [--includeTrans] [--device cpu]

The flags are those of ``hicpeaks_tpu.cli.tocooler`` plus ``--device``
(default ``cuda``; without CUDA balancing fails, it never falls back to the
CPU).  ``--nproc`` is accepted and has no effect.  An existing output is
refused: the traceback goes to the log file and the exit code is 1.  The
cooler is written through ``io/h5lite``; no h5py is needed.
"""
from __future__ import annotations

import argparse
import sys
import traceback

from .. import __version__
from ..io.ingest import parse_datasets_metadata
from .common import echo_arguments, setup_logging


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Generate cooler from TXT/NPZ Hi-C data and perform '
                    'ICE (GPU-accelerated).',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('-v', '--version', action='version',
                        version=' '.join(['%(prog)s', __version__]))
    parser.add_argument('-O', '--output', help='Output cooler path.')
    parser.add_argument('-d', '--datasets', type=parse_datasets_metadata,
                        help='Path to the metadata file mapping resolutions '
                             'to data paths.')
    parser.add_argument('-C', '--chroms', nargs='*', default=['#', 'X'],
                        help='List of chromosome labels ("#" = numeric).')
    parser.add_argument('--pixel-type', default='int', choices=['int', 'float'],
                        help='Data type of your contact matrices.')
    parser.add_argument('--includeTrans', action='store_true',
                        help='Also store trans-chromosomal data.')
    parser.add_argument('--assembly', help='Assembly name.')
    parser.add_argument('--chromsizes-file',
                        help='Path to the chromosome size file.')
    parser.add_argument('--no-balance', action='store_true',
                        help='Skip ICE balancing.')
    parser.add_argument('--nproc', default=1, type=int,
                        help='Accepted for compatibility; balancing runs '
                             'on device.')
    parser.add_argument('--logFile', default='tocooler.log',
                        help='Logging file name.')
    parser.add_argument('--device', default='cuda',
                        help='Torch device ICE runs on ("cuda", "cuda:1", '
                             '"cpu"). A CUDA device without CUDA is an error.')
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.output is None or args.datasets is None:
        parser.print_help()
        return 1

    logger = setup_logging(args.logFile, rotating=True, name_width=25)
    echo_arguments(logger, [
        ('Output cooler path', args.output),
        ('Hi-C datasets', args.datasets),
        ('Chromosomes', args.chroms),
        ('Include trans-chromosomal data', args.includeTrans),
        ('Genome Assembly', args.assembly),
        ('Chromosome size file', args.chromsizes_file),
        ('Log file name', args.logFile),
        ('Device', args.device)])

    from ..io.coolerlite import CoolerLite
    from ..io.ingest import ingest
    from ..ops.ice import balance

    try:
        outfil = ingest(args.datasets, args.output,
                        chromsizes_file=args.chromsizes_file,
                        chroms=args.chroms,
                        only_intra=not args.includeTrans,
                        assembly=args.assembly, dtype=args.pixel_type)
        if not args.no_balance:
            for res in args.datasets:
                uri = f'{outfil}::{res}'
                logger.info('Balancing %s', uri)
                stats = balance(CoolerLite(uri), device=args.device)
                if not stats['converged']:
                    logger.error('Iteration limit reached without convergence')
                logger.info('Done')
    except Exception:
        with open(args.logFile, 'a') as log:
            traceback.print_exc(file=log)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
