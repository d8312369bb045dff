"""Shared CLI scaffolding: the reference's logging shape (root logger at
level 10, console + [rotating] file handlers, uniform formatter, argument
echo header — scripts/pyHICCUPS:88-130) and chromosome selection.

The port's copy of ``hicpeaks_tpu/cli/common.py`` without its XLA
compilation cache, which has no counterpart here.
"""
from __future__ import annotations

import logging
import logging.handlers
import sys


def setup_logging(log_file, rotating=False, name_width=21):
    logger = logging.getLogger()
    logger.setLevel(10)
    for h in list(logger.handlers):   # idempotent across in-process calls
        logger.removeHandler(h)
        h.close()
    console = logging.StreamHandler()
    if rotating:
        filehandler = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=200000, backupCount=5)
    else:
        filehandler = logging.FileHandler(log_file)
    console.setLevel('INFO')
    filehandler.setLevel('INFO')
    formatter = logging.Formatter(
        fmt=f'%(name)-{name_width}s %(levelname)-7s @ %(asctime)s: %(message)s',
        datefmt='%m/%d/%y %H:%M:%S')
    console.setFormatter(formatter)
    filehandler.setFormatter(formatter)
    logger.addHandler(console)
    logger.addHandler(filehandler)
    logger.info('Python Version: %s', sys.version.split()[0])
    return logger


def echo_arguments(logger, pairs):
    lines = ['# ARGUMENT LIST:'] + [f'# {k} = {v}' for k, v in pairs]
    logger.info('\n' + '\n'.join(lines))


def chrom_selected(label, chroms):
    label = label.lstrip('chr')
    return (not chroms) or (label.isdigit() and '#' in chroms) or \
        (label in chroms)
