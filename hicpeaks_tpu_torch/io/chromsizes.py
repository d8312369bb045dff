"""Chromosome-size acquisition.

The port's copy of ``hicpeaks_tpu/io/chromsizes.py``.

Equivalent of the reference's ``readChromSizes`` / ``fetchChromSizes``
(reference: hicpeaks/utilities.py:20-49).  The UCSC path is pure-Python
HTTP against hgdownload (no ``fetchChromSizes`` subprocess dependency)
and degrades to a clear error when the network is unreachable.
"""
from __future__ import annotations


def _label_selected(label: str, chroms) -> bool:
    """Reference semantics (utilities.py:30,45): empty selection means all;
    '#' stands for purely-numeric labels; otherwise exact match."""
    return (not chroms) or (label.isdigit() and '#' in chroms) or (label in chroms)


def read_chromsizes(chromsizes_file: str, chroms=('#', 'X')) -> dict:
    """Read a UCSC-style 2-column ``<chrom>\t<size>`` file.

    The leading ``chr`` prefix is stripped, mirroring utilities.py:44.
    """
    chroms = set(chroms) if chroms else set()
    chromsizes = {}
    with open(chromsizes_file) as source:
        for line in source:
            parse = line.rstrip().split()
            if len(parse) < 2:
                continue
            c, s = parse[0].lstrip('chr'), parse[1]
            if _label_selected(c, chroms):
                chromsizes[c] = int(s)
    return chromsizes


UCSC_CHROMSIZES_URL = ('https://hgdownload.soe.ucsc.edu/goldenPath/'
                       '{assembly}/bigZips/{assembly}.chrom.sizes')


def fetch_chromsizes(assembly: str, chroms=('#', 'X'), timeout=30,
                     _urlopen=None) -> dict:
    """Fetch ``<assembly>.chrom.sizes`` from UCSC over plain HTTPS —
    the subprocess-free equivalent of the reference's ``fetchChromSizes``
    wrapper (utilities.py:20-36), line format and `chr`-strip/# selection
    semantics identical to :func:`read_chromsizes`.

    Raises ``ConnectionError`` with an actionable message (pointing at
    ``--chromsizes-file``) when the host is unreachable, instead of the
    reference's opaque FileNotFoundError from the missing UCSC binary.
    """
    from urllib.request import urlopen
    from urllib.error import URLError

    opener = _urlopen or urlopen
    url = UCSC_CHROMSIZES_URL.format(assembly=assembly)
    chroms = set(chroms) if chroms else set()
    chromsizes = {}
    try:
        with opener(url, timeout=timeout) as resp:
            body = resp.read()
    except (URLError, OSError) as exc:
        raise ConnectionError(
            f'could not fetch chromosome sizes for {assembly!r} from UCSC '
            f'({url}): {exc}. Provide --chromsizes-file to run offline.'
        ) from exc
    for line in body.decode().splitlines():
        parse = line.rstrip().split()
        if len(parse) < 2:
            continue
        c, s = parse[0].lstrip('chr'), parse[1]
        if _label_selected(c, chroms):
            chromsizes[c] = int(s)
    return chromsizes


def sort_chromlabels(labels) -> list:
    """Numeric labels ascending, then X, Y, M, then the rest sorted
    (reference: utilities.py:196-201)."""
    labels = list(labels)
    tmp = list(map(str, sorted(map(int, [i for i in labels if i.isdigit()]))))
    nondigits = [i for i in labels if not i.isdigit()]
    for i in ['X', 'Y', 'M']:
        if i in nondigits:
            tmp.append(nondigits.pop(nondigits.index(i)))
    return tmp + sorted(nondigits)
