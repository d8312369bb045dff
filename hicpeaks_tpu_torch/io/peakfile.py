"""Peak (bedpe) file parsing and emission.

The port's copy of ``hicpeaks_tpu/io/peakfile.py``.  The parser mirrors
``_parse_peakfile``/``find_chrom_pre`` (reference:
hicpeaks/utilities.py:433-467); the writers reproduce the exact text
formats of the reference CLIs:
  * 16-column pyHICCUPS bedpe (scripts/pyHICCUPS:200-210, README.rst:223-232)
  * 13-column pyBHFDR bedpe  (scripts/pyBHFDR:169-176)
  *  6-column combined bedpe  (scripts/combine-resolutions:68-71)
"""
from __future__ import annotations


def find_chrom_pre(chromlabels):
    ini = chromlabels[0]
    return 'chr' if ini.startswith('chr') else ''


def parse_peakfile(filpath, skip=1):
    """-> {chrom(label, prefix-stripped): [(start1, end1, start2, end2)]}"""
    D = {}
    with open(filpath) as source:
        for i, line in enumerate(source):
            if i < skip:
                continue
            parse = line.rstrip().split()
            chrom = parse[0]
            info = (int(parse[1]), int(parse[2]), int(parse[4]), int(parse[5]))
            D.setdefault(chrom, []).append(info)
    keys = list(D.keys())
    if not keys:
        return {}
    pre = find_chrom_pre(keys)
    return {chrom.lstrip(pre): D[chrom] for chrom in D}


_HICCUPS_FMT = ('{0}\t{1}\t{2}\t{3}\t{4}\t{5}\t{6}\t{7:.3g}\t{8}\t{9}\t'
                '{10:.3g}\t{11:.3g}\t{12:.3g}\t{13:.3g}\t{14:.3g}\t{15:.3g}\n')
_BHFDR_FMT = ('{0}\t{1}\t{2}\t{3}\t{4}\t{5}\t{6}\t{7:.3g}\t{8}\t{9}\t'
              '{10:.3g}\t{11:.3g}\t{12:.3g}\n')


def write_hiccups_bedpe(out, chrom, res, pixel_table):
    """16-col: chrom1 s1 e1 chrom2 s2 e2 . rawIF . . FoldK pK qK FoldY pY qY.

    ``pixel_table`` maps (x_bp, y_bp) -> (cen_x_bp, cen_y_bp, radius_bp,
    O, FoldK, pK, qK, FoldY, pY, qY), as assembled by hiccups()
    (callers.py:357-362)."""
    c = 'chr' + chrom.lstrip('chr')
    for pixel in pixel_table:
        tmp = pixel_table[pixel]
        content = (c, pixel[0], pixel[0] + res, c, pixel[1], pixel[1] + res,
                   '.', tmp[3], '.', '.') + tuple(tmp[4:])
        out.write(_HICCUPS_FMT.format(*content))


def write_bhfdr_bedpe(out, chrom, res, pixel_table):
    """13-col: chrom1 s1 e1 chrom2 s2 e2 . rawIF . . Fold p q.

    ``pixel_table`` maps (x_bp, y_bp) -> (cen_x_bp, cen_y_bp, radius_bp,
    O, Fold, p, q) as assembled by bhfdr() (callers.py:583-588)."""
    c = 'chr' + chrom.lstrip('chr')
    for pixel in pixel_table:
        tmp = pixel_table[pixel]
        content = (c, pixel[0], pixel[0] + res, c, pixel[1], pixel[1] + res,
                   '.', tmp[3], '.', '.') + tuple(tmp[4:])
        out.write(_BHFDR_FMT.format(*content))


def write_combined_bedpe(out, peak_list):
    """6-col output of the multi-resolution combiner."""
    for t in peak_list:
        line = ('chr' + t[0], str(t[1]), str(t[2]), 'chr' + t[3], str(t[4]), str(t[5]))
        out.write('\t'.join(line) + '\n')
