"""Peak (bedpe) file emission.

The port's copy of the writers of ``hicpeaks_tpu/io/peakfile.py``; they
reproduce the exact text formats of the reference CLIs:
  * 16-column pyHICCUPS bedpe (scripts/pyHICCUPS:200-210, README.rst:223-232)
  * 13-column pyBHFDR bedpe  (scripts/pyBHFDR:169-176)
"""
from __future__ import annotations


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
