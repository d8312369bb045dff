"""Mix entry ``chrom``: one chromosome (the traffic's ``chrom``) is drawn
from the seed and built into the program's bands as ``api._run``'s
producer builds them; each step is one ``engine.<caller>_chrom(bands,
cfg, device=...)`` on them, closed loop, one caller, the bands copied from
pageable memory by each call.  A step's answer is the chromosome's peak
table."""
from __future__ import annotations

import numpy as np

from ..compare import table_gap
from ..driver import Entry, ww_min


class ChromEntry(Entry):
    unit = 'call'

    def setup(self):
        from hicpeaks_tpu_torch.core import engine
        from hicpeaks_tpu_torch.ops.band import build_bands
        self.label = str(self.traffic['chrom'])
        b1, b2, ct, w, _, L = self.pixels(self.label)
        self.pix = (b1, b2, ct, w, L)
        self.shape = self.band_shape(b1, b2, ct, L)
        self.bands = build_bands(b1, b2, ct, w, L, self.num, ww_min(
            self.config), self.res, chrom=self.label, dtype=np.float32,
            keep_sparse=False)
        self.shape.update(band=list(self.bands.raw.shape))
        self.inputs = dict(self.shape, contacts=int(ct.sum()))
        self.fn = getattr(engine, f'{self.caller}_chrom')
        self.arg = self.bands

    def free(self):
        self.bands = self.arg = None

    def reference(self, dtype=np.float64):
        return self.reference_table(*self.pix, dtype)

    @staticmethod
    def gap(got, want):
        return table_gap(got, want)


ENTRY = ChromEntry
