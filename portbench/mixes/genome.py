"""Mix entry ``genome``: every chromosome of the configuration is drawn
from the seed, its band pixel by pixel and its cis contacts beyond the
band and the trans contacts contact by contact (:mod:`portbench.gen.synth`),
and written as one cooler in ``TMPDIR``, with the synthesis's weights as
the balanced weights; each step is one ``api.call_<caller>(uri, cfg,
device=...)``, the analyst's genome call with its prefetch thread.  A
step's answer is the genome's tables."""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from ..compare import genome_gap
from ..driver import Entry
from ..gen import cooler, synth


class GenomeEntry(Entry):
    unit = 'genome call'

    def setup(self):
        from hicpeaks_tpu_torch import api
        syn = self.config['synthesis']
        labels = list(self.config['chromsizes'])
        self.pix, self.shape, biases, weights = {}, {}, [], []
        for label in labels:
            b1, b2, ct, w, bias, L = self.pixels(label)
            f1, f2, fc = synth.far_pixels(syn, bias, self.seed,
                                          self.index(label))
            self.shape[label] = self.band_shape(b1, b2, ct, L)
            b1, b2, ct = (np.concatenate(p) for p in
                          ((b1, f1), (b2, f2), (ct, fc)))
            order = np.lexsort((b2, b1))
            self.pix[label] = (b1[order], b2[order], ct[order], w, L)
            biases.append(bias)
            weights.append(w)
        t1, t2, tc = synth.trans_pixels(biases, syn['trans_contacts'],
                                        self.seed)
        offsets = np.concatenate([[0], np.cumsum([len(b) for b in biases])])
        rows = np.searchsorted(t1, offsets)
        chunks = []
        self.contacts = self.pixel_count = 0
        for k, label in enumerate(labels):
            b1, b2, ct = self.pix[label][:3]
            sl = slice(rows[k], rows[k + 1])
            chunk = {'bin1_id': np.concatenate([b1 + offsets[k], t1[sl]]),
                     'bin2_id': np.concatenate([b2 + offsets[k], t2[sl]]),
                     'count': np.concatenate([ct, tc[sl]])}
            order = np.lexsort((chunk['bin2_id'], chunk['bin1_id']))
            chunks.append({c: v[order] for c, v in chunk.items()})
            self.contacts += int(chunk['count'].sum())
            self.pixel_count += len(order)
        del t1, t2, tc
        self.dir = tempfile.mkdtemp(prefix='portbench-')
        path = os.path.join(self.dir, 'genome.cool')
        cooler.create_cooler(path, self.config['chromsizes'], self.res,
                             chunks, np.concatenate(weights),
                             assembly=self.config.get('assembly'),
                             only_intra=False)
        del chunks
        self.inputs = dict(contacts=self.contacts, pixels=self.pixel_count,
                           file_bytes=os.path.getsize(path))
        self.fn = getattr(api, f'call_{self.caller}')
        self.arg = path

    def free(self):
        self.arg = None
        shutil.rmtree(self.dir, ignore_errors=True)

    def reference(self, dtype=np.float64):
        """The chromosomes' reference tables, four at a time on threads
        (numpy's sorts and scipy's cdf release the interpreter's lock)."""
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(4) as pool:
            futures = {label: pool.submit(self.reference_table, *p,
                                          dtype=dtype)
                       for label, p in self.pix.items()}
            return {label: f.result() for label, f in futures.items()}

    @staticmethod
    def gap(got, want):
        return genome_gap(got, want)


ENTRY = GenomeEntry
