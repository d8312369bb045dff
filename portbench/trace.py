"""What the benchmark reads from a ``torch.profiler`` Chrome trace.

A trace is the JSON that ``profile.export_chrome_trace`` writes: complete
events (``"ph": "X"``) with a category, a name, a start and a duration in
microseconds.  The device's work is its kernels, copies and memsets; the
host's marks are the ``record_function`` ranges (``user_annotation``):
the program's ``Chrom:<label>`` around each chromosome's call, and the
benchmark's own ``portbench.*`` spans.  ``chip_smoke.py``'s ``union_ms``
and ``trace_summary`` are the pattern.
"""
from __future__ import annotations

import json

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
#: the hand-written kernels as a trace names them (kineto may print the
#: demangled signature, so a name is matched as a substring)
HAND_WRITTEN = {'scan_pass_a': 'scan_pass_a_kernel',
                'scan_pass_b': 'scan_pass_b_kernel',
                'chunk_hist': 'chunk_hist_kernel'}
STEP = 'portbench.step'      # the benchmark's span around each timed call
OUTSIDE = 'outside any span'
NAME_CHARS = 120    # a device op's name in the breakdown, cut to this


def union_us(spans):
    """Microseconds covered by the union of (start, end) spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def clip(spans, lo, hi):
    """The parts of (start, end) ``spans`` inside [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


class Trace:
    """The complete events of one Chrome trace, split into the device's
    work and the host's marks, and the traced window: from the first
    benchmark step's start to the last one's end."""

    def __init__(self, events):
        done = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
        self.device = [e for e in done if e.get('cat') in DEVICE_CATS]
        self.marks = [e for e in done if e.get('cat') == 'user_annotation']
        steps = [span(e) for e in self.marks if e['name'] == STEP]
        if steps:
            self.window = (min(a for a, _ in steps), max(b for _, b in steps))
        else:
            self.window = None

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls(json.load(f)['traceEvents'])

    @property
    def window_us(self):
        return self.window[1] - self.window[0] if self.window else 0.0

    def busy_us(self):
        """Microseconds of the window in which the device ran a kernel,
        a copy or a memset: the union of their intervals."""
        if not self.window:
            return 0.0
        return union_us(clip([span(e) for e in self.device], *self.window))

    def device_us(self, pick):
        """Summed device microseconds, inside the window, of the device
        events for which ``pick(event)`` holds."""
        if not self.window:
            return 0.0
        return sum(b - a for a, b in clip(
            [span(e) for e in self.device if pick(e)], *self.window))

    def mark_spans(self, prefix):
        """(start, end) of the host marks whose names start ``prefix``."""
        return [span(e) for e in self.marks if e['name'].startswith(prefix)]

    def uncovered_us(self, prefix):
        """Microseconds of the window outside every host mark whose name
        starts ``prefix``."""
        if not self.window:
            return 0.0
        return self.window_us - union_us(clip(self.mark_spans(prefix),
                                              *self.window))

    def gaps(self):
        """The device's idle intervals inside the window."""
        if not self.window:
            return []
        lo, hi = self.window
        out, t = [], lo
        for a, b in sorted(clip([span(e) for e in self.device], lo, hi)):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def top_device_ops(self, n=10):
        """[[name, seconds]] of the ``n`` device operations with the most
        time in the window, summed by name."""
        by = {}
        if self.window:
            for e in self.device:
                part = clip([span(e)], *self.window)
                if part:
                    by[e['name']] = by.get(e['name'], 0.0) + \
                        (part[0][1] - part[0][0]) / 1e6
        return [[k[:NAME_CHARS], v] for k, v in sorted(
            by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_mark(self, n=10):
        """[[mark, seconds]]: the device's idle time in the window split
        by the innermost host mark open at each moment (the latest-started
        mark that covers it), summed by the mark's name and sorted, the
        ``n`` largest; ``Chrom:<label>`` marks count as ``Chrom:``."""
        marks = sorted(((a, b, _label(e['name']))
                        for e in self.marks for a, b in [span(e)]),
                       key=lambda m: m[0])
        by = {}
        for ga, gb in self.gaps():
            cuts = sorted({ga, gb} | {t for a, b, _ in marks
                                      for t in (a, b) if ga < t < gb})
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                inner = OUTSIDE
                for ma, mb, name in marks:
                    if ma > mid:
                        break
                    if mb > mid:
                        inner = name
                by[inner] = by.get(inner, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


def span(e):
    return float(e['ts']), float(e['ts']) + float(e['dur'])


def _label(name):
    return 'Chrom:' if name.startswith('Chrom:') else name


def is_hand_written(e):
    return any(sub in e['name'] for sub in HAND_WRITTEN.values())
