"""What the benchmark reads from the program's own stage spans.

The port marks each engine call ``hicpeaks.call`` and its stages
``hicpeaks.<stage>`` inside it, and each blocking device-to-host read
``hicpeaks.sync`` (``hicpeaks_tpu_torch/core/spans.py``), as
``record_function`` ranges of the capture the harness already makes: the
same ``user_annotation`` marks as ``Chrom:<label>``, on the device's
clock.  A trace with no such mark is a program without the spans; its
readers then find nothing to read.
"""
from __future__ import annotations

import copy

from .trace import clip, span

PREFIX = 'hicpeaks.'
CALL = 'hicpeaks.call'
SYNC = 'hicpeaks.sync'


def stage_marks(trace):
    """(start, end, name) of the trace's ``hicpeaks.*`` marks, or [] for a
    run without a trace."""
    if trace is None:
        return []
    return [span(e) + (e['name'],) for e in trace.marks
            if e['name'].startswith(PREFIX)]


def in_window(trace, name):
    """(start, end) of the ``name`` marks inside the traced window, cut to
    it."""
    return clip([(a, b) for a, b, n in stage_marks(trace) if n == name],
                *trace.window)


def per_call(run, name, reduce):
    """``reduce`` of the window's ``name`` marks divided by the calls, or
    None without a traced window or a ``hicpeaks.*`` mark in the trace."""
    if not stage_marks(run.trace) or not run.trace.window or not run.walls:
        return None
    return reduce(in_window(run.trace, name)) / len(run.walls)


def summed_ms(spans):
    return sum(b - a for a, b in spans) / 1e3


def idle_by_stage(trace):
    """{innermost ``hicpeaks.*`` mark: idle seconds}: ``Trace.idle_by_mark``
    over the program's marks alone, so idle under no such mark is
    ``trace.OUTSIDE``."""
    own = copy.copy(trace)
    # at one start the enclosing mark comes first, so its child is inner
    own.marks = sorted((e for e in trace.marks
                        if e['name'].startswith(PREFIX)),
                       key=lambda e: (float(e['ts']), -float(e['dur'])))
    return dict(own.idle_by_mark(n=len(own.marks) + 1))
