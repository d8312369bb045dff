"""Stage spans of the port in a running ``torch.profiler`` capture.

``span(name)`` is ``torch.profiler.record_function(name)`` while a capture
runs, so a stage lands in the same Chrome trace as the card's kernels and
copies, on the same clock; otherwise it is one shared null context (no
``RecordFunction``, no clock read).  A capture is seen on the thread that
started it (``torch.autograd._profiler_enabled``); while an
:class:`EveryThread` capture runs, spans record on every thread, the
prefetch thread's too.  A counter is the number of spans of one name in
the trace: :data:`SYNC` marks each blocking device-to-host read.  Names
are stable and carry no label.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import profile, record_function

SYNC = 'hicpeaks.sync'

_NULL = contextlib.nullcontext()
_every_thread = False    # an EveryThread capture is running


def span(name):
    """The stage ``name`` in the running capture, else a null context."""
    if _every_thread or torch.autograd._profiler_enabled():
        return record_function(name)
    return _NULL


class EveryThread(profile):
    """A ``torch.profiler.profile`` of ``activities`` that records every
    thread's ops and spans (``profile_all_threads``); building it raises
    RuntimeError where the installed torch has no such option."""

    def __init__(self, activities):
        try:
            config = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError) as exc:
            raise RuntimeError(
                'tracing the prefetch thread needs torch.profiler\'s '
                f'profile_all_threads, which torch {torch.__version__} '
                'lacks') from exc
        super().__init__(activities=activities, experimental_config=config)

    def start(self):
        global _every_thread
        super().start()
        _every_thread = True

    def stop(self):
        global _every_thread
        _every_thread = False
        super().stop()
