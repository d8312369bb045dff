"""Tool configuration dataclasses — single source of truth for defaults.

The port's copy of ``hicpeaks_tpu/core/config.py``, unchanged.

The reference embeds defaults both in CLI argparse definitions and function
signatures, and they disagree (SURVEY §5 'Config' row); at runtime the CLI
values win, so these dataclasses carry the *CLI* defaults:
pyHICCUPS: scripts/pyHICCUPS:38-73 (maxww 10, siglevel 0.05, sumq 0.01,
double-fold 1.75, single-fold 2, min-marginal-peaks 2, min-local-reads 16,
maxapart 1e7, only-anchors False);
pyBHFDR: scripts/pyBHFDR:38-50 (pw 2, ww 5, maxww 10, siglevel 0.05,
maxapart 2e6) with function-default min_marginal_peaks=3/onlyanchor=False
(callers.py:364-365) since the CLI does not expose them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class HiccupsConfig:
    pw: Tuple[int, ...] = (2,)
    ww: Tuple[int, ...] = (5,)
    maxww: int = 10
    siglevel: float = 0.05
    sumq: float = 0.01
    double_fold: float = 1.75
    single_fold: float = 2.0
    maxapart: int = 10_000_000
    use_raw: bool = False
    min_marginal_peaks: int = 2
    min_local_reads: int = 16
    only_anchors: bool = False
    clr_weight_name: str = 'weight'

    @property
    def ww_min(self):
        return min(self.ww)


@dataclass(frozen=True)
class BHFDRConfig:
    pw: int = 2
    ww: int = 5
    maxww: int = 10
    siglevel: float = 0.05
    maxapart: int = 2_000_000
    min_marginal_peaks: int = 3
    only_anchors: bool = False
    clr_weight_name: str = 'weight'

    @property
    def ww_min(self):
        return self.ww
