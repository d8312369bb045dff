"""The least time the card could take for a kernel's work.

Each kernel's work is counted from the band's shapes: every input byte
read once and every output byte written once, over the band's ``num``
diagonals of ``L`` bins (its padding left out), and the additions its
ring sums need.  The bound is the larger of the bytes at the card's
memory bandwidth and the operations at its float32 rate outside the
tensor cores; ``chip_smoke.py``'s ``kernel_checks`` is the pattern.

Peaks: NVIDIA's H100 SXM data sheet (dense rates, at its 700 W limit).
A card set below 700 W runs slower under load; the benchmark records its
``power.limit`` beside every share.
"""
from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


class Work(NamedTuple):
    terms: dict     # {what: bytes}
    ops: float      # float32 additions

    @property
    def bytes(self):
        return sum(self.terms.values())

    def bound_s(self):
        """(seconds, 'bytes' or 'operations'): the larger of the two
        times at the peaks."""
        t_bytes = self.bytes / HBM_BYTES_PER_S
        t_ops = self.ops / F32_OPS_PER_S
        return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops,
                                                            'operations')


def pass_a(L, num, n_cand, maxww, steps):
    """Pass A's freeze counts: the float32 raw band and the candidate mask
    in, one int32 count per plan step out; per position and ring radius
    3 adds (the Vn and Wq folds and the ring), per candidate one Reads
    add per plan step."""
    positions = L * num
    return Work({'raw_f32_in': 4 * positions,
                 'cand_mask_in': positions,
                 'counts_out': 4 * steps},
                3 * maxww * positions + steps * n_cand)


def pass_b(L, num, n_cand, maxww, steps, n_p):
    """Pass B's captures: the raw, balanced and expected float32 bands and
    the candidate mask in, the freeze gate (one byte a plan step) in, four
    float32 capture planes (KS, KE, YS, YE) a pool radius out; per position
    and ring radius 10 adds for each of the balanced and expected bands
    and 3 for raw, per candidate and plan step 4 background sums and one
    Reads add."""
    positions = L * num
    return Work({'bands_f32_in': 12 * positions,
                 'cand_mask_in': positions,
                 'gate_in': steps,
                 'captures_out': 16 * n_p * positions},
                23 * maxww * positions + 5 * steps * n_cand)


def plan_steps(caller, settings):
    """The pool plan's steps: one a (pw, w) pair for w from each ww up to
    maxww (pyHICCUPS), or one a w from ww up to maxww (pyBHFDR)."""
    maxww = int(settings['maxww'])
    if caller == 'hiccups':
        return sum(maxww - w + 1 for w in settings['ww'])
    return maxww - int(settings['ww']) + 1


def pool_radii(caller, settings):
    """The distinct pw values, each a set of capture planes."""
    if caller == 'hiccups':
        return len(set(settings['pw']))
    return 1


def kernel_work(kernel, caller, settings, L, num, n_cand):
    """The Work of ``kernel`` ('scan_pass_a' or 'scan_pass_b') on one
    chromosome of ``L`` bins and ``num`` diagonals with ``n_cand``
    candidates."""
    steps = plan_steps(caller, settings)
    maxww = int(settings['maxww'])
    if kernel == 'scan_pass_a':
        return pass_a(L, num, n_cand, maxww, steps)
    return pass_b(L, num, n_cand, maxww, steps,
                  pool_radii(caller, settings))
