"""scan_pass_b_roofline: the pass-B kernel's share of its roofline, in %:
the least time the card could take for its work (portbench.roofline,
from the band's shapes) over its traced time, launch for launch."""
from portbench.roofline import kernel_work
from portbench.trace import HAND_WRITTEN

KERNEL = 'scan_pass_b'


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    sub = HAND_WRITTEN[KERNEL]
    events = [e for e in t.device if e.get('cat') == 'kernel'
              and sub in e['name']]
    if not events:
        return None
    busy_us = t.device_us(lambda e: e.get('cat') == 'kernel'
                          and sub in e['name'])
    entry = run.entry
    s = entry.shape
    bound_s, _ = kernel_work(KERNEL, entry.caller, entry.settings, s['L'],
                             s['num'], s['n_cand']).bound_s()
    return 100.0 * bound_s * 1e6 * len(events) / busy_us
