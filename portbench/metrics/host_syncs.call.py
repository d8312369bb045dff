"""host_syncs.call: blocking device-to-host reads per call: the number of
the program's ``hicpeaks.sync`` spans in the traced window (one a read:
``core/engine._to_host``'s fetches, ``ops/score.compact_mask_batched``'s
sizing, ``global_bh_keep``'s loop tests, ...)."""
from portbench.stages import SYNC, per_call


def read(run):
    return per_call(run, SYNC, len)
