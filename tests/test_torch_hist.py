"""The (chunk, count) histogram's plain twin (hicpeaks_tpu_torch/ops/
cuda_hist.py, through the kernel wrapper's CPU route) against the Pallas
kernel in interpret mode and the jnp one-hot scan, at the cases of
test_pallas_hist.py.

The port does not pad its streams, so the tables may differ only in the
trash cell (0, 0), where JAX's padding lands; no valid pixel reads row 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicpeaks_tpu.ops import score as jscore
from hicpeaks_tpu.ops.pallas_hist import chunk_hist_pallas
from hicpeaks_tpu_torch.ops import cuda_hist

from .torch_threads import one_intra_op_thread  # noqa: F401


def _case(n, o_cap, seed):
    rng = np.random.default_rng(seed)
    S, C = 128, o_cap + 1
    O = rng.poisson(9.0, n).astype(np.float32)
    O[rng.random(n) < 0.01] = o_cap * 3.0          # clip-at-cap bucket
    cid = rng.integers(1, S, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    return O, cid, valid, S, C


def _port_streams(O, cid, valid, S, C):
    oc = np.clip(np.floor(O), 0, C - 1).astype(np.int32)
    cid0 = np.where(valid, np.clip(cid, 1, S - 1), 0).astype(np.int32)
    return torch.from_numpy(oc), torch.from_numpy(cid0)


def _assert_equal_but_trash_cell(got, want):
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_array_equal(got[0, 1:], want[0, 1:])


@pytest.mark.parametrize('n,o_cap,seed', [(5000, 256, 0), (70000, 512, 1),
                                          (300, 131, 2)])
def test_hist_twin_matches_pallas_and_scan(n, o_cap, seed):
    O, cid, valid, S, C = _case(n, o_cap, seed)
    Oc_p, cid_p, _ = jscore._chunk_pack(jnp.asarray(O), jnp.asarray(cid),
                                        jnp.asarray(valid), S, C)
    pallas = np.asarray(chunk_hist_pallas(Oc_p, cid_p, S, C, interpret=True))
    scan = np.asarray(jscore.chunk_hist(Oc_p, cid_p, S, C, 'jnp'))
    oc, cid0 = _port_streams(O, cid, valid, S, C)
    got = cuda_hist.chunk_hist(oc, cid0[None], S, C)
    assert got.dtype == torch.int32 and got.shape == (S, C)
    got = got.numpy()
    _assert_equal_but_trash_cell(got, pallas)
    _assert_equal_but_trash_cell(got, scan)
    assert got.sum() == n                   # every pixel counted once


def test_hist_twin_batched_rows_and_out_of_range():
    """B backgrounds land in row blocks b*S; ids outside [0, S) and counts
    outside [0, C) count nowhere."""
    rng = np.random.default_rng(9)
    n, S, C, B = 4000, 16, 33, 3
    oc = rng.integers(-2, C + 3, n).astype(np.int32)
    cid = rng.integers(-1, S + 2, (B, n)).astype(np.int32)
    got = cuda_hist.chunk_hist(torch.from_numpy(oc), torch.from_numpy(cid),
                               S, C).numpy()
    assert got.shape == (B * S, C)
    for b in range(B):
        ok = (cid[b] >= 0) & (cid[b] < S) & (oc >= 0) & (oc < C)
        want = np.zeros((S, C), np.int64)
        np.add.at(want, (cid[b][ok], oc[ok]), 1)
        np.testing.assert_array_equal(got[b * S:(b + 1) * S], want)
