"""The segment sum's split of long segments from short rows
(``repro_torch.kernels.segment_sum``), with no JAX, so that its card tests
run on a host without it.

* The plan's ``long_rows``: the segments of more than ``LONG_TERMS``
  terms in increasing order, then -1 up to ``long_bound(n)``, against a
  numpy count (segments of ``LONG_TERMS - 1``, ``LONG_TERMS`` and
  ``LONG_TERMS + 1`` terms, none long, every term in one segment, ids past
  either end as many as a long segment).
* ``segment_sum`` on those ids equal, bit for bit, to the index-order loop
  (``segment_sum_ref``) at C 1, 3 and 64.
* ``-m cuda``: the kernel (both paths) equal to the host's plain version
  to the bit on the same cases, one launch counted on ``launches`` and one
  on ``long_launches``; and the plan, both launches and the bag's backward
  with no host sync.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.segment_sum import segment_plan, segment_sum, segment_sum_plain
from repro_torch.kernels.segment_sum.ops import LONG_TERMS, long_bound
from repro_torch.kernels.segment_sum.ref import segment_sum_ref

LONG_CASES = ("threshold edges", "none long", "every term in one segment", "dropped ids")


def _long_ids(case, rng):
    """(ids int32, num_segments) for one of LONG_CASES."""
    if case == "threshold edges":  # LONG_TERMS - 1, LONG_TERMS, LONG_TERMS + 1 among short ones
        ids = np.repeat(np.arange(3), [LONG_TERMS - 1, LONG_TERMS, LONG_TERMS + 1])
        ids, R = rng.permutation(np.concatenate([ids, rng.integers(3, 50, 400)])), 50
    elif case == "none long":
        ids, R = rng.integers(0, 100, 3000), 100
    elif case == "every term in one segment":
        ids, R = np.full(5 * LONG_TERMS, 7), 9
    else:  # ids past either end, as many as a long segment, add nothing
        ids = np.concatenate([np.full(LONG_TERMS + 5, -1), np.full(LONG_TERMS + 5, 30),
                              np.full(LONG_TERMS + 1, 4), rng.integers(0, 30, 300)])
        ids, R = rng.permutation(ids), 30
    return ids.astype(np.int32), R


@pytest.mark.parametrize("case", LONG_CASES)
def test_segment_plan_lists_the_long_segments(case):
    ids, R = _long_ids(case, np.random.default_rng(3))
    plan = segment_plan(torch.from_numpy(ids), R)
    counts = np.bincount(ids[(ids >= 0) & (ids < R)], minlength=R)
    want = np.full(long_bound(ids.shape[0]), -1)
    long = np.flatnonzero(counts > LONG_TERMS)
    want[:long.shape[0]] = long
    assert plan.long_rows.dtype == torch.int32
    assert np.array_equal(plan.long_rows.numpy(), want)


@pytest.mark.parametrize("C", [1, 3, 64])
@pytest.mark.parametrize("case", LONG_CASES)
def test_segment_sum_equals_the_index_order_loop(case, C):
    ids, R = _long_ids(case, np.random.default_rng(3))
    data = np.random.default_rng(C).normal(size=(ids.shape[0], C)).astype(np.float32)
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), R)
    assert np.array_equal(got.numpy(), segment_sum_ref(data, ids, R))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 64, 257])
@pytest.mark.parametrize("case", LONG_CASES)
def test_segment_sum_kernel_equals_plain_on_long_segments_cuda(cuda, case, C):
    ids, R = _long_ids(case, np.random.default_rng(3))
    data = np.random.default_rng(C).normal(size=(ids.shape[0], C)).astype(np.float32)
    launches, long_launches = segment_sum.launches, segment_sum.long_launches
    got = segment_sum(torch.from_numpy(data).to(cuda), torch.from_numpy(ids).to(cuda), R)
    torch.cuda.synchronize()
    assert segment_sum.launches == launches + 1
    assert segment_sum.long_launches == long_launches + (long_bound(ids.shape[0]) > 0)
    assert torch.equal(got.cpu(), segment_sum_plain(torch.from_numpy(data), torch.from_numpy(ids), R))


@pytest.mark.cuda
def test_segment_plan_and_sum_make_no_host_sync_cuda(cuda):
    """The plan (sort, offsets, the list of long segments), the launch of
    both kernels and the bag's backward read nothing back from the card:
    sync debug mode raises on any host sync."""
    from repro_torch.kernels.embedding_bag import embedding_bag_backward, embedding_bag_backward_plain

    ids, R = _long_ids("threshold edges", np.random.default_rng(4))
    data = np.random.default_rng(5).normal(size=(ids.shape[0], 64)).astype(np.float32)
    bag_ids = ids[:LONG_TERMS * 6].reshape(-1, 6)
    g = data[:bag_ids.shape[0]]
    tids, tdata, tbag, tg = (torch.from_numpy(x).to(cuda) for x in (ids, data, bag_ids, g))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = segment_sum(tdata, segment_plan(tids, R))
        got_bag = embedding_bag_backward(tbag, tg, R)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.cpu(), segment_sum_plain(torch.from_numpy(data), torch.from_numpy(ids), R))
    assert torch.equal(got_bag.cpu(), embedding_bag_backward_plain(
        torch.from_numpy(bag_ids), torch.from_numpy(g), R))
