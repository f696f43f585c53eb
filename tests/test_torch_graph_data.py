"""The port's graph data pipeline (``repro_torch.data.graph_data``, a
numpy copy of the reference's) against the reference: the same seeds give
the same arrays, exactly — ``CSRGraph.random``, ``neighbors``,
``sample_fanout_subgraph`` and ``minibatch_stream``."""

import numpy as np
import pytest

from repro.data import graph_data as ref
from repro_torch.data import graph_data as port


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("n_nodes,avg_degree,seed", [(50, 4, 0), (300, 12, 3), (1000, 30, 7)])
def test_random_graph_equals_reference(n_nodes, avg_degree, seed):
    g, want = port.CSRGraph.random(n_nodes, avg_degree, seed), ref.CSRGraph.random(n_nodes, avg_degree, seed)
    assert g.n_nodes == want.n_nodes
    _same(g.indptr, want.indptr)
    _same(g.indices, want.indices)
    for v in (0, n_nodes // 2, n_nodes - 1):
        _same(g.neighbors(v), want.neighbors(v))


@pytest.mark.parametrize("fanout", [(3, 2), (15, 10)])
def test_fanout_subgraph_equals_reference(fanout):
    g, want_g = port.CSRGraph.random(400, 20, 1), ref.CSRGraph.random(400, 20, 1)
    seeds = np.random.default_rng(2).choice(400, 8, replace=False)
    got = port.sample_fanout_subgraph(g, seeds, fanout, np.random.default_rng(5), 400, 2048)
    want = ref.sample_fanout_subgraph(want_g, seeds, fanout, np.random.default_rng(5), 400, 2048)
    _same(got, want)


def test_fanout_subgraph_refuses_too_small_padding():
    g = port.CSRGraph.random(400, 20, 1)
    with pytest.raises(ValueError, match="exceeds padding"):
        port.sample_fanout_subgraph(g, np.arange(8), (15, 10), np.random.default_rng(0), 16, 16)


def test_minibatch_stream_equals_reference():
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(500, 6)).astype(np.float32)
    targets = rng.normal(size=500).astype(np.float32)
    args = (4, (3, 2), 64, 128)
    got = port.minibatch_stream(port.CSRGraph.random(500, 10, 2), feats, targets, *args, seed=9)
    want = ref.minibatch_stream(ref.CSRGraph.random(500, 10, 2), feats, targets, *args, seed=9)
    for _ in range(3):
        _same(next(got), next(want))
