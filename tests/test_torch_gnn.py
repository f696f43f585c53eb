"""The port's EGNN (``repro_torch.models.gnn``) and sorted segment sum
(``repro_torch.kernels.segment_sum``) against the reference.

* EGNN ``forward``, ``loss_fn``, ``batched_forward`` and ``batched_loss``
  and their gradients, on the reference's weights (``carry_params``) and
  the same numpy inputs, over every reduced shape of ``_reduce_egnn``:
  outputs and gradients within rtol 1e-4, atol 1e-5 (float32; matrix
  products and sums of a few terms add in other orders in XLA and
  PyTorch, and two layers of MLPs carry the differences on).
* The equivariance property of ``tests/test_smoke_archs.py`` on the port.
* ``segment_sum_plain`` equal, bit for bit, to a numpy loop in index
  order; the plan's order stable and its offsets the segments' starts.
* ``GatherRows`` and ``SegmentSum`` gradients equal to autograd's own
  ``x[ids]`` and ``index_add_`` on the CPU, to the bit (short segments:
  autograd adds a long one in another order), and ``GatherRows``'s to the
  index-order loop on every case (the plan's list of long segments and the
  kernel's long path: ``tests/test_torch_segment_sum.py``).
* ``-m cuda``: the kernel equal to the host's plain version to the bit,
  and an EGNN gradient the same in two runs.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side: a card host without JAX skips the file
import jax.numpy as jnp  # noqa: E402

from repro.configs.gnn_archs import EGNN_ARCH as REF_EGNN_ARCH  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro_torch.configs.gnn_archs import EGNN_ARCH  # noqa: E402
from repro_torch.kernels.segment_sum import (  # noqa: E402
    gather_rows,
    segment_plan,
    segment_sum,
    segment_sum_plain,
)
from repro_torch.kernels.segment_sum.ops import LONG_TERMS  # noqa: E402
from repro_torch.kernels.segment_sum.ref import segment_sum_ref  # noqa: E402
from repro_torch.models import carry_params, value_and_grad  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
CPU = "cpu"
SHAPES = list(EGNN_ARCH.reduced().shapes)


def _cfgs(shape_name):
    ref, port = REF_EGNN_ARCH.reduced(), EGNN_ARCH.reduced()
    d_feat = port.shapes[shape_name].dims["d_feat"]
    return (replace(ref.model_cfg, d_feat=d_feat), replace(port.model_cfg, d_feat=d_feat),
            port.shapes[shape_name].dims)


def _batch(dims, seed=0):
    """Seeded numpy inputs of a reduced shape; the last quarter of the
    edges are padding (src = dst = 0, mask 0), as the steps pad them."""
    rng = np.random.default_rng(seed)
    lead = (dims["batch"],) if dims.get("batched") else ()
    N, E = dims["n_nodes"], dims["n_edges"]
    mask = np.ones(lead + (E,), np.float32)
    mask[..., 3 * E // 4:] = 0.0
    src = rng.integers(0, N, lead + (E,)).astype(np.int32) * (mask > 0)
    dst = rng.integers(0, N, lead + (E,)).astype(np.int32) * (mask > 0)
    node_mask = (rng.random(lead + (N,)) < 0.8).astype(np.float32)
    return {"feats": rng.normal(size=lead + (N, dims["d_feat"])).astype(np.float32),
            "coords": rng.normal(size=lead + (N, 3)).astype(np.float32),
            "src": src.astype(np.int32), "dst": dst.astype(np.int32), "edge_mask": mask,
            "node_mask": node_mask, "targets": rng.normal(size=lead + (N,)).astype(np.float32)}


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _setup(shape_name):
    jcfg, tcfg, dims = _cfgs(shape_name)
    jparams = jgnn.init_params(jcfg, jax.random.key(3))
    tparams = carry_params(jax.tree.map(np.asarray, jparams), device=CPU)
    batch = _batch(dims)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, tcfg, dims, jparams, tparams, jbatch, tbatch


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: v for k in sorted(tree) for n, v in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("shape_name", SHAPES)
def test_egnn_forward_matches_reference(shape_name):
    jcfg, tcfg, dims, jparams, tparams, jb, tb = _setup(shape_name)
    if dims.get("batched"):
        want = jgnn.batched_forward(jcfg, jparams, jb)
        got = tgnn.batched_forward(tcfg, tparams, tb)
    else:
        args = ("feats", "coords", "src", "dst", "edge_mask")
        want = jgnn.forward(jcfg, jparams, *(jb[k] for k in args))
        got = tgnn.forward(tcfg, tparams, *(tb[k] for k in args))
    for name, g, w in zip(("h", "coords", "energy"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, name)


@pytest.mark.parametrize("shape_name", SHAPES)
def test_egnn_loss_and_gradients_match_reference(shape_name):
    jcfg, tcfg, dims, jparams, tparams, jb, tb = _setup(shape_name)
    jloss_fn = jgnn.batched_loss if dims.get("batched") else jgnn.loss_fn
    tloss_fn = tgnn.batched_loss if dims.get("batched") else tgnn.loss_fn
    want_loss, want_grads = jax.value_and_grad(lambda p: jloss_fn(jcfg, p, jb))(jparams)
    got_loss, got_grads = value_and_grad(lambda p: tloss_fn(tcfg, p, tb), tparams)
    _close(got_loss, want_loss, "loss")
    want, got = _flat(jax.tree.map(np.asarray, want_grads)), _flat(got_grads)
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], name)


def test_egnn_equivariance():
    """test_smoke_archs.py's property on the port: rotating and translating
    the coordinates rotates and translates the coordinate outputs and
    leaves the node features invariant."""
    cfg = tgnn.EGNNConfig(n_layers=2, d_hidden=16, d_feat=8)
    params = tgnn.init_params(cfg, 0, device=CPU)
    rng = np.random.default_rng(0)
    N, E = 12, 30
    feats = torch.from_numpy(rng.normal(size=(N, 8)).astype(np.float32))
    coords = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, N, E).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, N, E).astype(np.int32))
    mask = torch.ones(E)
    Q = torch.from_numpy(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(1, 3)).astype(np.float32))
    h1, x1, _ = tgnn.forward(cfg, params, feats, coords, src, dst, mask)
    h2, x2, _ = tgnn.forward(cfg, params, feats, coords @ Q.T + t, src, dst, mask)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose((x1 @ Q.T + t).numpy(), x2.numpy(), rtol=2e-3, atol=2e-3)


def test_edge_sharded_egnn_waits_for_the_multi_device_slice():
    """The edge-sharded EGNN, once pinned to raise, on a (1, 2) CPU mesh:
    its forward, loss and gradients against the reference's unsharded
    ones (the same sums in two shards; the reference's sharded path is in
    ``tests/test_torch_multidevice.py``)."""
    from repro_torch.launch.mesh import make_mesh

    jcfg, tcfg, dims, jparams, tparams, jb, tb = _setup("full_graph_sm")
    mesh = make_mesh((1, 2), ("data", "model"), devices=[CPU] * 2)
    args = ("feats", "coords", "src", "dst", "edge_mask")
    want = jgnn.forward(jcfg, jparams, *(jb[k] for k in args))
    got = tgnn.forward(tcfg, tparams, *(tb[k] for k in args), mesh=mesh,
                       edge_axes=("data", "model"))
    for name, g, w in zip(("h", "coords", "energy"), got, want):
        _close(g, w, name)
    want_loss, want_grads = jax.value_and_grad(lambda p: jgnn.loss_fn(jcfg, p, jb))(jparams)
    got_loss, got_grads = value_and_grad(
        lambda p: tgnn.loss_fn(tcfg, p, tb, mesh=mesh, edge_axes=("data", "model")), tparams)
    _close(got_loss, want_loss, "loss")
    want, got = _flat(jax.tree.map(np.asarray, want_grads)), _flat(got_grads)
    for name in want:
        _close(got[name], want[name], name)


# -- the segment sum ------------------------------------------------------------
SEG_CASES = {  # name: (n terms, segments, width or None for 1-D data, id low, id high)
    "in range": (200, 17, 5, 0, 17),
    "dropped ids": (300, 20, 3, -3, 25),
    "one segment": (64, 4, 64, 2, 3),
    "1-D data": (150, 9, None, -1, 10),
    "wide": (90, 6, 300, 0, 6),
    "no terms": (0, 5, 4, 0, 5),
    # the kernel's long path: one segment just over LONG_TERMS, and three
    # segments of ~1,700 terms each, more than the ring's 8 stages of 128
    "just over the long threshold": (LONG_TERMS + 2, 1, 3, 0, 1),
    "long over several stages": (5000, 3, 64, -1, 4),
}


def _seg_inputs(case):
    n, R, C, lo, hi = SEG_CASES[case]
    rng = np.random.default_rng(len(case))
    ids = rng.integers(lo, hi, n).astype(np.int32)
    data = rng.normal(size=(n,) if C is None else (n, C)).astype(np.float32)
    return data, ids, R


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segment_sum_plain_equals_a_loop_in_index_order(case):
    data, ids, R = _seg_inputs(case)
    want = segment_sum_ref(data, ids, R)
    got = segment_sum_plain(torch.from_numpy(data), torch.from_numpy(ids), R)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(segment_sum(torch.from_numpy(data), torch.from_numpy(ids), R).numpy(),
                          want)


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segment_plan_is_a_stable_sort_with_segment_starts(case):
    _, ids, R = _seg_inputs(case)
    plan = segment_plan(torch.from_numpy(ids), R)
    keys = np.where((ids >= 0) & (ids < R), ids, R)
    assert np.array_equal(plan.order.numpy(), np.argsort(keys, kind="stable"))
    assert np.array_equal(plan.offsets.numpy(), np.searchsorted(np.sort(keys), np.arange(R + 1)))
    assert plan.order.dtype == plan.offsets.dtype == torch.int32


# autograd's own index backward on the CPU (index_put_ with accumulate)
# adds a segment of more than ~100 terms in another order than the index
# order, so it is the oracle for the short segments only; every case's
# gradient is held to the index-order loop below
GRAD_CASES = [c for c in SEG_CASES if SEG_CASES[c][1] > 0 and SEG_CASES[c][0] <= 300]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gather_and_segment_sum_gradients_match_autograd(case):
    data, ids, R = _seg_inputs(case)
    keep = (ids >= 0) & (ids < R)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(R,) + data.shape[1:]).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(int(keep.sum()),) + data.shape[1:]).astype(np.float32))
    inside = torch.from_numpy(ids[keep])
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    gather_rows(a, inside).backward(g)
    b[inside.long()].backward(g)
    assert torch.equal(a.grad, b.grad)
    d = torch.from_numpy(data)
    a, b = d.clone().requires_grad_(), d.clone().requires_grad_()
    go = torch.from_numpy(rng.normal(size=(R,) + data.shape[1:]).astype(np.float32))
    segment_sum(a, torch.from_numpy(ids), R).backward(go)
    out = torch.zeros((R,) + data.shape[1:])
    out.index_add(0, inside.long(), b[torch.from_numpy(keep)]).backward(go)
    assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("case", [c for c in SEG_CASES if SEG_CASES[c][1] > 0])
def test_gather_rows_gradient_adds_in_index_order(case):
    data, ids, R = _seg_inputs(case)
    keep = (ids >= 0) & (ids < R)
    g = data[keep]
    x = torch.zeros((R,) + data.shape[1:], requires_grad=True)
    gather_rows(x, torch.from_numpy(ids[keep])).backward(torch.from_numpy(g))
    assert np.array_equal(x.grad.numpy(), segment_sum_ref(g, ids[keep], R))


def test_segment_sum_refuses_other_types():
    with pytest.raises(TypeError, match="float32"):
        segment_sum(torch.zeros(3, 2, dtype=torch.float64), torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(TypeError, match="int32"):
        segment_sum(torch.zeros(3, 2), torch.zeros(3, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="num_segments"):
        segment_sum(torch.zeros(3, 2), torch.zeros(3, dtype=torch.int32), 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segment_sum_kernel_equals_plain_cuda(cuda, case):
    data, ids, R = _seg_inputs(case)
    before = segment_sum.launches
    got = segment_sum(torch.from_numpy(data).to(cuda), torch.from_numpy(ids).to(cuda), R)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    assert torch.equal(got.cpu(), segment_sum_plain(torch.from_numpy(data), torch.from_numpy(ids), R))


@pytest.mark.cuda
def test_egnn_gradient_is_the_same_in_two_runs_cuda(cuda):
    cfg = tgnn.EGNNConfig(n_layers=2, d_hidden=16, d_feat=8)
    params = tgnn.init_params(cfg, 0, device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in _batch({"n_nodes": 300, "n_edges": 3000, "d_feat": 8}).items()}
    runs = [value_and_grad(lambda p: tgnn.loss_fn(cfg, p, batch), params) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(_flat(runs[0][1]).values(), _flat(runs[1][1]).values()):
        assert torch.equal(a, b)
