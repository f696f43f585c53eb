"""RecSys architectures: BERT4Rec, SASRec, DIN, Two-Tower retrieval (the
reference's ``models/recsys.py``): serving, and the training losses
(``seqrec_loss``, ``din_loss``, ``twotower_loss``).

With a mesh whose model axis is larger than 1, the lookups of a table
whose rows split over it are row-sharded
(:func:`repro_torch.models.embedding.sharded_embedding_lookup`), as the
reference's ``_lookup`` shards them; a table may come as a plain tensor
or as the :class:`Sharded` that the built steps place
(:func:`row_sharded`, the reference's ``_recsys_param_pspecs`` rule).
The two-tower user tower reduces its history with the port's
embedding-bag kernel on a card, forward and backward: unsharded through
:func:`repro_torch.models.embedding.embedding_bag_sum`, and over a model
axis larger than 1 once per table shard through
:func:`repro_torch.models.embedding.sharded_embedding_bag`. Retrieval's
top-k is a stable descending sort (the lower candidate first among equal
scores, as ``lax.top_k``), returning (scores, int32 indices).

The model functions (the losses, ``*_forward``/``*_score`` and the
retrievals) are one data shard's pieces: given a mesh of several data
shards they split only the lookups' ids over them, as the reference's
``shard_map`` does (``models/embedding.py``), and run the dense layers
on the lead device. The built steps compose them over a mesh's data
shards (:class:`DataShards`), one (1, model) row of the grid at a time:
data shard d takes its rows (retrieval: its candidates) on its lead
device, looks them up over its own row of table blocks and runs its
dense layers there; outputs meet on the mesh's lead device in shard
order. The losses are per-row means, assembled from each data shard's
sum (:func:`twotower_loss_over`: the in-batch softmax over every data
shard's item vectors).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.parallel import Sharded, concat_to_lead, gather_blocks, replicate, sum_to_lead
from repro_torch.models import layer_slice, make_generator, model_device, normal
from repro_torch.models.embedding import (
    embedding_bag_sum,
    embedding_lookup,
    sharded_embedding_bag,
    sharded_embedding_lookup,
    table_blocks,
)
from repro_torch.models.layers import (
    apply_norm,
    attention_block,
    dense,
    init_attention,
    init_dense,
    init_mlp,
    init_norm,
    mlp_block,
)
from repro_torch.models.moe import top_k_stable

NEG_MASK = -1e30


def row_sharded(name: str, shape, tp: int) -> bool:
    """Whether a built step keeps a parameter row-sharded over a model axis
    of ``tp``: an embedding table (``emb`` in its name, 2-D) whose rows
    divide by ``tp`` and make at least 64 a shard (the reference's
    ``_recsys_param_pspecs``)."""
    return (tp > 1 and "emb" in name and len(shape) == 2 and shape[0] % tp == 0
            and shape[0] >= 64 * tp)


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)


def _lookup(table, ids, mesh, dp_axes, ids_pspec=None):
    """The reference's ``_lookup``: sharded over the model axis when it is
    larger than 1 and divides the rows."""
    if isinstance(table, Sharded) or (_tp(mesh) > 1 and table.shape[0] % _tp(mesh) == 0):
        return sharded_embedding_lookup(table, ids, mesh, dp_axes=dp_axes, ids_pspec=ids_pspec)
    return embedding_lookup(table, ids)


def top_k_scores(scores, k: int):
    """``lax.top_k``: (values, int32 indices) of the k largest along the
    last axis, the lower index first among equal values."""
    values, idx = top_k_stable(scores, k)
    return values, idx.to(torch.int32)


# ==========================================================================
# Sequential recommenders (BERT4Rec / SASRec)
# ==========================================================================
@dataclass(frozen=True)
class SeqRecConfig:
    name: str
    n_items: int
    embed_dim: int
    n_blocks: int
    n_heads: int
    seq_len: int
    causal: bool  # SASRec: True; BERT4Rec: False (bidirectional)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads


def seqrec_init(cfg: SeqRecConfig, generator=0, *, device=None):
    device = model_device(device)
    gen = make_generator(generator, device)
    n, d = cfg.n_blocks, cfg.embed_dim
    return {
        "item_emb": normal((cfg.n_items, d), 0.02, gen, device),
        "pos_emb": normal((cfg.seq_len, d), 0.02, gen, device),
        "final_ln": init_norm(d, "layernorm", device=device),
        "blocks": {
            "ln1": init_norm(d, "layernorm", device=device, stack=(n,)),
            "ln2": init_norm(d, "layernorm", device=device, stack=(n,)),
            "attn": init_attention(d, cfg.n_heads, cfg.n_heads, cfg.head_dim, True,
                                   generator=gen, device=device, stack=(n,)),
            "mlp": init_mlp(d, 4 * d, generator=gen, device=device, stack=(n,)),
        },
    }


def seqrec_user_state(cfg: SeqRecConfig, params, hist, mesh=None, dp_axes=("data",)):
    """hist (B, S) item ids (-1 pad) -> user state (B, D)."""
    x = _lookup(params["item_emb"], hist, mesh, dp_axes)
    x = x + params["pos_emb"][None, : x.shape[1]].to(x.dtype)
    for i in range(params["blocks"]["ln1"]["scale"].shape[0]):
        p_b = layer_slice(params["blocks"], i)
        h, _ = attention_block(
            p_b["attn"],
            apply_norm(x, p_b["ln1"], "layernorm"),
            n_heads=cfg.n_heads,
            n_kv=cfg.n_heads,
            d_head=cfg.head_dim,
            rotary_pct=0.0,
            causal=cfg.causal,
        )
        x = x + h
        x = x + mlp_block(p_b["mlp"], apply_norm(x, p_b["ln2"], "layernorm"))
    x = apply_norm(x, params["final_ln"], "layernorm")
    return x[:, -1]  # next-item state


def seqrec_row_losses(cfg: SeqRecConfig, params, batch, mesh=None, dp_axes=("data",)):
    """Each row's sampled-softmax loss: target at slot 0 vs provided
    negatives -> (B,)."""
    u = seqrec_user_state(cfg, params, batch["hist"], mesh, dp_axes)
    cand = torch.cat([batch["target"][:, None], batch["negatives"]], dim=1)
    c = _lookup(params["item_emb"], cand, mesh, dp_axes)  # (B, 1+N, D)
    logits = torch.einsum("bd,bnd->bn", u, c).float()
    return -torch.log_softmax(logits, dim=-1)[:, 0]


def seqrec_loss(cfg: SeqRecConfig, params, batch, mesh=None, dp_axes=("data",)):
    """Sampled softmax: target at slot 0 vs provided negatives."""
    return seqrec_row_losses(cfg, params, batch, mesh, dp_axes).mean()


def seqrec_user(cfg: SeqRecConfig, params, batch, mesh=None, dp_axes=("data",)):
    return seqrec_user_state(cfg, params, batch["hist"], mesh, dp_axes)


def seqrec_candidate_scores(cfg: SeqRecConfig, params, u, batch, mesh=None,
                            dp_axes=("data",)):
    """The user states ``u`` (B, D) against candidates (B, C) -> (B, C)."""
    c = _lookup(params["item_emb"], batch["candidates"], mesh, dp_axes)
    return torch.einsum("bd,bcd->bc", u, c)


def seqrec_score(cfg: SeqRecConfig, params, batch, mesh=None, dp_axes=("data",)):
    """Score candidate items: hist (B,S) x candidates (B,C) -> (B,C)."""
    u = seqrec_user(cfg, params, batch, mesh, dp_axes)
    return seqrec_candidate_scores(cfg, params, u, batch, mesh, dp_axes)


# ==========================================================================
# DIN — Deep Interest Network (target attention CTR model)
# ==========================================================================
@dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 10_000_000
    n_cates: int = 100_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    d_user: int = 16


def din_init(cfg: DINConfig, generator=0, *, device=None):
    device = model_device(device)
    gen = make_generator(generator, device)
    d = cfg.embed_dim * 2  # item ++ cate
    kw = {"generator": gen, "device": device}
    return {
        "item_emb": normal((cfg.n_items, cfg.embed_dim), 0.02, gen, device),
        "cate_emb": normal((cfg.n_cates, cfg.embed_dim), 0.02, gen, device),
        "attn1": init_dense(4 * d, cfg.attn_mlp[0], **kw),
        "attn2": init_dense(cfg.attn_mlp[0], cfg.attn_mlp[1], **kw),
        "attn3": init_dense(cfg.attn_mlp[1], 1, **kw),
        "mlp1": init_dense(3 * d + cfg.d_user, cfg.mlp[0], **kw),
        "mlp2": init_dense(cfg.mlp[0], cfg.mlp[1], **kw),
        "out": init_dense(cfg.mlp[1], 1, **kw),
    }


def _din_emb(cfg, params, items, cates, mesh, dp_axes):
    ei = _lookup(params["item_emb"], items, mesh, dp_axes)
    ec = _lookup(params["cate_emb"], cates, mesh, dp_axes)
    return torch.cat([ei, ec], dim=-1)


def _din_head(params, feats, hist_items, eh, et, user_feats):
    """Target attention over the history, then the MLP: feats (N, S, 4d)
    -> logits (N,)."""
    a = F.silu(dense(params["attn1"], feats))
    a = F.silu(dense(params["attn2"], a))
    w = dense(params["attn3"], a)[..., 0]  # (N, S) target-attention weights
    w = torch.where(hist_items >= 0, w, NEG_MASK)
    w = torch.softmax(w.float(), dim=-1).to(eh.dtype)
    interest = torch.einsum("bs,bsd->bd", w, eh)
    z = torch.cat([interest, et, interest * et, user_feats.to(et.dtype)], dim=-1)
    z = F.silu(dense(params["mlp1"], z))
    z = F.silu(dense(params["mlp2"], z))
    return dense(params["out"], z)[:, 0]


def din_forward(cfg: DINConfig, params, batch, mesh=None, dp_axes=("data",)):
    """batch: hist_items/cates (B,S), target_item/cate (B,), user_feats (B,d_user)."""
    eh = _din_emb(cfg, params, batch["hist_items"], batch["hist_cates"], mesh, dp_axes)
    et = _din_emb(cfg, params, batch["target_item"], batch["target_cate"], mesh, dp_axes)
    et_b = et[:, None, :]  # (B, 1, d)
    feats = torch.cat([eh, et_b.expand_as(eh), eh - et_b, eh * et_b], dim=-1)
    return _din_head(params, feats, batch["hist_items"], eh, et, batch["user_feats"])


def din_row_losses(cfg: DINConfig, params, batch, mesh=None, dp_axes=("data",)):
    """Each row's BCE-with-logits (numerically stable) -> (B,)."""
    logit = din_forward(cfg, params, batch, mesh, dp_axes)
    y = batch["labels"].float()
    z = logit.float()
    return torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))


def din_loss(cfg: DINConfig, params, batch, mesh=None, dp_axes=("data",)):
    return torch.mean(din_row_losses(cfg, params, batch, mesh, dp_axes))


def din_user(cfg: DINConfig, params, batch, mesh=None, dp_axes=("data",)):
    """Retrieval's one history embedding (1, S, d), its lookups unsplit."""
    unsplit = (None, None)
    return torch.cat([_lookup(params["item_emb"], batch["hist_items"], mesh, dp_axes, unsplit),
                      _lookup(params["cate_emb"], batch["hist_cates"], mesh, dp_axes, unsplit)],
                     dim=-1)


def din_candidate_scores(cfg: DINConfig, params, eh, batch, mesh=None, dp_axes=("data",),
                         cand_pspec=None):
    """The history embedding ``eh`` (1, S, d) against the C candidates, their
    lookups split as ``cand_pspec`` says -> scores (C,)."""
    et = torch.cat([_lookup(params["item_emb"], batch["cand_items"], mesh, dp_axes, cand_pspec),
                    _lookup(params["cate_emb"], batch["cand_cates"], mesh, dp_axes, cand_pspec)],
                   dim=-1)  # (C, d)
    C = et.shape[0]
    ehb = eh[0][None].expand((C,) + eh.shape[1:])  # (C, S, d)
    et_b = et[:, None, :]  # (C, 1, d)
    feats = torch.cat([ehb, et_b.expand_as(ehb), ehb - et_b, ehb * et_b], dim=-1)
    hist = batch["hist_items"][0][None, :].expand(C, -1)
    uf = batch["user_feats"].expand(C, batch["user_feats"].shape[-1])
    return _din_head(params, feats, hist, ehb, et, uf)


def din_retrieval(cfg: DINConfig, params, batch, top_k: int = 100, mesh=None,
                  dp_axes=("data",), cand_pspec=None):
    """Score one user against C candidates (retrieval_cand shape): the
    history embedding is computed once, the candidates' lookups split as
    ``cand_pspec`` says -> (scores (1, k), ids (1, k))."""
    eh = din_user(cfg, params, batch, mesh, dp_axes)
    scores = din_candidate_scores(cfg, params, eh, batch, mesh, dp_axes, cand_pspec)
    return top_k_scores(scores[None, :], top_k)


# ==========================================================================
# Two-tower retrieval
# ==========================================================================
@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_items: int = 10_000_000
    n_cates: int = 100_000
    embed_dim: int = 256
    tower: tuple = (1024, 512, 256)
    hist_len: int = 50
    d_user: int = 64


def twotower_init(cfg: TwoTowerConfig, generator=0, *, device=None):
    device = model_device(device)
    gen = make_generator(generator, device)
    d = cfg.embed_dim

    def tower(d_in):
        dims = (d_in,) + tuple(cfg.tower)
        return {f"l{i + 1}": init_dense(dims[i], dims[i + 1], generator=gen, device=device)
                for i in range(3)}

    return {
        "item_emb": normal((cfg.n_items, d), 0.02, gen, device),
        "cate_emb": normal((cfg.n_cates, d), 0.02, gen, device),
        "user_tower": tower(d + cfg.d_user),
        "item_tower": tower(2 * d),
    }


def _tower(p, x):
    x = F.silu(dense(p["l1"], x))
    x = F.silu(dense(p["l2"], x))
    x = dense(p["l3"], x)
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-6)


def twotower_user(cfg, params, batch, mesh=None, dp_axes=("data",), bag_pspec=None):
    """The user tower over the history's bag-sum (the embedding-bag
    kernel on a card; once per table shard over a model axis larger than
    1, whose size must divide the rows) and the user features -> (B, D),
    unit norm."""
    table = params["item_emb"]
    if isinstance(table, Sharded) or _tp(mesh) > 1:
        hist = sharded_embedding_bag(table, batch["hist"], mesh, dp_axes=dp_axes,
                                     ids_pspec=bag_pspec)
    else:
        hist = embedding_bag_sum(table, batch["hist"])
    x = torch.cat([hist, batch["user_feats"].to(hist.dtype)], dim=-1)
    return _tower(params["user_tower"], x)


def twotower_item(cfg, params, item_ids, cate_ids, mesh=None, dp_axes=("data",)):
    ei = _lookup(params["item_emb"], item_ids, mesh, dp_axes)
    ec = _lookup(params["cate_emb"], cate_ids, mesh, dp_axes)
    return _tower(params["item_tower"], torch.cat([ei, ec], dim=-1))


def _in_batch_log_softmax(u, v, log_q):
    """The (rows of u, B) log-softmax of the in-batch logits: temperature
    20, then the logQ sampling correction."""
    logits = (u @ v.T).float() * 20.0  # temperature
    logits = logits - log_q[None, :]  # sampling correction
    return torch.log_softmax(logits, dim=-1)


def twotower_loss(cfg: TwoTowerConfig, params, batch, mesh=None, dp_axes=("data",)):
    """In-batch sampled softmax with logQ correction (Yi et al., RecSys'19):
    temperature 20, the diagonal of the (B, B) log-softmax."""
    u = twotower_user(cfg, params, batch, mesh, dp_axes)  # (B, D)
    v = twotower_item(cfg, params, batch["item"], batch["cate"], mesh, dp_axes)  # (B, D)
    return -_in_batch_log_softmax(u, v, batch["log_q"]).diagonal().mean()


def twotower_score(cfg: TwoTowerConfig, params, batch, mesh=None, dp_axes=("data",)):
    """Pointwise (user, item) scoring for online serving."""
    u = twotower_user(cfg, params, batch, mesh, dp_axes)
    v = twotower_item(cfg, params, batch["item"], batch["cate"], mesh, dp_axes)
    return torch.sum(u * v, dim=-1)


def twotower_query(cfg, params, batch, mesh=None, dp_axes=("data",)):
    """Retrieval's one user vector (1, D), its history's bag unsplit."""
    return twotower_user(cfg, params, batch, mesh, dp_axes, bag_pspec=(None, None))


def twotower_candidate_scores(cfg, params, u, batch, mesh=None, dp_axes=("data",),
                              cand_pspec=None):
    """The user vector ``u`` (1, D) against the item tower over every
    candidate, their lookups split as ``cand_pspec`` says -> (1, C)."""
    if isinstance(params["item_emb"], Sharded) or _tp(mesh) > 1:
        ei, ec = (sharded_embedding_lookup(params[name], batch[ids], mesh, dp_axes=dp_axes,
                                           ids_pspec=cand_pspec)
                  for name, ids in (("item_emb", "cand_items"), ("cate_emb", "cand_cates")))
        v = _tower(params["item_tower"], torch.cat([ei, ec], dim=-1))
    else:
        v = twotower_item(cfg, params, batch["cand_items"], batch["cand_cates"])
    return torch.einsum("qd,cd->qc", u, v)


def twotower_retrieve(cfg: TwoTowerConfig, params, batch, top_k: int = 100,
                      mesh=None, dp_axes=("data",), cand_pspec=None):
    """One query against a large candidate set: the item tower over every
    candidate, then a (1, C) score vector and its top-k."""
    u = twotower_query(cfg, params, batch, mesh, dp_axes)
    scores = twotower_candidate_scores(cfg, params, u, batch, mesh, dp_axes, cand_pspec)
    return top_k_scores(scores, top_k)


# ==========================================================================
# Data parallelism: a built step over a mesh's data shards
# ==========================================================================
class DataShards:
    """A recsys step's data shards on a mesh's (data, model) grid, as the
    reference's ``batch_pspec`` places a batch: data shard d takes its
    rows (or candidates) on its lead device ``grid[d, 0]``, runs its
    lookups and bags over its own row of table blocks (``meshes[d]``, the
    (1, model) mesh of ``grid[d]``; None where the step row-shards no
    table, as the reference passes no mesh then) and its dense layers on
    its lead device; results meet on the mesh's lead device in shard
    order. One data shard, or a batch that does not split, is computed
    once on the lead device (``once``)."""

    def __init__(self, mesh, lookups: bool):
        grid = mesh.grid()
        self.mesh, self.lead, self.dp = mesh, mesh.lead, grid.shape[0]
        self.leads = [grid[d, 0] for d in range(self.dp)]
        self.meshes = [mesh.data_row(d) if lookups else None for d in range(self.dp)]
        self.dp_axes = ("data",)  # a data row's own axis

    def params(self, params, n: int) -> list:
        """The first ``n`` data shards' parameters, [d]: a row-sharded
        table (a ``Sharded`` split along its rows) as data shard d's row of
        blocks (``embedding.table_blocks``: its own replicas, or one row's
        blocks replicated onto its devices); a leaf kept once per data
        shard, data shard d's replica; a plain tensor ``replicate``d onto
        each lead device (a view where the device is its own), so a
        gradient used on several data shards is added in shard order."""
        def per_leaf(x):
            if isinstance(x, Sharded) and x.axes == (None, 0):
                blocks = table_blocks(x, self.mesh, n)
                return [Sharded([col[d] for col in blocks]) for d in range(n)]
            if isinstance(x, Sharded):
                return [x.block(d, 0) for d in range(n)]
            return replicate(x, self.leads[:n])

        def walk(tree):
            if isinstance(tree, dict):
                per = {k: walk(v) for k, v in tree.items()}
                return [{k: v[d] for k, v in per.items()} for d in range(n)]
            return per_leaf(tree)

        return walk(params)

    def split(self, batch: dict, axes: dict) -> list:
        """Each data shard's batch on its lead device: the entries named in
        ``axes`` split along their axis, the rest whole."""
        parts = {k: v.chunk(self.dp, axes[k]) for k, v in batch.items() if k in axes}
        return [{k: (parts[k][d] if k in parts else v).to(lead) for k, v in batch.items()}
                for d, lead in enumerate(self.leads)]

    def once(self, fn, params, batch):
        """``fn(params, batch, mesh, dp_axes)`` once, on the lead device over
        the first data shard's blocks."""
        return fn(self.params(params, 1)[0], batch, self.meshes[0], self.dp_axes)

    def over_rows(self, fn, params, batch: dict) -> list:
        """``fn(params, batch, mesh, dp_axes)`` on each data shard's rows, [d]."""
        ps = self.params(params, self.dp)
        rows = self.split(batch, {k: 0 for k in batch})
        return [fn(p, b, m, self.dp_axes) for p, b, m in zip(ps, rows, self.meshes)]

    def concat(self, outs: list, axis: int = 0):
        return concat_to_lead(outs, axis, self.lead)

    def mean(self, row_losses, params, batch: dict):
        """The mean of ``row_losses`` over the batch: each data shard's sum
        of its rows' losses, the sums added in shard order on the lead."""
        parts = [x.sum() for x in self.over_rows(row_losses, params, batch)]
        return sum_to_lead(parts, self.lead) / next(iter(batch.values())).shape[0]

    def over_candidates(self, user, scores, params, batch: dict, cand_axes: dict):
        """Retrieval with its candidates split over the data shards (one
        user): ``user(params, batch, mesh, dp_axes)`` once on the lead
        device, its result ``replicate``d to each data shard, which scores
        its candidates with ``scores(params, state, batch, mesh, dp_axes)``;
        the scores concatenated along their last axis on the lead."""
        ps = self.params(params, self.dp)
        states = replicate(user(ps[0], batch, self.meshes[0], self.dp_axes), self.leads)
        outs = [scores(p, s, b, m, self.dp_axes) for p, s, b, m in
                zip(ps, states, self.split(batch, cand_axes), self.meshes)]
        return self.concat(outs, -1)


def twotower_loss_over(cfg: TwoTowerConfig, params, batch, shards: DataShards):
    """:func:`twotower_loss` with the batch's rows over the data shards:
    each computes its users' and items' vectors, ``gather_blocks`` hands
    every data shard all B item vectors (and log Q) in shard order, data
    shard d takes its (B/dp, B) log-softmax and its diagonal block at
    offset d B/dp, and the shards' sums are added in shard order on the
    lead device, then divided by B."""
    rows = shards.split(batch, {k: 0 for k in batch})
    ps = shards.params(params, shards.dp)
    us, vs = [], []
    for p, b, m in zip(ps, rows, shards.meshes):
        us.append(twotower_user(cfg, p, b, m, shards.dp_axes))
        vs.append(twotower_item(cfg, p, b["item"], b["cate"], m, shards.dp_axes))
    n = len(vs)
    everywhere = lambda xs: gather_blocks(  # noqa: E731 — by shard index: n - 1 blocks each
        xs, 0, shards.leads, ((n - 1) * sum(x.numel() * x.element_size() for x in xs),
                              n * (n - 1)))
    v_all, q_all = everywhere(vs), everywhere([b["log_q"] for b in rows])
    k = us[0].shape[0]
    parts = [-_in_batch_log_softmax(u, v, q).narrow(1, d * k, k).diagonal().sum()
             for d, (u, v, q) in enumerate(zip(us, v_all, q_all))]
    return sum_to_lead(parts, shards.lead) / (k * n)
