"""RecSys architectures: BERT4Rec, SASRec, DIN, Two-Tower retrieval (the
reference's ``models/recsys.py``): serving, and the training losses
(``seqrec_loss``, ``din_loss``, ``twotower_loss``).

Embedding tables are unsharded here: a mesh whose model axis would
row-shard a table raises, and the sharded lookups come with the
multi-device model slice. The two-tower user tower reduces its history
with :func:`repro_torch.models.embedding.embedding_bag_sum`, the port's
embedding-bag kernel on a card, forward and backward. Retrieval's top-k is a stable descending
sort (the lower candidate first among equal scores, as ``lax.top_k``),
returning (scores, int32 indices).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models import layer_slice, make_generator, model_device, normal
from repro_torch.models.embedding import embedding_bag_sum, embedding_lookup
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


def _sharded(table, mesh) -> bool:
    tp = 1 if mesh is None else mesh.shape.get("model", 1)
    return tp > 1 and table.shape[0] % tp == 0


def _lookup(table, ids, mesh, dp_axes):
    if _sharded(table, mesh):
        raise NotImplementedError(
            "row-sharded embedding lookups over a model axis come with the "
            "multi-device model slice")
    return embedding_lookup(table, ids)


def _top_k(scores, k: int):
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


def seqrec_loss(cfg: SeqRecConfig, params, batch, mesh=None, dp_axes=("data",)):
    """Sampled softmax: target at slot 0 vs provided negatives."""
    u = seqrec_user_state(cfg, params, batch["hist"], mesh, dp_axes)
    cand = torch.cat([batch["target"][:, None], batch["negatives"]], dim=1)
    c = _lookup(params["item_emb"], cand, mesh, dp_axes)  # (B, 1+N, D)
    logits = torch.einsum("bd,bnd->bn", u, c).float()
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()


def seqrec_score(cfg: SeqRecConfig, params, batch, mesh=None, dp_axes=("data",)):
    """Score candidate items: hist (B,S) x candidates (B,C) -> (B,C)."""
    u = seqrec_user_state(cfg, params, batch["hist"], mesh, dp_axes)
    c = _lookup(params["item_emb"], batch["candidates"], mesh, dp_axes)
    return torch.einsum("bd,bcd->bc", u, c)


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


def din_loss(cfg: DINConfig, params, batch, mesh=None, dp_axes=("data",)):
    logit = din_forward(cfg, params, batch, mesh, dp_axes)
    y = batch["labels"].float()
    z = logit.float()
    # numerically stable BCE-with-logits
    return torch.mean(torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


def din_retrieval(cfg: DINConfig, params, batch, top_k: int = 100, mesh=None,
                  dp_axes=("data",), cand_pspec=None):
    """Score one user against C candidates (retrieval_cand shape): the
    history embedding is computed once -> (scores (1, k), ids (1, k))."""
    eh = _din_emb(cfg, params, batch["hist_items"], batch["hist_cates"], mesh, dp_axes)  # (1, S, d)
    et = _din_emb(cfg, params, batch["cand_items"], batch["cand_cates"], mesh, dp_axes)  # (C, d)
    C = et.shape[0]
    ehb = eh[0][None].expand((C,) + eh.shape[1:])  # (C, S, d)
    et_b = et[:, None, :]  # (C, 1, d)
    feats = torch.cat([ehb, et_b.expand_as(ehb), ehb - et_b, ehb * et_b], dim=-1)
    hist = batch["hist_items"][0][None, :].expand(C, -1)
    uf = batch["user_feats"].expand(C, batch["user_feats"].shape[-1])
    scores = _din_head(params, feats, hist, ehb, et, uf)
    return _top_k(scores[None, :], top_k)


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
    kernel on a card) and the user features -> (B, D), unit norm."""
    if _sharded(params["item_emb"], mesh):
        raise NotImplementedError(
            "the row-sharded embedding bag comes with the multi-device model slice")
    hist = embedding_bag_sum(params["item_emb"], batch["hist"])
    x = torch.cat([hist, batch["user_feats"].to(hist.dtype)], dim=-1)
    return _tower(params["user_tower"], x)


def twotower_item(cfg, params, item_ids, cate_ids, mesh=None, dp_axes=("data",)):
    ei = _lookup(params["item_emb"], item_ids, mesh, dp_axes)
    ec = _lookup(params["cate_emb"], cate_ids, mesh, dp_axes)
    return _tower(params["item_tower"], torch.cat([ei, ec], dim=-1))


def twotower_loss(cfg: TwoTowerConfig, params, batch, mesh=None, dp_axes=("data",)):
    """In-batch sampled softmax with logQ correction (Yi et al., RecSys'19):
    temperature 20, the diagonal of the (B, B) log-softmax."""
    u = twotower_user(cfg, params, batch, mesh, dp_axes)  # (B, D)
    v = twotower_item(cfg, params, batch["item"], batch["cate"], mesh, dp_axes)  # (B, D)
    logits = (u @ v.T).float() * 20.0  # temperature
    logits = logits - batch["log_q"][None, :]  # sampling correction
    return -torch.log_softmax(logits, dim=-1).diagonal().mean()


def twotower_score(cfg: TwoTowerConfig, params, batch, mesh=None, dp_axes=("data",)):
    """Pointwise (user, item) scoring for online serving."""
    u = twotower_user(cfg, params, batch, mesh, dp_axes)
    v = twotower_item(cfg, params, batch["item"], batch["cate"], mesh, dp_axes)
    return torch.sum(u * v, dim=-1)


def twotower_retrieve(cfg: TwoTowerConfig, params, batch, top_k: int = 100,
                      mesh=None, dp_axes=("data",), cand_pspec=None):
    """One query against a large candidate set: the item tower over every
    candidate, then a (1, C) score vector and its top-k."""
    u = twotower_user(cfg, params, batch, mesh, dp_axes)  # (1, D)
    v = twotower_item(cfg, params, batch["cand_items"], batch["cand_cates"], mesh, dp_axes)
    scores = torch.einsum("qd,cd->qc", u, v)
    return _top_k(scores, top_k)
