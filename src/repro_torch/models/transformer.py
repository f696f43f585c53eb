"""Decoder-only transformer LM covering the assigned dense + MoE configs
(StableLM-2-1.6B, CodeQwen1.5-7B, Qwen1.5-32B, Phi-3.5-MoE, Granite-MoE);
the reference's ``models/transformer.py``, serving side.

* the stacked layer axis is walked by a Python loop where the reference
  runs ``lax.scan``;
* GQA with optional QKV bias (Qwen) and partial rotary (StableLM);
* MoE blocks via :mod:`repro_torch.models.moe`: the dense oracle without
  a mesh, capacity dispatch on one;
* entry points: ``forward``, ``prefill``, ``decode_step``, with bf16 and
  int8 (``quantized=True``) KV caches from ``init_cache``.

Training: ``lm_loss`` and ``lm_grads_microbatched``, gradients from
``torch.autograd``. With ``cfg.remat`` each layer of ``forward`` runs
under ``torch.utils.checkpoint`` where the reference wraps its scan body
in ``jax.checkpoint`` (the chunked attention also checkpoints its inner
block), so the backward holds one layer's intermediates at a time.

Over a mesh (``launch/mesh.py``, one process driving every device) of
more than one (data, model) shard the entry points run Megatron tensor
parallelism (a mesh of one shard runs the one-device path):
:func:`param_pspecs` and :func:`cache_pspecs` are the reference's
placement rules (departures named there), a data shard's residual stream
stays on its first device, and each layer's model shards run on their
devices: attention by whole q heads with the kv heads they read (shared
where ``n_kv % tp != 0``) or, where whole heads do not split (Qwen's 40
at tp 16), inside heads with the cache split by positions (:class:`_Plan`),
the MLP by ``d_ff`` columns, MoE experts expert-parallel
(``moe.moe_block``); their partials meet through ``parallel.sum_to_lead``
in shard order. The embedding is vocab-sharded
(``embedding.lookup_row``) and the loss vocab-parallel
(:func:`_token_losses`): no device holds the whole (B, S, V) float32
logits. A parameter is a tensor or a ``parallel.Sharded`` grid of blocks
(FSDP rows over the data shards or a replica per data shard, TP columns),
which ``parallel.MeshPlan`` hands to each shard, gathered inside the
layer that uses it (``parallel.gather_blocks``, under the layer's
remat), so every sum across shards, forward and backward, has one fixed
order and a sharded train step replays bit for bit. The reference's
``_constrain`` (activation placement for GSPMD) and ``_opt_barrier`` (an
identity with an identity gradient that pins XLA's scheduling) have no
counterpart.
``decode_step`` writes into the caches it is given and returns them: the
reference's step donates its caches, and a full-width cache (26 GB at
32k tokens) leaves no room for a second copy.
Each layer loop marks its boundaries for a cost count's live-bytes
profile (``obs/cost.py`` ``layer_boundary``; nothing outside a count).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models import (
    layer_slice,
    make_generator,
    model_device,
    normal,
    remat,
    torch_dtype,
    tree_map,
    unstack,
    value_and_grad,
)
from repro_torch.models.layers import (
    NEG_MASK,
    _cache_start,
    _write,
    apply_norm,
    apply_rotary,
    attention_block,
    gqa_attention,
    init_attention,
    init_mlp,
    init_norm,
    mlp_block,
    quantize_kv,
    rotary_angles,
)
from repro_torch.models.embedding import lookup_row
from repro_torch.models.moe import MoEConfig, init_moe, moe_block, moe_block_dense_ref
from repro_torch.obs.cost import layer_boundary
from repro_torch.parallel import MeshPlan, Sharded, all_to_all, replicate, sum_to_lead


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # or "layernorm"
    rotary_pct: float = 1.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    remat: bool = True
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Megatron-style vocab padding: embedding/lm-head tensors round the
        vocab up to a multiple of 256. Logical vocab stays cfg.vocab."""
        return -(-self.vocab // 256) * 256

    def param_count(self) -> int:
        D, H, Kv, Dh, F, V, L = (
            self.d_model, self.n_heads, self.n_kv, self.head_dim,
            self.d_ff, self.vocab, self.n_layers,
        )
        attn = D * H * Dh + 2 * D * Kv * Dh + H * Dh * D
        if self.qkv_bias:
            attn += H * Dh + 2 * Kv * Dh
        if self.moe is not None:
            E, Fe = self.moe.n_experts, self.moe.d_ff_expert
            ffn = D * E + E * (2 * D * Fe + Fe * D)
        else:
            ffn = 3 * D * F
        norms = 2 * D * (2 if self.norm == "layernorm" else 1)
        embed = V * D * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn + norms) + embed + D

    def active_param_count(self) -> int:
        """For MoE: params touched per token (6*N_active*D flops rule)."""
        if self.moe is None:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        E, Fe, k = self.moe.n_experts, self.moe.d_ff_expert, self.moe.top_k
        total = self.param_count()
        ffn_all = L * E * 3 * D * Fe
        ffn_active = L * k * 3 * D * Fe
        return total - ffn_all + ffn_active


def _layer_init(cfg: TransformerConfig, *, generator, device, stack=()):
    p = {
        "ln1": init_norm(cfg.d_model, cfg.norm, device=device, stack=stack),
        "ln2": init_norm(cfg.d_model, cfg.norm, device=device, stack=stack),
        "attn": init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.qkv_bias,
                               generator=generator, device=device, stack=stack),
    }
    if cfg.moe is not None:
        p["moe"] = init_moe(cfg.d_model, cfg.moe, generator=generator, device=device, stack=stack)
    else:
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, generator=generator, device=device, stack=stack)
    return p


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def init_params(cfg: TransformerConfig, generator=0, *, device=None, dtype=torch.float32):
    """Random weights with the reference's shapes, names and scales,
    drawn from ``generator`` (a ``torch.Generator`` or a seed) on
    ``device`` (the card unless the caller names another; ``"meta"``
    gives shapes only). Layer parameters are stacked along a leading
    ``n_layers`` axis. ``dtype`` casts every floating parameter (serving
    keeps bf16 weights, as the reference's step builder does)."""
    device = model_device(device)
    gen = make_generator(generator, device)
    params = {
        "embed": normal((cfg.vocab_padded, cfg.d_model), 0.02, gen, device),
        "layers": _layer_init(cfg, generator=gen, device=device, stack=(cfg.n_layers,)),
        "final_norm": init_norm(cfg.d_model, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_padded), 1.0 / np.sqrt(cfg.d_model),
                                   gen, device)
    return _cast(params, dtype)


# --------------------------------------------------------------------------
# sharding rules (Megatron TP over `model`; FSDP over `data`, launch/steps.py)
# --------------------------------------------------------------------------
def attention_splits(cfg: TransformerConfig, tp: int) -> bool:
    """Whether attention splits over ``tp`` model shards by whole q heads,
    each shard's heads reading whole kv heads of their own or all reading
    one kv head that several shards share. Where it does not (Qwen's 40
    heads at tp 16), attention splits inside heads (:class:`_Plan`)."""
    if cfg.n_heads % tp:
        return False
    h, g = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv
    return h % g == 0 or g % h == 0


def head_spans(cfg: TransformerConfig, tp: int) -> tuple:
    """([(first, stop) q heads], [(first, stop) kv heads]) of each of ``tp``
    model shards, where attention splits by whole heads: shard r's q heads
    and the kv heads they read (shared where ``n_kv % tp != 0``)."""
    h, g = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv
    q = [(r * h, (r + 1) * h) for r in range(tp)]
    return q, [(a // g, (b - 1) // g + 1) for a, b in q]


def param_pspecs(cfg: TransformerConfig, tp: int = 1, stacked: bool = True):
    """The reference's placement rules, a tree like ``init_params`` of
    tuples (a ``PartitionSpec``'s entries): ``"model"`` on the axis a leaf
    splits over the model shards, None elsewhere. q columns split where
    ``n_heads * d_head`` divides, kv columns where ``n_kv * d_head`` does.

    Departure from the reference: where whole q heads split but
    ``n_kv % tp != 0`` (phi and granite at tp 16), ``wk``/``wv``/``bk``/
    ``bv`` are kept whole and each shard takes the kv heads its q heads
    read, where the reference splits kv columns inside a head. The outputs
    are the same."""
    lead = (None,) if stacked else ()
    m = "model"

    def spec(*axes):
        return lead + axes

    dh = cfg.head_dim
    q_shard = m if (cfg.n_heads * dh) % tp == 0 else None
    if attention_splits(cfg, tp):
        kv_shard = m if cfg.n_kv % tp == 0 else None
    else:
        kv_shard = m if (cfg.n_kv * dh) % tp == 0 else None
    ff_shard = m if cfg.d_ff % tp == 0 else None
    attn = {"wq": spec(None, q_shard), "wk": spec(None, kv_shard),
            "wv": spec(None, kv_shard), "wo": spec(q_shard, None)}
    if cfg.qkv_bias:
        attn.update(bq=spec(q_shard), bk=spec(kv_shard), bv=spec(kv_shard))
    norm = {"scale": spec(None)}
    if cfg.norm == "layernorm":
        norm["bias"] = spec(None)
    layer = {"ln1": dict(norm), "ln2": dict(norm), "attn": attn}
    if cfg.moe is not None:
        e_shard = m if cfg.moe.n_experts % tp == 0 else None
        layer["moe"] = {"router": spec(None, None), "w_gate": spec(e_shard, None, None),
                        "w_up": spec(e_shard, None, None), "w_down": spec(e_shard, None, None)}
    else:
        layer["mlp"] = {"w_gate": spec(None, ff_shard), "w_up": spec(None, ff_shard),
                        "w_down": spec(ff_shard, None)}
    v_shard = m if cfg.vocab_padded % tp == 0 else None
    out = {"embed": (v_shard, None), "layers": layer,
           "final_norm": {k: (None,) for k in norm}}
    if not cfg.tie_embeddings:
        out["lm_head"] = (None, v_shard)
    return out


def cache_pspecs(cfg: TransformerConfig, tp: int, dp_axes, seq_len: int | None = None,
                 quantized: bool = False):
    """The KV cache's placement, as the reference's tuples: the batch over
    ``dp_axes``; where attention splits by whole heads, the kv heads over
    the model shards, one contiguous block per shard holding the kv heads
    its q heads read; elsewhere the sequence axis over the model shards
    where ``seq_len`` divides, else no split over them. Departure: where
    whole heads split but ``n_kv % tp != 0``, shards that share a kv head
    each hold it, where the reference shards the sequence axis."""
    dp = tuple(dp_axes) if not isinstance(dp_axes, str) else (dp_axes,)
    dp = dp[0] if len(dp) == 1 else dp  # as a PartitionSpec normalises one name
    if attention_splits(cfg, tp):
        s = (None, dp, None, "model", None)
    elif seq_len is not None and seq_len % tp == 0:
        s = (None, dp, "model", None, None)
    else:
        s = (None, dp, None, None, None)
    out = {"k": s, "v": s}
    if quantized:
        out["k_scale"] = out["v_scale"] = s[:-1]
    return out


# --------------------------------------------------------------------------
# forward passes, one device
# --------------------------------------------------------------------------
def _one_device(mesh) -> bool:
    """Whether a step over ``mesh`` runs the one-device path: no mesh, or
    a grid of one (data, model) shard."""
    return mesh is None or mesh.grid().shape == (1, 1)


def _block(cfg: TransformerConfig, plan: MeshPlan | None = None):
    """One layer on one device; an MoE layer by capacity dispatch over
    ``plan`` (a mesh of one shard) where there is one, else through the
    dense oracle."""
    def block(x, p_l, cache_l=None, position=0):
        h, new_cache = attention_block(
            p_l["attn"],
            apply_norm(x, p_l["ln1"], cfg.norm),
            n_heads=cfg.n_heads,
            n_kv=cfg.n_kv,
            d_head=cfg.head_dim,
            rotary_pct=cfg.rotary_pct,
            cache=cache_l,
            position=position,
        )
        x = x + h
        z = apply_norm(x, p_l["ln2"], cfg.norm)
        if cfg.moe is not None and plan is not None:
            (y,), aux = moe_block(p_l["moe"], [z], cfg=cfg.moe, plan=plan)
        elif cfg.moe is not None:
            y, aux = moe_block_dense_ref(p_l["moe"], z, cfg=cfg.moe), 0.0
        else:
            y, aux = mlp_block(p_l["mlp"], z), 0.0
        return x + y, new_cache, aux

    return block


def _embed(cfg: TransformerConfig, params, tokens):
    """The token rows of the embedding in the compute type (the reference
    casts the table, then gathers: the same values)."""
    return params["embed"][tokens.long()].to(torch_dtype(cfg.dtype))


def _logits(cfg: TransformerConfig, params, x):
    x = apply_norm(x, params["final_norm"], cfg.norm)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    return x @ head.to(x.dtype)


# --------------------------------------------------------------------------
# forward passes over a mesh
# --------------------------------------------------------------------------
def _spans(n: int, parts: int) -> list:
    return [(r * n // parts, (r + 1) * n // parts) for r in range(parts)]


class _Plan(MeshPlan):
    """An LM step's plan over the mesh: which layers split over the model
    shards, and how attention splits.

    * By whole heads (:func:`attention_splits`): shard r runs its q heads
      and the kv heads they read, on its device, and its cache block holds
      those kv heads.
    * Inside heads, elsewhere (``seq``): the q columns split where
      ``n_heads * d_head`` divides, the kv columns where ``n_kv * d_head``
      does (else each is projected whole on the lead device). Prefill and
      train re-lay each shard's projected columns out as sequence blocks
      of whole heads (``parallel.all_to_all``); shard j runs rotary and
      causal attention for its query block over the kv blocks it needs
      (an all-gather of them), keeps its kv block as its cache, and hands
      the output back as columns to ``wo``'s row block. A decode step
      gathers the token's q, k and v whole on each sequence shard; the
      shard that owns the position writes it, each takes a partial softmax
      over its positions (max, sum of exponentials, weighted v), and the
      partials meet on the lead device, merged by log-sum-exp in shard
      order, then split into columns for ``wo``. The sequence splits over
      the model shards where its length divides, else it stays in one
      block on the lead device."""

    def __init__(self, cfg: TransformerConfig, mesh, dp_axes):
        super().__init__(mesh, dp_axes)
        tp, dh = self.tp, cfg.head_dim
        self.heads = tp > 1 and attention_splits(cfg, tp)
        self.seq = tp > 1 and not self.heads
        q, kv = head_spans(cfg, tp) if self.heads else ([(0, cfg.n_heads)], [(0, cfg.n_kv)])
        self.q_heads, self.kv_heads = q, kv
        self.attn_how = {"wq": (1, q, dh), "wk": (1, kv, dh), "wv": (1, kv, dh),
                         "wo": (0, q, dh), "bq": (0, q, dh), "bk": (0, kv, dh),
                         "bv": (0, kv, dh)}
        n_q, n_kv = cfg.n_heads * dh, cfg.n_kv * dh
        self.q_cols = tp if self.seq and n_q % tp == 0 else 1
        self.kv_cols = tp if self.seq and n_kv % tp == 0 else 1
        qs, ks = _spans(n_q, self.q_cols), _spans(n_kv, self.kv_cols)
        self.q_how = {"wq": (1, qs, 1), "bq": (0, qs, 1), "wo": (0, qs, 1)}
        self.kv_how = {"wk": (1, ks, 1), "wv": (1, ks, 1), "bk": (0, ks, 1), "bv": (0, ks, 1)}
        self.ff = tp > 1 and cfg.moe is None and cfg.d_ff % tp == 0
        self.vocab = tp > 1 and cfg.vocab_padded % tp == 0

    def seq_blocks(self, seq_len: int) -> int:
        """The sequence blocks attention split inside heads runs in."""
        return self.tp if self.seq and seq_len % self.tp == 0 else 1

    def cache_cols(self, seq_len: int) -> int:
        """The model blocks of a cache of ``seq_len`` positions."""
        return self.tp if self.heads else self.seq_blocks(seq_len)

    def vocab_views(self, leaf, axis: int, cfg: TransformerConfig) -> list:
        cols = self.tp if self.vocab else 1
        return self.views(leaf, cols, axis, _spans(cfg.vocab_padded, cols) if cols > 1 else None)


def _row_sum(parts, lead):
    return parts[0] if len(parts) == 1 else sum_to_lead(parts, lead)


def _row_copies(x, plan: _Plan, d: int, cols: int) -> list:
    return [x] if cols == 1 else replicate(x, plan.row(d, cols))


def _rotary(cfg: TransformerConfig, q, k, start: int):
    """q and k (B, S, heads, Dh) rotated at positions start .. start + S - 1,
    as ``attention_block`` rotates them."""
    d_rot = int(cfg.head_dim * cfg.rotary_pct)
    d_rot -= d_rot % 2
    if not d_rot:
        return q, k
    B, S = q.shape[:2]
    pos = (torch.arange(S, device=q.device) + start)[None, :].expand(B, S)
    cos, sin = rotary_angles(pos, d_rot)
    return apply_rotary(q, cos, sin, cfg.rotary_pct), apply_rotary(k, cos, sin, cfg.rotary_pct)


def _project(views, zs, w: str, b: str, dt) -> list:
    """Each shard's columns of ``z @ w (+ b)``."""
    out = []
    for p, z in zip(views, zs):
        y = z @ p[w].to(dt)
        out.append(y + p[b].to(dt) if b in p else y)
    return out


def _seq_attention(cfg: TransformerConfig, plan: _Plan, d: int, qv, kvv, z, cache=None,
                   position: int = 0):
    """Data shard d's attention split inside heads (:class:`_Plan`): ``qv``
    and ``kvv`` the q-side (``wq``, ``bq``, ``wo``) and kv-side weights of
    each column shard, ``z`` the normed residual on the lead device,
    ``cache`` the sequence shards' cache blocks [j] or None -> (the output
    on the lead device, each sequence shard's cache [j])."""
    B, S, _ = z.shape
    dt = z.dtype
    zq = _row_copies(z, plan, d, plan.q_cols)
    zk = zq if plan.kv_cols == plan.q_cols else _row_copies(z, plan, d, plan.kv_cols)
    q = _project(qv, zq, "wq", "bq", dt)
    k = _project(kvv, zk, "wk", "bk", dt)
    v = _project(kvv, zk, "wv", "bv", dt)
    if cache is None:
        outs, caches = _seq_self_attention(cfg, plan, d, q, k, v)
    else:
        outs, caches = [_seq_cached_attention(cfg, plan, d, q, k, v, cache, position)], cache
    cols = all_to_all(outs, 2, 1, plan.row(d, plan.q_cols))
    return _row_sum([o @ p["wo"].to(dt) for o, p in zip(cols, qv)], plan.lead(d)), caches


def _seq_self_attention(cfg: TransformerConfig, plan: _Plan, d: int, q, k, v):
    """Causal self-attention of the projected columns by sequence blocks ->
    (each block's (B, S / n, H Dh) output on its shard, its cache)."""
    B, S, _ = q[0].shape
    H, Kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    nb = plan.seq_blocks(S)
    blk = S // nb
    devs = plan.row(d, nb)
    qs, ks, vs = (all_to_all(parts, 1, 2, devs) for parts in (q, k, v))
    rot = [_rotary(cfg, qs[j].reshape(B, blk, H, dh), ks[j].reshape(B, blk, Kv, dh), j * blk)
           for j in range(nb)]
    vs = [x.reshape(B, blk, Kv, dh) for x in vs]
    k_rows = [kj for _, kj in rot]
    shards = [(d, j) for j in range(nb)]
    k_all = plan._gather(k_rows, shards, 1, shards) if nb > 1 else k_rows
    v_all = plan._gather(vs, shards, 1, shards) if nb > 1 else vs
    outs = []
    for j, (qj, _) in enumerate(rot):
        stop = (j + 1) * blk
        o = gqa_attention(qj, k_all[j].narrow(1, 0, stop), v_all[j].narrow(1, 0, stop),
                          causal=True, q_offset=j * blk)
        outs.append(o.reshape(B, blk, H * dh))
    return outs, [{"k": kj, "v": vj} for kj, vj in zip(k_rows, vs)]


def _seq_cached_attention(cfg: TransformerConfig, plan: _Plan, d: int, q, k, v, cache,
                          position: int):
    """The new tokens' attention over a sequence-sharded cache -> the
    (B, S, H Dh) output on the lead device. The tokens' q, k and v are
    gathered whole and rotated on the lead device; each shard that owns
    positions of the new tokens receives and writes their k and v; q goes
    to every shard, which takes its partial softmax."""
    B, S, _ = q[0].shape
    H, Kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    G = H // Kv
    nb = len(cache)
    sizes = [c["k"].shape[1] for c in cache]
    starts = np.cumsum([0] + sizes).tolist()
    start = _cache_start(position, S, starts[-1])
    lead, shards = (d, 0), [(d, j) for j in range(nb)]

    def whole(parts):
        return plan._gather(parts, [(d, r) for r in range(len(parts))], 2, [lead])[0]

    qw, kw = _rotary(cfg, whole(q).reshape(B, S, H, dh), whole(k).reshape(B, S, Kv, dh),
                     position)
    vw = whole(v).reshape(B, S, Kv, dh)
    if "k_scale" in cache[0]:
        (k8, ks), (v8, vs) = quantize_kv(kw), quantize_kv(vw)
        new = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": kw, "v": vw}
    last = position + S - 1  # the last position any new token reads
    live = [j for j in range(nb) if starts[j] <= last]  # a shard past it adds nothing
    qs = plan._gather([qw.reshape(B, S, Kv, G, dh)], [lead], 1, [shards[j] for j in live])
    scale = float(np.float32(1.0 / np.sqrt(dh)))
    partials = []
    for j, qj in zip(live, qs):
        c = cache[j]
        lo, hi = max(start, starts[j]), min(start + S, starts[j + 1])
        if lo < hi:  # this shard owns positions of the new tokens
            for name, upd in new.items():
                (rows,) = plan._gather([upd.narrow(1, lo - start, hi - lo)], [lead], 1,
                                       [shards[j]])
                _write(c, name, rows, lo - starts[j])
        kf, vf = c["k"], c["v"]
        if "k_scale" in c:
            kf = kf.to(qj.dtype) * c["k_scale"][..., None].to(qj.dtype)
            vf = vf.to(qj.dtype) * c["v_scale"][..., None].to(qj.dtype)
        partials.append(_partial_softmax(qj, kf, vf, starts[j], position, scale)[None])
    (got,) = plan._gather(partials, [shards[j] for j in live], 0, [lead])
    # the online softmax's merge of the shards' partials, against their max
    top = got[..., 0].amax(dim=0)
    w = torch.exp(got[..., 0] - top)
    l = (got[..., 1] * w).sum(dim=0)
    acc = (got[..., 2:] * w[..., None]).sum(dim=0)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H * dh).to(qw.dtype)


def _partial_softmax(q, k, v, first: int, position: int, scale: float) -> torch.Tensor:
    """One shard's share of the new tokens' attention: q (B, S, Hkv, G, Dh)
    at positions position.., k and v (B, T, Hkv, Dh) at first.. ->
    (B, Hkv, G, S, Dh + 2) float32: each row's max score, its sum of
    exponentials and its float32 weighted v, as the reference's online
    softmax leaves them after one kv block (masked scores -1e30)."""
    S, T = q.shape[1], k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    if first + T - 1 > position:  # the block reaches past the first token's position
        kpos = first + torch.arange(T, device=q.device)
        qpos = position + torch.arange(S, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_MASK)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype), v).float()
    return torch.cat([m[..., None], p.sum(dim=-1)[..., None], pv], -1)


def _mesh_layer(cfg: TransformerConfig, plan: _Plan, p_l, xs, caches=None, position=0):
    """One layer over the grid: ``xs[d]`` data shard d's residual on its
    lead device; ``caches[d][r]`` shard (d, r)'s cache (or None) -> (the
    new residuals, the layer's aux loss on the mesh's lead device (0.0
    without MoE), the shards' new caches [d][r])."""
    if plan.seq:
        attn = p_l["attn"]
        q_side = plan.tree_views({k: v for k, v in attn.items() if k in plan.q_how},
                                 plan.q_cols, plan.q_how)
        kv_side = plan.tree_views({k: v for k, v in attn.items() if k in plan.kv_how},
                                  plan.kv_cols, plan.kv_how)
    else:
        cols = plan.tp if plan.heads else 1
        attn = plan.tree_views(p_l["attn"], cols, plan.attn_how)
    ln1, ln2 = (plan.tree_views(p_l[k], 1, {}) for k in ("ln1", "ln2"))
    hs, zs, new_caches = [], [], []
    for d, x in enumerate(xs):
        z = apply_norm(x, ln1[d][0], cfg.norm)
        if plan.seq:
            h, cs = _seq_attention(cfg, plan, d, q_side[d], kv_side[d], z,
                                   None if caches is None else caches[d], position)
            new_caches.append(cs)
            hs.append(x + h)
            zs.append(apply_norm(hs[-1], ln2[d][0], cfg.norm))
            continue
        outs, cs = [], []
        for r, z_r in enumerate(_row_copies(z, plan, d, cols)):
            (qa, qb), (ka, kb) = plan.q_heads[r], plan.kv_heads[r]
            h, c = attention_block(attn[d][r], z_r, n_heads=qb - qa, n_kv=kb - ka,
                                   d_head=cfg.head_dim, rotary_pct=cfg.rotary_pct,
                                   cache=None if caches is None else caches[d][r],
                                   position=position)
            outs.append(h)
            cs.append(c)
        new_caches.append(cs)
        hs.append(x + _row_sum(outs, plan.lead(d)))
        zs.append(apply_norm(hs[-1], ln2[d][0], cfg.norm))
    if cfg.moe is not None:
        ys, aux = moe_block(p_l["moe"], zs, cfg=cfg.moe, plan=plan)
    else:
        f = _spans(cfg.d_ff, plan.tp)
        ffn = plan.tree_views(p_l["mlp"], plan.tp if plan.ff else 1,
                              {"w_gate": (1, f, 1), "w_up": (1, f, 1), "w_down": (0, f, 1)})
        ys = [_row_sum([mlp_block(p, z_r) for p, z_r in
                        zip(ffn[d], _row_copies(z, plan, d, len(ffn[d])))], plan.lead(d))
              for d, z in enumerate(zs)]
        aux = 0.0
    return [h + y for h, y in zip(hs, ys)], aux, new_caches


def _mesh_embed(cfg: TransformerConfig, plan: _Plan, embed, tokens) -> list:
    """Each data shard's token rows in the compute type, on its lead
    device: over vocab blocks through ``embedding.lookup_row`` (non-owned
    ids read row ``position mod rows``, so the backward's ``index_put_``
    never adds a long run of one row)."""
    dt = torch_dtype(cfg.dtype)
    xs = []
    for d, ids in enumerate(plan.split_batch(tokens)):
        row = embed[d]
        x = row[0][ids.long()] if len(row) == 1 else lookup_row(row, ids, plan.lead(d))
        xs.append(x.to(dt))
    return xs


def _head(params, plan: _Plan, cfg: TransformerConfig, embed):
    """The vocab blocks of the head, [d][r]: an untied ``lm_head``'s
    column blocks, or the tied embedding's row blocks (``embed``, the
    views the lookup took, so both uses' gradients meet in one gather)."""
    if "lm_head" in params:
        return plan.vocab_views(params["lm_head"], 1, cfg), False
    return embed, True


def _head_parts(cfg, plan: _Plan, d: int, x, final, head, tied) -> list:
    """Data shard d's logits, one (..., V / tp) part per vocab shard on
    its device."""
    x = apply_norm(x, final[d][0], cfg.norm)
    row = head[d]
    return [x_r @ (w.T if tied else w).to(x.dtype)
            for x_r, w in zip(_row_copies(x, plan, d, len(row)), row)]


def _mesh_forward(cfg: TransformerConfig, params, tokens, mesh, dp_axes):
    """The train forward over the mesh -> (plan, each data shard's logits
    parts, the mean aux loss over layers). With ``cfg.remat`` each layer,
    its weights' gather included, runs under ``torch.utils.checkpoint``,
    so the backward holds one layer's gathered weights at a time."""
    plan = _Plan(cfg, mesh, dp_axes)
    embed = plan.vocab_views(params["embed"], 0, cfg)
    xs = _mesh_embed(cfg, plan, embed, tokens)

    def layer(p_l, *xs):
        out, aux, _ = _mesh_layer(cfg, plan, p_l, xs)
        return (*out, aux)

    aux = torch.zeros((), dtype=torch.float32, device=plan.mesh_lead)
    for i, p_l in enumerate(unstack(params["layers"], cfg.n_layers)):
        layer_boundary(xs[0], i, cfg.n_layers)
        *xs, a = remat(layer, p_l, *xs) if cfg.remat else layer(p_l, *xs)
        aux = aux + a
    layer_boundary(xs[0], cfg.n_layers, cfg.n_layers)
    final = plan.tree_views(params["final_norm"], 1, {})
    head, tied = _head(params, plan, cfg, embed)
    parts = [_head_parts(cfg, plan, d, x, final, head, tied) for d, x in enumerate(xs)]
    return plan, parts, aux / cfg.n_layers


def _gather_logits(plan: _Plan, parts) -> torch.Tensor:
    rows = [p[0] if len(p) == 1 else torch.cat([t.to(plan.lead(d)) for t in p], -1)
            for d, p in enumerate(parts)]
    return rows[0] if len(rows) == 1 else torch.cat([r.to(plan.mesh_lead) for r in rows])


def _token_losses(cfg: TransformerConfig, parts, targets, lead) -> torch.Tensor:
    """One data shard's per-token ``lse - target logit`` (float32) from its
    vocab shards' logits: each shard's max (the global one combined in
    shard order, held constant as the reference's ``logsumexp`` holds it)
    and sum of exponentials, its pad columns masked by global column; the
    target logit from its owner shard. No device holds the whole (B, S, V)
    float32 logits."""
    if len(parts) == 1:
        logits = parts[0].float()
        if cfg.vocab_padded != cfg.vocab:
            cols = torch.arange(cfg.vocab_padded, device=logits.device)
            logits = logits + torch.where(cols >= cfg.vocab, NEG_MASK, 0.0)
        lse = torch.logsumexp(logits, dim=-1)
        # The reference takes the target logit by a one-hot contraction (a
        # sharded-V reduction). A gather gives the same float32 value, since
        # every other product of the contraction is an exact zero, without a
        # (B, S, V) one-hot (6.6 GB a microbatch at stablelm's full width).
        return lse - logits.gather(-1, targets.long()[..., None])[..., 0]
    width = parts[0].shape[-1]
    logits, peak = [], None
    for r, part in enumerate(parts):
        part = part.float()
        if cfg.vocab_padded != cfg.vocab:
            cols = torch.arange(r * width, (r + 1) * width, device=part.device)
            part = part + torch.where(cols >= cfg.vocab, NEG_MASK, 0.0)
        logits.append(part)
        m = part.detach().amax(dim=-1).to(lead)
        peak = m if peak is None else torch.maximum(peak, m)
    sums = [torch.exp(part - peak.to(part.device)[..., None]).sum(dim=-1) for part in logits]
    lse = peak + torch.log(sum_to_lead(sums, lead))
    picked = []
    for r, part in enumerate(logits):
        local = targets.to(part.device).long() - r * width
        own = (local >= 0) & (local < width)
        got = part.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
        picked.append(torch.where(own, got, 0.0))
    return lse - sum_to_lead(picked, lead)


def forward(cfg: TransformerConfig, params, tokens, mesh=None, dp_axes=("data",)):
    """tokens (B, S) -> (logits (B, S, V), mean aux loss over layers); each
    layer rematerialised in the backward when ``cfg.remat``. Over a mesh
    the layers run tensor-parallel (see the module docstring) and the
    logits come back whole on the mesh's lead device; a mesh of one shard
    runs the one-device path."""
    if not _one_device(mesh):
        plan, parts, aux = _mesh_forward(cfg, params, tokens, mesh, dp_axes)
        return _gather_logits(plan, parts), aux
    x = _embed(cfg, params, tokens)
    block = _block(cfg, None if mesh is None else MeshPlan(mesh, dp_axes))

    def layer(x, p_l):
        y, _, a = block(x, p_l)
        return y, a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p_l in enumerate(unstack(params["layers"], cfg.n_layers)):
        layer_boundary(x, i, cfg.n_layers)
        x, a = remat(layer, x, p_l) if cfg.remat else layer(x, p_l)
        aux = aux + a
    layer_boundary(x, cfg.n_layers, cfg.n_layers)
    return _logits(cfg, params, x), aux / cfg.n_layers


def lm_loss(cfg: TransformerConfig, params, tokens, targets, mesh=None, dp_axes=("data",)):
    """Mean next-token cross-entropy in float32 over (B, S), pad columns
    of the padded vocabulary masked with -1e30, plus 0.01 x the MoE aux
    loss. Over a mesh the cross-entropy is vocab-parallel
    (:func:`_token_losses`) and the mean is over the global batch."""
    if _one_device(mesh):
        logits, aux = forward(cfg, params, tokens, mesh, dp_axes)
        loss = _token_losses(cfg, [logits], targets, logits.device).mean()
    else:
        plan, parts, aux = _mesh_forward(cfg, params, tokens, mesh, dp_axes)
        per = [_token_losses(cfg, p, t, plan.lead(d)).to(plan.mesh_lead)
               for d, (p, t) in enumerate(zip(parts, plan.split_batch(targets)))]
        loss = per[0].mean() if len(per) == 1 else torch.cat([t.reshape(-1) for t in per]).mean()
    if cfg.moe is not None:
        loss = loss + 0.01 * aux
    return loss


def lm_grads_microbatched(cfg: TransformerConfig, params, tokens, targets, n_micro: int,
                          mesh=None, dp_axes=("data",), bf16_gather: bool = True):
    """Gradient accumulation over ``n_micro`` microbatches in order: the
    float32 sums of ``g / n_micro`` and ``loss / n_micro`` -> (loss,
    grads), the grads float32 like the master parameters. Microbatch i is
    rows [i B / n_micro, (i + 1) B / n_micro) of the global batch, split
    over the data shards.

    With ``bf16_gather`` and a mesh, every float32 parameter (each block
    of a sharded one, where it lives) is cast to bfloat16 before
    ``lm_loss`` gathers it, as the reference's ``cast_sharded`` casts it
    (the reference also needs its parameter specs, which its step builder
    always passes); the gradients come back through the cast, so each is
    the float32 of a bfloat16-rounded value."""
    B = tokens.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
    tk = tokens.reshape(n_micro, B // n_micro, -1)
    tg = targets.reshape(n_micro, B // n_micro, -1)
    cast = bf16_gather and mesh is not None

    def loss_fn(p, t, y):
        if cast:
            p = tree_map(lambda x: x.to(torch.bfloat16) if x.dtype == torch.float32 else x, p)
        return lm_loss(cfg, p, t, y, mesh, dp_axes)

    grads = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                     params)
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(n_micro):
        l, g = value_and_grad(loss_fn, params, tk[i], tg[i])
        tree_map(lambda acc, gi: acc.add_(gi.float().div_(n_micro)), grads, g)
        del g
        loss = loss + l / n_micro
    return loss, grads


def _cache_views(plan: _Plan, caches, i: int, cols: int) -> list:
    """Layer i of the caches as [d][r] dicts: each ``Sharded`` cache's
    block (d, r), or views of a whole cache (batch rows of data shard d,
    and the kv heads or the sequence block of shard r) where every shard
    is on its device."""
    out = [[{} for _ in range(cols)] for _ in range(plan.dp)]
    for name, c in caches.items():
        if isinstance(c, Sharded):
            if c.grid != (plan.dp, cols):
                raise ValueError(f"a cache on a grid of {c.grid}; the step takes "
                                 f"{(plan.dp, cols)}")
            for d in range(plan.dp):
                for r in range(cols):
                    out[d][r][name] = c.block(d, r)[i]
            continue
        rows = c.shape[1] // plan.dp
        spans = plan.kv_heads if plan.heads else _spans(c.shape[2], cols)
        for d in range(plan.dp):
            for r in range(cols):
                if plan.grid[d, r] != c.device:
                    raise ValueError(f"a whole cache on {c.device} serves a mesh of that "
                                     f"device only, not {plan.grid[d, r]}")
                v = c[i].narrow(0, d * rows, rows)
                if cols > 1:
                    a, b = spans[r]
                    v = v.narrow(2 if plan.heads else 1, a, b - a)
                out[d][r][name] = v
    return out


def _stacked_caches(plan: _Plan, per_layer: list, cols: int, seq_len: int):
    """The prefill's per-layer caches [layer][d][r] as the step's caches:
    plain (L, B, S, Hkv, Dh) tensors on a (1, 1) grid, else a ``Sharded``
    per name, block (d, r) the stacked cache of shard (d, r): its kv heads
    or its sequence block."""
    if cols == 1:
        axes, spans = (1, None), None
    elif plan.heads:
        axes, spans = (1, 3), [tuple(s) for s in plan.kv_heads]
    else:
        axes, spans = (1, 2), [tuple(s) for s in _spans(seq_len, cols)]
    out = {}
    for name in ("k", "v"):
        blocks = [torch.stack([layer[d][r][name] for layer in per_layer])
                  for d in range(plan.dp) for r in range(cols)]
        out[name] = blocks[0] if len(blocks) == 1 else Sharded(blocks, (plan.dp, cols), axes,
                                                               spans)
    return out


def _mesh_serve(cfg: TransformerConfig, params, tokens, mesh, dp_axes, caches=None,
                position=0):
    plan = _Plan(cfg, mesh, dp_axes)
    seq_len = tokens.shape[1] if caches is None else caches["k"].shape[2]
    cols = plan.cache_cols(seq_len)
    embed = plan.vocab_views(params["embed"], 0, cfg)
    xs = _mesh_embed(cfg, plan, embed, tokens)
    per_layer = []
    for i in range(cfg.n_layers):
        layer_boundary(xs[0], i, cfg.n_layers)
        views = None if caches is None else _cache_views(plan, caches, i, cols)
        # the layer's aux loss is dropped at once: a step's live bytes at each
        # layer boundary are then the same function of the layer
        xs, cs = _mesh_layer(cfg, plan, layer_slice(params["layers"], i), xs, views,
                             position)[::2]
        if caches is None:
            per_layer.append(cs)
    layer_boundary(xs[0], cfg.n_layers, cfg.n_layers)
    final = plan.tree_views(params["final_norm"], 1, {})
    head, tied = _head(params, plan, cfg, embed)
    last = [x if caches is not None else x[:, -1:] for x in xs]
    logits = _gather_logits(plan, [_head_parts(cfg, plan, d, x, final, head, tied)
                                   for d, x in enumerate(last)])[:, 0]
    if caches is not None:
        return logits, caches
    return logits, _stacked_caches(plan, per_layer, cols, seq_len)


def prefill(cfg: TransformerConfig, params, tokens, mesh=None, dp_axes=("data",)):
    """tokens (B, S) -> (last-position logits (B, V), stacked KV cache
    {"k", "v"} of (L, B, S, Hkv, Dh) in the compute type). Over a mesh the
    cache comes back per ``cache_pspecs``: a ``Sharded`` whose block (d, r)
    is shard (d, r)'s (whole tensors on a (1, 1) mesh)."""
    if not _one_device(mesh):
        return _mesh_serve(cfg, params, tokens, mesh, dp_axes)
    x = _embed(cfg, params, tokens)
    block = _block(cfg, None if mesh is None else MeshPlan(mesh, dp_axes))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        layer_boundary(x, i, cfg.n_layers)
        x, cache = block(x, layer_slice(params["layers"], i))[:2]
        ks.append(cache["k"])
        vs.append(cache["v"])
    layer_boundary(x, cfg.n_layers, cfg.n_layers)
    return _logits(cfg, params, x[:, -1:])[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(cfg: TransformerConfig, params, token, caches, position, mesh=None,
                dp_axes=("data",)):
    """token (B, 1) + caches (L-stacked k/v (L, B, Smax, Hkv, Dh), and
    k_scale/v_scale for the int8 cache; over a mesh ``Sharded`` per
    ``cache_pspecs``, or whole tensors on the device of every shard) +
    position (an int or a 0-d tensor) -> (logits (B, V), the caches,
    updated in place)."""
    position = int(position)
    if not _one_device(mesh):
        return _mesh_serve(cfg, params, token, mesh, dp_axes, caches, position)
    x = _embed(cfg, params, token)
    block = _block(cfg, None if mesh is None else MeshPlan(mesh, dp_axes))
    for i in range(cfg.n_layers):
        layer_boundary(x, i, cfg.n_layers)
        x = block(x, layer_slice(params["layers"], i), cache_l=layer_slice(caches, i),
                  position=position)[0]
    layer_boundary(x, cfg.n_layers, cfg.n_layers)
    return _logits(cfg, params, x)[:, 0], caches


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               quantized: bool = False, *, device=None):
    """Zeroed KV caches on ``device`` (the card unless the caller names
    another): k/v (L, B, max_len, Hkv, Dh) in ``dtype``, or int8 k/v with
    float32 k_scale/v_scale (L, B, max_len, Hkv) when ``quantized``."""
    device = model_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    if quantized:
        sshape = shape[:-1]
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
    dtype = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
