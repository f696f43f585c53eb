"""Shared neural-net layers: norms, rotary embeddings, GQA attention,
gated MLP (the reference's ``models/layers.py``).

Plain functions on tensors; parameters are dicts of tensors under the
reference's key names, and every function computes on the device of its
inputs. Where the reference's rounding is a choice, the port makes the
same one: the norms' statistics in float32, the population variance,
``jnp.round``'s half-to-even in the int8 quantiser, and the constant
divisions as XLA compiles them (a multiplication by the float32
reciprocal). Attention and the MLPs are plain torch matrix products, as
the reference leaves them to XLA: none of them is a Pallas kernel there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import normal, remat

NEG_MASK = -1e30  # the reference's masked score
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))  # XLA turns "/ 127.0" into this product


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return y * scale.to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm as the reference computes it: the statistics in float32
    with the population variance (``jnp.var``), the normalised value cast
    back to ``x.dtype``, then scale and bias in ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * scale.to(x.dtype) + bias.to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(d: int, kind: str, *, device, stack=()):
    p = {"scale": torch.ones((*stack, d), dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((*stack, d), dtype=torch.float32, device=device)
    return p


# ---------------- rotary ---------------------------------------------------
def rotary_angles(positions, d_rot: int, theta: float = 10_000.0):
    """positions: (...,) int -> cos/sin of shape (..., d_rot//2). The
    inverse frequencies are computed in float64, as numpy does in the
    reference, and used as float32."""
    inv = 1.0 / (theta ** (np.arange(0, d_rot, 2) / d_rot))
    inv = torch.from_numpy(inv.astype(np.float32)).to(positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, cos, sin, rotary_pct: float = 1.0):
    """x: (B, S, H, Dh); cos/sin: (B, S, d_rot//2). Partial rotary
    (StableLM-2 rotates 25 % of each head) leaves the tail unrotated."""
    dh = x.shape[-1]
    d_rot = int(dh * rotary_pct)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., : d_rot // 2], xr[..., d_rot // 2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out, xp], dim=-1)


# ---------------- attention -------------------------------------------------
def gqa_attention_naive(q, k, v, *, causal: bool, q_offset=0, kv_len_valid=None):
    """Reference/decode path: the full (B, H, Sq, Skv) score matrix. Used
    when Sq == 1 and as the numerics oracle for the chunked path."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores * float(np.float32(1.0) / np.float32(np.sqrt(Dh)))
    Skv = k.shape[1]
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        mask = kpos[None, :] <= qpos[:, None]
    if kv_len_valid is not None:
        mask = mask & (kpos[None, :] < kv_len_valid)
    scores = torch.where(mask, scores, NEG_MASK)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hq, Dh)


def _kv_block(m, l, acc, qblk, kblk, vblk, mask, scale: float):
    """One KV block of the online softmax: the running max, normaliser and
    float32 accumulator after the block."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk).float() * scale
    s = torch.where(mask, s, NEG_MASK)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(qblk.dtype), vblk).float()
    return m_new, l, acc * corr[..., None] + pv


def gqa_attention_chunked(
    q, k, v, *, causal: bool, q_offset=0, kv_len_valid=None,
    q_block: int = 512, kv_block: int = 1024,
):
    """Flash-style attention in plain torch ops: a loop over Q blocks and,
    inside, over KV blocks with the reference's online softmax (running
    max, normaliser and float32 accumulator, ``-1e30`` masks). Each KV
    block is rematerialised in the backward, as the reference checkpoints
    its inner scan body, so a backward holds one block's scores at a time.

    A KV block past a Q block's last causal position, or at or past
    ``kv_len_valid``, is skipped. That changes nothing: once block 0
    has given every row a finite running max, such a block's
    probabilities are exactly 0 and its correction exactly 1, so the
    reference's update leaves the running values as they were."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qb = min(q_block, Sq)
    kb = min(kv_block, Skv)
    nq = -(-Sq // qb)
    nk = -(-Skv // kb)
    pad_q = nq * qb - Sq
    pad_k = nk * kb - Skv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    kv_valid = Skv if kv_len_valid is None else int(kv_len_valid)
    scale = float(np.float32(1.0 / np.sqrt(Dh)))
    dev = q.device
    qg = q.reshape(B, nq, qb, Hkv, G, Dh)
    kg = k.reshape(B, nk, kb, Hkv, Dh)
    vg = v.reshape(B, nk, kb, Hkv, Dh)
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi]
        q_first = q_offset + qi * qb
        qpos = q_first + torch.arange(qb, device=dev)
        m = torch.full((B, Hkv, G, qb), NEG_MASK, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, qb, Dh), dtype=torch.float32, device=dev)
        for kj in range(nk):
            k_first = kj * kb
            if kj and kv_valid > 0 and (k_first >= kv_valid
                                        or (causal and k_first > q_first + qb - 1)):
                continue
            kpos = k_first + torch.arange(kb, device=dev)
            mask = kpos[None, :] < kv_valid
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            else:
                mask = mask.expand(qb, kb)
            m, l, acc = remat(_kv_block, m, l, acc, qblk, kg[:, kj], vg[:, kj], mask, scale)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        # (B, Hkv, G, qb, Dh) -> (B, qb, Hq, Dh)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qb, Hq, Dh).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq]


def gqa_attention(q, k, v, *, causal: bool, q_offset=0, kv_len_valid=None,
                  q_block: int = 512, kv_block: int = 1024):
    """Dispatch: chunked for long sequences, naive for decode/small."""
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq == 1 or (Sq * Skv) <= q_block * kv_block:
        return gqa_attention_naive(
            q, k, v, causal=causal, q_offset=q_offset, kv_len_valid=kv_len_valid
        )
    return gqa_attention_chunked(
        q, k, v, causal=causal, q_offset=q_offset, kv_len_valid=kv_len_valid,
        q_block=q_block, kv_block=kv_block,
    )


def init_attention(d_model: int, n_heads: int, n_kv: int, d_head: int, qkv_bias: bool,
                   *, generator, device, stack=()):
    scale = 1.0 / np.sqrt(d_model)
    p = {
        "wq": normal((*stack, d_model, n_heads * d_head), scale, generator, device),
        "wk": normal((*stack, d_model, n_kv * d_head), scale, generator, device),
        "wv": normal((*stack, d_model, n_kv * d_head), scale, generator, device),
        "wo": normal((*stack, n_heads * d_head, d_model), scale, generator, device),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((*stack, width * d_head), dtype=torch.float32, device=device)
    return p


def quantize_kv(x):
    """The int8 cache's quantiser: x (B, S, Hkv, Dh) -> int8 values and
    per-(token, head) float32 scales, max|x| / 127 floored at 1e-8,
    rounded half to even and clipped to [-127, 127]."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) * RECIP_127, 1e-8)
    q8 = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q8.to(torch.int8), scale


def _cache_start(position: int, S: int, s_max: int) -> int:
    """Where ``jax.lax.dynamic_update_slice`` writes S rows into a cache
    of s_max: the start clamped into [0, s_max - S], so the update fits."""
    return min(max(position, 0), s_max - S)


def _write(cache, name: str, update, start: int) -> torch.Tensor:
    """``dynamic_update_slice`` into ``cache[name]`` along its sequence
    axis, in place. The same dtype error as ``lax`` for a mismatch."""
    buf = cache[name]
    if buf.dtype != update.dtype:
        raise TypeError(f"the cache's {name} is {buf.dtype} and the update {update.dtype}: "
                        "dynamic_update_slice requires arguments to have the same dtypes")
    buf[:, start:start + update.shape[1]] = update
    return buf


def attention_block(
    p,
    x,
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    rotary_pct: float,
    causal: bool = True,
    cache=None,
    position=0,
):
    """Returns (out, new_cache). cache: dict(k, v) of (B, Smax, Hkv, Dh),
    with k_scale/v_scale (B, Smax, Hkv) for the int8 cache, or None
    (full self-attention over x). A cache is updated in place and comes
    back as ``new_cache`` (the reference's decode step donates it)."""
    B, S, _ = x.shape
    dt = x.dtype
    position = int(position)
    q = (x @ p["wq"].to(dt)).reshape(B, S, n_heads, d_head)
    k = (x @ p["wk"].to(dt)).reshape(B, S, n_kv, d_head)
    v = (x @ p["wv"].to(dt)).reshape(B, S, n_kv, d_head)
    if "bq" in p:
        q = q + p["bq"].to(dt).reshape(n_heads, d_head)
        k = k + p["bk"].to(dt).reshape(n_kv, d_head)
        v = v + p["bv"].to(dt).reshape(n_kv, d_head)
    d_rot = int(d_head * rotary_pct)
    d_rot -= d_rot % 2
    if d_rot:
        pos = (torch.arange(S, device=x.device) + position)[None, :].expand(B, S)
        cos, sin = rotary_angles(pos, d_rot)
        q = apply_rotary(q, cos, sin, rotary_pct)
        k = apply_rotary(k, cos, sin, rotary_pct)
    if cache is None:
        out = gqa_attention(q, k, v, causal=causal)
        new_cache = {"k": k, "v": v}
    else:
        start = _cache_start(position, S, cache["k"].shape[1])
        if "k_scale" in cache:
            # int8 cache: per-(token, head) symmetric scales, dequantised
            # into the attention's type before the contraction
            k_q, k_s = quantize_kv(k)
            v_q, v_s = quantize_kv(v)
            new_cache = {name: _write(cache, name, upd, start)
                         for name, upd in (("k", k_q), ("v", v_q),
                                           ("k_scale", k_s), ("v_scale", v_s))}
            kf = new_cache["k"].to(dt) * new_cache["k_scale"][..., None].to(dt)
            vf = new_cache["v"].to(dt) * new_cache["v_scale"][..., None].to(dt)
        else:
            new_cache = {"k": _write(cache, "k", k, start), "v": _write(cache, "v", v, start)}
            kf, vf = new_cache["k"], new_cache["v"]
        out = gqa_attention(q, kf, vf, causal=True, q_offset=position,
                            kv_len_valid=position + S)
    out = out.reshape(B, S, n_heads * d_head) @ p["wo"].to(dt)
    return out, new_cache


# ---------------- MLP --------------------------------------------------------
def init_mlp(d_model: int, d_ff: int, *, generator, device, stack=()):
    s_in = 1.0 / np.sqrt(d_model)
    s_out = 1.0 / np.sqrt(d_ff)
    return {
        "w_gate": normal((*stack, d_model, d_ff), s_in, generator, device),
        "w_up": normal((*stack, d_model, d_ff), s_in, generator, device),
        "w_down": normal((*stack, d_ff, d_model), s_out, generator, device),
    }


def mlp_block(p, x):
    dt = x.dtype
    g = F.silu(x @ p["w_gate"].to(dt))
    u = x @ p["w_up"].to(dt)
    return (g * u) @ p["w_down"].to(dt)


def init_dense(d_in: int, d_out: int, bias: bool = True, *, generator, device):
    p = {"w": normal((d_in, d_out), 1.0 / np.sqrt(d_in), generator, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y
