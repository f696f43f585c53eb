"""The port's LM serving path against the reference package.

Seeded numpy inputs and the reference's own weights (``carry_params``)
go through the JAX functions, jitted as the reference runs them inside
its scans and steps, and through the port on the CPU. Tolerances:

* float32: rtol 1e-4, atol 1e-4 (the two add in different orders);
* bfloat16 logits: cosine >= 0.995 and argmax agreement >= 0.9 over
  every (row, step) — each package rounds its own matrix products to
  bf16, so single values may differ by a few bf16 steps;
* the int8 cache's values are equal in float32 (the port quantises with
  XLA's rounding) and within one step in bfloat16.

The reference's int8-cache thresholds (``test_kv_int8.py``: cosine >
0.995, argmax agreement >= 0.9) hold the port's int8 cache to its bf16
one. The batcher tests pin the reference's admission fault (ROADMAP
Queue 3 item 6), which the port copies.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference side: a card host without JAX skips the file
import jax.numpy as jnp  # noqa: E402

from repro.configs.lm_archs import LM_ARCHS as REF_LM_ARCHS
from repro.launch.mesh import make_mesh as jax_mesh
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.serving.lm_batcher import LMContinuousBatcher as RefBatcher
from repro_torch.configs.lm_archs import LM_ARCHS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import carry_params
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.parallel import MeshPlan
from repro_torch.serving import LMContinuousBatcher

RTOL = ATOL = 1e-4
COS_BF16, ARGMAX_BF16 = 0.995, 0.9
ARCH_IDS = [a.arch_id for a in LM_ARCHS]
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _cosine(a, b) -> float:
    a, b = _np(a).ravel().astype(np.float64), _np(b).ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _agreement(a, b) -> float:
    return float((_np(a).argmax(-1) == _np(b).argmax(-1)).mean())


def _rand(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _pair(x, dtype):
    """One numpy array as (JAX, torch) arrays of ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(x, jd), _t(x).to(getattr(torch, dtype))


def _cfgs(arch_id, dtype):
    ref = next(a for a in REF_LM_ARCHS if a.arch_id == arch_id).reduced().model_cfg
    port = next(a for a in LM_ARCHS if a.arch_id == arch_id).reduced().model_cfg
    return replace(ref, dtype=dtype), replace(port, dtype=dtype)


@pytest.fixture(scope="module")
def models():
    """Per arch: reduced configs and the reference's float32 weights,
    carried to the port in float32 and in bfloat16."""
    out = {}
    for i, arch_id in enumerate(ARCH_IDS):
        rc, pc = _cfgs(arch_id, "float32")
        params = jt.init_params(rc, jax.random.key(i))
        host = jax.tree.map(np.asarray, params)
        out[arch_id] = (rc, pc, params, carry_params(host, device=CPU),
                        carry_params(host, device=CPU, dtype=torch.bfloat16))
    return out


# -- layers ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind, dtype):
    x = _rand(1, (3, 5, 24), 2.0) + 0.7
    scale, bias = _rand(2, (24,)) + 1.0, _rand(3, (24,))
    jx, tx = _pair(x, dtype)
    p_j = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    p_t = {"scale": _t(scale), "bias": _t(bias)}
    want = jax.jit(lambda x, p: jl.apply_norm(x, p, kind))(jx, p_j)
    got = tl.apply_norm(tx, p_t, kind)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(got, want, rtol=tol, atol=tol)


def test_layer_norm_uses_population_variance():
    x = torch.tensor([[1.0, 2.0, 3.0, 6.0]])
    got = tl.layer_norm(x, torch.ones(4), torch.zeros(4), eps=0.0)
    mu, var = 3.0, np.mean((np.array([1, 2, 3, 6]) - 3.0) ** 2)
    np.testing.assert_allclose(got.numpy()[0], (np.array([1, 2, 3, 6]) - mu) / np.sqrt(var),
                               rtol=1e-6)


@pytest.mark.parametrize("pct", [1.0, 0.25])
def test_rotary(pct):
    B, S, H, Dh = 2, 7, 3, 16
    x = _rand(4, (B, S, H, Dh))
    pos = np.broadcast_to(np.arange(S)[None] + 5, (B, S)).astype(np.int32)
    d_rot = int(Dh * pct) - int(Dh * pct) % 2

    def ref(x, pos):
        cos, sin = jl.rotary_angles(pos, d_rot)
        return jl.apply_rotary(x, cos, sin, pct)

    want = jax.jit(ref)(jnp.asarray(x), jnp.asarray(pos))
    cos, sin = tl.rotary_angles(_t(pos), d_rot)
    got = tl.apply_rotary(_t(x), cos, sin, pct)
    _close(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., d_rot:].numpy(), x[..., d_rot:])  # tail unrotated
    assert not np.allclose(got[..., :d_rot].numpy(), x[..., :d_rot])


GRID = [(2, 128, 128, 4, 2, 16), (1, 96, 200, 4, 4, 8), (2, 64, 64, 8, 1, 16)]


def _qkv(seed, B, Sq, Skv, Hq, Hkv, Dh):
    return _rand(seed, (B, Sq, Hq, Dh)), _rand(seed + 1, (B, Skv, Hkv, Dh)), \
        _rand(seed + 2, (B, Skv, Hkv, Dh))


@pytest.mark.parametrize("path", ["naive", "chunked"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh", GRID)
def test_attention_grid(path, causal, B, Sq, Skv, Hq, Hkv, Dh):
    """test_attention.py's grid, q_offset = Skv - Sq when causal."""
    q, k, v = _qkv(B * Sq + Hq, B, Sq, Skv, Hq, Hkv, Dh)
    off = Skv - Sq if causal else 0
    kw = {} if path == "naive" else {"q_block": 32, "kv_block": 48}
    fn_j = getattr(jl, f"gqa_attention_{path}")
    want = jax.jit(lambda q, k, v: fn_j(q, k, v, causal=causal, q_offset=off, **kw))(q, k, v)
    got = getattr(tl, f"gqa_attention_{path}")(_t(q), _t(k), _t(v), causal=causal,
                                               q_offset=off, **kw)
    _close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("path", ["naive", "chunked"])
@pytest.mark.parametrize("causal,off,valid", [(False, 0, 37), (True, 5, 50), (True, 9, None)])
def test_attention_kv_len_valid_and_offset(path, causal, off, valid):
    q, k, v = _qkv(11, 1, 40, 64, 2, 2, 8)
    kw = {} if path == "naive" else {"q_block": 16, "kv_block": 16}
    fn_j = getattr(jl, f"gqa_attention_{path}")
    want = jax.jit(lambda q, k, v: fn_j(q, k, v, causal=causal, q_offset=off,
                                        kv_len_valid=valid, **kw))(q, k, v)
    got = getattr(tl, f"gqa_attention_{path}")(_t(q), _t(k), _t(v), causal=causal,
                                               q_offset=off, kv_len_valid=valid, **kw)
    _close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Sq,Skv,path", [(1, 4096, "naive"), (64, 64, "naive"),
                                         (512, 1024, "naive"), (513, 1024, "chunked")])
def test_attention_dispatch_rule(monkeypatch, Sq, Skv, path):
    """Naive when Sq == 1 or Sq * Skv <= q_block * kv_block, else chunked."""
    called = []
    for name in ("naive", "chunked"):
        monkeypatch.setattr(tl, f"gqa_attention_{name}",
                            lambda *a, _n=name, **k: called.append(_n))
    q = torch.zeros(1, Sq, 2, 4)
    kv = torch.zeros(1, Skv, 2, 4)
    tl.gqa_attention(q, kv, kv, causal=True)
    assert called == [path]


def _attn_params(seed, d, H, Hkv, Dh):
    rng = np.random.default_rng(seed)
    p = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32) for n, s in (
        ("wq", (d, H * Dh)), ("wk", (d, Hkv * Dh)), ("wv", (d, Hkv * Dh)), ("wo", (H * Dh, d)))}
    p["bq"], p["bk"], p["bv"] = (_rand(seed + i, (w * Dh,), 0.1) for i, w in ((1, H), (2, Hkv),
                                                                              (3, Hkv)))
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache,position", [("none", 0)] + [
    (c, p) for c in ("plain", "int8") for p in (0, 7, 14)])
def test_attention_block(dtype, cache, position):
    """Against the jitted reference, with a cache of Smax = 16 and S = 3
    new tokens: at position 14 the update starts past Smax - S, where
    ``dynamic_update_slice`` clamps its start to 13."""
    B, S, d, H, Hkv, Dh, Smax = 2, 3, 32, 4, 2, 8, 16
    p = _attn_params(20, d, H, Hkv, Dh)
    x = _rand(21, (B, S, d))
    jx, tx = _pair(x, dtype)
    kw = dict(n_heads=H, n_kv=Hkv, d_head=Dh, rotary_pct=0.5)
    c_np = None
    if cache == "plain":
        c_np = {n: _rand(22 + i, (B, Smax, Hkv, Dh)) for i, n in enumerate("kv")}
    elif cache == "int8":
        rng = np.random.default_rng(23)
        c_np = {"k": rng.integers(-127, 128, (B, Smax, Hkv, Dh)).astype(np.int8),
                "v": rng.integers(-127, 128, (B, Smax, Hkv, Dh)).astype(np.int8),
                "k_scale": np.abs(_rand(24, (B, Smax, Hkv), 0.01)),
                "v_scale": np.abs(_rand(25, (B, Smax, Hkv), 0.01))}
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: _t(a) for n, a in p.items()}
    if c_np is None:
        want_out, want_c = jax.jit(lambda p, x: jl.attention_block(p, x, **kw))(jp, jx)
        got_out, got_c = tl.attention_block(tp, tx, **kw)
    else:
        jc = {n: (jnp.asarray(a) if a.dtype.kind != "f" or a.ndim == 3 else _pair(a, dtype)[0])
              for n, a in c_np.items()}
        tc = {n: (_t(a) if a.dtype.kind != "f" or a.ndim == 3 else _pair(a, dtype)[1])
              for n, a in c_np.items()}
        want_out, want_c = jax.jit(
            lambda p, x, c, pos: jl.attention_block(p, x, cache=c, position=pos, **kw)
        )(jp, jx, jc, jnp.int32(position))
        got_out, got_c = tl.attention_block(tp, tx, cache=tc, position=position, **kw)
        for n in tc:
            assert got_c[n] is tc[n]  # written in place
    if dtype == "float32":
        _close(got_out, want_out)
    else:
        assert _cosine(got_out, want_out) > 0.999
    for n in want_c:
        if want_c[n].dtype == jnp.int8:
            diff = np.abs(got_c[n].numpy().astype(int) - np.asarray(want_c[n]).astype(int))
            assert diff.max() <= (0 if dtype == "float32" else 1), n
        elif dtype == "float32":
            _close(got_c[n], want_c[n], rtol=1e-5, atol=1e-5)
        else:
            _close(got_c[n], want_c[n], rtol=2e-2, atol=2e-2)
    if cache != "none":
        start = min(position, Smax - S)
        untouched = np.ones(Smax, bool)
        untouched[start:start + S] = False
        np.testing.assert_array_equal(_np(got_c["k"])[:, untouched],
                                      _np(_pair(c_np["k"], dtype)[1] if cache == "plain"
                                          else _t(c_np["k"]))[:, untouched])


def test_cache_dtype_mismatch_raises_like_lax():
    p = {n: _t(a) for n, a in _attn_params(20, 32, 4, 2, 8).items()}
    cache = {n: torch.zeros(1, 8, 2, 8, dtype=torch.bfloat16) for n in "kv"}
    with pytest.raises(TypeError, match="same dtypes"):
        tl.attention_block(p, torch.zeros(1, 1, 32), n_heads=4, n_kv=2, d_head=8,
                           rotary_pct=1.0, cache=cache, position=0)


# -- MoE ------------------------------------------------------------------------
def _moe_setup(dtype, top_k=2):
    cfg_j = jmoe.MoEConfig(n_experts=4, top_k=top_k, d_ff_expert=32, capacity_factor=1.25)
    cfg_t = tmoe.MoEConfig(n_experts=4, top_k=top_k, d_ff_expert=32, capacity_factor=1.25)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(3), 16, cfg_j))
    x = _rand(5, (2, 8, 16), 1.0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None), p)
    tp = carry_params(p, device=CPU, dtype=getattr(torch, dtype))
    return cfg_j, cfg_t, jp, tp, *_pair(x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense_ref(dtype):
    cfg_j, cfg_t, jp, tp, jx, tx = _moe_setup(dtype)
    want = jax.jit(lambda p, x: jmoe.moe_block_dense_ref(p, x, cfg=cfg_j))(jp, jx)
    got = tmoe.moe_block_dense_ref(tp, tx, cfg=cfg_t)
    if dtype == "float32":
        _close(got, want)
    else:
        assert _cosine(got, want) > 0.999


def _moe_over(p, x, cfg, mesh):
    """``moe_block`` over ``mesh``'s plan, the batch split over its data
    shards as a transformer layer hands it over -> (y, aux)."""
    plan = MeshPlan(mesh, ("data",))
    ys, aux = tmoe.moe_block(p, plan.split_batch(x), cfg=cfg, plan=plan)
    return torch.cat(ys), aux


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_moe_capacity_dispatch_on_a_one_device_mesh(top_k):
    """moe_block on a (1, 1) mesh — the path a transformer block takes on
    a mesh — with capacity 1.25: some tokens overflow and are dropped."""
    cfg_j, cfg_t, jp, tp, jx, tx = _moe_setup("float32", top_k)
    want_y, want_aux = jax.jit(lambda p, x: jmoe.moe_block(
        p, x, cfg=cfg_j, mesh=jax_mesh((1, 1), ("data", "model")), dp_axes=("data",)))(jp, jx)
    mesh = make_mesh((1, 1), ("data", "model"), devices=[CPU])
    got_y, got_aux = _moe_over(tp, tx, cfg_t, mesh)
    _close(got_y, want_y)
    _close(got_aux, want_aux, rtol=1e-6, atol=1e-6)
    T, capacity = 16, int(np.ceil(16 * top_k * 1.25 / 4))
    _, gate_e = tmoe.top_k_stable(torch.softmax(tx.reshape(T, 16) @ tp["router"], -1), top_k)
    dropped = torch.bincount(gate_e.reshape(-1), minlength=4).max() > capacity
    dense = tmoe.moe_block_dense_ref(tp, tx, cfg=cfg_t)
    assert torch.allclose(got_y, dense, atol=1e-5) != dropped


def test_moe_gate_ties_take_the_lower_expert():
    x = torch.tensor([[3.0, 1.0, 3.0, 3.0, 0.0]])
    vals, idx = tmoe.top_k_stable(x, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def test_moe_block_refuses_expert_parallelism():
    """Expert parallelism, once pinned to raise, on a (1, 2) CPU mesh: each
    rank dispatches its two experts at the one-rank capacity, so the
    result is the reference's (1, 1) block within the float32 tolerance
    (the reference's own tp > 1 is in ``tests/test_torch_multidevice.py``)."""
    cfg_j, cfg_t, jp, tp, jx, tx = _moe_setup("float32")
    want_y, want_aux = jax.jit(lambda p, x: jmoe.moe_block(
        p, x, cfg=cfg_j, mesh=jax_mesh((1, 1), ("data", "model")), dp_axes=("data",)))(jp, jx)
    mesh = make_mesh((1, 2), ("data", "model"), devices=[CPU] * 2)
    got_y, got_aux = _moe_over(tp, tx, cfg_t, mesh)
    _close(got_y, want_y)
    _close(got_aux, want_aux, rtol=1e-6, atol=1e-6)


# -- the transformer ------------------------------------------------------------
def _tokens(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_forward_prefill_decode_float32(models, arch_id):
    rc, pc, params, pp, _ = models[arch_id]
    toks = _tokens(rc, 1, 2, 20)
    want_l, want_aux = jax.jit(lambda p, t: jt.forward(rc, p, t))(params, toks)
    got_l, got_aux = tt.forward(pc, pp, _t(toks))
    _close(got_l, want_l)
    want_last, want_c = jax.jit(lambda p, t: jt.prefill(rc, p, t))(params, toks)
    got_last, got_c = tt.prefill(pc, pp, _t(toks))
    _close(got_last, want_last)
    for n in ("k", "v"):
        _close(got_c[n], want_c[n])
    # decode three tokens after the prompt, at positions 20..22 of a 24-slot cache
    jc = jt.init_cache(rc, 2, 24, dtype=jnp.float32)
    jc = jax.tree.map(lambda c, u: c.at[:, :, :20].set(u), jc, want_c)
    tc = tt.init_cache(pc, 2, 24, dtype=torch.float32, device=CPU)
    for n in ("k", "v"):
        tc[n][:, :, :20] = got_c[n]
    dec = jax.jit(lambda p, t, c, pos: jt.decode_step(rc, p, t, c, pos))
    more = _tokens(rc, 2, 2, 3)
    for i in range(3):
        want_d, jc = dec(params, more[:, i:i + 1], jc, 20 + i)
        got_d, tc = tt.decode_step(pc, pp, _t(more[:, i:i + 1]), tc, 20 + i)
        _close(got_d, want_d)
    for n in ("k", "v"):
        _close(tc[n], jc[n])


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_prefill_decode_bfloat16(models, arch_id):
    """bf16 weights and activations: prefill, then decode teacher-forced
    from position 0 on a bf16 and on an int8 cache, as test_kv_int8.py
    feeds it."""
    _, _, params, _, pp = models[arch_id]
    rc, pc = _cfgs(arch_id, "bfloat16")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    toks = _tokens(rc, 3, 4, 16)
    want_last, _ = jax.jit(lambda p, t: jt.prefill(rc, p, t))(jp, toks)
    got_last, _ = tt.prefill(pc, pp, _t(toks))
    assert _cosine(got_last, want_last) >= COS_BF16
    dec = jax.jit(lambda p, t, c, pos: jt.decode_step(rc, p, t, c, pos))
    for quantized in (False, True):
        jc = jt.init_cache(rc, 4, 16, quantized=quantized)
        tc = tt.init_cache(pc, 4, 16, quantized=quantized, device=CPU)
        want, got = [], []
        for pos in range(12):
            lj, jc = dec(jp, toks[:, pos:pos + 1], jc, pos)
            lt, tc = tt.decode_step(pc, pp, _t(toks[:, pos:pos + 1]), tc, pos)
            want.append(np.asarray(lj, np.float32))
            got.append(_np(lt))
        assert _cosine(np.stack(got), np.stack(want)) >= COS_BF16, quantized
        assert _agreement(np.stack(got), np.stack(want)) >= ARGMAX_BF16, quantized


def test_int8_cache_matches_bf16_cache():
    """test_kv_int8.py's check on the port: teacher-forced decode of 24
    tokens on a bf16 and an int8 cache of 48."""
    cfg = next(a for a in LM_ARCHS if a.arch_id == "stablelm-1.6b").reduced().model_cfg
    params = tt.init_params(cfg, 0, device=CPU, dtype=torch.bfloat16)
    stream = _t(_tokens(cfg, 1, 4, 24))
    out = {}
    for quantized in (False, True):
        cache = tt.init_cache(cfg, 4, 48, quantized=quantized, device=CPU)
        out[quantized] = torch.stack([tt.decode_step(cfg, params, stream[:, p:p + 1], cache, p)[0]
                                      for p in range(24)], dim=1)
    assert _cosine(out[True], out[False]) > 0.995
    assert _agreement(out[True], out[False]) >= 0.9


def test_init_cache_layouts():
    cfg = next(a for a in LM_ARCHS if a.arch_id == "phi3.5-moe-42b-a6.6b").reduced().model_cfg
    rc = next(a for a in REF_LM_ARCHS if a.arch_id == "phi3.5-moe-42b-a6.6b").reduced().model_cfg
    for quantized in (False, True):
        got = tt.init_cache(cfg, 3, 10, quantized=quantized, device=CPU)
        want = jt.init_cache(rc, 3, 10, quantized=quantized)
        assert sorted(got) == sorted(want)
        for n in want:
            assert tuple(got[n].shape) == want[n].shape
            assert str(got[n].dtype).split(".")[-1] == str(want[n].dtype)
            assert not got[n].any()


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_full_width_configs_and_counts(arch_id):
    ref = next(a for a in REF_LM_ARCHS if a.arch_id == arch_id)
    port = next(a for a in LM_ARCHS if a.arch_id == arch_id)
    assert port.model_cfg.param_count() == ref.model_cfg.param_count()
    assert port.model_cfg.active_param_count() == ref.model_cfg.active_param_count()
    assert port.model_cfg.vocab_padded == ref.model_cfg.vocab_padded
    assert {k: v.dims for k, v in port.shapes.items()} == {k: v.dims for k, v in ref.shapes.items()}
    assert port.skips == ref.skips and port.source == ref.source
    red_p, red_r = port.reduced(), ref.reduced()
    assert red_p.model_cfg.param_count() == red_r.model_cfg.param_count()
    params = tt.init_params(red_p.model_cfg, 0, device="meta")
    want = jax.eval_shape(lambda: jt.init_params(red_r.model_cfg, jax.random.key(0)))
    got_shapes = jax.tree.map(lambda t: tuple(t.shape), params)
    assert got_shapes == jax.tree.map(lambda s: s.shape, want)


# -- the continuous batcher -----------------------------------------------------
def _batcher_cfgs():
    return _cfgs("stablelm-1.6b", "float32")


def _drive(batcher, schedule, n_steps):
    """Submit ``schedule[step]`` before each step; the finished outputs."""
    done = {}
    for step in range(n_steps):
        for prompt in schedule.get(step, ()):
            batcher.submit(prompt)
        done.update(batcher.step())
    return done


def _pair_batchers(rc, pc, params, pp, B, max_len):
    ref = RefBatcher(rc, params, B, max_len, eos_id=-1)
    # the reference allocates a bf16 cache whatever the config; a float32
    # config needs a float32 one (its decode step raises otherwise)
    ref.caches = jt.init_cache(rc, B, max_len, dtype=jnp.float32)
    return ref, LMContinuousBatcher(pc, pp, B, max_len, eos_id=-1, device=CPU)


# A joins an empty pool; B joins at pos 2; C takes A's slot at pos 5
SCHEDULE = {0: [[5, 7, 9]], 2: [[3]], 7: [[11, 4]]}


def test_batcher_matches_reference_with_its_admission_fault(models):
    rc, pc = _batcher_cfgs()
    _, _, params, pp, _ = models["stablelm-1.6b"]
    ref, port = _pair_batchers(rc, pc, params, pp, 2, 8)
    want = _drive(ref, SCHEDULE, 16)
    got = _drive(port, SCHEDULE, 16)
    assert got == want and sorted(got) == [0, 1, 2]


def test_batcher_feeds_only_the_last_prompt_token(models):
    rc, pc = _batcher_cfgs()
    _, _, params, pp, _ = models["stablelm-1.6b"]
    outs = []
    for prompts in ([[5, 7, 9], [1, 2, 9]], [[9], [9]]):
        ref, port = _pair_batchers(rc, pc, params, pp, 2, 8)
        got = _drive(port, {0: prompts}, 8)
        assert got == _drive(ref, {0: prompts}, 8)
        outs.append(got)
    assert outs[0][0] == outs[0][1] == outs[1][0]


def test_batcher_new_slot_attends_over_previous_occupant(models):
    """C is admitted into A's slot at pos 5 = the other slot's length:
    its token lands at row 5, rows 0..4 still hold A's entries, and its
    attention (kv_len_valid 6) reads them, so C's output depends on A."""
    rc, pc = _batcher_cfgs()
    _, _, params, pp, _ = models["stablelm-1.6b"]
    outs = {}
    for first in ([5, 7, 9], [8]):
        ref, port = _pair_batchers(rc, pc, params, pp, 2, 8)
        sched = {**SCHEDULE, 0: [first]}
        _drive(port, sched, 7)
        before = port.caches["k"][:, 0].clone()
        assert before[:, :6].abs().sum(dim=(-1, -2)).min() > 0  # A's rows 0..5
        port.submit([11, 4])
        port.step()
        after = port.caches["k"][:, 0]
        assert port.lengths[1] == 6 and port.lengths[0] == 1
        torch.testing.assert_close(after[:, :5], before[:, :5], rtol=0, atol=0)
        assert not torch.equal(after[:, 5], before[:, 5])
        done = _drive(port, {}, 10)
        want = _drive(ref, sched, 17)
        assert done[2] == want[2]
        outs[tuple(first)] = done[2]
    assert outs[(5, 7, 9)] != outs[(8,)]


def test_batcher_cache_follows_the_config_dtype(models):
    _, _, _, _, pp = models["stablelm-1.6b"]
    _, pc = _cfgs("stablelm-1.6b", "bfloat16")
    b = LMContinuousBatcher(pc, pp, 2, 8, device=CPU)
    assert b.caches["k"].dtype == torch.bfloat16
    rc = next(a for a in REF_LM_ARCHS if a.arch_id == "stablelm-1.6b").reduced().model_cfg
    assert RefBatcher(rc, {}, 2, 8).caches["k"].dtype == jnp.bfloat16
