"""Llama-3 family inference model with NVFP4/MXFP4 weight-only linears.

The reference delegates serving to SGLang/vLLM (README.md:21); the north star
requires a native serving path, so this is new-build territory: a pure-JAX
Llama (RMSNorm / RoPE / GQA / SwiGLU) whose projection weights live in the
petit FP4 layout and run through the FP4 GEMM (ops/kernels/fused.py).

Weights are a plain pytree:
  dense linear   : {"w": bf16 (k, n)}
  quantized linear: {"words": u32 (k/8, n), "scales": u8 (k/group, n),
                     "gs": f32 scalar}
so the same forward works for BF16 baselines and FP4, enabling MMLU-delta
style comparisons (BASELINE.md).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import os
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..numerics import reference as ref_numerics
from ..ops import layout as layout_mod
from ..ops import gemm as gemm_mod
from ..ops.kernels import attention as attn_quant
from ..ops.solution import ElementB


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 2048
    attn_bias: bool = False     # Qwen2-style bias on q/k/v projections

    @staticmethod
    def llama3_8b(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128), **kw})

    @staticmethod
    def llama3_70b(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128), **kw})

    @staticmethod
    def qwen2_7b(**kw):
        """Qwen2/Qwen2.5-7B: Llama architecture + QKV bias, 1e6 rope."""
        return LlamaConfig(**{**dict(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
            rope_theta=1e6, rms_eps=1e-6, attn_bias=True), **kw})

    @staticmethod
    def tiny(**kw):
        """Small config for tests/compile checks; same code path."""
        return LlamaConfig(**{**dict(
            vocab_size=512, hidden_size=256, intermediate_size=512,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
            max_seq_len=128), **kw})


# ---------------------------------------------------------------------------
# Linear layers
# ---------------------------------------------------------------------------

# (block_nf, block_nd) preferences for fmt="hybrid", widest first; a layer
# falls back to pure nvfp4 when no pair divides its n.
_HYBRID_BLOCKS = ((1536, 512), (768, 256), (384, 128))


def quantize_linear(w_kn: np.ndarray, fmt: str = "nvfp4") -> dict:
    """Dense (k, n) f32/bf16 -> quantized FP4 layer dict. fmt="hybrid"
    keeps the most salient columns dense bf16 (ops/hybrid.py), falling back
    to nvfp4 for layers too narrow to split."""
    if fmt == "hybrid":
        from ..ops import hybrid as hybrid_mod
        n = np.asarray(w_kn).shape[1]
        for (bnf, bnd) in _HYBRID_BLOCKS:
            if n % (bnf + bnd) == 0:
                return hybrid_mod.quantize_hybrid(
                    np.asarray(w_kn, np.float32), block_nf=bnf, block_nd=bnd)
        fmt = "nvfp4"  # too narrow to split: pure FP4
    w = np.asarray(w_kn, np.float32).T  # (n, k): checkpoint orientation
    if fmt in ("nvfp4", "w4a8"):  # w4a8: same container, int8 compute
        qw, scales, gs = ref_numerics.quantize_nvfp4(w)
        group = 16
    elif fmt == "nvfp4p2":  # pow2-scale NVFP4: int-scale kernel fast path
        qw, scales, gs = ref_numerics.quantize_nvfp4_pow2(w)
        group = 16
    elif fmt == "nvfp4p2z":  # zero-free pow2: flag-free decode at the
        qw, scales, gs = ref_numerics.quantize_nvfp4_pow2z(w)  # DMA floor
        group = 16
    elif fmt == "mxfp4z":  # zero-free MXFP4: flag-free decode, halved
        qw, scales, gs = ref_numerics.quantize_mxfp4z(w)  # scale bytes
        group = 32
    else:
        qw, scales, gs = ref_numerics.quantize_mxfp4(w)
        group = 32
    n, k = w.shape
    words = layout_mod.repack_fp4_weights(
        qw, n, k, pad_to=layout_mod.pad_multiple(group))
    st = layout_mod.process_fp4_scales(scales, n, k, group_size=group)
    return {"words": jnp.asarray(words), "scales": jnp.asarray(st),
            "gs": jnp.float32(gs)}


def linear(x: jax.Array, layer: dict, *, fmt: str = "nvfp4",
           interpret: bool = False) -> jax.Array:
    """y = x @ W (+ b) for dense or FP4-quantized layer dicts. x: (..., k).
    An optional "b" entry (Qwen2-style QKV bias) is added in bf16 after the
    matmul — it never participates in quantization."""
    *lead, k = x.shape
    if "w" in layer:
        y = jnp.dot(x, layer["w"], preferred_element_type=jnp.float32
                    ).astype(x.dtype)
        return y + layer["b"].astype(y.dtype) if "b" in layer else y
    m = int(np.prod(lead)) if lead else 1
    x2 = x.reshape(m, k)
    if "wd" in layer:  # hybrid FP4+BF16 layer (ops/hybrid.py)
        from ..ops import hybrid as hybrid_mod
        y = hybrid_mod.mul_hybrid(x2.astype(jnp.bfloat16), layer,
                                  interpret=interpret).astype(x.dtype)
        n = y.shape[-1]
    else:
        n = layer["words"].shape[1]
        # fmt="hybrid" layers too narrow to split fall back to pure nvfp4
        pure_fmt = (fmt if fmt in ("mxfp4", "mxfp4z", "nvfp4p2",
                                   "nvfp4p2z", "w4a8") else "nvfp4")
        if interpret:
            mul = {"nvfp4": gemm_mod.mul_nvfp4_a16,
                   "nvfp4p2": gemm_mod.mul_nvfp4p2_a16,
                   "nvfp4p2z": gemm_mod.mul_nvfp4p2z_a16,
                   "w4a8": gemm_mod.mul_nvfp4_a8,
                   "mxfp4": gemm_mod.mul_mxfp4_a16,
                   "mxfp4z": gemm_mod.mul_mxfp4z_a16}[pure_fmt]
            y = mul(x2, layer["words"], layer["scales"], layer["gs"], m, n,
                    k, -1, interpret=True)
        else:
            # differentiable path (custom VJP): grads flow to activations
            y = gemm_mod.mul_fp4_diff(pure_fmt, k, x2, layer["words"],
                                      layer["scales"], layer["gs"])
    if "b" in layer:
        y = y + layer["b"].astype(y.dtype)
    return y.reshape(*lead, n)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def init_params(cfg: LlamaConfig, key: jax.Array,
                dtype=jnp.bfloat16) -> dict:
    """Random-init dense params (testing / synthetic benchmarks)."""
    ks = jax.random.split(key, cfg.num_layers + 2)
    h, q = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    f = cfg.intermediate_size

    def dense(key, k, n, scale=None, bias=False):
        scale = scale or (1.0 / np.sqrt(k))
        out = {"w": (jax.random.normal(key, (k, n), jnp.float32) * scale
                     ).astype(dtype)}
        if bias:
            out["b"] = (jax.random.normal(jax.random.fold_in(key, 1), (n,),
                                          jnp.float32) * 0.02).astype(dtype)
        return out

    def layer_params(key):
        sk = jax.random.split(key, 7)
        return {
            "attn_norm": jnp.ones((h,), dtype),
            "wq": dense(sk[0], h, q, bias=cfg.attn_bias),
            "wk": dense(sk[1], h, kv, bias=cfg.attn_bias),
            "wv": dense(sk[2], h, kv, bias=cfg.attn_bias),
            "wo": dense(sk[3], q, h),
            "mlp_norm": jnp.ones((h,), dtype),
            "w_gate": dense(sk[4], h, f),
            "w_up": dense(sk[5], h, f),
            "w_down": dense(sk[6], f, h),
        }

    return {
        "embed": (jax.random.normal(ks[0], (cfg.vocab_size, h), jnp.float32)
                  * 0.02).astype(dtype),
        "layers": [layer_params(ks[i + 1]) for i in range(cfg.num_layers)],
        "final_norm": jnp.ones((h,), dtype),
        "lm_head": dense(ks[-1], h, cfg.vocab_size, scale=0.02),
    }


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def host_map(fn, items) -> list:
    """[fn(x) for x in items] on a small thread pool. Host quantization is
    numpy array work that releases the GIL, so a model's matrices quantize
    in parallel; at most 8 are in flight, which bounds host memory."""
    items = list(items)
    workers = min(8, os.cpu_count() or 1, len(items))
    if workers <= 1:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


def _dense(lp: dict, *names: str) -> np.ndarray:
    ws = [np.asarray(lp[n]["w"], np.float32) for n in names]
    return ws[0] if len(ws) == 1 else np.concatenate(ws, axis=1)


# Fuse wq|wk|wv and w_gate|w_up along n before quantizing: one wide kernel
# launch instead of three/two narrow ones (the kv projections are the
# narrowest matmuls in the model). Split back in attention()/mlp().
_FUSED = {"wqkv": ("wq", "wk", "wv"), "w_gateup": ("w_gate", "w_up"),
          "wo": ("wo",), "w_down": ("w_down",)}


def quantize_params(params: dict, fmt: str = "nvfp4",
                    min_k: int = 128, fuse: bool = True,
                    quant_head: bool = False) -> dict:
    """Quantize every projection weight to FP4 (embed/lm_head stay dense,
    like ModelOpt checkpoints the reference consumes, README.md:31). With
    fuse=True (default) wq|wk|wv and w_gate|w_up are concatenated along n
    before quantization — 4 kernel launches per layer instead of 7, and
    the narrow kv projections ride the wide fused matmul. The matrices
    quantize in parallel on the host (host_map).

    quant_head=True additionally quantizes lm_head (decode streams it
    every step: a bf16 head is ~6% of the 8B-class weight stream; FP4
    cuts that 3.2x). Off by default — ModelOpt checkpoints keep the head
    dense, and head quantization is a distinct quality decision (gate it
    with tools/quality_gate.py --quant-head before adopting)."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "lm_head": params["lm_head"], "layers": []}
    jobs = []          # (output layer dict, key, source layer, source keys)
    if quant_head:
        shape = np.shape(params["lm_head"]["w"])
        if shape[0] % min_k == 0 and shape[1] % 16 == 0:
            jobs.append((out, "lm_head", params, ("lm_head",)))
    for lp in params["layers"]:
        quantizable = all(
            np.shape(lp[n]["w"])[0] % min_k == 0
            and np.shape(lp[n]["w"])[1] % 16 == 0 for n in _QUANT_KEYS)
        if fuse and quantizable and fmt != "hybrid":
            q = {k: v for k, v in lp.items() if k not in _QUANT_KEYS}
            jobs += [(q, name, lp, src) for name, src in _FUSED.items()]
        else:
            q = dict(lp)
            for name in _QUANT_KEYS:
                shape = np.shape(lp[name]["w"])
                if shape[0] % min_k == 0 and shape[1] % 16 == 0:
                    jobs.append((q, name, lp, (name,)))
        out["layers"].append(q)
    done = host_map(lambda j: quantize_linear(_dense(j[2], *j[3]), fmt), jobs)
    for (q, name, lp, src), layer in zip(jobs, done):
        if "b" in lp[src[0]]:   # Qwen2 QKV bias rides the (fused) projection
            layer["b"] = jnp.concatenate([jnp.asarray(lp[nm]["b"])
                                          for nm in src])
        q[name] = layer
    return out


def init_quantized_params(cfg: LlamaConfig, key: jax.Array,
                          fmt: str = "nvfp4") -> dict:
    """Random FP4 model fabricated ON THE DEVICE (smoke tests, benchmarks
    at full width): the pytree quantize_params(init_params(...), fmt)
    builds — fused wqkv / w_gateup, dense bf16 embed and lm_head — but
    from random packed words and bounded scales (utils/testdata.
    random_fp4_layer), with no host pass over the weights."""
    from ..utils import testdata

    h, d = cfg.hidden_size, cfg.head_dim
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * d
    f = cfg.intermediate_size
    ks = jax.random.split(key, cfg.num_layers + 2)

    def layer(k):
        k = jax.random.split(k, 4)
        return {
            "attn_norm": jnp.ones((h,), jnp.bfloat16),
            "mlp_norm": jnp.ones((h,), jnp.bfloat16),
            "wqkv": testdata.random_fp4_layer(k[0], h, qkv, fmt),
            "wo": testdata.random_fp4_layer(k[1], cfg.num_heads * d, h, fmt),
            "w_gateup": testdata.random_fp4_layer(k[2], h, 2 * f, fmt),
            "w_down": testdata.random_fp4_layer(k[3], f, h, fmt),
        }

    return {
        "embed": (jax.random.normal(ks[0], (cfg.vocab_size, h), jnp.float32)
                  * 0.02).astype(jnp.bfloat16),
        "layers": [layer(ks[i + 1]) for i in range(cfg.num_layers)],
        "final_norm": jnp.ones((h,), jnp.bfloat16),
        "lm_head": {"w": (jax.random.normal(ks[-1], (h, cfg.vocab_size),
                                            jnp.float32)
                          * (1.0 / np.sqrt(h))).astype(jnp.bfloat16)},
    }


def rms_norm(x: jax.Array, w: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps)).astype(x.dtype) * w


def _rope_angles(pos: jax.Array, d: int, theta: float):
    """(cos, sin) each (B, T, 1, d/2) f32 for absolute positions pos (B, T).
    Hoisted out of the per-layer rope: every layer (and q/k within a layer)
    shares one pair of transcendental evaluations per forward."""
    freqs = 1.0 / (theta ** (jnp.arange(0, d, 2, dtype=jnp.float32) / d))
    ang = pos[:, :, None, None].astype(jnp.float32) * freqs  # (B,T,1,d/2)
    return jnp.cos(ang), jnp.sin(ang)


def _rope_apply(x: jax.Array, cs) -> jax.Array:
    """Interleaved-pair rotary application; x (B, T, H, D)."""
    cos, sin = cs
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    return jnp.stack([xr1, xr2], axis=-1).reshape(x.shape).astype(x.dtype)


def rope(x: jax.Array, pos: jax.Array, theta: float) -> jax.Array:
    """x: (B, T, H, D), pos: (B, T) absolute positions."""
    return _rope_apply(x, _rope_angles(pos, x.shape[-1], theta))


def attention(x, lp, cache, pos, cfg: LlamaConfig, mask, *, fmt, interpret,
              kv_window: Optional[int] = None,
              write_mask: Optional[jax.Array] = None, rope_cs=None):
    B, T, H = x.shape
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lin = functools.partial(linear, fmt=fmt, interpret=interpret)
    if "wqkv" in lp:  # fused projection (quantize_params fuse=True)
        qkv = lin(x, lp["wqkv"])
        s0, s1 = nq * d, (nq + nkv) * d  # split points from cfg (static)
        q, k, v = qkv[..., :s0], qkv[..., s0:s1], qkv[..., s1:]
        q = q.reshape(B, T, nq, d)
        k = k.reshape(B, T, nkv, d)
        v = v.reshape(B, T, nkv, d)
    else:
        q = lin(x, lp["wq"]).reshape(B, T, nq, d)
        k = lin(x, lp["wk"]).reshape(B, T, nkv, d)
        v = lin(x, lp["wv"]).reshape(B, T, nkv, d)
    # one fused rotary application over q||k (the per-head math is
    # identical and elementwise, so concatenating the head axis halves the
    # slice/stack op count); angles are hoisted per forward via rope_cs
    if rope_cs is None:
        rope_cs = _rope_angles(pos, d, cfg.rope_theta)
    qk = _rope_apply(jnp.concatenate([q, k], axis=2), rope_cs)
    q, k = qk[:, :, :nq], qk[:, :, nq:]

    if cache is not None:
        ck, cv = cache  # (B, S, nkv, d) flat, or (B, nkv, S, d) headed
        headed = cache_is_headed(ck, cfg)
        # per-sequence write offset: slots in a continuously-batched decode
        # step sit at different positions; rows with write_mask False keep
        # their cache content bit-exactly
        ck, cv = attn_quant.kv_write(ck, cv, k, v, pos[:, 0], write_mask,
                                     headed=headed)
        new_cache = (ck, cv)
        S = ck.shape[2] if headed else ck.shape[1]
        if kv_window is not None and T == 1:
            # decode attention over the static window of the first
            # kv_window positions: the bytes read track the batch's
            # bucketed length, not max_seq_len
            o = attn_quant.decode_attention(
                q.reshape(B, nq, d), ck, cv, pos[:, 0],
                window=min(kv_window, S), headed=headed)
            o = o.reshape(B, T, nq * d).astype(x.dtype)
            return lin(o, lp["wo"]), new_cache
        if kv_window is not None:
            # chunked prefill over the cache: assumes this chunk's
            # positions are contiguous pos[b, t] = pos[b, 0] + t (the
            # chunked-prefill contract; generic callers keep the masked
            # path by not passing kv_window)
            o = attn_quant.prefill_attention(
                q, ck, cv, pos[:, 0], window=min(kv_window, S),
                headed=headed)
            o = o.reshape(B, T, nq * d).astype(x.dtype)
            return lin(o, lp["wo"]), new_cache
        if headed:  # masked fallback consumes (B, S, nkv, d)
            k_all = ck.transpose(0, 2, 1, 3).astype(x.dtype)
            v_all = cv.transpose(0, 2, 1, 3).astype(x.dtype)
        else:
            k_all, v_all = ck.astype(x.dtype), cv.astype(x.dtype)
        # per-query causal mask against absolute positions: query at pos[b,t]
        # may attend kv slots <= pos[b,t] (a (B,1,1,S) mask keyed only on the
        # LAST position would let earlier prompt tokens see the future during
        # multi-token cached prefill)
        kv_pos = jnp.arange(S)[None, None, :]           # (1,1,S)
        attn_mask = (kv_pos <= pos[:, :, None])[:, None]  # (B,1,T,S)
    else:
        k_all, v_all = k, v
        new_cache = None
        attn_mask = mask  # (1,1,T,T) causal

    # GQA: repeat kv heads
    rep = nq // nkv
    k_all = jnp.repeat(k_all, rep, axis=2)
    v_all = jnp.repeat(v_all, rep, axis=2)

    qf = q.astype(jnp.float32) / np.sqrt(d)
    logits = jnp.einsum("bthd,bshd->bhts", qf, k_all.astype(jnp.float32))
    logits = jnp.where(attn_mask, logits, -1e30)
    p = jax.nn.softmax(logits, axis=-1)
    o = jnp.einsum("bhts,bshd->bthd", p, v_all.astype(jnp.float32))
    o = o.reshape(B, T, nq * d).astype(x.dtype)
    return lin(o, lp["wo"]), new_cache


def mlp(x, lp, *, fmt, interpret):
    lin = functools.partial(linear, fmt=fmt, interpret=interpret)
    if "w_gateup" in lp:  # fused projection (quantize_params fuse=True)
        gu = lin(x, lp["w_gateup"])
        g, u = jnp.split(gu, 2, axis=-1)
    else:
        g = lin(x, lp["w_gate"])
        u = lin(x, lp["w_up"])
    return lin(jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype) * u,
               lp["w_down"])


def forward(params, tokens, cfg: LlamaConfig, cache=None, pos=None, *,
            fmt: str = "nvfp4", interpret: bool = False,
            kv_window: Optional[int] = None,
            write_mask: Optional[jax.Array] = None):
    """tokens (B, T) -> logits (B, T, V); cache: list of per-layer (k, v) or
    None for full-sequence (prefill/eval) mode. kv_window (static): when
    set and T == 1, decode attention runs through the fused kernel reading
    only ~kv_window KV positions (engines pass the batch's bucketed max
    length — the compile count stays O(log max_seq)). write_mask (B,) bool:
    rows with False keep their KV cache bit-exact (inactive/mid-prefill
    slots in a batched decode step)."""
    B, T = tokens.shape
    x = params["embed"][tokens]
    if pos is None:
        pos = jnp.broadcast_to(jnp.arange(T)[None, :], (B, T))
    mask = jnp.tril(jnp.ones((T, T), bool))[None, None]
    rope_cs = _rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    new_cache = []
    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        a, c = attention(h, lp, None if cache is None else cache[i],
                         pos, cfg, mask, fmt=fmt, interpret=interpret,
                         kv_window=kv_window, write_mask=write_mask,
                         rope_cs=rope_cs)
        x = x + a
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + mlp(h, lp, fmt=fmt, interpret=interpret)
        new_cache.append(c)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = linear(x, params["lm_head"], fmt=fmt, interpret=interpret)
    return logits, (new_cache if cache is not None else None)


def init_cache(cfg: LlamaConfig, batch: int, dtype=jnp.bfloat16,
               headed: Optional[bool] = None):
    """KV cache. dtype may be jnp.float8_e4m3fn for FP8 KV (halves cache
    footprint and decode traffic — north-star config 5, BASELINE.json).

    FP8 caches default to the HEADED (B, Hkv, S, d) layout, bf16 caches to
    (B, S, Hkv, d); override with headed= (e.g. parallel.tp shards the
    head axis of the flat layout). Attention reads either layout."""
    if headed is None:
        headed = dtype == jnp.float8_e4m3fn
    S = cfg.max_seq_len
    if headed and S == cfg.num_kv_heads:
        # cache_is_headed resolves layout from shapes; S == Hkv would make
        # a headed cache indistinguishable from flat — reject at
        # construction rather than silently attending transposed data
        raise ValueError(
            f"headed cache needs max_seq_len != num_kv_heads "
            f"(both are {S}); pad max_seq_len")
    shape = ((batch, cfg.num_kv_heads, S, cfg.head_dim)
             if headed else
             (batch, S, cfg.num_kv_heads, cfg.head_dim))
    return [(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))
            for _ in range(cfg.num_layers)]


def cache_is_headed(ck, cfg: LlamaConfig) -> bool:
    """Layout of a contiguous cache array: headed (B, Hkv, S, d) vs flat
    (B, S, Hkv, d). Resolved from cfg; the ambiguous S == num_kv_heads
    case resolves to flat (the legacy layout)."""
    if ck.shape[2] == cfg.num_kv_heads and ck.shape[1] != cfg.num_kv_heads:
        return False
    if ck.shape[1] == cfg.num_kv_heads and ck.shape[2] != cfg.num_kv_heads:
        return True
    return False


def greedy_decode(params, cfg: LlamaConfig, prompt_tokens, max_new: int, *,
                  fmt: str = "nvfp4", cache_dtype=jnp.bfloat16,
                  interpret: bool = False):
    """Greedy generation: prefill then token-by-token decode with KV cache."""
    B, T0 = prompt_tokens.shape
    cache = init_cache(cfg, B, cache_dtype)
    pos = jnp.broadcast_to(jnp.arange(T0)[None, :], (B, T0))
    logits, cache = forward(params, prompt_tokens, cfg, cache, pos,
                            fmt=fmt, interpret=interpret)
    tok = jnp.argmax(logits[:, -1], axis=-1)
    out = [tok]

    step_fn = functools.partial(forward, cfg=cfg, fmt=fmt, interpret=interpret)
    if not interpret:
        step_fn = jax.jit(step_fn, static_argnames=())
    for t in range(max_new - 1):
        p = jnp.full((B, 1), T0 + t, jnp.int32)
        logits, cache = step_fn(params, tok[:, None], cache=cache, pos=p)
        tok = jnp.argmax(logits[:, -1], axis=-1)
        out.append(tok)
    return jnp.stack(out, axis=1)
