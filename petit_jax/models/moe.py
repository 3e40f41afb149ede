"""Mixture-of-Experts with FP4 expert weights (Mixtral 8x7B family).

Grouped/batched quantized matmul path (BASELINE.json config 4). The
reference's only batching analog is a host-side strided-batch loop
(tools/benchmarks/matmul/rocm/matmul_petit.cc:116-132); here tokens are
routed on-device into per-expert capacity buckets and one grouped FP4 GEMM
(ops/kernels/grouped.py) runs every held expert — all shapes static under
jit.

Weights per expert layer are stacked: words (E, k/8, n), scales (E, g, n),
gs (E,). Expert e's slice is exactly a single-expert repack, so expert
parallelism later shards axis 0.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..numerics import reference as ref_numerics
from ..ops import layout as layout_mod
from ..ops import gemm as gemm_mod
from . import llama


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0


def quantize_moe_linear(ws_kn: np.ndarray, fmt: str = "mxfp4") -> dict:
    """Stack per-expert quantized layers. ws_kn: (E, k, n) dense."""
    E = ws_kn.shape[0]
    words, scales, gss = [], [], []
    group = 32 if fmt in ("mxfp4", "mxfp4z") else 16
    quant = {"nvfp4": ref_numerics.quantize_nvfp4,
             "nvfp4p2": ref_numerics.quantize_nvfp4_pow2,
             "nvfp4p2z": ref_numerics.quantize_nvfp4_pow2z,
             "mxfp4": ref_numerics.quantize_mxfp4,
             "mxfp4z": ref_numerics.quantize_mxfp4z}[fmt]
    for e in range(E):
        w = np.asarray(ws_kn[e], np.float32).T  # (n, k)
        qw, sc, gs = quant(w)
        n, k = w.shape
        words.append(layout_mod.repack_fp4_weights(
            qw, n, k, pad_to=layout_mod.pad_multiple(group)))
        scales.append(layout_mod.process_fp4_scales(sc, n, k,
                                                    group_size=group))
        gss.append(gs)
    return {"words": jnp.asarray(np.stack(words)),
            "scales": jnp.asarray(np.stack(scales)),
            "gs": jnp.asarray(np.stack(gss))}


def moe_mlp_partial(x: jax.Array, router_w: jax.Array, experts: dict,
                    moe_cfg: MoEConfig, *, expert_base: int = 0,
                    num_local: int | None = None, fmt: str = "mxfp4",
                    interpret: bool = False) -> jax.Array:
    """Contributions of experts [expert_base, expert_base + num_local) to
    the SwiGLU MoE block, in f32: the expert-parallel building block
    (parallel/ep.py psums these across the "ep" axis). Routing is computed
    over ALL experts (router_w replicated); `experts` holds only the local
    stack, indexed 0..num_local-1. expert_base may be a traced scalar (the
    shard index under shard_map).
    """
    T, H = x.shape
    E, topk = moe_cfg.num_experts, moe_cfg.top_k
    if num_local is None:
        num_local = E
    cap = int(np.ceil(T * topk / E * moe_cfg.capacity_factor))
    cap = max(8, -(-cap // 8) * 8)

    logits = jnp.dot(x.astype(jnp.float32), router_w.astype(jnp.float32))
    gate_vals, gate_idx = jax.lax.top_k(logits, topk)        # (T, topk)
    gate_w = jax.nn.softmax(gate_vals, axis=-1)              # (T, topk)

    flat_idx = gate_idx.reshape(-1)                          # (T*topk,)
    flat_w = gate_w.reshape(-1)
    flat_tok = jnp.repeat(jnp.arange(T), topk)

    # Route with ONE sort over all (token, expert) pairs — O(sort(T*topk)),
    # independent of E (an O(E) per-expert argsort loop is hostile at
    # DeepSeek-class E=64). Stable sort keeps first-come-first-served
    # order within each expert, matching capacity-drop semantics.
    order = jnp.argsort(flat_idx, stable=True)               # (T*topk,)
    sorted_e = flat_idx[order]
    # rank of each pair within its expert = position - expert's first slot
    starts = jnp.searchsorted(sorted_e, jnp.arange(E))       # (E,)
    rank = jnp.arange(T * topk) - starts[sorted_e]
    local_e = sorted_e - expert_base
    valid = (local_e >= 0) & (local_e < num_local) & (rank < cap)
    # scatter each pair into its (expert, rank) bucket slot; invalid /
    # overflow pairs land in a sacrificial slot past the buckets
    dest = jnp.where(valid, local_e * cap + rank, num_local * cap)
    nslot = num_local * cap + 1
    buf_tok = jnp.zeros(nslot, jnp.int32).at[dest].set(
        flat_tok[order].astype(jnp.int32))
    buf_w = jnp.zeros(nslot, jnp.float32).at[dest].set(flat_w[order])
    buf_valid = jnp.zeros(nslot, bool).at[dest].set(valid)
    toks_g = buf_tok[:num_local * cap].reshape(num_local, cap)
    w_g = (buf_w[:num_local * cap] * buf_valid[:num_local * cap]
           ).reshape(num_local, cap)
    vmask = buf_valid[:num_local * cap].reshape(num_local, cap)
    xsg = x[toks_g] * vmask[..., None].astype(x.dtype)       # (El, cap, H)

    from ..ops.kernels import grouped as grouped_mod
    from ..ops.solution import ElementB

    def gmul(ys, layer):
        eb = (ElementB.MXFP4 if fmt in ("mxfp4", "mxfp4z")
              else ElementB.NVFP4)
        return grouped_mod.grouped_mul(
            ys, layer["words"], layer["scales"], layer["gs"],
            element_b=eb, interpret=interpret)

    g = gmul(xsg, experts["w_gate"])
    u = gmul(xsg, experts["w_up"])
    h = jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype) * u
    y = gmul(h, experts["w_down"])                           # (El, cap, H)
    # one scatter-add back to tokens (invalid slots carry weight 0)
    out = jnp.zeros((T, H), jnp.float32).at[toks_g.reshape(-1)].add(
        y.reshape(-1, H).astype(jnp.float32) * w_g.reshape(-1, 1))
    return out


def routing_drop_count(x: jax.Array, router_w: jax.Array,
                       moe_cfg: MoEConfig) -> jax.Array:
    """Number of (token, expert) assignments dropped by capacity overflow
    for this batch — the observability counter for capacity-factor
    routing (overflow silently zeroes contributions in moe_mlp). Serving
    loops can log this periodically; it shares the router math but runs
    outside the hot path."""
    T = x.shape[0]
    E, topk = moe_cfg.num_experts, moe_cfg.top_k
    cap = int(np.ceil(T * topk / E * moe_cfg.capacity_factor))
    cap = max(8, -(-cap // 8) * 8)
    logits = jnp.dot(x.astype(jnp.float32), router_w.astype(jnp.float32))
    _, gate_idx = jax.lax.top_k(logits, topk)
    counts = jnp.zeros(E, jnp.int32).at[gate_idx.reshape(-1)].add(1)
    return jnp.maximum(counts - cap, 0).sum()


def moe_mlp(x: jax.Array, router_w: jax.Array, experts: dict,
            moe_cfg: MoEConfig, *, fmt: str = "mxfp4",
            interpret: bool = False) -> jax.Array:
    """SwiGLU MoE block. x: (T, H) flattened tokens -> (T, H).

    experts: {"w_gate": stacked, "w_up": stacked, "w_down": stacked}.
    Top-k routing with per-expert capacity buckets; overflow tokens drop
    (standard capacity-factor semantics).
    """
    out = moe_mlp_partial(x, router_w, experts, moe_cfg, fmt=fmt,
                          interpret=interpret)
    return out.astype(x.dtype)


# ---------------------------------------------------------------------------
# Mixtral model: llama attention + MoE MLP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MixtralConfig(llama.LlamaConfig):
    num_experts: int = 8
    top_k: int = 2

    @staticmethod
    def mixtral_8x7b(**kw):
        return MixtralConfig(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1e6), **kw})

    @staticmethod
    def tiny(**kw):
        return MixtralConfig(**{**dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            max_seq_len=64, num_experts=4, top_k=2), **kw})


def init_params(cfg: MixtralConfig, key: jax.Array, dtype=jnp.bfloat16):
    base = llama.init_params(
        llama.LlamaConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(llama.LlamaConfig)}),
        key, dtype)
    ks = jax.random.split(key, cfg.num_layers + 1)
    h, f, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    for i, lp in enumerate(base["layers"]):
        sk = jax.random.split(ks[i], 4)
        for name in ("w_gate", "w_up", "w_down"):
            del lp[name]
        lp["router"] = (jax.random.normal(sk[0], (h, E), jnp.float32)
                        * 0.02).astype(dtype)
        s = 1.0 / np.sqrt(h)
        lp["experts"] = {
            "w_gate": {"w": (jax.random.normal(sk[1], (E, h, f)) * s
                             ).astype(dtype)},
            "w_up": {"w": (jax.random.normal(sk[2], (E, h, f)) * s
                           ).astype(dtype)},
            "w_down": {"w": (jax.random.normal(sk[3], (E, f, h))
                             / np.sqrt(f)).astype(dtype)},
        }
    return base


def quantize_params(params: dict, cfg: MixtralConfig, fmt: str = "mxfp4"):
    """Quantize attention projections (NVFP4) + expert weights (fmt)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lp in params["layers"]:
        q = dict(lp)
        for name in ("wq", "wk", "wv", "wo"):
            w = np.asarray(lp[name]["w"], np.float32)
            if w.shape[0] % 128 == 0 and w.shape[1] % 16 == 0:
                q[name] = llama.quantize_linear(w, "nvfp4")
        ex = lp["experts"]
        q["experts"] = {
            name: quantize_moe_linear(
                np.asarray(ex[name]["w"], np.float32), fmt)
            for name in ("w_gate", "w_up", "w_down")
        }
        out["layers"].append(q)
    return out


def forward(params, tokens, cfg: MixtralConfig, cache=None, pos=None, *,
            attn_fmt: str = "nvfp4", moe_fmt: str = "mxfp4",
            interpret: bool = False, kv_window=None, write_mask=None,
            moe_block_fn=None):
    """Mixtral forward with the same serving contract as llama.forward:
    kv_window (static) routes single-token decode through the fused
    attention kernel; write_mask (B,) bool keeps inactive/mid-prefill
    slots' KV bit-exact — so the continuous-batching engines can serve
    MoE models directly (forward_fn hook).

    moe_block_fn(x2d, router_w, experts) -> (T, H) overrides the MoE
    block — e.g. parallel/ep.py's expert-parallel shard_map block; the
    attention/cache path stays replicated while experts shard on "ep"."""
    moe_cfg = MoEConfig(cfg.num_experts, cfg.top_k)
    B, T = tokens.shape
    x = params["embed"][tokens]
    if pos is None:
        pos = jnp.broadcast_to(jnp.arange(T)[None, :], (B, T))
    mask = jnp.tril(jnp.ones((T, T), bool))[None, None]
    new_cache = []
    for i, lp in enumerate(params["layers"]):
        h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        a, c = llama.attention(h, lp, None if cache is None else cache[i],
                               pos, cfg, mask, fmt=attn_fmt,
                               interpret=interpret, kv_window=kv_window,
                               write_mask=write_mask)
        x = x + a
        h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        ex = lp["experts"]
        if moe_block_fn is not None:
            y = moe_block_fn(h.reshape(B * T, -1), lp["router"], ex)
        elif "words" in ex["w_gate"]:
            y = moe_mlp(h.reshape(B * T, -1), lp["router"], ex, moe_cfg,
                        fmt=moe_fmt, interpret=interpret)
        else:
            # dense experts oracle path
            y = _dense_moe(h.reshape(B * T, -1), lp["router"], ex, moe_cfg)
        x = x + y.reshape(B, T, -1)
        new_cache.append(c)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = llama.linear(x, params["lm_head"], interpret=interpret)
    return logits, (new_cache if cache is not None else None)


def _dense_moe(x, router_w, experts, moe_cfg: MoEConfig):
    """Dense-weight oracle with identical routing semantics (no capacity
    drop: used on tiny shapes where cap >= all tokens)."""
    T, H = x.shape
    logits = jnp.dot(x.astype(jnp.float32), router_w.astype(jnp.float32))
    gate_vals, gate_idx = jax.lax.top_k(logits, moe_cfg.top_k)
    gate_w = jax.nn.softmax(gate_vals, axis=-1)
    out = jnp.zeros((T, H), jnp.float32)
    for e in range(moe_cfg.num_experts):
        wg, wu, wd = (experts[n]["w"][e] for n in ("w_gate", "w_up", "w_down"))
        g = jnp.dot(x, wg, preferred_element_type=jnp.float32)
        u = jnp.dot(x, wu, preferred_element_type=jnp.float32)
        h = jax.nn.silu(g) * u
        y = jnp.dot(h.astype(x.dtype), wd, preferred_element_type=jnp.float32)
        w_e = jnp.where(gate_idx == e, gate_w, 0.0).sum(-1)   # (T,)
        out = out + y * w_e[:, None]
    return out.astype(x.dtype)


def make_engine_forward(cfg: MixtralConfig, *, attn_fmt: str = "nvfp4",
                        moe_fmt: str = "mxfp4", interpret: bool = False):
    """forward_fn hook for the continuous-batching engines
    (serving.Engine(..., forward_fn=..., cache=llama.init_cache(cfg, B))):
    MoE models serve through the same scheduler, fused decode attention,
    and masked-KV-write machinery as dense Llama."""
    def forward_fn(p, toks, cache_, pos_, kv_window=None, write_mask=None):
        return forward(p, toks, cfg, cache_, pos_, attn_fmt=attn_fmt,
                       moe_fmt=moe_fmt, interpret=interpret,
                       kv_window=kv_window, write_mask=write_mask)
    return forward_fn
