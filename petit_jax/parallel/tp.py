"""Tensor-parallel FP4 inference: Mesh + shard_map over the FP4 GEMM.

The reference has no distributed code — multi-GPU serving is delegated to
SGLang's TP above the library (README.md:3,21; SURVEY.md section 2.3).
The equivalent layer is built here, the idiomatic JAX way: a
jax.sharding.Mesh with named axes ("dp", "tp"), Megatron-style
column/row-parallel quantized linears under shard_map, and XLA collectives
(psum / all_gather), which XLA hands to NCCL over the cards' all-to-all
links.

Key layout interaction: the petit weight layout interleaves k-quarters
globally (ops/layout.py), so row(k)-parallel weights must be repacked
PER SHARD; the packed rows of shard t then occupy block t of axis 0 and a
plain NamedSharding P("tp", None) places them correctly.  Column(n)-parallel
weights repack column-independently, so P(None, "tp") just works.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from ._compat import shard_map

from ..numerics import reference as ref_numerics
from ..ops import layout as layout_mod
from ..ops import gemm as gemm_mod
from ..models import llama


# ---------------------------------------------------------------------------
# Param sharding for the dense model (GSPMD path: training / BF16 baselines)
# ---------------------------------------------------------------------------

def shard_dense_params(params: dict, mesh: Mesh) -> dict:
    """Megatron-style NamedShardings on the dense llama pytree; XLA inserts
    the collectives (all-gather / reduce-scatter) under jit."""
    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    out = {
        "embed": put(params["embed"], P(None, None)),
        "final_norm": put(params["final_norm"], P(None)),
        "lm_head": {"w": put(params["lm_head"]["w"], P(None, "tp"))},
        "layers": [],
    }
    col = P(None, "tp")   # column parallel: shard output features
    row = P("tp", None)   # row parallel: shard input features
    for lp in params["layers"]:
        out["layers"].append({
            "attn_norm": put(lp["attn_norm"], P(None)),
            "mlp_norm": put(lp["mlp_norm"], P(None)),
            "wq": {"w": put(lp["wq"]["w"], col)},
            "wk": {"w": put(lp["wk"]["w"], col)},
            "wv": {"w": put(lp["wv"]["w"], col)},
            "wo": {"w": put(lp["wo"]["w"], row)},
            "w_gate": {"w": put(lp["w_gate"]["w"], col)},
            "w_up": {"w": put(lp["w_up"]["w"], col)},
            "w_down": {"w": put(lp["w_down"]["w"], row)},
        })
    return out


# ---------------------------------------------------------------------------
# FP4 TP quantization: per-shard repack
# ---------------------------------------------------------------------------

def quantize_linear_tp(w_kn: np.ndarray, tp: int, shard: str,
                       fmt: str = "nvfp4") -> dict:
    """Quantize + repack a dense (k, n) weight for tp-way sharding.

    shard="n": column parallel — one global quantize/repack; the layout is
      column-independent so slicing columns later is exact.
    shard="k": row parallel — each k-slice is quantized (shared global
      scale) and repacked separately, then concatenated along packed rows so
      P("tp", None) splits at shard boundaries.
    """
    w = np.asarray(w_kn, np.float32).T  # (n, k)
    n, k = w.shape
    quant = {"nvfp4": ref_numerics.quantize_nvfp4,
             "nvfp4p2": ref_numerics.quantize_nvfp4_pow2,
             "nvfp4p2z": ref_numerics.quantize_nvfp4_pow2z,
             "mxfp4": ref_numerics.quantize_mxfp4}[fmt]
    group = 32 if fmt == "mxfp4" else 16
    if shard == "n":
        qw, scales, gs = quant(w)
        words = layout_mod.repack_fp4_weights(
            qw, n, k, pad_to=layout_mod.pad_multiple(group))
        st = layout_mod.process_fp4_scales(scales, n, k, group_size=group)
        return {"words": jnp.asarray(words), "scales": jnp.asarray(st),
                "gs": jnp.float32(gs)}
    assert shard == "k" and k % tp == 0, (shard, k, tp)
    ks = k // tp
    if fmt == "mxfp4":
        gs = np.float32(1.0)
    else:
        amax = np.abs(w).max()
        gs = np.float32(amax / (6.0 * 448.0)) if amax > 0 else np.float32(1.0)
    words_parts, scale_parts = [], []
    for t in range(tp):
        wt = w[:, t * ks:(t + 1) * ks]
        if fmt == "mxfp4":
            qw, scales, _ = ref_numerics.quantize_mxfp4(wt)
        else:
            qw, scales, _ = quant(wt, global_scale=gs)
        words_parts.append(layout_mod.repack_fp4_weights(
            qw, n, ks, pad_to=layout_mod.pad_multiple(group)))
        scale_parts.append(layout_mod.process_fp4_scales(
            scales, n, ks, group_size=group))
    return {"words": jnp.asarray(np.concatenate(words_parts, axis=0)),
            "scales": jnp.asarray(np.concatenate(scale_parts, axis=0)),
            "gs": jnp.float32(gs)}


_COL_KEYS = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW_KEYS = ("wo", "w_down")


def quantize_tp(params: dict, tp: int, fmt: str = "nvfp4") -> dict:
    """Quantize dense llama params for tp-way tensor parallelism, not yet
    placed: column-parallel projections quantize globally, row-parallel
    ones per shard (quantize_linear_tp). The matrices quantize in parallel
    on the host (llama.host_map). One result can be placed on several
    meshes (place_params_tp), e.g. one per data-parallel replica."""
    layers, jobs = [], []       # jobs: (output layer, key, source, shard)
    for lp in params["layers"]:
        q = {"attn_norm": lp["attn_norm"], "mlp_norm": lp["mlp_norm"]}
        layers.append(q)
        jobs += [(q, name, lp, "n") for name in _COL_KEYS]
        jobs += [(q, name, lp, "k") for name in _ROW_KEYS]
    done = llama.host_map(lambda j: quantize_linear_tp(
        np.asarray(j[2][j[1]]["w"], np.float32), tp, j[3], fmt), jobs)
    for (q, name, _, _), layer in zip(jobs, done):
        q[name] = layer
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"], "layers": layers}


def place_params_tp(qparams: dict, mesh: Mesh) -> dict:
    """Put quantize_tp's params on `mesh` with the specs the TP forward
    reads (_params_spec): column-parallel words/scales split on n,
    row-parallel ones on packed k, the rest replicated."""
    return jax.tree.map(
        lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
        qparams, _params_spec(qparams))


def quantize_params_tp(params: dict, cfg: llama.LlamaConfig, mesh: Mesh,
                       fmt: str = "nvfp4") -> dict:
    """Quantize dense llama params for tp-way tensor parallelism and place
    shards on the mesh."""
    return place_params_tp(quantize_tp(params, mesh.shape["tp"], fmt), mesh)


# ---------------------------------------------------------------------------
# TP forward (device-local Megatron block under shard_map)
# ---------------------------------------------------------------------------

def _params_spec(qparams):
    qspec_col = {"words": P(None, "tp"), "scales": P(None, "tp"), "gs": P()}
    qspec_row = {"words": P("tp", None), "scales": P("tp", None), "gs": P()}
    layer_spec = {
        "attn_norm": P(None), "mlp_norm": P(None),
        **{k: qspec_col for k in _COL_KEYS},
        **{k: qspec_row for k in _ROW_KEYS},
    }
    return {
        "embed": P(None, None),
        "final_norm": P(None),
        "lm_head": {"w": P(None, "tp")},
        "layers": [layer_spec for _ in qparams["layers"]],
    }


# KV cache shards on the head axis, like the attention that produces it:
# flat (B, S, Hkv, d) -> axis 2; headed (B, Hkv, S, d) -> axis 1 (the fp8
# default, llama.init_cache headed=True).
_CACHE_SPEC = (P("dp", None, "tp", None), P("dp", None, "tp", None))
_CACHE_SPEC_HEADED = (P("dp", "tp", None, None), P("dp", "tp", None, None))


def _cache_specs(cache, cfg):
    """Per-layer cache PartitionSpecs resolved from the cache layout."""
    return [(_CACHE_SPEC_HEADED if llama.cache_is_headed(layer[0], cfg)
             else _CACHE_SPEC) for layer in cache]


def _local_forward(qparams, tokens, cache, pos, cfg, tp, fmt,
                   write_mask=None, kv_window=None):
    """Device-local Megatron block: heads column-sharded, wo/down
    row-sharded, one psum per block. Reuses llama.attention/mlp with a
    per-shard head count, so the cached-decode path (continuous batching)
    and the cacheless prefill path are the same code as single-device."""
    import dataclasses as _dc

    B, T = tokens.shape
    cfg_l = _dc.replace(cfg, num_heads=cfg.num_heads // tp,
                        num_kv_heads=cfg.num_kv_heads // tp)
    x = qparams["embed"][tokens]
    if pos is None:
        pos = jnp.broadcast_to(jnp.arange(T)[None, :], (B, T))
    mask = jnp.tril(jnp.ones((T, T), bool))[None, None]
    new_cache = []
    for i, lp in enumerate(qparams["layers"]):
        h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        a, c = llama.attention(h, lp, None if cache is None else cache[i],
                               pos, cfg_l, mask, fmt=fmt, interpret=False,
                               kv_window=kv_window, write_mask=write_mask)
        new_cache.append(c)
        x = x + jax.lax.psum(a, "tp")                 # row-parallel wo
        h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        dn = llama.mlp(h, lp, fmt=fmt, interpret=False)
        x = x + jax.lax.psum(dn, "tp")                # row-parallel w_down
    x = llama.rms_norm(x, qparams["final_norm"], cfg.rms_eps)
    logits_local = jnp.dot(x, qparams["lm_head"]["w"],
                           preferred_element_type=jnp.float32)
    logits = jax.lax.all_gather(logits_local, "tp", axis=2, tiled=True)
    return logits.astype(jnp.bfloat16), new_cache


def make_tp_forward(cfg: llama.LlamaConfig, mesh: Mesh, fmt: str = "nvfp4"):
    """Jitted (qparams, tokens) -> logits TP+DP prefill-style forward."""
    tp = mesh.shape["tp"]
    assert cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0

    def local(qparams, tokens):
        logits, _ = _local_forward(qparams, tokens, None, None, cfg, tp, fmt)
        return logits

    def fwd(qparams, tokens):
        fn = shard_map(
            local, mesh=mesh,
            in_specs=(_params_spec(qparams), P("dp", None)),
            out_specs=P("dp", None, None),
            check_rep=False,
        )
        return fn(qparams, tokens)

    return jax.jit(fwd)


def init_cache_tp(cfg: llama.LlamaConfig, batch: int, mesh: Mesh,
                  dtype=jnp.bfloat16, headed: bool | None = None):
    """Per-layer (k, v) KV cache sharded on the head axis over "tp" and the
    batch axis over "dp" (one engine batch per dp shard uses batch=local).

    Like llama.init_cache, fp8 caches default to the HEADED (B, Hkv, S, d)
    layout — Hkv shards over "tp" exactly like the flat layout's head
    axis, and each shard's attention takes the per-shard hkv. The
    north-star 70B-TP8 + FP8-KV config serves through this path."""
    if headed is None:
        headed = dtype == jnp.float8_e4m3fn
    cache = llama.init_cache(cfg, batch, dtype, headed=headed)
    spec = _CACHE_SPEC_HEADED if headed else _CACHE_SPEC
    return [tuple(jax.device_put(t, NamedSharding(mesh, s))
                  for t, s in zip(layer, spec)) for layer in cache]


def mul_fp4_tp_rs(a: jax.Array, layer: dict, mesh: Mesh, size_k: int,
                  fmt: str = "nvfp4"):
    """k-sharded fused FP4 GEMM with a REDUCE-SCATTER epilogue (SURVEY
    §2.3): words/scales sharded on packed-k (quantize_linear_tp shard="k",
    per-shard repack), activations sharded on k, each device runs its local
    fused GEMM and the partial sums are psum_scatter'd over n — every
    device ends with an (m, n/tp) shard instead of psum-then-keep-full.

    Halves the epilogue's per-device receive volume vs psum and leaves the
    output column-sharded — exactly the layout the next column-parallel
    consumer wants, so XLA can overlap the scatter with that consumer's
    dequant+matmul. Pinned against the psum path in tests/test_parallel.py.
    """
    tp = mesh.shape["tp"]
    n = layer["words"].shape[1]
    assert n % tp == 0 and size_k % tp == 0
    mul = {"nvfp4": gemm_mod.mul_nvfp4_a16,
           "nvfp4p2": gemm_mod.mul_nvfp4p2_a16,
           "nvfp4p2z": gemm_mod.mul_nvfp4p2z_a16,
           "mxfp4": gemm_mod.mul_mxfp4_a16}[fmt]

    def local(a_l, words_l, scales_l, gs):
        m = a_l.shape[0]
        y = mul(a_l, words_l, scales_l, gs, m, n, size_k // tp, -1)
        return jax.lax.psum_scatter(y, "tp", scatter_dimension=1,
                                    tiled=True)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "tp"), P("tp", None), P("tp", None), P()),
        out_specs=P(None, "tp"), check_rep=False)
    return fn(a, layer["words"], layer["scales"], layer["gs"])


def make_tp_forward_sp(cfg: llama.LlamaConfig, mesh: Mesh,
                       fmt: str = "nvfp4"):
    """Megatron-SP-style TP forward: the residual stream is SHARDED over
    tokens; each row-parallel projection ends in a reduce-scatter over the
    token axis instead of a psum, and each column-parallel block starts
    with the matching all-gather. Same total link volume as psum, but split
    into halves that XLA can overlap with the adjacent dequant+matmul, and
    the norm/residual elementwise work runs on 1/tp of the tokens
    (SURVEY.md §2.3 "reduce-scatter epilogue for k-sharding"; prefill /
    training structure — the cached decode step keeps make_tp_step).

    Returns jitted (qparams, tokens (B, T)) -> logits; requires T % tp == 0.
    """
    tp = mesh.shape["tp"]
    assert cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    import dataclasses as _dc
    cfg_l = _dc.replace(cfg, num_heads=cfg.num_heads // tp,
                        num_kv_heads=cfg.num_kv_heads // tp)

    def local(qparams, tokens):
        # tokens arrive sequence-sharded: (B, T/tp) per device
        B, Ts = tokens.shape
        x = qparams["embed"][tokens]                    # (B, T/tp, H) shard
        mask_full = None
        for lp in qparams["layers"]:
            h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)   # sharded
            hf = jax.lax.all_gather(h, "tp", axis=1, tiled=True)  # (B,T,H)
            T = hf.shape[1]
            if mask_full is None:
                mask_full = jnp.tril(jnp.ones((T, T), bool))[None, None]
                pos = jnp.broadcast_to(jnp.arange(T)[None, :], (B, T))
            a, _ = llama.attention(hf, lp, None, pos, cfg_l, mask_full,
                                   fmt=fmt, interpret=False)
            # row-parallel wo: local partial sums reduce-scatter over tokens
            x = x + jax.lax.psum_scatter(a, "tp", scatter_dimension=1,
                                         tiled=True)
            h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
            hf = jax.lax.all_gather(h, "tp", axis=1, tiled=True)
            dn = llama.mlp(hf, lp, fmt=fmt, interpret=False)
            x = x + jax.lax.psum_scatter(dn, "tp", scatter_dimension=1,
                                         tiled=True)
        x = llama.rms_norm(x, qparams["final_norm"], cfg.rms_eps)
        # token and vocab shards ride the SAME tp axis: gather tokens
        # first (full (B, T, H) per device), then the vocab-sharded
        # lm_head + vocab gather — a single gather can't undo both
        xf = jax.lax.all_gather(x, "tp", axis=1, tiled=True)
        logits_local = jnp.dot(xf, qparams["lm_head"]["w"],
                               preferred_element_type=jnp.float32)
        logits = jax.lax.all_gather(logits_local, "tp", axis=2, tiled=True)
        return logits.astype(jnp.bfloat16)

    def fwd(qparams, tokens):
        fn = shard_map(
            local, mesh=mesh,
            in_specs=(_params_spec(qparams), P("dp", "tp")),
            out_specs=P("dp", None, None),
            check_rep=False,
        )
        return fn(qparams, tokens)

    return jax.jit(fwd)


def make_tp_step(cfg: llama.LlamaConfig, mesh: Mesh, fmt: str = "nvfp4"):
    """Jitted cached TP forward for serving: (qparams, tokens (B, T),
    cache, pos (B, T)) -> (logits, new_cache). Drop-in forward_fn for
    models.serving.Engine — tensor-parallel continuous batching."""
    tp = mesh.shape["tp"]
    assert cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0

    def step(qparams, tokens, cache, pos, write_mask=None, kv_window=None):
        if write_mask is None:
            write_mask = jnp.ones(tokens.shape[0], bool)

        def local(qparams, tokens, cache, pos, write_mask):
            return _local_forward(qparams, tokens, cache, pos, cfg, tp, fmt,
                                  write_mask=write_mask, kv_window=kv_window)

        cache_specs = _cache_specs(cache, cfg)
        fn = shard_map(
            local, mesh=mesh,
            in_specs=(_params_spec(qparams), P("dp", None), cache_specs,
                      P("dp", None), P("dp")),
            out_specs=(P("dp", None, None), cache_specs),
            check_rep=False,
        )
        return fn(qparams, tokens, cache, pos, write_mask)

    return step
