"""GPipe-style pipeline parallelism for the Llama stack (Mesh axis "pp").

The reference has no distributed layer; the north star needs the full
parallelism menu. This is the inference pipeline: layers are stacked and
stage-sharded on "pp", microbatches flow through the stages with
`lax.ppermute`, and the classic GPipe schedule
(n_micro + n_stages - 1 ticks) is a `lax.fori_loop` — compiler-friendly
static shapes, no host round trips.

Every stage executes its layer scan each tick (inactive ticks compute on
zeros and are masked); that is the standard trade for a single fused jit
program, and the bubble fraction (S-1)/(n_micro+S-1) matches GPipe.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from ._compat import shard_map

from ..models import llama


def stack_layers(layers: list) -> dict:
    """List of per-layer param dicts -> one pytree with leading layer axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *layers)


def place_params_pp(params: dict, mesh: Mesh) -> dict:
    """Stage-shard stacked layers on "pp"; embed/norm/head replicated."""
    stacked = stack_layers(params["layers"])

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    return {
        "embed": put(params["embed"], P(None, None)),
        "final_norm": put(params["final_norm"], P(None)),
        "lm_head": jax.tree.map(lambda x: put(x, P(None, None)),
                                params["lm_head"]),
        "layers": jax.tree.map(
            lambda x: put(x, P("pp", *(None,) * (x.ndim - 1))), stacked),
    }


def _layer_forward(x, lp, cfg, pos, mask, fmt, interpret):
    h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    a, _ = llama.attention(h, lp, None, pos, cfg, mask,
                           fmt=fmt, interpret=interpret)
    x = x + a
    h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + llama.mlp(h, lp, fmt=fmt, interpret=interpret)


def init_cache_pp(cfg: llama.LlamaConfig, batch: int, mesh: Mesh,
                  dtype=jnp.bfloat16):
    """Stage-local KV cache for pipelined DECODE: per-layer (k, v) stacked
    on a leading layer axis and sharded on "pp" — each stage holds only its
    own layers' KV."""
    shape = (cfg.num_layers, batch, cfg.max_seq_len, cfg.num_kv_heads,
             cfg.head_dim)
    spec = P("pp", None, None, None, None)
    return tuple(jax.device_put(jnp.zeros(shape, dtype),
                                NamedSharding(mesh, spec))
                 for _ in range(2))


def make_pp_step(cfg: llama.LlamaConfig, mesh: Mesh, n_micro: int,
                 *, fmt: str = "bf16", interpret: bool = False):
    """Jitted pipelined DECODE step: (params_pp, (ck, cv), toks (B,),
    pos (B,)) -> (logits (B, V), (ck, cv)).

    One token per sequence flows through the GPipe schedule; each stage
    scans its local layers with the matching slice of its stage-local KV
    cache (init_cache_pp) and writes this step's K/V at each slot's pos.
    Inactive (bubble) ticks compute on zeros with write_mask=False, so
    they cannot corrupt the cache (models/llama.attention masked write).
    This closes the round-2 gap where PP served prefill-style forwards
    only (cache=None) and could not decode.
    """
    S_ = mesh.shape["pp"]
    assert cfg.num_layers % S_ == 0

    def local(toks, pos, embed, stacked_local, final_norm, lm_head_w,
              ck, cv):
        s = jax.lax.axis_index("pp")
        B = toks.shape[0]
        H = cfg.hidden_size
        mb = B // n_micro
        h_in = embed[toks].reshape(n_micro, mb, 1, H)
        pos_r = pos.reshape(n_micro, mb)

        def run_stage(x, ck_m, cv_m, pos_mb, active):
            wm = jnp.broadcast_to(active, (mb,))

            def body(h, inp):
                lp, k_l, v_l = inp
                hh = llama.rms_norm(h, lp["attn_norm"], cfg.rms_eps)
                a, (nk, nv) = llama.attention(
                    hh, lp, (k_l, v_l), pos_mb[:, None], cfg, None,
                    fmt=fmt, interpret=interpret, write_mask=wm)
                h = h + a
                hh = llama.rms_norm(h, lp["mlp_norm"], cfg.rms_eps)
                return h + llama.mlp(hh, lp, fmt=fmt,
                                     interpret=interpret), (nk, nv)

            h, (nk, nv) = jax.lax.scan(body, x,
                                       (stacked_local, ck_m, cv_m))
            return h, nk, nv

        def tick(t, carry):
            buf, acc, ck, cv = carry
            m = t - s                        # microbatch index at this stage
            active = jnp.logical_and(m >= 0, m < n_micro)
            m_c = jnp.clip(m, 0, n_micro - 1)
            x_in = jnp.where(s == 0, h_in[m_c], buf)
            ck_m = jax.lax.dynamic_slice_in_dim(ck, m_c * mb, mb, axis=1)
            cv_m = jax.lax.dynamic_slice_in_dim(cv, m_c * mb, mb, axis=1)
            y, nk, nv = run_stage(x_in, ck_m, cv_m, pos_r[m_c], active)
            # inactive ticks returned the cache unchanged (write_mask), so
            # unconditional writeback is safe
            ck = jax.lax.dynamic_update_slice_in_dim(ck, nk, m_c * mb,
                                                     axis=1)
            cv = jax.lax.dynamic_update_slice_in_dim(cv, nv, m_c * mb,
                                                     axis=1)
            y = jnp.where(active, y, jnp.zeros_like(y))
            logits_m = jnp.dot(
                llama.rms_norm(y[:, 0], final_norm, cfg.rms_eps),
                lm_head_w, preferred_element_type=jnp.float32)
            is_out = jnp.logical_and(s == S_ - 1, active)
            acc = jax.lax.dynamic_update_index_in_dim(
                acc, jnp.where(is_out, logits_m, acc[m_c]), m_c, 0)
            buf = jax.lax.ppermute(
                y, "pp", [(i, (i + 1) % S_) for i in range(S_)])
            return buf, acc, ck, cv

        buf0 = jnp.zeros((mb, 1, H), h_in.dtype)
        acc0 = jnp.zeros((n_micro, mb, cfg.vocab_size), jnp.float32)
        _, acc, ck, cv = jax.lax.fori_loop(
            0, n_micro + S_ - 1, tick, (buf0, acc0, ck, cv))
        acc = jnp.where(s == S_ - 1, acc, jnp.zeros_like(acc))
        acc = jax.lax.psum(acc, "pp")
        return (acc.reshape(B, cfg.vocab_size).astype(jnp.bfloat16),
                ck, cv)

    cache_spec = P("pp", None, None, None, None)

    def step(params_pp, cache, toks, pos):
        layer_specs = jax.tree.map(
            lambda x: P("pp", *(None,) * (x.ndim - 1)),
            params_pp["layers"])
        fn = shard_map(
            local, mesh=mesh,
            in_specs=(P(None), P(None), P(None, None), layer_specs,
                      P(None), P(None, None), cache_spec, cache_spec),
            out_specs=(P(None, None), cache_spec, cache_spec),
            check_rep=False)
        logits, ck, cv = fn(toks, pos, params_pp["embed"],
                            params_pp["layers"], params_pp["final_norm"],
                            params_pp["lm_head"]["w"], cache[0], cache[1])
        return logits, (ck, cv)

    return jax.jit(step)


def make_pp_forward(cfg: llama.LlamaConfig, mesh: Mesh, n_micro: int,
                    *, fmt: str = "bf16", interpret: bool = False):
    """Build a jitted pipelined (params_pp, tokens) -> logits forward.

    tokens (B, T) with B % n_micro == 0; microbatches of B/n_micro
    sequences stream through the pp stages.
    """
    S = mesh.shape["pp"]
    assert cfg.num_layers % S == 0

    def local(tokens, embed, stacked_local, final_norm, lm_head_w):
        s = jax.lax.axis_index("pp")
        B, T = tokens.shape
        H = cfg.hidden_size
        mb = B // n_micro
        pos = jnp.broadcast_to(jnp.arange(T)[None, :], (mb, T))
        mask = jnp.tril(jnp.ones((T, T), bool))[None, None]

        # every stage holds the token stream (replicated input) and embeds
        # its own injections — cheaper than shipping stage-0 activations
        h_in = embed[tokens].reshape(n_micro, mb, T, H)

        def run_stage(x):
            def body(h, lp):
                return _layer_forward(h, lp, cfg, pos, mask, fmt,
                                      interpret), None
            h, _ = jax.lax.scan(body, x, stacked_local)
            return h

        def tick(t, carry):
            buf, acc = carry
            m = t - s                       # microbatch index at this stage
            active = jnp.logical_and(m >= 0, m < n_micro)
            m_c = jnp.clip(m, 0, n_micro - 1)
            x_in = jnp.where(s == 0, h_in[m_c], buf)
            y = run_stage(x_in)
            y = jnp.where(active, y, jnp.zeros_like(y))
            is_last = s == S - 1
            acc = jax.lax.dynamic_update_index_in_dim(
                acc, jnp.where(jnp.logical_and(is_last, active), y,
                               acc[m_c]), m_c, 0)
            buf = jax.lax.ppermute(
                y, "pp", [(i, (i + 1) % S) for i in range(S)])
            return buf, acc

        buf0 = jnp.zeros((mb, T, H), h_in.dtype)
        acc0 = jnp.zeros((n_micro, mb, T, H), h_in.dtype)
        _, acc = jax.lax.fori_loop(0, n_micro + S - 1, tick, (buf0, acc0))
        # only the last stage holds real outputs; zero elsewhere -> psum
        acc = jnp.where(s == S - 1, acc, jnp.zeros_like(acc))
        acc = jax.lax.psum(acc, "pp")
        x = llama.rms_norm(acc.reshape(B, T, H), final_norm, cfg.rms_eps)
        return jnp.dot(x, lm_head_w,
                       preferred_element_type=jnp.float32
                       ).astype(jnp.bfloat16)

    def fwd(params_pp, tokens):
        layer_specs = jax.tree.map(
            lambda x: P("pp", *(None,) * (x.ndim - 1)),
            params_pp["layers"])
        fn = shard_map(
            local, mesh=mesh,
            in_specs=(P(None, None), P(None, None), layer_specs,
                      P(None), P(None, None)),
            out_specs=P(None, None, None),
            check_rep=False)
        return fn(tokens, params_pp["embed"], params_pp["layers"],
                  params_pp["final_norm"], params_pp["lm_head"]["w"])

    return jax.jit(fwd)
