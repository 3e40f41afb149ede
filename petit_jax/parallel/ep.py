"""Expert parallelism for quantized MoE blocks (Mesh axis "ep").

The reference has no distributed code (SURVEY.md §2.3); this is the
expert-parallel layer for the Mixtral-style MoE path (models/moe.py): the
stacked per-expert quantized weights are sharded on the expert axis, every
device routes the full token set but computes only its local experts'
contributions through the grouped FP4 GEMM, and one psum over "ep"
combines them — the standard EP pattern with an XLA collective instead of
all-to-all dispatch (capacity-bucketed gather keeps shapes static, which
jit requires).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from ._compat import shard_map

from ..models import moe as moe_mod


def place_experts_ep(experts: dict, router_w, mesh: Mesh) -> tuple:
    """Shard stacked per-expert quantized tensors on the "ep" axis."""
    espec = {"words": P("ep", None, None), "scales": P("ep", None, None),
             "gs": P("ep")}

    def put(tree, spec):
        return jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            tree, spec)

    placed = {name: put(experts[name], espec) for name in experts}
    router = jax.device_put(jnp.asarray(router_w),
                            NamedSharding(mesh, P(None, None)))
    return placed, router


def make_moe_mlp_ep(moe_cfg, mesh: Mesh, *, fmt: str = "mxfp4",
                    interpret: bool = False):
    """Build a jitted expert-parallel MoE block: (x, router_w, experts) ->
    (T, H). x is replicated over "ep"; each shard evaluates its local
    experts with the global routing decision and psums the contributions.

    The per-shard compute reuses models/moe.py's capacity-bucketed expert
    loop with a shifted expert-id base, so EP and the single-device path
    share one implementation (and one set of numerics tests).
    """
    ep = mesh.shape["ep"]
    assert moe_cfg.num_experts % ep == 0
    e_local = moe_cfg.num_experts // ep

    espec = {"words": P("ep", None, None), "scales": P("ep", None, None),
             "gs": P("ep")}

    def local_block(x, router_w, experts):
        # global routing (replicated), local expert evaluation
        shard = jax.lax.axis_index("ep")
        local = moe_mod.moe_mlp_partial(
            x, router_w, experts,
            moe_cfg, expert_base=shard * e_local, num_local=e_local,
            fmt=fmt, interpret=interpret)
        return jax.lax.psum(local, "ep").astype(x.dtype)

    def fwd(x, router_w, experts):
        fn = shard_map(
            local_block, mesh=mesh,
            in_specs=(P(None, None), P(None, None),
                      {name: espec for name in experts}),
            out_specs=P(None, None),
            check_rep=False)
        return fn(x, router_w, experts)

    return jax.jit(fwd)


def quantize_params_ep(params: dict, cfg, mesh: Mesh,
                       moe_fmt: str = "mxfp4") -> dict:
    """Quantize a Mixtral-family model and shard every layer's expert
    stack on the "ep" axis (attention projections + router replicated)."""
    q = moe_mod.quantize_params(params, cfg, moe_fmt)
    for lp in q["layers"]:
        lp["experts"], lp["router"] = place_experts_ep(
            lp["experts"], lp["router"], mesh)
    return q


def make_ep_step(cfg, mesh: Mesh, *, attn_fmt: str = "nvfp4",
                 moe_fmt: str = "mxfp4", interpret: bool = False):
    """forward_fn hook for the serving engines with expert-parallel MoE
    blocks: attention/cache replicated, experts sharded on "ep", one psum
    per layer combines local contributions — continuous batching over EP
    (north-star configs 4/5 composed). Pass to
    serving.Engine(..., forward_fn=make_ep_step(...), cache=llama.init_cache)."""
    moe_cfg = moe_mod.MoEConfig(cfg.num_experts, cfg.top_k)
    block = make_moe_mlp_ep(moe_cfg, mesh, fmt=moe_fmt,
                            interpret=interpret)

    def forward_fn(p, toks, cache_, pos_, kv_window=None, write_mask=None):
        return moe_mod.forward(
            p, toks, cfg, cache_, pos_, attn_fmt=attn_fmt,
            moe_fmt=moe_fmt, interpret=interpret, kv_window=kv_window,
            write_mask=write_mask, moe_block_fn=block)

    return forward_fn
