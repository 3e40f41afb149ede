"""Grouped (per-expert) FP4 GEMM: one kernel for all experts.

The capacity-bucketed MoE gives each expert a fixed (cap, k) activation
bucket; instead of launching one GEMM per expert, a single call runs the
FP4 kernel body of ops/kernels/fused.py with the expert as a grid axis over
stacked weight/scale/activation arrays. Reference analog: the
strided-batch host loop (tools/benchmarks/matmul/rocm/
matmul_petit.cc:116-132), re-designed as a grid axis instead of a loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import dispatch
from . import fused


@functools.partial(jax.jit, static_argnames=("block_m", "block_n", "block_k",
                                             "interpret", "out_dtype",
                                             "solution_id", "element_b"))
def grouped_mul(xs: jax.Array, words: jax.Array, scales_t: jax.Array,
                gs: jax.Array, *, block_m: int = 0, block_n: int = 0,
                block_k: int = 0, solution_id: int = -1,
                element_b=None, out_dtype=jnp.bfloat16,
                interpret: bool = False) -> jax.Array:
    """(E, cap, k) @ per-expert dequant((E, kp/8, n), (E, kp/16, n)) * gs[E]
    -> (E, cap, n), one kernel with the expert as a grid axis.

    xs rows must already be gathered per expert (capacity buckets); k is
    the logical contraction size (kp = words.shape[1] * 8 covers padding).

    The grouped GEMM's dispatch point (ops/dispatch.py). Block shapes
    resolve through the solution machinery (tuned grouped table entry ->
    dense entry -> heuristic, ops/gemm.py resolve_grouped_solution),
    overridable with an explicit solution_id or raw block_m/n/k kwargs.
    """
    E, cap, k = xs.shape
    impl = dispatch.implementation("grouped_gemm", interpret, m=cap)
    _, kw, n = words.shape
    kp = kw * 8
    assert words.shape[0] == E and scales_t.shape == (E, kp // 16, n)
    gs = jnp.asarray(gs, jnp.float32).reshape(E)
    if impl == "xla":
        w = jax.vmap(fused.dequant)(words, scales_t)[:, :k]      # (E, k, n)
        out = jnp.einsum("eck,ekn->ecn", xs.astype(jnp.bfloat16), w,
                         preferred_element_type=jnp.float32)
        return (out * gs[:, None, None]).astype(out_dtype)
    return grouped_kernel(xs, words, scales_t, gs, block_m=block_m,
                          block_n=block_n, block_k=block_k,
                          solution_id=solution_id, element_b=element_b,
                          out_dtype=out_dtype,
                          interpret=impl == "interpret")


def grouped_kernel(xs, words, scales_t, gs, *, block_m: int = 0,
                   block_n: int = 0, block_k: int = 0, solution_id: int = -1,
                   element_b=None, out_dtype=jnp.bfloat16,
                   interpret: bool = False):
    """The Triton kernel for any capacity (grouped_mul's choice aside)."""
    from ..solution import ElementB
    E, cap, k = xs.shape
    kp = words.shape[1] * 8
    n = words.shape[2]
    gs = jnp.asarray(gs, jnp.float32).reshape(E)
    if element_b is None:
        element_b = (ElementB.NVFP4 if kp == k or kp - k < 512
                     else ElementB.MXFP4)
    warps, stages = 4, 2
    if not (block_m and block_n and block_k):
        from .. import gemm as gemm_mod
        sid = gemm_mod.resolve_grouped_solution(cap, n, k, element_b,
                                                solution_id=solution_id)
        block_m, block_n, block_k = sid.block_m, sid.block_n, sid.block_k
        warps, stages = sid.num_warps, sid.num_stages
    bm = min(block_m, max(16, 1 << (cap - 1).bit_length()))
    a, words, scales_t = fused._pad_operands(xs, words, scales_t, bm,
                                             block_n)
    out = fused.w4a16_pallas(
        a, words, scales_t, gs, block_m=bm, block_n=block_n,
        block_k=block_k, num_warps=warps, num_stages=stages, split_k=1,
        high_precision=False, out_dtype=out_dtype, interpret=interpret)
    return out[:, :cap, :n]
