"""Hybrid FP4+BF16 quantization: salient columns stay dense.

The most salient columns keep their dense bf16 values (better accuracy than
pure FP4 at a footprint between the two). Column selection by weight
salience, per-part quantize/repack, and the public mul: the FP4 GEMM on the
FP4 columns, one dense dot on the rest, stitched back into checkpoint
column order.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..numerics import reference as ref_numerics
from . import layout as layout_mod
from . import gemm as gemm_mod


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class HybridMeta:
    """Static split metadata of a hybrid layer. Registered static so a
    params pytree holding hybrid layers can flow through jax.jit — these
    are compile-time shapes, not data."""
    block_nf: int
    block_nd: int
    size_k: int
    fmt: str = "nvfp4"


def permute_k_for_a(wd: np.ndarray, kp: int) -> np.ndarray:
    """(k, nd) -> (kp, nd) rows reordered to the fused kernel's A order
    (zero-pad to kp, then the pi (8,16)-transpose within each 128-chunk —
    the same transform fused_mul applies to A)."""
    k, nd = wd.shape
    out = np.zeros((kp, nd), wd.dtype)
    out[:k] = wd
    return (out.reshape(kp // 128, 8, 16, nd)
            .swapaxes(1, 2).reshape(kp, nd))


def quantize_hybrid(w_kn: np.ndarray, *, block_nf: int = 1536,
                    block_nd: int = 512, fmt: str = "nvfp4") -> dict:
    """Split a dense (k, n) weight into FP4 columns + salient dense columns.

    The global split ratio equals block_nf : block_nd (one FP4 block and one
    dense block per kernel n-step), so n must be divisible by
    (block_nf + block_nd). Salience = per-column max |w| (outlier columns
    are exactly preserved — the accuracy rationale of AWQ-style methods,
    applied at column granularity so the kernel split stays block-aligned).
    """
    import ml_dtypes

    w = np.asarray(w_kn, np.float32)
    k, n = w.shape
    step = block_nf + block_nd
    assert n % step == 0, (n, step)
    nn = n // step
    nf, nd = nn * block_nf, nn * block_nd

    sal = np.abs(w).max(axis=0)
    dense_idx = np.sort(np.argsort(sal)[-nd:])
    mask = np.ones(n, bool)
    mask[dense_idx] = False
    fp4_idx = np.flatnonzero(mask)
    perm = np.concatenate([fp4_idx, dense_idx])

    quant = (ref_numerics.quantize_nvfp4 if fmt == "nvfp4"
             else ref_numerics.quantize_mxfp4)
    group = 16 if fmt == "nvfp4" else 32
    qw, scales, gs = quant(w[:, fp4_idx].T)      # (nf, k) layout
    words = layout_mod.repack_fp4_weights(
        qw, nf, k, pad_to=layout_mod.pad_multiple(group))
    st = layout_mod.process_fp4_scales(scales, nf, k, group_size=group)
    kp = words.shape[0] * 8
    wd = permute_k_for_a(w[:, dense_idx].astype(ml_dtypes.bfloat16), kp)
    return {
        "words": jnp.asarray(words), "scales": jnp.asarray(st),
        "gs": jnp.float32(gs), "wd": jnp.asarray(wd),
        "inv_perm": jnp.asarray(np.argsort(perm), jnp.int32),
        "meta": HybridMeta(block_nf, block_nd, k, fmt),
    }


def mul_hybrid(a: jax.Array, hq: dict, *,
               interpret: bool = False) -> jax.Array:
    """(m, k) @ hybrid-quantized (k, n) -> (m, n) in original column order:
    the FP4 GEMM on the FP4 columns plus a dense dot on the salient
    columns (whose rows are stored in the pi-permuted k order of
    permute_k_for_a, so A takes the same permutation)."""
    meta = hq["meta"]
    m, k = a.shape
    nf = hq["words"].shape[1]
    mul = gemm_mod.mul_nvfp4_a16 if meta.fmt == "nvfp4" else \
        gemm_mod.mul_mxfp4_a16
    outf = mul(a, hq["words"], hq["scales"], hq["gs"], m, nf, k,
               interpret=interpret)
    kp = hq["wd"].shape[0]
    ap = jnp.pad(a.astype(jnp.bfloat16), ((0, 0), (0, kp - k)))
    ap = ap.reshape(m, kp // 128, 8, 16).swapaxes(2, 3).reshape(m, kp)
    outd = jnp.dot(ap, hq["wd"], preferred_element_type=jnp.float32)
    out = jnp.concatenate([outf.astype(jnp.float32), outd], axis=1)
    return out[:, hq["inv_perm"]].astype(a.dtype)
