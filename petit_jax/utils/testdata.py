"""Deterministic quantized-GEMM test-data generator.

Analog of the reference's GemmMPTestData (lib/tests/quantization.h:19-94,
quantization.cc:10-62): constrained random generators that respect the
kernel invariants — positive E4M3 scales in a sane exponent band, non-NaN
E8M0 scales, negative-zero-free FP4 codes — seeded for reproducibility.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..numerics import formats
from ..ops import layout as layout_mod


@dataclasses.dataclass
class GemmTestData:
    a: np.ndarray            # (m, k) f32 activations
    qweights: np.ndarray     # (n, k/2) u8 reference-layout packed nibbles
    scales: np.ndarray       # (n, k/group) u8 raw scale bytes
    global_scale: np.float32
    words: np.ndarray        # (kp/8, n) u32 petit layout
    scales_t: np.ndarray     # (kp/group, n) u8 processed scales


def make_gemm_data(m: int, n: int, k: int, fmt: str = "nvfp4",
                   seed: int = 42) -> GemmTestData:
    rng = np.random.default_rng(seed)
    group = 16 if fmt in ("nvfp4", "nvfp4p2", "nvfp4p2z") else 32
    a = rng.standard_normal((m, k)).astype(np.float32)
    if fmt in ("nvfp4p2z", "mxfp4z"):
        # zero-free contract: no zero codes (0 = +0, 8 = -0) anywhere
        nib = rng.integers(1, 16, size=(n, k), dtype=np.uint8)
        nib[nib == 8] = 9
    else:
        nib = rng.integers(0, 16, size=(n, k), dtype=np.uint8)
        nib[nib == 8] = 0  # no negative zero (reference invariant)
    qweights = formats.pack_fp4_pairs(nib)
    if fmt == "nvfp4":
        # positive E4M3 scales with exponents 4..10 (2^-3 .. 2^3), like the
        # reference's constrained generator (quantization.cc:10-34)
        scales = ((rng.integers(4, 11, size=(n, k // group), dtype=np.uint8)
                   << 3)
                  | rng.integers(0, 8, size=(n, k // group), dtype=np.uint8))
    elif fmt in ("nvfp4p2", "nvfp4p2z"):
        # pow2 E4M3 scale bytes only (mantissa 0): the nvfp4p2 contract
        scales = (rng.integers(4, 11, size=(n, k // group), dtype=np.uint8)
                  << 3)
    else:
        scales = rng.integers(110, 145, size=(n, k // group), dtype=np.uint8)
    gs = np.float32(rng.uniform(0.5, 2.0))
    words = layout_mod.repack_fp4_weights(
        qweights, n, k, pad_to=layout_mod.pad_multiple(group))
    scales_t = layout_mod.process_fp4_scales(scales, n, k, group_size=group)
    return GemmTestData(a, qweights, scales, gs, words, scales_t)


def random_fp4_layer(key, k: int, n: int, fmt: str = "nvfp4") -> dict:
    """A quantized layer {"words", "scales", "gs"} fabricated ON THE DEVICE
    from `key`: random packed words (every code, both signs), bounded
    scales (E4M3 bytes 2^-1..2^1 with any mantissa for NVFP4, E8M0 bytes
    2^-2..2^2 for MXFP4) decoded to the processed bf16 layout, and a global
    scale that gives the dequantized weight an RMS near 1/sqrt(k), so
    activations stay O(1) through a deep random model. No host pass over
    the weights. k must need no repack padding (k % 512 == 0, MXFP4
    k % 1024 == 0), which holds for every published model width."""
    import jax
    import jax.numpy as jnp

    group = 32 if fmt in ("mxfp4", "mxfp4z") else 16
    assert k % layout_mod.pad_multiple(group) == 0, (k, fmt)
    kw, ks, km = jax.random.split(key, 3)
    words = jax.random.bits(kw, (k // 8, n), jnp.uint32)
    if group == 16:
        byte = ((jax.random.randint(ks, (k // 16, n), 6, 9) << 3)
                | jax.random.randint(km, (k // 16, n), 0, 8))
        scales = jax.lax.bitcast_convert_type(
            byte.astype(jnp.uint8), jnp.float8_e4m3fn).astype(jnp.bfloat16)
        scale_rms = 1.56
    else:
        e = jax.random.randint(ks, (k // 32, n), -2, 3)
        scales = jnp.repeat(jnp.exp2(e.astype(jnp.float32)), 2,
                            axis=0).astype(jnp.bfloat16)
        scale_rms = 2.0
    # RMS of a uniformly random E2M1 code is ~2.93
    gs = jnp.float32(1.0 / (2.93 * scale_rms * np.sqrt(k)))
    return {"words": words, "scales": scales, "gs": gs}
