"""Host-side reference dequantization and GEMM oracles.

These are the numpy analogs of the reference's standalone dequant kernels
(lib/gemm/rocm/quantization/quantization_utils.cu:306-727, the four
DequantizeFp4Kernel flavors) and its pure-torch test reference
(tests/ops/test_fp4_gemm_quark.py:9-24).  Every GEMM path is tested
against these.

Canonical quantized-checkpoint layout (identical to the reference inputs):
  qweights : uint8 (n, k//2)   two E2M1 nibbles per byte, low nibble = even k
  scales   : uint8 (n, k//16)  raw E4M3 bytes      (NVFP4, group size 16)
             uint8 (n, k//32)  raw E8M0 bytes      (MXFP4, group size 32)
  global_scale : float32 scalar (NVFP4 and MXFP4 both multiply it in; the
             reference applies it as the GEMM epilogue alpha,
             lib/gemm/rocm/quantization/qgemm.cuh:144-157)
"""

from __future__ import annotations

import numpy as np

from . import formats


def dequant_nvfp4(qweights: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Dequantize NVFP4 (n, k//2) bytes + (n, k//16) E4M3 scales -> f32 (n, k).

    Does NOT apply the global scale (matching the reference's per-block
    dequant; global scale is a GEMM epilogue concern).
    """
    n, kb = qweights.shape
    k = kb * 2
    assert scales.shape == (n, k // formats.NVFP4_GROUP_SIZE), (
        f"scales shape {scales.shape} != {(n, k // 16)}")
    nib = formats.unpack_fp4_pairs(qweights)          # (n, k)
    vals = formats.fp4_decode(nib)                    # f32
    s = formats.e4m3_decode(scales)                   # (n, k/16) f32
    return (vals.reshape(n, -1, formats.NVFP4_GROUP_SIZE)
            * s[:, :, None]).reshape(n, k)


def dequant_mxfp4(qweights: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Dequantize MXFP4 (n, k//2) bytes + (n, k//32) E8M0 scales -> f32 (n, k)."""
    n, kb = qweights.shape
    k = kb * 2
    assert scales.shape == (n, k // formats.MXFP4_GROUP_SIZE)
    nib = formats.unpack_fp4_pairs(qweights)
    vals = formats.fp4_decode(nib)
    s = formats.e8m0_decode(scales)
    return (vals.reshape(n, -1, formats.MXFP4_GROUP_SIZE)
            * s[:, :, None]).reshape(n, k)


def gemm_reference(a: np.ndarray, qweights: np.ndarray, scales: np.ndarray,
                   global_scale: float, *, fmt: str = "nvfp4") -> np.ndarray:
    """Oracle for mul_{nv,mx}fp4_a16: c = (a_f32 @ deq(B).T * gs).astype(a.dtype).

    a: (m, k) bf16/f16/f32; returns (m, n) in a.dtype. Mirrors
    tests/ops/test_fp4_gemm_quark.py:23-24,52-54.
    """
    deq = dequant_nvfp4 if fmt == "nvfp4" else dequant_mxfp4
    b = deq(qweights, scales) * np.float32(global_scale)   # (n, k)
    c = a.astype(np.float32) @ b.T
    return c.astype(a.dtype)


# ---------------------------------------------------------------------------
# Quantizers — fabricate NVFP4/MXFP4 checkpoints from dense f32 weights.
# ModelOpt-style: positive scales, amax-based. Used for tests and for
# quantizing HF bf16 checkpoints when no pre-quantized one is available.
# ---------------------------------------------------------------------------

def quantize_nvfp4(w: np.ndarray, global_scale: float | None = None):
    """Quantize dense (n, k) f32 -> (qweights u8 (n,k/2), scales u8 (n,k/16),
    global_scale f32).

    Two-level scheme: per-16 group amax maps the group into [-6, 6] via an
    E4M3 scale; a single f32 global scale folds the E4M3 quantization of the
    per-group scales. global_scale = amax(w) / (6 * 448) per ModelOpt recipe.
    Pass global_scale explicitly to share one value across tensor-parallel
    shards of the same weight.
    """
    n, k = w.shape
    g = formats.NVFP4_GROUP_SIZE
    assert k % g == 0
    w = w.astype(np.float32)
    if global_scale is None:
        amax = np.abs(w).max()
        global_scale = (np.float32(amax / (6.0 * 448.0)) if amax > 0
                        else np.float32(1.0))
    global_scale = np.float32(global_scale)
    wg = w.reshape(n, k // g, g)
    gmax = np.abs(wg).max(axis=-1)                         # (n, k/g)
    scale_f = gmax / 6.0 / global_scale                    # target E4M3 value
    scales = formats.e4m3_encode(np.maximum(scale_f, 2.0 ** -9))
    s_dec = formats.e4m3_decode(scales)                    # actual stored scale
    # Round scales UP to the next representable E4M3 so group values stay in
    # [-6, 6] after scaling (no FP4 saturation). E4M3 is monotonic in its
    # byte value for positives, so +1 steps to the next magnitude.
    bump = (s_dec < scale_f) & (scales < 0x7E)
    scales = np.where(bump, scales + 1, scales).astype(np.uint8)
    s_dec = formats.e4m3_decode(scales)
    denom = s_dec * global_scale
    denom = np.where(denom == 0, 1.0, denom)
    q = formats.fp4_encode(wg / denom[:, :, None])
    return formats.pack_fp4_pairs(q.reshape(n, k)), scales, global_scale


def quantize_nvfp4_pow2(w: np.ndarray, global_scale: float | None = None,
                        zero_free: bool = False):
    """NVFP4 with POWER-OF-TWO per-group scales ("nvfp4p2"): same container
    format as quantize_nvfp4 (E2M1 nibbles, E4M3 scale bytes, f32 global
    scale, group size 16) but every stored scale is an exact power of two.

    Why: power-of-two scales make every scale apply an exponent shift, the
    property MXFP4 has, while keeping NVFP4's 16-wide groups.

    Numerics: group dynamic range still adapts every 16 elements (vs MXFP4's
    32), but the scale loses E4M3's 3 mantissa bits — values absorb the
    mantissa factor and re-round in E2M1. Quality sits between exact NVFP4
    and MXFP4; measure with tools/quality_gate.py before adopting. This is
    the re-quantization variant sanctioned as an opt-in accuracy trade, NOT
    a drop-in replacement for checkpoints that need exact NVFP4 semantics.

    E4M3 pow2 range: 2^-9 (subnormal 0x01) .. 2^8 (0x78). global_scale
    anchors the largest group at 2^8 so the full 18-octave byte range is
    available downward.
    """
    n, k = w.shape
    g = formats.NVFP4_GROUP_SIZE
    assert k % g == 0
    w = w.astype(np.float32)
    wg = w.reshape(n, k // g, g)
    gmax = np.abs(wg).max(axis=-1)                         # (n, k/g)
    if global_scale is None:
        amax = np.abs(w).max()
        if amax > 0:
            # largest group's pow2 scale lands exactly on byte 2^8
            global_scale = np.float32(
                2.0 ** (np.ceil(np.log2(amax / 6.0)) - 8))
        else:
            global_scale = np.float32(1.0)
    global_scale = np.float32(global_scale)
    # smallest 2^e with gmax <= 6 * 2^e * gs, clipped to the E4M3 pow2 range
    safe = np.where(gmax > 0, gmax, 1.0)
    e = np.ceil(np.log2(safe / (6.0 * global_scale))).astype(np.int32)
    e = np.clip(e, -9, 8)
    # E4M3 byte for 2^e: subnormals 2^-9..2^-7 are mantissa {1,2,4} at
    # exponent field 0; normals 2^-6..2^8 are mantissa 0, exp field e+7
    sub = np.uint8(1) << (e + 9).clip(0, 2).astype(np.uint8)
    scales = np.where(e < -6, sub, ((e + 7) << 3)).astype(np.uint8)
    s_dec = formats.e4m3_decode(scales)
    denom = s_dec * global_scale
    denom = np.where(denom == 0, 1.0, denom)
    q = formats.fp4_encode(wg / denom[:, :, None], zero_free=zero_free)
    return formats.pack_fp4_pairs(q.reshape(n, k)), scales, global_scale


def quantize_nvfp4_pow2z(w: np.ndarray, global_scale: float | None = None):
    """The "nvfp4p2z" extension: nvfp4p2 with ZERO-FREE value rounding —
    no element ever stores the zero code. Same container as nvfp4p2. Accuracy
    trade: near-zero weights round to +-0.5*2^e instead of 0 (<= 2x their
    exact-E2M1 rounding error) — gate with tools/quality_gate.py."""
    return quantize_nvfp4_pow2(w, global_scale, zero_free=True)


def requantize_nvfp4_pow2(qweights: np.ndarray, scales: np.ndarray,
                          global_scale: float, zero_free: bool = False):
    """Convert an existing NVFP4 tensor (E4M3 scales) to the pow2-scale
    variant by dequantizing and re-quantizing. Loader-side helper for
    pre-quantized checkpoints served in "nvfp4p2" mode (zero_free=True
    for "nvfp4p2z")."""
    deq = dequant_nvfp4(qweights, scales) * np.float32(global_scale)
    return quantize_nvfp4_pow2(deq, zero_free=zero_free)


def quantize_mxfp4(w: np.ndarray, zero_free: bool = False):
    """Quantize dense (n, k) f32 -> (qweights u8 (n,k/2), scales u8 (n,k/32),
    global_scale f32=1.0). Scale = power-of-two s.t. group amax maps <= 6.

    zero_free=True is the "mxfp4z" extension: round to the nearest NONZERO
    E2M1 magnitude so the kernel can drop the stored-zero flag pipeline
    (same contract and trade as nvfp4p2z — see quantize_nvfp4_pow2z)."""
    n, k = w.shape
    g = formats.MXFP4_GROUP_SIZE
    assert k % g == 0
    w = w.astype(np.float32)
    wg = w.reshape(n, k // g, g)
    gmax = np.abs(wg).max(axis=-1)
    gmax = np.where(gmax == 0, 1.0, gmax)
    # Largest power of two <= gmax/6 rounded up so values fit in [-6, 6].
    e = np.ceil(np.log2(gmax / 6.0)).astype(np.int32)
    scales = np.clip(e + 127, 1, 254).astype(np.uint8)
    s_dec = formats.e8m0_decode(scales)
    q = formats.fp4_encode(wg / s_dec[:, :, None], zero_free=zero_free)
    return formats.pack_fp4_pairs(q.reshape(n, k)), scales, np.float32(1.0)


def quantize_mxfp4z(w: np.ndarray):
    """The "mxfp4z" extension: MXFP4 with zero-free value rounding — the
    MXFP4 analog of quantize_nvfp4_pow2z (E8M0 scales are already pure
    powers of two, so only the value rounding changes). Halved scale bytes
    vs NVFP4 put its DMA floor BELOW nvfp4p2z's; gate before adopting."""
    return quantize_mxfp4(w, zero_free=True)


def dequant_fp4_device(qweights, scales, *, fmt: str = "nvfp4"):
    """On-device (jnp) dequant from the NATIVE layout -> (n, k) f32.

    Same contract as dequant_nvfp4/dequant_mxfp4 (no global scale), but
    built from XLA ops so it runs on the accelerator: the host numpy path
    is O(n*k) on a machine whose per-element throughput is ~100x worse
    than the chip's, which made large-shape bench/test-data preparation
    (e.g. the 84M-element Llama-70B projections) take minutes per tensor.
    Used by bench.py to fabricate the dense-baseline operand; tests keep
    the bit-exact numpy oracle.
    """
    import jax.numpy as jnp
    import jax.lax as lax

    n, kb = qweights.shape
    k = kb * 2
    g = (formats.NVFP4_GROUP_SIZE
         if fmt in ("nvfp4", "nvfp4p2", "nvfp4p2z", "w4a8")
         else formats.MXFP4_GROUP_SIZE)
    assert scales.shape == (n, k // g), (scales.shape, (n, k // g))
    q = jnp.asarray(qweights)
    nib = jnp.stack([q & 0xF, q >> 4], axis=-1).reshape(n, k)
    vals = jnp.take(jnp.asarray(formats.FP4_VALUES, jnp.float32),
                    nib.astype(jnp.int32))
    sc = jnp.asarray(scales)
    if g == formats.NVFP4_GROUP_SIZE:
        s = lax.bitcast_convert_type(
            sc, jnp.float8_e4m3fn).astype(jnp.float32)
    else:
        bits = sc.astype(jnp.uint32) << 23
        s = lax.bitcast_convert_type(bits, jnp.float32)
        s = jnp.where(sc == 0, jnp.float32(2.0 ** -127), s)
        s = jnp.where(sc == 255, jnp.float32(jnp.nan), s)
    return (vals.reshape(n, k // g, g) * s[:, :, None]).reshape(n, k)
