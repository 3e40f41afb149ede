"""Low-precision floating-point codecs (host-side, numpy).

These pin down the bit-level contract for the FP4 (E2M1) weight format and the
two block-scale formats used by NVFP4 (FP8-E4M3) and MXFP4 (E8M0).  Everything
else in the framework — the offline repack, the fused Pallas kernels, and the
tests — is validated against these functions.

Reference semantics (causalflow-ai/petit-kernel):
  - E2M1 value table: lib/gemm/rocm/quantization/dequant.cuh (fp4_values table
    also restated in tests/ops/test_fp4_gemm_quark.py:10-14).
  - E4M3 per-16-element block scales, f32 global scale (NVFP4):
    lib/gemm/rocm/quantization/gemm.h:119-146.
  - E8M0 per-32-element block scales (MXFP4): same header; decode 2^(u8-127).
"""

from __future__ import annotations

import numpy as np
import ml_dtypes

# ---------------------------------------------------------------------------
# FP4 E2M1
# ---------------------------------------------------------------------------

# Nibble n = [s e1 e0 m]; value = (-1)^s * (e==0 ? m/2 : 2^(e-1) * (1 + m/2)).
FP4_VALUES = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0],
    dtype=np.float32,
)

# Elements per scale group along k.
NVFP4_GROUP_SIZE = 16
MXFP4_GROUP_SIZE = 32


def fp4_decode(nibbles: np.ndarray) -> np.ndarray:
    """Decode E2M1 nibble codes (values 0..15) to float32."""
    nibbles = np.asarray(nibbles)
    if nibbles.dtype not in (np.uint8, np.int32, np.int64, np.uint32):
        nibbles = nibbles.astype(np.int64)
    return FP4_VALUES[nibbles & 0xF]


def fp4_encode(values: np.ndarray, zero_free: bool = False) -> np.ndarray:
    """Encode float values to the nearest E2M1 nibble (round-to-nearest-even).

    Ties between two representable magnitudes round to the one with the even
    mantissa bit, matching IEEE RN semantics on the 8-entry magnitude table.
    Out-of-range magnitudes saturate to +-6.  Used by the quantizer that
    fabricates NVFP4/MXFP4 checkpoints for tests and model conversion.

    zero_free: round to the nearest NONZERO magnitude (min +-0.5) — the
    "nvfp4p2z" extension's value rounding. Magnitudes below 0.25 take up to
    2x the error of exact E2M1 rounding (0.5 step instead of 0.25 max); the
    tensor then holds no stored-zero code. Quality-gate before adopting
    (tools/quality_gate.py).
    """
    v = np.asarray(values, dtype=np.float32)
    sign = (np.signbit(v)).astype(np.uint8)
    mag = np.abs(v)
    table = FP4_VALUES[:8]  # [0, .5, 1, 1.5, 2, 3, 4, 6]
    # Midpoints between consecutive magnitudes; ties -> even index.
    mids = (table[:-1] + table[1:]) / 2.0  # [.25, .75, 1.25, 1.75, 2.5, 3.5, 5]
    idx = np.searchsorted(mids, mag, side="left").astype(np.uint8)
    if zero_free:
        idx = np.maximum(idx, np.uint8(1))
    # searchsorted(side='left') keeps exact midpoints at the lower index i;
    # IEEE RNE demands the even-codepoint side, so bump ties up when the
    # upper index is even.
    for i, m in enumerate(mids):
        hi = i + 1
        if hi % 2 == 0:  # tie must round UP to even index hi
            idx = np.where(mag == m, np.uint8(hi), idx)
    code = (idx | (sign << 3)).astype(np.uint8)
    # Never emit negative zero: the reference masks it at repack time because
    # it decodes to NaN on some hardware (quantization_utils.cu:196-199); we
    # keep the invariant at the source.
    return np.where(code == 8, np.uint8(0), code)


def pack_fp4_pairs(nibbles: np.ndarray) -> np.ndarray:
    """Pack nibble codes along the last axis, low nibble first: byte i holds
    elements (2i | 2i+1 << 4). Matches the reference's on-disk qweight bytes
    (tests/ops/test_fp4_gemm_quark.py:15-19)."""
    n = np.asarray(nibbles, dtype=np.uint8)
    assert n.shape[-1] % 2 == 0
    lo = n[..., 0::2]
    hi = n[..., 1::2]
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_fp4_pairs(packed: np.ndarray) -> np.ndarray:
    """Inverse of pack_fp4_pairs: byte -> (lo, hi) nibble codes interleaved."""
    p = np.asarray(packed, dtype=np.uint8)
    out = np.empty(p.shape[:-1] + (p.shape[-1] * 2,), dtype=np.uint8)
    out[..., 0::2] = p & 0xF
    out[..., 1::2] = p >> 4
    return out


# ---------------------------------------------------------------------------
# FP8 E4M3 (fn variant: no inf, single NaN at 0x7F/0xFF)
# ---------------------------------------------------------------------------

def e4m3_decode(raw: np.ndarray) -> np.ndarray:
    """Decode raw E4M3 bytes to float32 (bit-exact via ml_dtypes)."""
    raw = np.asarray(raw, dtype=np.uint8)
    return raw.view(ml_dtypes.float8_e4m3fn).astype(np.float32)


def e4m3_encode(values: np.ndarray) -> np.ndarray:
    """Encode float32 -> raw E4M3 bytes (RNE, saturating per ml_dtypes)."""
    v = np.asarray(values, dtype=np.float32)
    return v.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)


# ---------------------------------------------------------------------------
# E8M0 (MX block scale: pure power of two, bias 127; 0xFF = NaN)
# ---------------------------------------------------------------------------

def e8m0_decode(raw: np.ndarray) -> np.ndarray:
    """Decode raw E8M0 bytes to float32: 2^(u8 - 127); 255 -> NaN."""
    raw = np.atleast_1d(np.asarray(raw, dtype=np.uint8))
    bits = raw.astype(np.uint32) << 23
    out = bits.view(np.float32).reshape(raw.shape).copy()
    # u8 == 0 encodes 2^-127 (the bit pattern 0<<23 is +0.0, not 2^-127).
    out = np.where(raw == 0, np.float32(2.0 ** -127), out)
    out = np.where(raw == 255, np.float32(np.nan), out)
    return out


def e8m0_encode(values: np.ndarray) -> np.ndarray:
    """Encode positive floats to the nearest-below power-of-two E8M0 byte."""
    v = np.asarray(values, dtype=np.float32)
    if np.any(v <= 0):
        raise ValueError("E8M0 encodes positive powers of two only")
    e = np.floor(np.log2(v)).astype(np.int32)
    return np.clip(e + 127, 0, 254).astype(np.uint8)
