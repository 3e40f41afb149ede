"""Offline weight/scale repack into the kernel layout ("petit layout").

Analog of the reference's Marlin-style offline shuffle
(lib/gemm/rocm/quantization/quantization_utils.cu:183-304: PetitFormat nibble
permutation + RepackQWeightLayout64x32 tiling). The reference pre-positions
nibble bits for branch-free MFMA-side dequant; here the layout is co-designed
with the GEMM kernel's integer decode (ops/kernels/fused.py):

  Packed weights W: uint32, shape (K/8, N).
    Word W[r, c] holds 8 *q-coded* E2M1 nibbles of column n=c.  Slot s (bits
    4s..4s+3), with j = s & 3 and h = s >> 2, holds the nibble for

        k = j*(K/4) + chunk*128 + pi(i),     where
        chunk = r // 64,  i = 2*(r % 64) + h,
        pi(i) = (i % 8) * 16 + (i // 8)      (the (8,16)-transpose).

    **q-coding**: the stored magnitude is remapped offline, swapping E2M1
    codes 0 and 1 (q = [1, 0, 2, 3, 4, 5, 6, 7][m], self-inverse), so the
    seven nonzero magnitudes {0.5, 1, 1.5, 2, 3, 4, 6} sit at
    consecutive-bf16-bit-pattern codes q in {0, 2..7}: the magnitude ramp
    0x3F00 + q*0x40 covers all nonzero E2M1 values because E2M1 is a
    minifloat embedded in bf16's exponent ramp, with a hole at q=1 (0.75 is
    not an E2M1 value) that the zero code squats.

    **Single-shift bit prepositioning**: within each 16-bit half, a slot's
    sign bit and 3 magnitude bits are stored PRE-POSITIONED so the decode
    extracts both with one shift+mask per quarter — the analog of the
    reference's PetitFormat bit permutation (quantization_utils.cu:183-206).
    Placement per half (j = quarter, t = 3-bit q-coded magnitude, s = sign):

        j=0: t at bits {6,7,8},  s at 15   -> y =  w        & 0x81C081C0
        j=1: t at bits {3,4,5},  s at 12   -> y = (w << 3)  & 0x81C081C0
        j=2: t at bits {0,1,2},  s at 9    -> y = (w << 6)  & 0x81C081C0
        j=3: t{0,1} at {10,11}, t{2} at 13, s at 14 (three-extract quarter:
             the {p,p+1,p+2,p+9} pattern admits only three disjoint single
             shifts in 16 bits — provably, so one quarter pays extra)

    after which  bits = y + nonzero*0x3F00  builds every nonzero value (the
    bias add cannot carry into the sign bit: max 0x1C0 + 0x3F00 = 0x40C0 <
    0x8000), and the stored zero (t=1, sign always +0 after negative-zero
    masking) is masked to +0.0 by the decode.

    Two further design moves are encoded here:

    1. Pairing (slots j / j+4 -> one 32-bit word): the two 16-bit halves of
       a decoded word are the bf16 values of slots j and j+4, so one word
       decodes a pair of consecutive k rows of quarter j with no shuffles.

    2. Group interleave pi within each 128-row chunk: decoded row i of a
       chunk carries k = chunk*128 + (i%8)*16 + i//8, so the 8 NVFP4 scale
       groups of the chunk cycle with period 8 down the rows, and every
       slab of word rows with one residue mod 4 shares a single scale row
       per half. The GEMM wrapper permutes A's k axis to match (k-order
       inside a dot contraction is free as long as A and B agree).

  Scales S: bfloat16, shape (K/16, N) — the checkpoint scales decoded to
    bf16 offline (exact: E4M3 has 3 mantissa bits, E8M0 is a power of two)
    and transposed to k-major at one row per 16 k for both formats (MXFP4's
    32-wide groups are duplicated per half-group). Storing decoded bf16
    instead of raw bytes costs 1 extra byte/group of traffic (~3% of the
    weight stream) but removes any scale decode from the kernel. It
    replaces the reference's E4M3->"E5M3" x2^7 re-bias
    (quantization_utils.cu:143-163), which exists only to dodge denormal
    flushing.

Negative-zero FP4 codes (0x8) are masked to +0 at repack, matching
MaskNegativeZeroOnPetitFp4Format (quantization_utils.cu:196-199).

Sharding note: the k-quarter interleave is *global* in K, so for tensor
parallelism shard the checkpoint along N or K **first**, then repack each
shard (parallel/tp.py does this).
"""

from __future__ import annotations

import numpy as np

from ..numerics import formats

# K must cover 4 quarters x 2 (nibble pair) x 8 sublanes minimum; we also
# keep the reference's contract of K % 128 == 0 (pybind/fp4.cc:44-46).
K_ALIGN = 128
N_ALIGN = 16
# Repack zero-pads K up to a multiple of K_PAD, so each k-quarter is a
# whole number of 128-deep chunks (the kernel's 512-deep k-step covers one
# chunk of each quarter); MXFP4 pads to 1024. The GEMM wrapper zero-pads A
# to match, so padding contributes nothing.
K_PAD = 512
K_PAD_MX = 1024
# Processed scales are stored at one bf16 row per 16 k-elements for BOTH
# formats (MXFP4's 32-wide groups are duplicated per half-group offline).
SCALE_STRIDE = 16

# q-code magnitude remap (self-inverse: swaps E2M1 codes 0 and 1).
# Applied per nibble at repack (sign bit untouched); see module doc.
# Code 1 is the stored ZERO; all-zero padding words decode to t=0 = 0.5
# times the tiny (2^-126) scales of the padded region against zero A
# columns, so padding contributes nothing.
Q_OF_M = np.array([1, 0, 2, 3, 4, 5, 6, 7], dtype=np.uint8)

# v6 bit placement within each 16-bit half (see module doc): per quarter j,
# the left-shift the kernel applies, and where sign lives. j=3 is the
# three-extract quarter: t bits {0,1} at {10,11}, t bit 2 at 13, sign 14.
V6_SHIFT = (0, 3, 6)            # j = 0..2: t stored at bits {6,7,8} >> shift
V6_SGN_POS = (15, 12, 9, 14)


def _v6_place(nib: np.ndarray, j: int) -> np.ndarray:
    """q-coded nibble (sign<<3 | t) -> its v6 in-half bit pattern (u32)."""
    t = (nib & 7).astype(np.uint32)
    sg = (nib >> 3).astype(np.uint32)
    if j < 3:
        return (t << (6 - V6_SHIFT[j])) | (sg << V6_SGN_POS[j])
    return ((t & 3) << 10) | ((t >> 2) << 13) | (sg << 14)


def _v6_extract(half: np.ndarray, j: int) -> np.ndarray:
    """Inverse of _v6_place on a 16-bit half value -> q-coded nibble."""
    if j < 3:
        t = (half >> (6 - V6_SHIFT[j])) & 7
        sg = (half >> V6_SGN_POS[j]) & 1
    else:
        t = ((half >> 10) & 3) | (((half >> 13) & 1) << 2)
        sg = (half >> 14) & 1
    return ((sg << 3) | t).astype(np.uint8)


def _q_encode_nibbles(nib: np.ndarray) -> np.ndarray:
    """E2M1 nibble codes -> stored q-codes (negative zero already masked)."""
    return (nib & 8) | Q_OF_M[nib & 7]


def _q_decode_nibbles(qnib: np.ndarray) -> np.ndarray:
    """Stored q-codes -> E2M1 nibble codes (Q_OF_M is self-inverse)."""
    return (qnib & 8) | Q_OF_M[qnib & 7]


def pad_multiple(group_size: int) -> int:
    return K_PAD if group_size == formats.NVFP4_GROUP_SIZE else K_PAD_MX


def padded_k(size_k: int, multiple: int = K_PAD) -> int:
    return -(-size_k // multiple) * multiple


def _to_numpy_u8_qweights(qweights, size_n: int, size_k: int) -> np.ndarray:
    """Normalize qweights to uint8 (n, k/2). Accepts uint8 (n, k/2) or an
    int32/uint32 (n, k/8) little-endian view (the reference's input dtype,
    pybind/fp4.cc:52-55)."""
    q = np.asarray(qweights)
    if q.dtype in (np.int32, np.uint32):
        q = q.view(np.uint8).reshape(q.shape[0], -1)
    if q.dtype != np.uint8:
        raise TypeError(f"qweights must be uint8 or int32, got {q.dtype}")
    if q.shape != (size_n, size_k // 2):
        raise ValueError(
            f"qweights shape {q.shape} != (n, k/2) = {(size_n, size_k // 2)}")
    return q


def _validate_nk(size_n: int, size_k: int) -> None:
    if size_k % K_ALIGN != 0:
        raise ValueError(f"k = {size_k} must be a multiple of {K_ALIGN}")
    if size_n % N_ALIGN != 0:
        raise ValueError(f"n = {size_n} must be a multiple of {N_ALIGN}")


def repack_fp4_weights(qweights, size_n: int, size_k: int, *,
                       pad_to: int = K_PAD,
                       use_native: bool = True) -> np.ndarray:
    """Reference-layout qweights -> petit packed words, uint32 (k/8, n).

    Weight repack is identical for NVFP4 and MXFP4 (only scales differ), as
    in the reference where repack_mxfp4 aliases repack_nvfp4
    (petit_kernel/__init__.py:27-28).

    Uses the native C++ runtime core (runtime/repack.cpp) when buildable;
    the numpy path below is the bit-identical fallback and spec.
    """
    _validate_nk(size_n, size_k)
    q = _to_numpy_u8_qweights(qweights, size_n, size_k)
    kp = padded_k(size_k, pad_to)
    if kp != size_k:
        pad = np.zeros((size_n, (kp - size_k) // 2), np.uint8)
        q = np.concatenate([q, pad], axis=1)
        size_k = kp
    if use_native:
        from .. import runtime
        out = runtime.repack_fp4_native(q, size_n, size_k)
        if out is not None:
            return out
    nib = formats.unpack_fp4_pairs(q)            # (n, k) codes
    nib = np.where(nib == 8, np.uint8(0), nib)   # mask negative zero
    nib = _q_encode_nibbles(nib)                 # q-code remap
    nib_t = nib.T                                # (k, n)
    k, n = size_k, size_n
    words = np.zeros((k // 8, n), dtype=np.uint32)
    r = np.arange(k // 8)
    for s in range(8):
        j, h = s & 3, s >> 2
        ks = _slot_k(r, j, h, k)
        words |= _v6_place(nib_t[ks], j) << np.uint32(16 * h)
    return words


def _slot_k(r: np.ndarray, j: int, h: int, k: int) -> np.ndarray:
    """k index held by slot (j + 4h) of word row r (module-doc layout)."""
    chunk = r // 64
    i = 2 * (r % 64) + h
    return j * (k // 4) + chunk * 128 + (i % 8) * 16 + i // 8


def unpack_fp4_weights(words: np.ndarray, size_n: int, size_k: int) -> np.ndarray:
    """Inverse of repack_fp4_weights -> nibble codes (n, size_k), dropping
    any K_PAD padding. Test/debug path, analog of DequantPetitFp4's layout
    walk (quantization_utils.cu:306-727)."""
    n = size_n
    k = words.shape[0] * 8  # padded k
    assert words.shape == (k // 8, n) and k >= size_k
    nib_t = np.zeros((k, n), dtype=np.uint8)
    r = np.arange(k // 8)
    for s in range(8):
        j, h = s & 3, s >> 2
        half = (words >> np.uint32(16 * h)) & np.uint32(0xFFFF)
        nib_t[_slot_k(r, j, h, k)] = _v6_extract(half, j)
    return _q_decode_nibbles(nib_t[:size_k].T)


def process_fp4_scales(scales, size_n: int, size_k: int, *,
                       group_size: int) -> np.ndarray:
    """Checkpoint scales (n, k/group) -> k-major bfloat16 (k/16, n)
    (stride-16 rows for both formats; MXFP4 rows duplicated per half-group).

    Validates the positive-scale invariant the kernels rely on (ModelOpt/
    Quark checkpoints guarantee it; reference README.md:31) and decodes the
    raw E4M3/E8M0 bytes to bf16 offline (exact — see module doc).
    """
    import ml_dtypes

    _validate_nk(size_n, size_k)
    s = np.asarray(scales)
    if s.dtype != np.uint8:
        # accept ml_dtypes fp8 views
        s = s.view(np.uint8)
    if s.shape != (size_n, size_k // group_size):
        raise ValueError(
            f"scales shape {s.shape} != (n, k/{group_size}) = "
            f"{(size_n, size_k // group_size)}")
    if group_size == formats.NVFP4_GROUP_SIZE:
        if np.any(s & 0x80):
            raise ValueError("NVFP4 E4M3 scales must be positive")
        if np.any((s & 0x7F) == 0x7F):
            raise ValueError("NVFP4 E4M3 scales must not be NaN")
        dec = formats.e4m3_decode(s)     # exact in bf16 (3 mantissa bits)
    else:
        if np.any(s == 0xFF):
            raise ValueError("MXFP4 E8M0 scales must not be NaN (0xFF)")
        if np.any(s > 252):
            # layout contract: scale * max|fp4| = 2^(s-127)*6 must stay
            # finite in bf16 (the dequantized weight), i.e. byte <= 252
            # (2^125).
            raise ValueError(
                "MXFP4 E8M0 scale bytes 253/254 (2^126, 2^127) exceed the "
                "kernel's exponent-add range; rescale the checkpoint "
                "(ModelOpt/Quark never emit these)")
        # 2^(u8-127); byte 0 (2^-127) is below bf16 normal range — emit an
        # exact 0.0 rather than a subnormal, so the result never depends
        # on a backend's denormal handling.
        dec = np.where(s == 0, np.float32(0), formats.e8m0_decode(s))
    out = np.ascontiguousarray(dec.T.astype(ml_dtypes.bfloat16))
    if group_size == formats.MXFP4_GROUP_SIZE:
        # duplicate each 32-wide group's scale per 16-element half so BOTH
        # formats present one uniform (k/16, n) stride-16 buffer and one
        # kernel serves both.
        out = np.repeat(out, 2, axis=0)
    kp = padded_k(size_k, pad_multiple(group_size))
    if kp != size_k:
        # Padded (all-zero-value) k region: scale rows get 2^-126, the
        # smallest bf16 normal (a finite scale for every decode path); A's
        # zero k-padding keeps all contributions 0.
        pad = np.full(((kp - size_k) // SCALE_STRIDE, size_n),
                      ml_dtypes.bfloat16(2.0 ** -126), ml_dtypes.bfloat16)
        out = np.concatenate([out, pad], axis=0)
    return out


def dequant_from_layout(words: np.ndarray, scales_t: np.ndarray,
                            size_n: int, size_k: int, *,
                            group_size: int) -> np.ndarray:
    """Reference dequant straight from the packed layout -> f32 (k, n).

    Host-side oracle used by round-trip tests (repack -> dequant-from-tiled
    must equal dequant-from-native), mirroring NvFp4ToPetitFp4Test::
    TestConvert (quantization_utils_fp4_test.cc:103-133).
    """
    nib = unpack_fp4_weights(words, size_n, size_k)      # (n, size_k)
    vals = formats.fp4_decode(nib)                       # (n, size_k) f32
    srows = size_k // SCALE_STRIDE  # stride-16 rows for both formats
    sc = np.asarray(scales_t[:srows].T, dtype=np.float32)   # bf16 -> f32
    deq = (vals.reshape(size_n, -1, SCALE_STRIDE) * sc[:, :, None])
    return deq.reshape(size_n, size_k).T                 # (size_k, n)
