"""FP4 weight-only GEMM: the Hopper kernel, the plain XLA path, the dequant.

The kernel follows the Marlin design the reference's CDNA kernels share
(lib/gemm/rocm/quantization/fp4/gemm_fp4_fp16_grid.cuh:441-498): packed
weights are streamed once from device memory, decoded in registers right
before the tensor-core product, and never written back as bf16. It is a
Pallas kernel on the Triton route: one block owns a (block_m, block_n)
output tile, loops over its share of k inside the block, and at small m
the k loop is split over several blocks (split-K) whose partial sums are
added in a second pass, so that enough blocks are in flight to fill the
card.

Layout (ops/layout.py): word row r of the (K/8, N) uint32 weights holds,
for quarter j and half h, the nibble of

    k = j*K/4 + (r // 64)*128 + pi(2*(r % 64) + h),  pi(i) = (i%8)*16 + i//8.

Decoding a tile of word rows therefore yields, per quarter, a "low" slab
(h = 0) and a "high" slab (h = 1). The wrapper permutes A's k axis once
(_a_kernel_order) so that both slabs meet contiguous A columns, and each
k-step is 4 quarters x 2 halves tensor-core dots.

Decode (per u32 word, quarter j, both halves at once; module constants):

    y    = (w << {0,3,6}) & 0x81C081C0       # j<3; j=3 is a 3-extract
    z    = y ^ 0x00400040
    flag = ((z + 0x01C001C0) & 0x02000200) >> 9     # nonzero code (t != 1)
    bits = (y + flag*0x3F00) & (flag*0xFFFF)         # bf16 bits per half

E2M1's seven nonzero magnitudes are consecutive points of bf16's exponent
ramp, 0x3F00 + t*0x40, so one add builds them; the stored zero (t = 1)
is masked to +0.0. No result depends on how the card treats denormals.
Each half becomes an f32 by a shift (same-width bitcast), is multiplied
by its group scale (bf16, decoded offline) and rounded to bf16, which is
exact: a 2-bit by 4-bit significand product. The scale of low row r is
scale row j*K/64 + (r//64)*8 + 2*(r%4) (+1 for the high row), so a k-step
loads 4 rows per chunk and broadcasts them down the slab.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .. import dispatch
from ..solution import SolutionId

_YMASK = np.uint32(0x81C081C0)      # sign | t<<6 per half (post-shift)
_ZXOR = np.uint32(0x00400040)
_CADD = np.uint32(0x01C001C0)
_CMASK = np.uint32(0x02000200)      # carry bit 9: nonzero (t != 1) flag
_NRM_BIAS = np.uint32(0x3F00)       # (126 << 7), multiplied onto the flag
_HI = np.uint32(0xFFFF0000)


def _extract_quarter(words: jax.Array, j: int) -> jax.Array:
    """v6 single-shift extraction: u32 words -> sign|t<<6 per half."""
    if j == 0:
        return words & _YMASK
    if j < 3:
        return (words << np.uint32(3 * j)) & _YMASK
    # three-extract quarter (see layout doc: only three disjoint single
    # shifts exist for the {p,p+1,p+2,p+9} payload pattern in 16 bits)
    return (((words >> np.uint32(4)) & np.uint32(0x00C000C0))
            | ((words >> np.uint32(5)) & np.uint32(0x01000100))
            | ((words << np.uint32(1)) & np.uint32(0x80008000)))


def decode_quarter_bits(words: jax.Array, j: int) -> jax.Array:
    """Quarter j of packed words -> u32 holding the two unscaled bf16 bit
    patterns (low half: slot j, high half: slot j+4). Stored zeros decode
    to exactly +0.0."""
    y = _extract_quarter(words, j)
    flag = (((y ^ _ZXOR) + _CADD) & _CMASK) >> np.uint32(9)
    return (y + flag * _NRM_BIAS) & (flag * np.uint32(0xFFFF))


def _halves_f32(bits: jax.Array):
    """(low, high) bf16 halves of u32 `bits` as exact f32 values."""
    lo = jax.lax.bitcast_convert_type(bits << np.uint32(16), jnp.float32)
    hi = jax.lax.bitcast_convert_type(bits & _HI, jnp.float32)
    return lo, hi


def dequant(words: jax.Array, scales_t: jax.Array, *,
            dtype=jnp.bfloat16) -> jax.Array:
    """Packed weights (kp/8, n) u32 + stride-16 scales (kp/16, n) -> the
    dequantized (kp, n) weight in natural k order, k incl. padding.

    The plain XLA dequant shared by the XLA GEMM path, the backward pass
    and the references; analog of DequantPetitFp4 / DequantPetitMxFp4
    (quantization_utils.cu:306-727)."""
    kw, n = words.shape
    kp = kw * 8
    quarters = []
    for j in range(4):
        lo, hi = _halves_f32(decode_quarter_bits(words, j))
        # decoded row 2r + h of quarter j
        quarters.append(jnp.stack([lo, hi], axis=1).reshape(kp // 4, n))
    v = jnp.stack(quarters)
    # undo the pi-interleave within each 128-row chunk (pi is the
    # (16,8)/(8,16) transpose, its own inverse up to the swap)
    v = v.reshape(4, kp // 512, 16, 8, n).swapaxes(2, 3).reshape(kp, n)
    s = scales_t.astype(jnp.float32)
    out = v.reshape(kp // 16, 16, n) * s[:, None, :]
    return out.reshape(kp, n).astype(dtype)


def _a_kernel_order(a: jax.Array, kp: int, bk: int) -> jax.Array:
    """Permute A's (zero-padded) k axis into the kernel's order: for each
    quarter and k-step, the k of the low slab's rows, then the high's.

    Within a 128-deep chunk the low row 4t+q holds k = 32q + t and the high
    row k = 32q + 16 + t, so natural (q, h, t) becomes (h, t, q)."""
    lead = a.shape[:-1]
    c = bk // 512
    a = a.reshape(*lead, 4, kp // bk, c, 4, 2, 16)      # j, it, c, q, h, t
    nl = len(lead)
    perm = tuple(range(nl)) + tuple(nl + i for i in (0, 1, 4, 2, 5, 3))
    return a.transpose(perm).reshape(*lead, kp)


def _w4a16_kernel(a_ref, w_ref, s_ref, gs_ref, o_ref, *, bm: int, bn: int,
                  kp: int, bk: int, iters: int, split: int,
                  high_precision: bool, grouped: bool):
    """One (block_m, block_n) output tile over `iters` k-steps.

    grid = (n blocks, m blocks, split-K index or expert). Dense refs are
    (m, kp) / (kp/8, n) / (kp/16, n); grouped refs carry a leading expert
    axis."""
    pn, pm, pz = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    lead = (pz,) if grouped else ()
    rows = bk // 8               # word rows per k-step (64 per chunk)
    chunks = bk // 512
    quarter = kp // 4
    r = jax.lax.broadcasted_iota(jnp.int32, (4 * chunks,), 0)
    srow = (r // 4) * 8 + 2 * (r % 4)   # low-half scale rows of one step
    cols = pl.ds(pn * bn, bn)
    it0 = 0 if grouped else pz * iters
    mm = jnp.float32 if high_precision else jnp.bfloat16

    def step(i, acc):
        it = it0 + i
        w = w_ref[(*lead, pl.ds(it * rows, rows), cols)]
        for j in range(4):
            halves = _halves_f32(decode_quarter_bits(w, j))
            base = j * (kp // 64) + it * (bk // 64)
            for h in range(2):
                s = s_ref[(*lead, base + srow + h, cols)].astype(jnp.float32)
                s = jnp.broadcast_to(s.reshape(chunks, 1, 4, bn),
                                     (chunks, 16, 4, bn)).reshape(rows, bn)
                b = (halves[h] * s).astype(mm)
                a = a_ref[(*lead, pl.ds(pm * bm, bm),
                           pl.ds(j * quarter + (2 * it + h) * rows, rows))]
                if high_precision:
                    acc += jnp.dot(a, b, preferred_element_type=jnp.float32,
                                   precision=jax.lax.Precision.HIGHEST)
                else:
                    acc += jnp.dot(a, b, preferred_element_type=jnp.float32)
        return acc

    acc = jax.lax.fori_loop(0, iters, step, jnp.zeros((bm, bn), jnp.float32))
    if split == 1:
        acc = acc * gs_ref[pz if grouped else 0]
    o_ref[(*((pz,) if grouped or split > 1 else ()), pl.ds(pm * bm, bm),
           cols)] = acc.astype(o_ref.dtype)


def w4a16_pallas(a: jax.Array, words: jax.Array, scales_t: jax.Array,
                 gs: jax.Array, *, block_m: int, block_n: int, block_k: int,
                 num_warps: int, num_stages: int, split_k: int,
                 high_precision: bool, out_dtype, interpret: bool):
    """Run the kernel on already padded operands.

    a: (m, kp) or grouped (E, m, kp), m % block_m == 0; words (.., kp/8, n)
    and scales_t (.., kp/16, n) with n % block_n == 0; gs (1,) or (E,).
    Returns (.., m, n) in out_dtype."""
    grouped = a.ndim == 3
    *_, m, kp = a.shape
    n = words.shape[-1]
    nit = kp // block_k
    assert kp % block_k == 0 and nit % split_k == 0, (kp, block_k, split_k)
    assert m % block_m == 0 and n % block_n == 0, (m, block_m, n, block_n)
    assert not (grouped and split_k > 1)
    dt = jnp.float32 if high_precision else jnp.bfloat16
    a = _a_kernel_order(a.astype(dt), kp, block_k)
    if grouped:
        zdim = a.shape[0]
        out_shape = (zdim, m, n)
    else:
        zdim = split_k
        out_shape = (split_k, m, n) if split_k > 1 else (m, n)
    part_dtype = jnp.float32 if split_k > 1 else out_dtype
    kernel = functools.partial(
        _w4a16_kernel, bm=block_m, bn=block_n, kp=kp, bk=block_k,
        iters=nit if grouped else nit // split_k, split=split_k,
        high_precision=high_precision, grouped=grouped)
    out = pl.pallas_call(
        kernel,
        grid=(n // block_n, m // block_m, zdim),
        out_shape=jax.ShapeDtypeStruct(out_shape, part_dtype),
        compiler_params=pltr.CompilerParams(num_warps=num_warps,
                                            num_stages=num_stages),
        interpret=interpret,
        name="petit_w4a16",
    )(a, words, scales_t, jnp.asarray(gs, jnp.float32).reshape(-1))
    if split_k > 1:
        out = (out.sum(0) * jnp.asarray(gs, jnp.float32).reshape(())
               ).astype(out_dtype)
    return out


def _pad_operands(a, words, scales_t, bm: int, bn: int):
    """Zero-pad A to (m_pad, kp) and, for an n that is not a block_n
    multiple, the weight columns (padded scales are zero, so those columns
    compute 0 and are sliced off)."""
    *_, m, k = a.shape
    kp = words.shape[-2] * 8
    n = words.shape[-1]
    m_pad = -(-m // bm) * bm
    n_pad = -(-n // bn) * bn
    nl = a.ndim - 2
    if m_pad != m or kp != k:
        a = jnp.pad(a, ((0, 0),) * nl + ((0, m_pad - m), (0, kp - k)))
    if n_pad != n:
        wpad = ((0, 0),) * nl + ((0, 0), (0, n_pad - n))
        words = jnp.pad(words, wpad)
        scales_t = jnp.pad(scales_t, wpad)
    return a, words, scales_t


@functools.partial(jax.jit, static_argnames=("sid", "interpret", "out_dtype"))
def fused_mul(a: jax.Array, words: jax.Array, scales_t: jax.Array,
              global_scale: jax.Array, *, sid: SolutionId,
              out_dtype=jnp.bfloat16, interpret: bool = False) -> jax.Array:
    """c[m, n] = (a[m, k] @ dequant(words, scales).[k, n]) * global_scale.

    a        : (m, k) bf16 (f32 when sid.high_precision)
    words    : (k/8, n) uint32 petit q-coded layout (ops/layout.py)
    scales_t : (k/16, n) bfloat16 stride-16 scales decoded offline
    global_scale : () or (1,) f32

    The FP4 GEMM's dispatch point (ops/dispatch.py): the Triton kernel on
    the GPU up to dispatch.KERNEL_MAX_M rows, dequant -> dot beyond that
    and on the CPU, the kernel interpreted when the caller asks for
    interpret mode.
    """
    m, k = a.shape
    kp = words.shape[0] * 8
    n = words.shape[1]
    group = sid.group_size
    assert kp >= k and kp - k < (512 if group == 16 else 1024), (kp, k)
    # processed scales are stride-16 rows for both formats (layout doc)
    assert scales_t.shape == (kp // 16, n)
    impl = dispatch.implementation("fp4_gemm", interpret, m=m)
    if impl == "xla":
        return _fused_mul_xla(a, words, scales_t, global_scale,
                              high_precision=sid.high_precision,
                              out_dtype=out_dtype)
    return fused_mul_kernel(a, words, scales_t, global_scale, sid=sid,
                            out_dtype=out_dtype,
                            interpret=impl == "interpret")


def fused_mul_kernel(a, words, scales_t, global_scale, *, sid: SolutionId,
                     out_dtype=jnp.bfloat16, interpret: bool = False):
    """The Triton kernel for any m (fused_mul's choice aside): pad, run,
    slice."""
    m = a.shape[0]
    n = words.shape[1]
    a, words, scales_t = _pad_operands(a, words, scales_t, sid.block_m,
                                       sid.block_n)
    out = w4a16_pallas(
        a, words, scales_t, global_scale, block_m=sid.block_m,
        block_n=sid.block_n, block_k=sid.block_k, num_warps=sid.num_warps,
        num_stages=sid.num_stages, split_k=sid.split_k,
        high_precision=sid.high_precision, out_dtype=out_dtype,
        interpret=interpret)
    return out[:m, :n]


def _fused_mul_xla(a, words, scales_t, global_scale, *,
                   high_precision: bool, out_dtype):
    """The plain version: dequantize to a dense weight, then one dot."""
    k = a.shape[-1]
    dt = jnp.float32 if high_precision else jnp.bfloat16
    w = dequant(words, scales_t, dtype=dt)[:k]
    prec = jax.lax.Precision.HIGHEST if high_precision else None
    out = jnp.matmul(a.astype(dt), w, preferred_element_type=jnp.float32,
                     precision=prec)
    return (out * jnp.asarray(global_scale, jnp.float32).reshape(())
            ).astype(out_dtype)


# ---------------------------------------------------------------------------
# W4A8: FP4 weights requantized to int8 per column, int8 activations per
# token, one int8 dot with an int32 accumulator (XLA hands it to the int8
# tensor cores). Analog of the reference's third mfma type
# (kMatmulMfmaTypeFp8, gemm.h:63-67; CDNA3 bf8 fast path,
# dequant.cuh:326-363). Opt-in (MatmulType.INT8): per-column weight
# requantization is a different numerics contract than exact group-wise FP4
# dequant — quality-gate before adopting (tools/quality_gate.py).
# ---------------------------------------------------------------------------


def _round_i8_bf16(b):
    """RNE round-to-integer of a bf16 array IN the bf16 domain, as int8:
    |b| + 128 lands in [128, 256), where the bf16 ulp is exactly 1, so the
    add itself rounds to nearest even; subtracting 128 is exact. Requires
    |b| <= 127, guaranteed by the requant constant r = scale*127/colmax.
    Bit-identical to lax.round(TO_NEAREST_EVEN) on that domain."""
    m = jnp.bfloat16(128.0)
    r = (jnp.abs(b) + m) - m
    return jnp.where(b < 0, -r, r).astype(jnp.int8)


def w4a8_requant_constants(scales_t: jax.Array):
    """Per-column weight requant constants for W4A8:
    colmax = 6 * max(scales_t) per column, r_t = scales_t * 127/colmax
    (bf16), acol = colmax/127 (f32, (1, n)). Precompute once at load or
    engine-init time and pass to fused_mul_w4a8(r_t=..., acol=...)."""
    s32 = scales_t.astype(jnp.float32)
    colmax = 6.0 * jnp.max(s32, axis=0, keepdims=True)        # (1, n)
    colmax = jnp.where(colmax == 0, 1.0, colmax)
    r_t = (s32 * (127.0 / colmax)).astype(jnp.bfloat16)       # (kp/16, n)
    acol = colmax / 127.0                                     # (1, n)
    return r_t, acol


@functools.partial(jax.jit, static_argnames=("out_dtype",))
def fused_mul_w4a8(a: jax.Array, words: jax.Array, scales_t: jax.Array,
                   global_scale: jax.Array, *, out_dtype=jnp.bfloat16,
                   r_t: jax.Array | None = None,
                   acol: jax.Array | None = None) -> jax.Array:
    """W4A8 path of fused_mul: same (words, scales_t) operands.

    Per-token activation quantization (arow = max|a|/127), per-column
    weight requantization (the decoded value times r_t, rounded in bf16 to
    int8), an int8 x int8 -> int32 dot, and the epilogue
    out = acc * arow * acol * gs."""
    m, k = a.shape
    kp = words.shape[0] * 8
    assert scales_t.shape == (kp // 16, words.shape[1])
    if r_t is None or acol is None:
        r_t, acol = w4a8_requant_constants(scales_t)
    af = a.astype(jnp.float32)
    arow = jnp.max(jnp.abs(af), axis=1, keepdims=True) / 127.0  # (m, 1)
    arow = jnp.where(arow == 0, 1.0, arow)
    a_i8 = jax.lax.round(af / arow, jax.lax.RoundingMethod.TO_NEAREST_EVEN
                         ).astype(jnp.int8)
    # decoded values (exact in bf16) times the requant constant, in bf16
    v = dequant(words, jnp.ones_like(r_t), dtype=jnp.bfloat16)
    r = jnp.repeat(r_t, 16, axis=0)
    w_i8 = _round_i8_bf16(v * r)[:k]
    acc = jax.lax.dot_general(a_i8, w_i8, (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    gs = jnp.asarray(global_scale, jnp.float32).reshape(())
    return (acc.astype(jnp.float32) * arow * acol * gs).astype(out_dtype)
