"""FP4 GEMM kernel, XLA path and dequant vs host oracle (CPU).

Analog of the reference GEMM-vs-hipBLASLt integration tests
(fp4/gemm_fp4_fp16_rocm_test.cc:192-289): the oracle dequantizes B with the
host reference and runs a dense f32 matmul; tolerance |d| < max(1e-2, 1%).
The Triton kernel runs in Pallas interpret mode here, and is lowered for
CUDA (without a card) to check that it translates at real widths.
"""

import functools

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from petit_jax.numerics import formats, reference
from petit_jax.ops import dispatch, layout
from petit_jax.ops import solution as solution_mod
from petit_jax.ops.kernels import fused, grouped
from petit_jax.ops.solution import SolutionId, ElementB


def make_case(m, n, k, fmt, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    nib = rng.integers(0, 16, size=(n, k), dtype=np.uint8)
    nib[nib == 8] = 0
    qw = formats.pack_fp4_pairs(nib)
    group = 16 if fmt == "nvfp4" else 32
    if fmt == "nvfp4":
        # positive E4M3 around 1.0 (exponents 4..10 => 2^-3..2^3)
        scales = (rng.integers(4, 11, size=(n, k // group), dtype=np.uint8) << 3
                  | rng.integers(0, 8, size=(n, k // group), dtype=np.uint8))
    else:
        scales = rng.integers(120, 135, size=(n, k // group), dtype=np.uint8)
    gs = np.float32(rng.uniform(0.5, 2.0))
    words = layout.repack_fp4_weights(qw, n, k,
                                      pad_to=layout.pad_multiple(group))
    st = layout.process_fp4_scales(scales, n, k, group_size=group)
    return a, qw, scales, gs, words, st


def check(c, a, qw, scales, gs, fmt, rtol=0.01, atol=0.01):
    a_bf = a.astype(jnp.bfloat16).astype(np.float32)
    ref = reference.gemm_reference(a_bf, qw, scales, gs, fmt=fmt)
    c = np.asarray(c, dtype=np.float32)
    np.testing.assert_allclose(c, ref, rtol=rtol, atol=atol)


def test_standalone_dequant_kernel_bit_exact():
    for fmt in ("nvfp4", "mxfp4"):
        _, qw, scales, _, words, st = make_case(1, 32, 512, fmt, seed=5)
        group = 16 if fmt == "nvfp4" else 32
        out = fused.dequant(jnp.asarray(words), jnp.asarray(st))
        expect = layout.dequant_from_layout(words, st, 32, 512,
                                            group_size=group)
        # output covers padded k; logical rows must match bit-exactly
        # (bf16 cast of exact products is exact: <= 6 significand bits), and
        # padded rows must be zero
        out = np.asarray(out, np.float32)
        assert np.array_equal(out[:512], expect), fmt
        assert not out[512:].any(), fmt


CASES = [
    # m, n, k, sid blocks (bm, bn, bk)
    (16, 128, 512, (16, 128, 512)),
    (1, 128, 512, (16, 128, 512)),     # m padding
    (16, 192, 1024, (16, 128, 512)),   # n padding (192 -> 256), two k-steps
    (33, 128, 1024, (16, 128, 512)),   # m padding multi-block
    (64, 256, 1024, (32, 256, 1024)),  # multi n-block, single k-step
    (16, 128, 384, (16, 128, 512)),    # k padding (384 -> 512)
]


@pytest.mark.parametrize(("m", "n", "k", "blocks"), CASES)
@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_fused_gemm_vs_oracle(m, n, k, blocks, fmt):
    eb = ElementB.NVFP4 if fmt == "nvfp4" else ElementB.MXFP4
    sid = SolutionId(*blocks, element_b=eb)
    a, qw, scales, gs, words, st = make_case(m, n, k, fmt, seed=m * k + n)
    c = fused.fused_mul(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(words), jnp.asarray(st),
        jnp.float32(gs), sid=sid, interpret=True)
    assert c.shape == (m, n) and c.dtype == jnp.bfloat16
    check(c, a, qw, scales, gs, fmt)


def test_fused_gemm_high_precision():
    sid = SolutionId(16, 128, 512, element_b=ElementB.NVFP4,
                     high_precision=True)
    a, qw, scales, gs, words, st = make_case(16, 128, 512, "nvfp4", seed=9)
    c = fused.fused_mul(
        jnp.asarray(a, jnp.float32), jnp.asarray(words), jnp.asarray(st),
        jnp.float32(gs), sid=sid, out_dtype=jnp.float32, interpret=True)
    # f32 path: compare against f32 oracle (no bf16 rounding of A)
    ref = reference.gemm_reference(a, qw, scales, gs, fmt="nvfp4")
    np.testing.assert_allclose(np.asarray(c), ref, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_kernel_dequant_exhaustive_values(fmt):
    """Every (FP4 nibble x scale byte) combination decodes bit-exactly
    through repack -> decode, vs the closed-form host product.

    Reference analog: ExhaustiveFp4DequantTest / MxFp4DequantTest
    (fp4/quantization_utils_fp4_test.cc:255-394). Products e2m1 x scale are
    exact in bf16 (2 + 3 significand bits), so the comparison is equality.
    """
    group = 16 if fmt == "nvfp4" else 32
    n, k = 128, 32 * group  # 32 scale groups per row
    # every nibble code in every group: k cycles 0..15
    nib = np.tile(np.arange(16, dtype=np.uint8), (n, k // 16))
    nib[nib == 8] = 0
    if fmt == "nvfp4":
        valid = np.array([b for b in range(127) if (b & 0x7F) != 0x7F],
                         dtype=np.uint8)  # positive, non-NaN E4M3
    else:
        # all E8M0 except NaN (255) and 253/254, which process_fp4_scales
        # rejects (layout contract)
        valid = np.arange(253, dtype=np.uint8)
    gidx = (np.arange(n)[:, None] * (k // group)
            + np.arange(k // group)[None, :])
    scales = valid[gidx % len(valid)]
    assert len(np.unique(scales)) == len(valid)  # full byte coverage

    words = layout.repack_fp4_weights(
        formats.pack_fp4_pairs(nib), n, k,
        pad_to=layout.pad_multiple(group))
    st = layout.process_fp4_scales(scales, n, k, group_size=group)
    deq = np.asarray(fused.dequant(jnp.asarray(words), jnp.asarray(st)),
                     np.float32)[:k]  # (k, n)

    vals = formats.fp4_decode(nib).astype(np.float64)  # (n, k)
    sc = (formats.e4m3_decode(scales) if fmt == "nvfp4"
          else formats.e8m0_decode(scales)).astype(np.float64)
    want = (vals.reshape(n, -1, group) * sc[:, :, None]).reshape(n, k).T
    # bf16-exact products: round the closed form through bf16
    import ml_dtypes
    want = want.astype(np.float32).astype(ml_dtypes.bfloat16)
    got = deq.astype(ml_dtypes.bfloat16)
    if fmt == "mxfp4":
        # products below the bf16 normal range (only reachable with extreme
        # E8M0 scales, never by NVFP4's E4M3 range) are compared as zero:
        # the E8M0 byte-0 scale is stored as 0.0, and how a backend rounds
        # denormal products is its own
        flush = (np.repeat(sc.T < 2.0 ** -126, group, axis=0)
                 | (np.abs(want.astype(np.float64)) < 2.0 ** -126))
        got = np.where(flush, ml_dtypes.bfloat16(0), got)
        want = np.where(flush, ml_dtypes.bfloat16(0), want)
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize(("m", "n", "k", "blocks"), [
    (64, 256, 1024, (16, 128, 512, 2)),    # 4 m-blocks, 2 n-blocks
    (33, 128, 1024, (16, 128, 512, 2)),    # padded m, odd final block
    (128, 256, 4096, (32, 256, 1024, 4)),
])
@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_fused_gemm_weight_cache_vs_oracle(m, n, k, blocks, fmt):
    """Split-K solutions (the k loop spread over split_k blocks, partial
    sums added in a second pass) match the oracle like the plain kernel."""
    eb = ElementB.NVFP4 if fmt == "nvfp4" else ElementB.MXFP4
    bm, bn, bk, split = blocks
    sid = SolutionId(bm, bn, bk, element_b=eb, split_k=split)
    assert SolutionId.from_repr(sid.repr()) == sid  # split round-trips
    a, qw, scales, gs, words, st = make_case(m, n, k, fmt, seed=m + n + k)
    c = fused.fused_mul(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(words), jnp.asarray(st),
        jnp.float32(gs), sid=sid, interpret=True)
    assert c.shape == (m, n)
    check(c, a, qw, scales, gs, fmt)


def test_weight_cache_matches_plain_kernel_bitexact():
    """Split-K only reorders the f32 sum: it agrees with the unsplit
    kernel to f32 rounding before the bf16 output cast."""
    m, n, k = 48, 256, 2048
    a, qw, scales, gs, words, st = make_case(m, n, k, "nvfp4", seed=7)
    args = (jnp.asarray(a, jnp.bfloat16), jnp.asarray(words),
            jnp.asarray(st), jnp.float32(gs))
    plain = fused.fused_mul(*args, sid=SolutionId(16, 128, 512),
                            out_dtype=jnp.float32, interpret=True)
    split = fused.fused_mul(*args, sid=SolutionId(16, 128, 512, split_k=4),
                            out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(np.asarray(plain), np.asarray(split),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_stored_zero_decodes_to_exact_zero(fmt):
    """A zero code (+0 or -0) times ANY scale is +0.0 exactly — by the
    integer mask in the decode, not by a denormal flush — in the dequant
    and through the kernel."""
    group = 16 if fmt == "nvfp4" else 32
    n, k = 128, 1024
    rng = np.random.default_rng(3)
    nib = np.where(rng.random((n, k)) < 0.5, 0, 8).astype(np.uint8)
    if fmt == "nvfp4":
        scales = rng.integers(0, 127, size=(n, k // group), dtype=np.uint8)
        scales = np.where((scales & 0x7F) == 0x7F, 1, scales)
    else:
        scales = rng.integers(0, 253, size=(n, k // group), dtype=np.uint8)
    scales = scales.astype(np.uint8)
    words = layout.repack_fp4_weights(formats.pack_fp4_pairs(nib), n, k,
                                      pad_to=layout.pad_multiple(group))
    st = layout.process_fp4_scales(scales, n, k, group_size=group)
    deq = np.asarray(fused.dequant(jnp.asarray(words), jnp.asarray(st),
                                   dtype=jnp.float32))
    assert (deq.view(np.uint32) == 0).all()          # +0.0 bit pattern
    for j in range(4):
        bits = np.asarray(fused.decode_quarter_bits(jnp.asarray(words), j))
        assert (bits == 0).all(), j
    eb = ElementB.NVFP4 if fmt == "nvfp4" else ElementB.MXFP4
    c = fused.fused_mul(jnp.ones((16, k), jnp.bfloat16), jnp.asarray(words),
                        jnp.asarray(st), jnp.float32(1.0),
                        sid=SolutionId(16, 128, 512, eb),
                        out_dtype=jnp.float32, interpret=True)
    assert (np.asarray(c).view(np.uint32) == 0).all()


@pytest.mark.parametrize("op,platform,interpret,m,want", [
    ("fp4_gemm", "gpu", False, None, "triton"),
    ("fp4_gemm", "cpu", False, None, "xla"),
    ("fp4_gemm", "cpu", True, None, "interpret"),
    ("fp4_gemm", "gpu", True, None, "interpret"),
    ("grouped_gemm", "gpu", False, None, "triton"),
    ("grouped_gemm", "cpu", False, None, "xla"),
    ("fp4_gemm", "gpu", False, dispatch.KERNEL_MAX_M, "triton"),
    ("fp4_gemm", "gpu", False, dispatch.KERNEL_MAX_M + 1, "xla"),
    ("grouped_gemm", "gpu", False, 4 * dispatch.KERNEL_MAX_M, "xla"),
    ("grouped_gemm", "cpu", True, 4 * dispatch.KERNEL_MAX_M, "interpret"),
])
def test_dispatch_per_platform(op, platform, interpret, m, want):
    """Kernel up to KERNEL_MAX_M rows on the GPU, XLA beyond it and on the
    CPU; interpret mode whenever the caller asks, at any m."""
    assert dispatch.implementation(op, interpret, platform=platform,
                                   m=m) == want


@pytest.mark.parametrize("platform", ["rocm", "metal", "plugin"])
def test_dispatch_refuses_unknown_platform(platform):
    """No op falls back silently on a platform it was not built for."""
    for op in dispatch.OPS:
        with pytest.raises(RuntimeError, match="no implementation"):
            dispatch.implementation(op, platform=platform)
    with pytest.raises(KeyError):
        dispatch.implementation("no_such_op", platform="gpu")


def test_cpu_runs_plain_xla_not_interpret():
    """On the CPU without interpret=True the GEMM is the XLA path: its
    program holds a dot and no Pallas call."""
    a = jnp.zeros((16, 512), jnp.bfloat16)
    w = jnp.zeros((64, 128), jnp.uint32)
    s = jnp.ones((32, 128), jnp.bfloat16)
    txt = jax.jit(functools.partial(fused.fused_mul,
                                    sid=SolutionId(16, 128, 512))
                  ).lower(a, w, s, jnp.float32(1)).as_text()
    assert "dot" in txt and "pallas" not in txt.lower()


def _lower_for_cuda(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    return jax.jit(f).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("m,n,k,fmt", [
    (16, 8192, 8192, "nvfp4"),      # decode: split-K
    (256, 28672, 4096, "nvfp4"),    # prefill tile
    (16, 6144, 4096, "mxfp4"),
    (64, 4096, 14336, "nvfp4"),
])
def test_kernel_lowers_for_cuda(m, n, k, fmt):
    """The chosen solution's Triton kernel translates for CUDA at real
    widths (Triton IR emitted, no card needed); compiling it is the
    card's job."""
    eb = ElementB.NVFP4 if fmt == "nvfp4" else ElementB.MXFP4
    sid = solution_mod.choose_default_solution(m, n, k, eb)
    f = functools.partial(
        fused.w4a16_pallas, block_m=sid.block_m, block_n=sid.block_n,
        block_k=sid.block_k, num_warps=sid.num_warps,
        num_stages=sid.num_stages, split_k=sid.split_k,
        high_precision=False, out_dtype=jnp.bfloat16, interpret=False)
    mp = -(-m // sid.block_m) * sid.block_m
    txt = _lower_for_cuda(f, ((mp, k), jnp.bfloat16),
                          ((k // 8, n), jnp.uint32),
                          ((k // 16, n), jnp.bfloat16), ((1,), jnp.float32))
    assert "triton" in txt


def test_grouped_and_high_precision_lower_for_cuda():
    hp = functools.partial(
        fused.w4a16_pallas, block_m=16, block_n=64, block_k=512,
        num_warps=4, num_stages=2, split_k=2, high_precision=True,
        out_dtype=jnp.float32, interpret=False)
    txt = _lower_for_cuda(hp, ((16, 4096), jnp.float32),
                          ((512, 1024), jnp.uint32),
                          ((256, 1024), jnp.bfloat16), ((1,), jnp.float32))
    assert "triton" in txt
    gr = functools.partial(
        fused.w4a16_pallas, block_m=16, block_n=128, block_k=512,
        num_warps=4, num_stages=2, split_k=1, high_precision=False,
        out_dtype=jnp.bfloat16, interpret=False)
    txt = _lower_for_cuda(gr, ((8, 16, 4096), jnp.bfloat16),
                          ((8, 512, 14336), jnp.uint32),
                          ((8, 256, 14336), jnp.bfloat16),
                          ((8,), jnp.float32))
    assert "triton" in txt


def test_a_kernel_order_is_a_permutation():
    for kp, bk in ((512, 512), (2048, 512), (2048, 1024), (4096, 1024)):
        a = jnp.arange(kp, dtype=jnp.float32)[None]
        p = np.asarray(fused._a_kernel_order(a, kp, bk))[0]
        assert sorted(p.tolist()) == list(range(kp))


@pytest.mark.gpu
def test_triton_kernel_on_gpu_matches_xla(gpu):
    """On the card: the compiled Triton kernel agrees with the XLA path."""
    m, n, k = 16, 1024, 2048
    a, qw, scales, gs, words, st = make_case(m, n, k, "nvfp4", seed=1)
    args = (jnp.asarray(a, jnp.bfloat16), jnp.asarray(words),
            jnp.asarray(st), jnp.float32(gs))
    sid = solution_mod.choose_default_solution(m, n, k)
    got = fused.fused_mul(*args, sid=sid, out_dtype=jnp.float32)
    want = fused._fused_mul_xla(*args, high_precision=False,
                                out_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
def test_grouped_kernel_on_gpu_matches_xla(gpu):
    E, cap, n, k = 4, 16, 256, 1024
    rng = np.random.default_rng(2)
    cases = [make_case(cap, n, k, "mxfp4", seed=e) for e in range(E)]
    xs = jnp.asarray(np.stack([c[0] for c in cases]), jnp.bfloat16)
    w = jnp.asarray(np.stack([c[4] for c in cases]))
    s = jnp.asarray(np.stack([c[5] for c in cases]))
    gs = jnp.asarray(rng.uniform(0.5, 2, E), jnp.float32)
    got = grouped.grouped_mul(xs, w, s, gs, out_dtype=jnp.float32)
    want = jnp.stack([fused._fused_mul_xla(xs[e], w[e], s[e], gs[e],
                                           high_precision=False,
                                           out_dtype=jnp.float32)
                      for e in range(E)])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-2, atol=1e-2)
