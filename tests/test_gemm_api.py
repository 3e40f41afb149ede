"""Differentiable FP4 matmul (custom VJP) vs dense-dequant autodiff oracle."""
import numpy as np
import jax
import jax.numpy as jnp

import pytest

import petit_jax as pk
from petit_jax.ops import gemm as G
from petit_jax.ops import layout as L
from petit_jax.ops import solution as S
from petit_jax.numerics import reference as refn
from petit_jax.utils.testdata import make_gemm_data


def test_mul_fp4_diff_grads_match_dense():
    d = make_gemm_data(8, 128, 512, "nvfp4", seed=3)
    a = jnp.asarray(d.a, jnp.bfloat16)
    b, s = jnp.asarray(d.words), jnp.asarray(d.scales_t)
    gs = jnp.float32(d.global_scale)

    def f(a, gs):
        return jnp.sum(G.mul_fp4_diff("nvfp4", 512, a, b, s, gs)
                       .astype(jnp.float32) ** 2)

    val, (da, dgs) = jax.value_and_grad(f, argnums=(0, 1))(a, gs)

    deq = L.dequant_from_layout(d.words, d.scales_t, 128, 512,
                                    group_size=16)
    w = jnp.asarray(deq, jnp.bfloat16)

    def f_ref(a, gs):
        y = jnp.dot(a, w, preferred_element_type=jnp.float32) * gs
        return jnp.sum(y.astype(jnp.float32) ** 2)

    val_r, (da_r, dgs_r) = jax.value_and_grad(f_ref, argnums=(0, 1))(a, gs)
    assert np.allclose(float(val), float(val_r), rtol=0.02)
    da = np.asarray(da, np.float32)
    da_r = np.asarray(da_r, np.float32)
    scale = np.abs(da_r).max()
    np.testing.assert_allclose(da / scale, da_r / scale, atol=0.02)
    assert np.allclose(float(dgs), float(dgs_r), rtol=0.05)


def test_nvfp4p2_quantizer_emits_pow2_scales():
    """quantize_nvfp4_pow2: every stored E4M3 byte decodes to an exact
    power of two, values stay in [-6, 6], and end-to-end dequantization
    error is bounded (pow2 scales re-round values in E2M1: worst-case one
    E2M1 step at double the ideal scale = 2/3 relative, typical far less)."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    w[3, :16] = 0.0          # all-zero group
    w[5, 40] = 100.0         # outlier group
    qw, scales, gs = refn.quantize_nvfp4_pow2(w)
    dec = np.asarray(
        [float(refn.formats.e4m3_decode(np.uint8(b))) for b in
         scales.reshape(-1)])
    assert (dec > 0).all()
    exp = np.log2(dec)
    np.testing.assert_array_equal(exp, np.round(exp))  # pure powers of two
    deq = refn.dequant_nvfp4(qw, scales) * gs
    err = np.abs(deq - w).reshape(64, -1, 16)
    # per-group bound: 1/2 E2M1 ulp at the chosen scale; scale <= 2*ideal
    gmax = np.abs(w.reshape(64, -1, 16)).max(-1, keepdims=True)
    assert (err <= np.maximum(gmax / 3.0, 1e-6)).all()
    # aggregate accuracy sanity: relative RMS error under 10%
    rms = np.sqrt(np.mean((deq - w) ** 2)) / np.sqrt(np.mean(w ** 2))
    assert rms < 0.10, rms


def test_mul_nvfp4p2_matches_nvfp4_and_oracle():
    """mul_nvfp4p2_a16 agrees with both the host oracle and the NVFP4 path
    on pow2-scale data (one kernel; the format is a quantizer contract)."""
    for (m, n, k) in [(16, 256, 512), (5, 128, 1024), (33, 208, 640)]:
        d = make_gemm_data(m, n, k, "nvfp4p2", seed=m)
        a = jnp.asarray(d.a, jnp.bfloat16)
        args = (a, jnp.asarray(d.words), jnp.asarray(d.scales_t),
                jnp.float32(d.global_scale), m, n, k, -1)
        c_p2 = pk.mul_nvfp4p2_a16(*args, interpret=True)
        c_nv = pk.mul_nvfp4_a16(*args, interpret=True)
        ref = refn.gemm_reference(np.asarray(a, np.float32), d.qweights,
                                  d.scales, d.global_scale, fmt="nvfp4")
        np.testing.assert_allclose(np.asarray(c_p2, np.float32), ref,
                                   rtol=0.01, atol=0.01)
        np.testing.assert_allclose(np.asarray(c_p2, np.float32),
                                   np.asarray(c_nv, np.float32),
                                   rtol=0.005, atol=0.005)


def test_nvfp4p2_solution_id_roundtrip_and_validation():
    """nvfp4p2 shares NVFP4's kernel and solution space: a split-K id
    round-trips, differs from the unsplit one, and is accepted through the
    public mul; an MXFP4 id is rejected."""
    sid = S.SolutionId(16, 128, 512, S.ElementB.NVFP4, split_k=2)
    assert S.SolutionId.from_repr(sid.repr()) == sid
    assert sid.repr() != S.SolutionId(16, 128, 512, S.ElementB.NVFP4).repr()
    d = make_gemm_data(8, 128, 1024, "nvfp4p2", seed=1)
    with pytest.raises(ValueError, match="element_b"):
        pk.mul_nvfp4p2_a16(jnp.asarray(d.a, jnp.bfloat16),
                           jnp.asarray(d.words), jnp.asarray(d.scales_t),
                           jnp.float32(d.global_scale), 8, 128, 1024,
                           S.SolutionId(16, 128, 512, S.ElementB.MXFP4
                                        ).repr(), interpret=True)
    # explicit solution id accepted through the public mul
    c = pk.mul_nvfp4p2_a16(jnp.asarray(d.a, jnp.bfloat16),
                           jnp.asarray(d.words), jnp.asarray(d.scales_t),
                           jnp.float32(d.global_scale), 8, 128, 1024,
                           sid.repr(), interpret=True)
    assert c.shape == (8, 128)


def test_nvfp4p2_end_to_end_model_quality():
    """fmt="nvfp4p2" through a tiny llama: logits stay close to the dense
    model (sanity that the mode is wired end-to-end, not a perf-only stub)."""
    from petit_jax.models import llama
    cfg = llama.LlamaConfig.tiny(hidden_size=256, intermediate_size=512)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    qp = llama.quantize_params(params, "nvfp4p2")
    toks = jnp.arange(8)[None, :] % cfg.vocab_size
    dense, _ = llama.forward(params, toks, cfg, interpret=True)
    quant, _ = llama.forward(qp, toks, cfg, fmt="nvfp4p2", interpret=True)
    # same sanity band the nvfp4 model tests use: top-1 agreement mostly
    agree = (jnp.argmax(dense[0], -1) == jnp.argmax(quant[0], -1)).mean()
    assert float(agree) >= 0.5, float(agree)


def test_nvfp4p2z_quantizer_zero_free_and_bounded():
    """quantize_nvfp4_pow2z: NO stored-zero codes anywhere (the format
    contract), pow2 scales, and error bounded by one extra half-step for
    near-zero values."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    w[3, :16] = 0.0          # all-zero group: must still be zero-FREE
    w[7, 32:48] = 1e-6       # near-zero group
    qw, scales, gs = refn.quantize_nvfp4_pow2z(w)
    nibs = np.concatenate([qw & 0xF, qw >> 4], axis=-1)
    assert not ((nibs == 0) | (nibs == 8)).any()   # zero-free
    dec = refn.formats.e4m3_decode(scales.reshape(-1)).astype(np.float64)
    exp = np.log2(dec)
    np.testing.assert_array_equal(exp, np.round(exp))  # powers of two
    deq = refn.dequant_nvfp4(qw, scales) * gs
    # near-zero values land at +-0.5 * (group scale * gs): bounded by one
    # half-step of the chosen (<= 2x ideal) scale
    err = np.abs(deq - w).reshape(64, -1, 16)
    gmax = np.abs(w.reshape(64, -1, 16)).max(-1, keepdims=True)
    step = np.maximum(gmax / 3.0, refn.formats.e4m3_decode(
        scales)[..., None].astype(np.float64) * gs)
    assert (err <= np.maximum(step, 1e-6)).all()


def test_mul_nvfp4p2z_matches_pow2_kernel_bit_exact():
    """On zero-free tensors mul_nvfp4p2z_a16 is BIT-IDENTICAL to
    mul_nvfp4p2_a16 and matches the host oracle."""
    for (m, n, k) in [(16, 256, 512), (5, 128, 1024), (33, 208, 640)]:
        d = make_gemm_data(m, n, k, "nvfp4p2z", seed=m)
        a = jnp.asarray(d.a, jnp.bfloat16)
        args = (a, jnp.asarray(d.words), jnp.asarray(d.scales_t),
                jnp.float32(d.global_scale), m, n, k, -1)
        c_z = pk.mul_nvfp4p2z_a16(*args, interpret=True)
        c_p2 = pk.mul_nvfp4p2_a16(*args, interpret=True)
        assert np.array_equal(np.asarray(c_z, np.float32),
                              np.asarray(c_p2, np.float32))
        ref = refn.gemm_reference(np.asarray(a, np.float32), d.qweights,
                                  d.scales, d.global_scale, fmt="nvfp4")
        np.testing.assert_allclose(np.asarray(c_z, np.float32), ref,
                                   rtol=0.01, atol=0.01)


def test_nvfp4p2z_solution_id_and_model():
    sid = S.SolutionId(16, 128, 512, S.ElementB.NVFP4, num_warps=8,
                       num_stages=2)
    assert S.SolutionId.from_repr(sid.repr()) == sid
    assert sid.repr() != S.SolutionId(16, 128, 512, S.ElementB.NVFP4,
                                      num_stages=2).repr()
    with pytest.raises(AssertionError):
        S.SolutionId(16, 128, 512, S.ElementB.NVFP4, num_warps=3)
    # end-to-end tiny llama sanity (mode wired, not a perf-only stub)
    from petit_jax.models import llama
    cfg = llama.LlamaConfig.tiny(hidden_size=256, intermediate_size=512)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    qp = llama.quantize_params(params, "nvfp4p2z")
    toks = jnp.arange(8)[None, :] % cfg.vocab_size
    dense, _ = llama.forward(params, toks, cfg, interpret=True)
    quant, _ = llama.forward(qp, toks, cfg, fmt="nvfp4p2z", interpret=True)
    agree = (jnp.argmax(dense[0], -1) == jnp.argmax(quant[0], -1)).mean()
    assert float(agree) >= 0.5, float(agree)


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_mul_w4a8_close_to_a16(fmt):
    """W4A8 (int8 product, per-token activation quant + per-column weight
    requant) tracks the exact a16 path within int8 quantization noise —
    the third MatmulType (reference kMatmulMfmaTypeFp8 analog)."""
    for (m, n, k) in [(256, 256, 512), (64, 128, 1024)]:
        d = make_gemm_data(m, n, k, fmt, seed=m + len(fmt))
        a = jnp.asarray(d.a, jnp.bfloat16)
        args = (a, jnp.asarray(d.words), jnp.asarray(d.scales_t),
                jnp.float32(d.global_scale), m, n, k, -1)
        mul8 = pk.mul_nvfp4_a8 if fmt == "nvfp4" else pk.mul_mxfp4_a8
        mul16 = pk.mul_nvfp4_a16 if fmt == "nvfp4" else pk.mul_mxfp4_a16
        c8 = np.asarray(mul8(*args, interpret=True), np.float32)
        c16 = np.asarray(mul16(*args, interpret=True), np.float32)
        assert c8.shape == (m, n)
        rel = (np.linalg.norm(c8 - c16) / np.linalg.norm(c16))
        assert rel < 0.03, (fmt, m, n, k, rel)


def test_mul_w4a8_weight_cache_variant():
    """W4A8 is one XLA program whatever INT8 solution is named: an explicit
    id gives the same bits as -1 resolution, and precomputed requant
    constants (the engines' path) the same bits as per-call ones."""
    m, n, k = 256, 256, 1024
    d = make_gemm_data(m, n, k, "nvfp4", seed=3)
    a = jnp.asarray(d.a, jnp.bfloat16)
    base = (a, jnp.asarray(d.words), jnp.asarray(d.scales_t),
            jnp.float32(d.global_scale), m, n, k)
    sid_wc = S.SolutionId(64, 256, 512, S.ElementB.NVFP4,
                          S.MatmulType.INT8, num_stages=1)
    sid_no = -1
    c_wc = np.asarray(pk.mul_nvfp4_a8(*base, sid_wc.repr(),
                                      interpret=True), np.float32)
    c_no = np.asarray(pk.mul_nvfp4_a8(*base, sid_no,
                                      interpret=True), np.float32)
    assert np.array_equal(c_wc, c_no)
    from petit_jax.ops.kernels import fused
    r_t, acol = fused.w4a8_requant_constants(jnp.asarray(d.scales_t))
    c_pre = np.asarray(pk.mul_nvfp4_a8(*base, r_t=r_t, acol=acol),
                       np.float32)
    assert np.array_equal(c_pre, c_no)
    c16 = np.asarray(pk.mul_nvfp4_a16(*base, -1, interpret=True),
                     np.float32)
    rel = np.linalg.norm(c_wc - c16) / np.linalg.norm(c16)
    assert rel < 0.03, rel


def test_mul_w4a8_explicit_solution_validation():
    d = make_gemm_data(64, 128, 512, "nvfp4", seed=2)
    a = jnp.asarray(d.a, jnp.bfloat16)
    base = (a, jnp.asarray(d.words), jnp.asarray(d.scales_t),
            jnp.float32(d.global_scale), 64, 128, 512)
    sid = S.SolutionId(64, 128, 512, S.ElementB.NVFP4, S.MatmulType.INT8,
                       num_stages=1)
    c = pk.mul_nvfp4_a8(*base, sid.repr(), interpret=True)
    assert c.shape == (64, 128)
    # non-INT8 explicit solution rejected
    bad = S.SolutionId(64, 128, 512, S.ElementB.NVFP4, S.MatmulType.BF16)
    with pytest.raises(ValueError, match="INT8"):
        pk.mul_nvfp4_a8(*base, bad.repr(), interpret=True)


@pytest.mark.parametrize("seed", range(6))
def test_mul_fuzz_shapes_vs_oracle(seed):
    """Randomized shapes (ragged m, n % 16, k % 128, both formats, random
    explicit solutions) through the public mul API vs the host oracle —
    guards the padding paths the fixed cases miss."""
    rng = np.random.default_rng(1000 + seed)
    fmt = rng.choice(["nvfp4", "mxfp4"])
    m = int(rng.integers(1, 70))
    n = int(rng.integers(1, 20)) * 16
    k = int(rng.integers(1, 9)) * 128
    d = make_gemm_data(m, n, k, fmt, seed=seed)
    a = jnp.asarray(d.a, jnp.bfloat16)
    mul = pk.mul_nvfp4_a16 if fmt == "nvfp4" else pk.mul_mxfp4_a16

    sols = G.get_fp4_solutions(
        m, n, k, element_b=S.ElementB.NVFP4 if fmt == "nvfp4"
        else S.ElementB.MXFP4)
    sid = int(rng.choice([s for s in sols
                          if not S.SolutionId.from_repr(s).high_precision]
                         or [-1])) if sols and rng.random() < 0.5 else -1

    c = mul(a, jnp.asarray(d.words), jnp.asarray(d.scales_t),
            jnp.float32(d.global_scale), m, n, k, sid, interpret=True)
    assert c.shape == (m, n)
    ref = refn.gemm_reference(np.asarray(a, np.float32), d.qweights,
                              d.scales, d.global_scale, fmt=fmt)
    np.testing.assert_allclose(np.asarray(c, np.float32), ref,
                               rtol=0.01, atol=0.01)


def test_mxfp4z_quantizer_zero_free():
    """quantize_mxfp4z: no stored-zero codes anywhere (the format
    contract), E8M0 scales unchanged from quantize_mxfp4."""
    rng = np.random.default_rng(21)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    w[3, :32] = 0.0
    qw, scales, gs = refn.quantize_mxfp4z(w)
    nibs = np.concatenate([qw & 0xF, qw >> 4], axis=-1)
    assert not ((nibs == 0) | (nibs == 8)).any()
    qw0, scales0, _ = refn.quantize_mxfp4(w)
    assert np.array_equal(scales, scales0)  # only the value rounding moves
    deq = refn.dequant_mxfp4(qw, scales) * gs
    err = np.abs(deq - w).reshape(64, -1, 32)
    step = refn.formats.e8m0_decode(scales)[..., None].astype(np.float64)
    assert (err <= np.maximum(step, 1e-6)).all()


def test_mul_mxfp4z_matches_mxfp4_kernel_bit_exact():
    """On zero-free tensors mul_mxfp4z_a16 is BIT-IDENTICAL to
    mul_mxfp4_a16 and matches the host oracle; 1152/1664 force the repack
    k-padding (pad scales are 2^-126, their products finite)."""
    for (m, n, k) in [(16, 256, 1024), (5, 128, 2048), (33, 208, 1024),
                      (16, 256, 1152), (9, 208, 1664)]:
        d = make_gemm_data(m, n, k, "mxfp4z", seed=m)
        a = jnp.asarray(d.a, jnp.bfloat16)
        args = (a, jnp.asarray(d.words), jnp.asarray(d.scales_t),
                jnp.float32(d.global_scale), m, n, k, -1)
        c_z = pk.mul_mxfp4z_a16(*args, interpret=True)
        c_mx = pk.mul_mxfp4_a16(*args, interpret=True)
        assert np.array_equal(np.asarray(c_z, np.float32),
                              np.asarray(c_mx, np.float32))
        got = np.asarray(c_z, np.float32)
        assert np.isfinite(got).all()
        ref = refn.gemm_reference(np.asarray(a, np.float32), d.qweights,
                                  d.scales, d.global_scale, fmt="mxfp4")
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
        assert rel.max() < 0.02, float(rel.max())


def test_mxfp4z_solution_id_and_model():
    sid = S.SolutionId(16, 128, 1024, S.ElementB.MXFP4, num_stages=1,
                       split_k=2)
    assert S.SolutionId.from_repr(sid.repr()) == sid
    with pytest.raises(AssertionError):
        S.SolutionId(16, 128, 1536, S.ElementB.MXFP4)
    from petit_jax.models import llama
    cfg = llama.LlamaConfig.tiny(hidden_size=256, intermediate_size=512)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    qp = llama.quantize_params(params, "mxfp4z")
    toks = jnp.arange(8)[None, :] % cfg.vocab_size
    dense, _ = llama.forward(params, toks, cfg, interpret=True)
    quant, _ = llama.forward(qp, toks, cfg, fmt="mxfp4z", interpret=True)
    agree = (jnp.argmax(dense[0], -1) == jnp.argmax(quant[0], -1)).mean()
    assert float(agree) >= 0.5, float(agree)
