"""Decode/prefill attention and the KV write vs naive full-window
references."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from petit_jax.ops.kernels import attention as attn


def _naive(q, k_all, v_all, pos):
    """q (B,H,d); k/v (B,S,Hkv,d); pos (B,) -> (B,H,d) f32."""
    B, H, d = q.shape
    S, Hkv = k_all.shape[1], k_all.shape[2]
    rep = H // Hkv
    k = np.repeat(np.asarray(k_all, np.float32), rep, axis=2)
    v = np.repeat(np.asarray(v_all, np.float32), rep, axis=2)
    qf = np.asarray(q, np.float32) / np.sqrt(d)
    logits = np.einsum("bhd,bshd->bhs", qf, k)
    mask = np.arange(S)[None, None, :] <= np.asarray(pos)[:, None, None]
    logits = np.where(mask, logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhs,bshd->bhd", p, v)


@pytest.mark.parametrize("hkv,h", [(2, 8), (4, 28), (2, 2)])
def test_decode_attention_contiguous_matches_naive(hkv, h):
    B, S, d, ps = 3, 256, 128, 128
    rng = np.random.default_rng(h)
    q = jnp.asarray(rng.standard_normal((B, h, d)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, S, hkv, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, S, hkv, d)), jnp.bfloat16)
    pos = jnp.asarray([5, 130, 255], jnp.int32)
    nb = S // ps
    out = attn.decode_attention(q, k, v, pos, window=nb * ps)
    want = _naive(q, k, v, pos)
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=3e-2, atol=3e-2)


def test_decode_attention_paged_matches_naive():
    """Random page assignment; only allocated pages are referenced."""
    B, S, hkv, h, d, ps = 2, 512, 2, 8, 128, 128
    per = S // ps
    rng = np.random.default_rng(0)
    k_all = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    v_all = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    # scatter into a shuffled pool (plus one scratch page at the end)
    P = B * per
    perm = rng.permutation(P)
    k_pages = np.zeros((P + 1, ps, hkv, d), np.float32)
    v_pages = np.zeros((P + 1, ps, hkv, d), np.float32)
    bt = np.zeros((B, per), np.int32)
    for b in range(B):
        for i in range(per):
            pid = int(perm[b * per + i])
            k_pages[pid] = k_all[b, i * ps:(i + 1) * ps]
            v_pages[pid] = v_all[b, i * ps:(i + 1) * ps]
            bt[b, i] = pid
    q = rng.standard_normal((B, h, d)).astype(np.float32)
    pos = np.asarray([100, 500], np.int32)
    nb = attn.pow2_bucket(-(-501 // ps))
    out = attn.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k_pages, jnp.bfloat16),
        jnp.asarray(v_pages, jnp.bfloat16), jnp.asarray(bt),
        jnp.asarray(pos), nb=nb, page_size=ps)
    want = _naive(jnp.asarray(q, jnp.bfloat16),
                  jnp.asarray(k_all, jnp.bfloat16),
                  jnp.asarray(v_all, jnp.bfloat16), pos)
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=3e-2, atol=3e-2)


def test_decode_attention_fp8_kv():
    """FP8 cache: upcast at the dot; tolerance covers e4m3 noise."""
    B, S, hkv, h, d, ps = 2, 256, 2, 8, 128, 128
    rng = np.random.default_rng(3)
    k = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((B, h, d)), jnp.bfloat16)
    pos = jnp.asarray([255, 40], jnp.int32)
    k8 = jnp.asarray(k, jnp.float8_e4m3fn)
    v8 = jnp.asarray(v, jnp.float8_e4m3fn)
    out = attn.decode_attention(q, k8, v8, pos, window=S)
    want = _naive(q, jnp.asarray(k8, jnp.float32),
                  jnp.asarray(v8, jnp.float32), pos)
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=5e-2, atol=5e-2)


def test_decode_attention_headed_bf16_matches_legacy_layout():
    """Headed (P,Hkv,ps,d) pool = same numerics as the (P,ps,Hkv,d) path."""
    B, S, hkv, h, d, ps = 2, 256, 2, 8, 128, 128
    rng = np.random.default_rng(7)
    k = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((B, h, d)), jnp.bfloat16)
    pos = jnp.asarray([255, 100], jnp.int32)
    per = S // ps
    bt = jnp.asarray(np.arange(B * per, dtype=np.int32).reshape(B, per))
    kp = jnp.asarray(k.reshape(B * per, ps, hkv, d), jnp.bfloat16)
    vp = jnp.asarray(v.reshape(B * per, ps, hkv, d), jnp.bfloat16)
    legacy = attn.paged_decode_attention(q, kp, vp, bt, pos, nb=per,
                                         page_size=ps)
    headed = attn.paged_decode_attention(
        q, kp.transpose(0, 2, 1, 3), vp.transpose(0, 2, 1, 3), bt, pos,
        nb=per, page_size=ps, headed=True)
    np.testing.assert_array_equal(np.asarray(legacy, np.float32),
                                  np.asarray(headed, np.float32))


def test_decode_attention_headed_fp8_swar():
    """Headed fp8 page pool vs the exact-upcast oracle (bf16 dot rounding
    is the only deviation, within the usual attention tolerance)."""
    B, S, hkv, h, d, ps = 2, 512, 2, 8, 128, 256
    rng = np.random.default_rng(11)
    k = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((B, h, d)), jnp.bfloat16)
    pos = jnp.asarray([511, 70], jnp.int32)
    per = S // ps
    bt = jnp.asarray(np.arange(B * per, dtype=np.int32).reshape(B, per))
    k8 = jnp.asarray(k.reshape(B * per, ps, hkv, d),
                     jnp.float8_e4m3fn).transpose(0, 2, 1, 3)
    v8 = jnp.asarray(v.reshape(B * per, ps, hkv, d),
                     jnp.float8_e4m3fn).transpose(0, 2, 1, 3)
    out = attn.paged_decode_attention(q, k8, v8, bt, pos, nb=per,
                                      page_size=ps,
                                      headed=True)
    k8v = np.asarray(k8.transpose(0, 2, 1, 3), np.float32).reshape(
        B, S, hkv, d)
    v8v = np.asarray(v8.transpose(0, 2, 1, 3), np.float32).reshape(
        B, S, hkv, d)
    want = _naive(q, k8v, v8v, pos)
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=5e-2, atol=5e-2)


def test_bucket():
    assert attn.pow2_bucket(1) == 1 and attn.pow2_bucket(3) == 4
    assert attn.pow2_bucket(16) == 16 and attn.pow2_bucket(17) == 32


def _naive_prefill(q, k_all, v_all, pos0):
    """q (B,T,H,d) positions pos0[b]+t; kv (B,S,Hkv,d) -> (B,T,H,d) f32."""
    B, T, H, d = q.shape
    S, Hkv = k_all.shape[1], k_all.shape[2]
    rep = H // Hkv
    k = np.repeat(np.asarray(k_all, np.float32), rep, axis=2)
    v = np.repeat(np.asarray(v_all, np.float32), rep, axis=2)
    qf = np.asarray(q, np.float32) / np.sqrt(d)
    logits = np.einsum("bthd,bshd->bhts", qf, k)
    qpos = np.asarray(pos0)[:, None] + np.arange(T)[None, :]      # (B,T)
    mask = np.arange(S)[None, None, :] <= qpos[:, :, None]        # (B,T,S)
    logits = np.where(mask[:, None], logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhts,bshd->bthd", p, v)


@pytest.mark.parametrize("hkv,h,T", [(2, 8, 128), (4, 28, 64), (2, 8, 256)])
def test_flash_prefill_matches_naive(hkv, h, T):
    B, S, d = 2, 512, 128
    rng = np.random.default_rng(T)
    q = jnp.asarray(rng.standard_normal((B, T, h, d)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, S, hkv, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, S, hkv, d)), jnp.bfloat16)
    pos0 = jnp.asarray([0, 100], jnp.int32)   # fresh + resumed chunk
    ns = S // 128
    out = attn.prefill_attention(q, k, v, pos0, window=ns * 128)
    want = _naive_prefill(q, k, v, pos0)
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=3e-2, atol=3e-2)


def test_flash_prefill_fp8_kv():
    B, T, S, hkv, h, d = 1, 64, 256, 2, 8, 128
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.standard_normal((B, T, h, d)), jnp.bfloat16)
    k8 = jnp.asarray(rng.standard_normal((B, S, hkv, d)), jnp.float8_e4m3fn)
    v8 = jnp.asarray(rng.standard_normal((B, S, hkv, d)), jnp.float8_e4m3fn)
    pos0 = jnp.asarray([30], jnp.int32)
    out = attn.prefill_attention(q, k8, v8, pos0, window=256)
    want = _naive_prefill(q, jnp.asarray(k8, jnp.float32),
                          jnp.asarray(v8, jnp.float32), pos0)
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=5e-2, atol=5e-2)


def test_decode_contiguous_headed_bf16_matches_flat():
    """Headed contiguous (B,Hkv,S,d) decode = the flat (B,S,Hkv,d) path."""
    B, S, hkv, h, d = 3, 256, 2, 8, 128
    rng = np.random.default_rng(13)
    k = jnp.asarray(rng.standard_normal((B, S, hkv, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, S, hkv, d)), jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((B, h, d)), jnp.bfloat16)
    pos = jnp.asarray([5, 130, 255], jnp.int32)
    flat = attn.decode_attention(q, k, v, pos, window=256)
    headed = attn.decode_attention(
        q, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3), pos,
        window=256, headed=True)
    np.testing.assert_array_equal(np.asarray(flat, np.float32),
                                  np.asarray(headed, np.float32))


def test_decode_contiguous_headed_fp8_swar():
    """fp8 headed contiguous decode vs the exact oracle."""
    B, S, hkv, h, d = 2, 512, 2, 8, 128
    rng = np.random.default_rng(17)
    k8 = jnp.asarray(rng.standard_normal((B, S, hkv, d)),
                     jnp.float8_e4m3fn)
    v8 = jnp.asarray(rng.standard_normal((B, S, hkv, d)),
                     jnp.float8_e4m3fn)
    q = jnp.asarray(rng.standard_normal((B, h, d)), jnp.bfloat16)
    pos = jnp.asarray([511, 70], jnp.int32)
    out = attn.decode_attention(
        q, k8.transpose(0, 2, 1, 3), v8.transpose(0, 2, 1, 3), pos,
        window=512, headed=True)
    want = _naive(q, np.asarray(k8, np.float32),
                  np.asarray(v8, np.float32), pos)
    np.testing.assert_allclose(np.asarray(out, np.float32), want,
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["bf16", "fp8"])
def test_flash_prefill_headed_matches_flat(dtype):
    B, T, S, hkv, h, d = 2, 64, 512, 2, 8, 128
    rng = np.random.default_rng(19)
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float8_e4m3fn
    k = jnp.asarray(rng.standard_normal((B, S, hkv, d)), dt)
    v = jnp.asarray(rng.standard_normal((B, S, hkv, d)), dt)
    q = jnp.asarray(rng.standard_normal((B, T, h, d)), jnp.bfloat16)
    pos0 = jnp.asarray([0, 100], jnp.int32)
    flat = attn.prefill_attention(q, k, v, pos0, window=512)
    headed = attn.prefill_attention(
        q, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3), pos0,
        window=512, headed=True)
    np.testing.assert_array_equal(np.asarray(flat, np.float32),
                                  np.asarray(headed, np.float32))


@pytest.mark.parametrize("headed,dtype", [
    (False, jnp.bfloat16), (True, jnp.bfloat16),
    (True, jnp.float8_e4m3fn)])
def test_kv_append_in_place(headed, dtype):
    """The KV write of one decode token per row matches a masked per-row
    update bit-exactly in both cache layouts, bf16 and fp8."""
    B, S, H, D = 2, 8, 2, 128
    shape = (B, H, S, D) if headed else (B, S, H, D)
    ck = (jnp.arange(np.prod(shape), dtype=jnp.float32) % 13
          ).reshape(shape).astype(dtype)
    cv = (ck.astype(jnp.float32) + 1).astype(dtype)
    kn = jnp.full((B, H, D), 7.0, jnp.bfloat16)
    vn = jnp.full((B, H, D), 9.0, jnp.bfloat16)
    pos = jnp.array([2, 5], jnp.int32)
    mask = jnp.array([True, False])
    ck0, cv0 = np.asarray(ck, np.float32), np.asarray(cv, np.float32)
    nk, nv = attn.kv_write(ck, cv, kn[:, None], vn[:, None], pos, mask,
                           headed=headed)
    exp_k, exp_v = ck0.copy(), cv0.copy()
    if headed:
        exp_k[0, :, 2], exp_v[0, :, 2] = 7.0, 9.0
    else:
        exp_k[0, 2], exp_v[0, 2] = 7.0, 9.0
    assert np.array_equal(np.asarray(nk, np.float32), exp_k)
    assert np.array_equal(np.asarray(nv, np.float32), exp_v)
    # mask=None appends every row
    nk2, _ = attn.kv_write(ck, cv, kn[:, None], vn[:, None], pos, None,
                           headed=headed)
    idx = (1, slice(None), 5) if headed else (1, 5)
    assert np.all(np.asarray(nk2, np.float32)[idx] == 7.0)


@pytest.mark.parametrize("headed", [False, True])
def test_kv_write_multi_token_masked(headed):
    """kv_write stores a T-token chunk per row at its own position; a
    masked row keeps its cache bit-exactly."""
    B, S, H, D, T = 3, 16, 2, 8, 4
    shape = (B, H, S, D) if headed else (B, S, H, D)
    ck = jnp.zeros(shape, jnp.bfloat16)
    new = (jnp.arange(B * T * H * D, dtype=jnp.float32) + 1).reshape(
        B, T, H, D).astype(jnp.bfloat16)
    pos = jnp.array([0, 5, 12], jnp.int32)
    mask = jnp.array([True, False, True])
    nk, nv = attn.kv_write(ck, ck, new, new, pos, mask, headed=headed)
    got = np.asarray(nk, np.float32)
    if headed:
        got = got.transpose(0, 2, 1, 3)
    want = np.zeros((B, S, H, D), np.float32)
    for b in (0, 2):
        want[b, int(pos[b]):int(pos[b]) + T] = np.asarray(new[b], np.float32)
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.asarray(nv), np.asarray(nk))


def test_decode_attention_reads_only_the_window():
    """Positions beyond the static window never reach the result: garbage
    (even NaN) there leaves the output unchanged."""
    B, S, hkv, h, d = 2, 512, 2, 8, 64
    rng = np.random.default_rng(23)
    k = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, S, hkv, d)).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((B, h, d)), jnp.bfloat16)
    pos = jnp.asarray([100, 255], jnp.int32)
    ref = attn.decode_attention(q, jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), pos,
                                window=256)
    k[:, 256:] = np.nan
    v[:, 256:] = np.nan
    got = attn.decode_attention(q, jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), pos,
                                window=256)
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(ref, np.float32))
    want = _naive(q, k[:, :256], v[:, :256], pos)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=3e-2, atol=3e-2)
