"""Tiny-Llama end-to-end: FP4-quantized forward vs dense-dequantized oracle.
The model-level analog of the reference Python e2e test
(tests/ops/test_fp4_gemm_quark.py) — full pipeline quantize -> repack ->
fused GEMM inside a real transformer forward."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from petit_jax.models import llama
from petit_jax.numerics import reference as refn
from petit_jax.ops import layout


@pytest.fixture(scope="module")
def tiny_setup():
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    # fuse=False: these tests compare per-projection against dense oracles;
    # the fused default is covered by test_fused_projections_match_unfused
    qparams = llama.quantize_params(params, "nvfp4", fuse=False)
    return cfg, params, qparams


def _dequant_params(qparams, params):
    """Dense params where each FP4 layer is replaced by its exact dequant
    (logical k taken from the original dense weight; repack pads k)."""
    out = {k: v for k, v in qparams.items() if k != "layers"}
    out["layers"] = []
    for lp, dense_lp in zip(qparams["layers"], params["layers"]):
        d = dict(lp)
        for name, layer in lp.items():
            if isinstance(layer, dict) and "words" in layer:
                k, n = dense_lp[name]["w"].shape
                deq = layout.dequant_from_layout(
                    np.asarray(layer["words"]), np.asarray(layer["scales"]),
                    n, k, group_size=16) * np.float32(layer["gs"])
                d[name] = {"w": jnp.asarray(deq, jnp.bfloat16)}
                if "b" in layer:
                    d[name]["b"] = layer["b"]
        out["layers"].append(d)
    return out


def test_quantized_layers_present(tiny_setup):
    _, params, qparams = tiny_setup
    lp = qparams["layers"][0]
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert "words" in lp[name], name
    # the fused default emits wqkv / w_gateup instead
    fused = llama.quantize_params(params, "nvfp4")["layers"][0]
    for name in ("wqkv", "w_gateup", "wo", "w_down"):
        assert "words" in fused[name], name


def test_fused_projections_match_unfused(tiny_setup):
    """quantize_params(fuse=True) forward tracks the unfused forward within
    quantization-noise tolerance (fusing shares one global scale across the
    concatenated projections)."""
    cfg, params, qparams = tiny_setup
    fused = llama.quantize_params(params, "nvfp4")
    tokens = jax.random.randint(jax.random.PRNGKey(7), (1, 12), 0,
                                cfg.vocab_size)
    lu, _ = llama.forward(qparams, tokens, cfg, fmt="nvfp4", interpret=True)
    lf, _ = llama.forward(fused, tokens, cfg, fmt="nvfp4", interpret=True)
    lu = np.asarray(lu, np.float32)
    lf = np.asarray(lf, np.float32)
    assert np.isfinite(lf).all()
    assert np.abs(lu - lf).mean() < 0.25, np.abs(lu - lf).mean()


def test_fp4_forward_matches_dequant_oracle(tiny_setup):
    cfg, params, qparams = tiny_setup
    dparams = _dequant_params(qparams, params)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                cfg.vocab_size)
    logits_q, _ = llama.forward(qparams, tokens, cfg, fmt="nvfp4",
                                interpret=True)
    logits_d, _ = llama.forward(dparams, tokens, cfg)
    # dequant oracle is the exact same math modulo dot blocking: tight tol
    lq = np.asarray(logits_q, np.float32)
    ld = np.asarray(logits_d, np.float32)
    np.testing.assert_allclose(lq, ld, rtol=0.05, atol=0.05)
    # top-1 agreement where the oracle is confident (random-weight logits
    # are near-uniform, so unconditional argmax agreement is noise-dominated)
    top2 = np.partition(ld, -2, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    confident = margin > 0.05
    agree = (lq.argmax(-1) == ld.argmax(-1))[confident]
    assert agree.size == 0 or agree.mean() >= 0.95, agree.mean()


def test_qwen2_attn_bias_quantized_forward():
    """Qwen2 family = Llama + QKV bias: the bias survives quantization
    (unfused and fused), changes the logits, and the quantized forward
    matches the dequant oracle with the bias in place."""
    cfg = llama.LlamaConfig.tiny(attn_bias=True)
    params = llama.init_params(cfg, jax.random.PRNGKey(3))
    assert "b" in params["layers"][0]["wq"]
    tokens = jax.random.randint(jax.random.PRNGKey(4), (1, 8), 0,
                                cfg.vocab_size)

    qparams = llama.quantize_params(params, "nvfp4", fuse=False)
    assert all("b" in qparams["layers"][0][n] for n in ("wq", "wk", "wv"))
    dparams = _dequant_params(qparams, params)
    lq, _ = llama.forward(qparams, tokens, cfg, fmt="nvfp4", interpret=True)
    ld, _ = llama.forward(dparams, tokens, cfg)
    np.testing.assert_allclose(np.asarray(lq, np.float32),
                               np.asarray(ld, np.float32),
                               rtol=0.05, atol=0.05)

    # the bias is load-bearing: zeroing it moves the logits
    z = jax.tree.map(lambda x: x, dparams)
    for lp in z["layers"]:
        for n in ("wq", "wk", "wv"):
            lp[n] = {"w": lp[n]["w"], "b": jnp.zeros_like(lp[n]["b"])}
    l0, _ = llama.forward(z, tokens, cfg)
    assert np.abs(np.asarray(ld) - np.asarray(l0)).max() > 1e-3

    # fused path concatenates the three biases onto wqkv
    fused = llama.quantize_params(params, "nvfp4")
    b = fused["layers"][0]["wqkv"]["b"]
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    assert b.shape == (nq + 2 * nkv,)
    np.testing.assert_array_equal(np.asarray(b[:nq]),
                                  np.asarray(params["layers"][0]["wq"]["b"]))
    lf, _ = llama.forward(fused, tokens, cfg, fmt="nvfp4", interpret=True)
    assert np.isfinite(np.asarray(lf, np.float32)).all()


def test_qwen2_config():
    cfg = llama.LlamaConfig.qwen2_7b()
    assert cfg.attn_bias and cfg.num_kv_heads == 4
    assert cfg.rope_theta == 1e6


def test_greedy_decode_with_cache_matches_no_cache(tiny_setup):
    cfg, params, _ = tiny_setup
    tokens = jax.random.randint(jax.random.PRNGKey(2), (1, 8), 0,
                                cfg.vocab_size)
    # decode 4 tokens with the cache path (dense weights for speed)
    out = llama.greedy_decode(params, cfg, tokens, 4, fmt="nvfp4")
    assert out.shape == (1, 4)
    # oracle: recompute full forward each step without cache
    cur = tokens
    expect = []
    for _ in range(4):
        logits, _ = llama.forward(params, cur, cfg)
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        expect.append(nxt)
        cur = jnp.concatenate([cur, nxt[:, None]], axis=1)
    expect = jnp.stack(expect, axis=1)
    assert np.array_equal(np.asarray(out), np.asarray(expect))


def test_cached_prefill_is_causal(tiny_setup):
    """Regression: multi-token prefill THROUGH the cache path must equal the
    no-cache causal forward at every position — a mask keyed only on the last
    position lets prompt tokens attend to the future (contaminating layer>=1
    KV and the first-token logits)."""
    cfg, params, _ = tiny_setup
    B, T = 2, 12
    tokens = jax.random.randint(jax.random.PRNGKey(11), (B, T), 0,
                                cfg.vocab_size)
    ref_logits, _ = llama.forward(params, tokens, cfg)  # no-cache causal
    cache = llama.init_cache(cfg, B)
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    cl, _ = llama.forward(params, tokens, cfg, cache, pos)
    np.testing.assert_allclose(np.asarray(cl, np.float32),
                               np.asarray(ref_logits, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_fp4_model_perplexity_sane(tiny_setup):
    """Quantization must not blow up the distribution: avg KL(dense || fp4)
    bounded. Analog of the BASELINE MMLU-delta gate at toy scale."""
    cfg, params, qparams = tiny_setup
    dparams = _dequant_params(qparams, params)
    tokens = jax.random.randint(jax.random.PRNGKey(3), (1, 32), 0,
                                cfg.vocab_size)
    lq, _ = llama.forward(qparams, tokens, cfg, fmt="nvfp4", interpret=True)
    ld, _ = llama.forward(dparams, tokens, cfg)
    pq = jax.nn.log_softmax(lq.astype(jnp.float32), -1)
    pd = jax.nn.log_softmax(ld.astype(jnp.float32), -1)
    kl = jnp.sum(jnp.exp(pd) * (pd - pq), axis=-1).mean()
    assert float(kl) < 0.05, float(kl)
