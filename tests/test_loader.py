"""HF checkpoint loader: synthetic safetensors round trip, both dense and
pre-quantized (ModelOpt NVFP4) flavors."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest

from petit_jax.models import llama, loader
from petit_jax.numerics import reference as refn

st_numpy = pytest.importorskip("safetensors.numpy")

CFG = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, head_dim=32, rope_theta=10000.0,
           rms_norm_eps=1e-5)


def _write_dense_ckpt(path, rng, qwen2=False):
    h, f, v = CFG["hidden_size"], CFG["intermediate_size"], CFG["vocab_size"]
    q = CFG["num_attention_heads"] * CFG["head_dim"]
    kv = CFG["num_key_value_heads"] * CFG["head_dim"]
    t = {"model.embed_tokens.weight": rng.standard_normal((v, h)).astype(
            ml_dtypes.bfloat16),
         "model.norm.weight": np.ones(h, ml_dtypes.bfloat16),
         "lm_head.weight": rng.standard_normal((v, h)).astype(
            ml_dtypes.bfloat16)}
    shapes = {"self_attn.q_proj": (q, h), "self_attn.k_proj": (kv, h),
              "self_attn.v_proj": (kv, h), "self_attn.o_proj": (h, q),
              "mlp.gate_proj": (f, h), "mlp.up_proj": (f, h),
              "mlp.down_proj": (h, f)}
    for i in range(CFG["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        t[pre + "input_layernorm.weight"] = np.ones(h, ml_dtypes.bfloat16)
        t[pre + "post_attention_layernorm.weight"] = np.ones(
            h, ml_dtypes.bfloat16)
        for name, (n, k) in shapes.items():
            t[pre + name + ".weight"] = (
                rng.standard_normal((n, k)).astype(ml_dtypes.bfloat16) / 8)
        if qwen2:
            for name in ("self_attn.q_proj", "self_attn.k_proj",
                         "self_attn.v_proj"):
                n = shapes[name][0]
                t[pre + name + ".bias"] = (
                    rng.standard_normal(n) / 50).astype(ml_dtypes.bfloat16)
    st_numpy.save_file(t, os.path.join(path, "model.safetensors"))
    cfg_json = dict(CFG)
    if qwen2:
        cfg_json["architectures"] = ["Qwen2ForCausalLM"]
    with open(os.path.join(path, "config.json"), "w") as fp:
        json.dump(cfg_json, fp)


def test_load_dense_and_quantize(tmp_path):
    rng = np.random.default_rng(0)
    _write_dense_ckpt(tmp_path, rng)
    cfg, params = loader.load_llama(str(tmp_path), fmt="nvfp4")
    assert cfg.hidden_size == 128 and cfg.num_layers == 2
    assert "words" in params["layers"][0]["wq"]
    cfgb, dense = loader.load_llama(str(tmp_path), fmt="bf16")
    # loading-then-quantizing must equal quantizing the loaded dense params
    # (noise-free oracle; raw-dense comparison would measure FP4 noise)
    qref = llama.quantize_params(dense, "nvfp4", fuse=False)
    for i in range(cfg.num_layers):
        for name in ("wq", "wo", "w_down"):
            assert np.array_equal(
                np.asarray(params["layers"][i][name]["words"]),
                np.asarray(qref["layers"][i][name]["words"])), (i, name)
    toks = jax.random.randint(jax.random.PRNGKey(0), (1, 8), 0,
                              cfg.vocab_size)
    lq, _ = llama.forward(params, toks, cfg, fmt="nvfp4", interpret=True)
    assert np.isfinite(np.asarray(lq, np.float32)).all()


def test_load_prequantized_modelopt(tmp_path):
    rng = np.random.default_rng(1)
    _write_dense_ckpt(tmp_path, rng)
    # replace one projection with ModelOpt-style pre-quantized tensors and
    # check the loader repacks it to the same result as quantizing the
    # equivalent dense weight
    n, k = 128, 128  # o_proj is (h, q) = (128, 128)
    w = rng.standard_normal((n, k)).astype(np.float32) / 8
    qw, scales, gs = refn.quantize_nvfp4(w)
    t = st_numpy.load_file(os.path.join(tmp_path, "model.safetensors"))
    pre = "model.layers.0.self_attn.o_proj"
    del t[pre + ".weight"]
    t[pre + ".weight"] = qw
    # safetensors' numpy backend can't write fp8 dtypes; raw uint8 bytes
    # carry the same bits (the loader views as uint8 regardless)
    t[pre + ".weight_scale"] = scales
    t[pre + ".weight_scale_2"] = np.asarray(gs, np.float32)
    st_numpy.save_file(t, os.path.join(tmp_path, "model.safetensors"))

    cfg, params = loader.load_llama(str(tmp_path), fmt="nvfp4")
    layer = params["layers"][0]["wo"]
    expect = llama.quantize_linear(w.T, "nvfp4")
    # identical quantized tensors -> identical repack
    assert np.array_equal(np.asarray(layer["words"]),
                          np.asarray(expect["words"]))
    assert np.array_equal(np.asarray(layer["scales"]),
                          np.asarray(expect["scales"]))
    assert float(layer["gs"]) == pytest.approx(float(expect["gs"]))


def test_tied_embeddings(tmp_path):
    rng = np.random.default_rng(2)
    _write_dense_ckpt(tmp_path, rng)
    t = st_numpy.load_file(os.path.join(tmp_path, "model.safetensors"))
    del t["lm_head.weight"]
    st_numpy.save_file(t, os.path.join(tmp_path, "model.safetensors"))
    cfg, params = loader.load_llama(str(tmp_path), fmt="bf16")
    assert params["lm_head"]["w"].shape == (cfg.hidden_size, cfg.vocab_size)


def test_repack_cache_roundtrip(tmp_path):
    """Second load must come from petit_cache/ and be identical."""
    rng = np.random.default_rng(5)
    _write_dense_ckpt(tmp_path, rng)
    cfg, p1 = loader.load_llama(str(tmp_path), fmt="nvfp4")
    cache = loader._cache_file(str(tmp_path), "nvfp4")
    assert os.path.exists(cache)
    assert loader._load_repack_cache(str(tmp_path), "nvfp4") is not None
    _, p2 = loader.load_llama(str(tmp_path), fmt="nvfp4")
    for i in range(cfg.num_layers):
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            a, b = p1["layers"][i][name], p2["layers"][i][name]
            assert np.array_equal(np.asarray(a["words"]),
                                  np.asarray(b["words"]))
            assert np.array_equal(
                np.asarray(a["scales"]).view(np.uint16),
                np.asarray(b["scales"]).view(np.uint16))
            assert float(a["gs"]) == float(b["gs"])
    # stale cache (older than a touched shard) is ignored
    os.utime(os.path.join(tmp_path, "model.safetensors"))
    assert loader._load_repack_cache(str(tmp_path), "nvfp4") is None


def test_load_qwen2_bias(tmp_path):
    """Qwen2-flavor checkpoint (architectures + QKV .bias tensors): config
    detection sets attn_bias, biases land on the quantized layers, and the
    forward runs them."""
    rng = np.random.default_rng(3)
    _write_dense_ckpt(tmp_path, rng, qwen2=True)
    cfg, params = loader.load_llama(str(tmp_path), fmt="nvfp4",
                                    use_cache=False)
    assert cfg.attn_bias
    lp = params["layers"][0]
    assert all("b" in lp[n] for n in ("wq", "wk", "wv"))
    assert "b" not in lp["wo"] and "b" not in lp["w_gate"]
    # bias round-trips bit-exactly from the checkpoint
    raw = st_numpy.load_file(os.path.join(tmp_path, "model.safetensors"))
    np.testing.assert_array_equal(
        np.asarray(lp["wq"]["b"]).view(np.uint16),
        raw["model.layers.0.self_attn.q_proj.bias"]
        .astype(ml_dtypes.bfloat16).view(np.uint16))
    toks = jax.random.randint(jax.random.PRNGKey(0), (1, 8), 0,
                              cfg.vocab_size)
    lg, _ = llama.forward(params, toks, cfg, fmt="nvfp4", interpret=True)
    assert np.isfinite(np.asarray(lg, np.float32)).all()


def test_load_prequantized_as_nvfp4p2(tmp_path):
    """fmt="nvfp4p2" over a pre-quantized NVFP4 checkpoint folds the E4M3
    mantissa factor into the FP4 values on load (pow2-scale fast path):
    stored scales are pure powers of two and the repack equals a direct
    requantize_nvfp4_pow2 of the same tensor."""
    rng = np.random.default_rng(11)
    _write_dense_ckpt(tmp_path, rng)
    n, k = 128, 128
    w = rng.standard_normal((n, k)).astype(np.float32) / 8
    qw, scales, gs = refn.quantize_nvfp4(w)
    t = st_numpy.load_file(os.path.join(tmp_path, "model.safetensors"))
    pre = "model.layers.0.self_attn.o_proj"
    del t[pre + ".weight"]
    t[pre + ".weight"] = qw
    t[pre + ".weight_scale"] = scales
    t[pre + ".weight_scale_2"] = np.asarray(gs, np.float32)
    st_numpy.save_file(t, os.path.join(tmp_path, "model.safetensors"))

    cfg, params = loader.load_llama(str(tmp_path), fmt="nvfp4p2",
                                    use_cache=False)
    layer = params["layers"][0]["wo"]
    qw2, s2, gs2 = refn.requantize_nvfp4_pow2(qw, scales, gs)
    # every byte is a pow2 E4M3 value: normal (mantissa 0) or subnormal
    # with a single mantissa bit ({1,2,4} at exp field 0)
    mant, expf = s2 & 0b111, (s2 >> 3) & 0xF
    assert np.all((mant == 0) | ((expf == 0) & np.isin(mant, (1, 2, 4))))
    from petit_jax.ops import layout as layout_mod
    assert np.array_equal(np.asarray(layer["words"]),
                          layout_mod.repack_fp4_weights(qw2, n, k))
    assert float(layer["gs"]) == pytest.approx(float(gs2))
    # requantized tensor still decodes close to the original weight
    deq = refn.dequant_nvfp4(qw2, s2) * gs2
    orig = refn.dequant_nvfp4(qw, scales) * gs
    assert np.abs(deq - orig).max() <= 0.25 * np.abs(orig).max()


def test_load_prequantized_as_nvfp4p2z(tmp_path):
    """fmt="nvfp4p2z" over a pre-quantized NVFP4 checkpoint: pow2 scales
    AND no stored-zero codes anywhere (the flag-free kernel contract)."""
    rng = np.random.default_rng(13)
    _write_dense_ckpt(tmp_path, rng)
    n, k = 128, 128
    w = rng.standard_normal((n, k)).astype(np.float32) / 8
    w[5, :32] = 0.0  # zero-heavy rows must still come out zero-free
    qw, scales, gs = refn.quantize_nvfp4(w)
    t = st_numpy.load_file(os.path.join(tmp_path, "model.safetensors"))
    pre = "model.layers.0.self_attn.o_proj"
    del t[pre + ".weight"]
    t[pre + ".weight"] = qw
    t[pre + ".weight_scale"] = scales
    t[pre + ".weight_scale_2"] = np.asarray(gs, np.float32)
    st_numpy.save_file(t, os.path.join(tmp_path, "model.safetensors"))

    cfg, params = loader.load_llama(str(tmp_path), fmt="nvfp4p2z",
                                    use_cache=False)
    layer = params["layers"][0]["wo"]
    qw2, s2, gs2 = refn.requantize_nvfp4_pow2(qw, scales, gs,
                                              zero_free=True)
    nibs = np.concatenate([qw2 & 0xF, qw2 >> 4], axis=-1)
    assert not ((nibs == 0) | (nibs == 8)).any()
    from petit_jax.ops import layout as layout_mod
    assert np.array_equal(np.asarray(layer["words"]),
                          layout_mod.repack_fp4_weights(qw2, n, k))
    # near-zero rows bounded by one half-step of the group scale
    deq = refn.dequant_nvfp4(qw2, s2) * gs2
    orig = refn.dequant_nvfp4(qw, scales) * gs
    assert np.abs(deq - orig).max() <= 0.25 * np.abs(orig).max()
