"""HuggingFace checkpoint loader: safetensors -> petit model params.

The reference's only checkpoint-adjacent feature is the offline repack of
ModelOpt/Quark quantized tensors at load time (README.md:31, pybind/fp4.cc:
38-161); this module is its model-level counterpart: load a Llama-family
safetensors checkpoint and produce the params pytree, repacking into the
kernel layout on the way.

Supported checkpoint flavors:
  1. Dense bf16/f16/f32 (standard HF Llama) -> quantized here (NVFP4/MXFP4)
     or kept dense (fmt="bf16").
  2. Pre-quantized ModelOpt-style NVFP4: per-linear tensors
        {prefix}.weight          uint8 (n, k/2) packed E2M1 pairs
        {prefix}.weight_scale    float8_e4m3fn (n, k/16) block scales
        {prefix}.weight_scale_2  float32 () global scale
     -> repacked directly (no requantization), exactly the reference's
     repack_nvfp4 + process_nvfp4_scales flow.

Repacked layouts are cached next to the checkpoint (petit_cache/) so
reloads skip the shuffle.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import jax.numpy as jnp

from . import llama
from ..numerics import reference as ref_numerics
from ..ops import layout as layout_mod

_HF_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm",
    "post_attention_layernorm.weight": "mlp_norm",
    "self_attn.q_proj": "wq",
    "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv",
    "self_attn.o_proj": "wo",
    "mlp.gate_proj": "w_gate",
    "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
}


def config_from_hf(hf: dict) -> llama.LlamaConfig:
    return llama.LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads",
                            hf["num_attention_heads"]),
        head_dim=hf.get("head_dim", hf["hidden_size"]
                        // hf["num_attention_heads"]),
        rope_theta=hf.get("rope_theta", 500000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        # Qwen2/Qwen2.5 = Llama architecture + bias on q/k/v projections
        attn_bias=(hf.get("attention_bias", False)
                   or any("Qwen2" in a
                          for a in hf.get("architectures", []))),
    )


def _open_all_tensors(path: str) -> dict:
    """Load every tensor from all *.safetensors files under path."""
    from safetensors import numpy as st_numpy
    tensors = {}
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    for f in files:
        tensors.update(st_numpy.load_file(os.path.join(path, f)))
    return tensors


def _to_f32(x: np.ndarray) -> np.ndarray:
    import ml_dtypes  # noqa: F401  (registers bfloat16 for numpy view)
    return np.asarray(x).astype(np.float32)


def _make_quantized_layer(tensors: dict, prefix: str, fmt: str) -> dict:
    """Build a quantized-linear dict from either dense or pre-quantized
    checkpoint tensors for `{prefix}` (an HF linear module path)."""
    wkey = f"{prefix}.weight"
    skey = f"{prefix}.weight_scale"
    gkey = f"{prefix}.weight_scale_2"
    if skey in tensors:  # pre-quantized ModelOpt NVFP4
        qw = np.asarray(tensors[wkey]).view(np.uint8)
        scales = np.asarray(tensors[skey]).view(np.uint8)
        gs = np.float32(_to_f32(tensors[gkey]).reshape(()))
        if fmt in ("nvfp4p2", "nvfp4p2z"):
            # serve an exact-NVFP4 checkpoint on the pow2-scale fast path:
            # fold the E4M3 mantissa factor into the FP4 values (opt-in
            # re-round; quality-gate before adopting — see numerics docs).
            # "nvfp4p2z" additionally rounds zero codes to the nearest
            # nonzero magnitude so the flag-free kernel applies.
            qw, scales, gs = ref_numerics.requantize_nvfp4_pow2(
                qw, scales, gs, zero_free=(fmt == "nvfp4p2z"))
        n, kb = qw.shape
        k = kb * 2
        words = layout_mod.repack_fp4_weights(qw, n, k)
        st = layout_mod.process_fp4_scales(scales, n, k, group_size=16)
        return {"words": jnp.asarray(words), "scales": jnp.asarray(st),
                "gs": jnp.float32(gs)}
    w = _to_f32(tensors[wkey])           # HF linear: (n, k) = (out, in)
    return llama.quantize_linear(w.T, fmt)


def _cache_file(path: str, fmt: str) -> str:
    return os.path.join(path, "petit_cache", f"{fmt}.npz")


def _load_repack_cache(path: str, fmt: str):
    """Return {(layer, name): {words, scales, gs}} from the repack cache if
    it is newer than every safetensors shard, else None."""
    cache = _cache_file(path, fmt)
    if not os.path.exists(cache):
        return None
    src = max((os.path.getmtime(os.path.join(path, f))
               for f in os.listdir(path) if f.endswith(".safetensors")),
              default=0.0)
    if os.path.getmtime(cache) < src:
        return None
    try:
        raw = np.load(cache)
        out: dict = {}
        for key in raw.files:
            li, name, part = key.split("/")
            out.setdefault((int(li), name), {})[part] = raw[key]
        return out
    except Exception:
        return None  # corrupt/partial cache: fall back to a fresh repack


def _save_repack_cache(path: str, fmt: str, layers: list) -> None:
    """Best-effort: persist every quantized linear so reloads skip the
    repack (the reference recommends the same one-shot-offline flow,
    README.md:31; a 70B repack is minutes of host work)."""
    arrays = {}
    for li, lp in enumerate(layers):
        for name, val in lp.items():
            if isinstance(val, dict) and "words" in val:
                arrays[f"{li}/{name}/words"] = np.asarray(val["words"])
                # npz can't store bfloat16 natively: keep the bit pattern
                arrays[f"{li}/{name}/scales"] = np.asarray(
                    val["scales"]).view(np.uint16)
                arrays[f"{li}/{name}/gs"] = np.asarray(val["gs"])
    try:
        target = _cache_file(path, fmt)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = target + ".tmp"
        np.savez(tmp, **arrays)
        # np.savez appends .npz when the name lacks it
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", target)
    except OSError:
        pass  # read-only checkpoint dir: skip caching


def load_llama(path: str, fmt: str = "nvfp4",
               cfg: Optional[llama.LlamaConfig] = None,
               use_cache: bool = True):
    """Load an HF Llama checkpoint directory -> (cfg, params).

    fmt: "nvfp4" / "mxfp4" / "nvfp4p2" (pow2 scales, int-add fast path) /
    "w4a8" (nvfp4 container, int8 compute) or "bf16" (dense).
    Pre-quantized ModelOpt NVFP4 checkpoints are repacked directly
    (fmt="nvfp4p2" requantizes them to pow2 scales on load).
    Repacked layouts are cached under <path>/petit_cache/ and reused
    when newer than the safetensors shards.
    """
    if cfg is None:
        with open(os.path.join(path, "config.json")) as f:
            cfg = config_from_hf(json.load(f))
    tensors = _open_all_tensors(path)
    # hybrid layers carry wd/inv_perm/meta beyond words/scales/gs; the npz
    # cache doesn't persist those, so caching hybrid would silently rebuild
    # layers as pure-FP4 with the wrong output width — skip it entirely.
    cacheable = use_cache and fmt not in ("bf16", "hybrid")
    cached = _load_repack_cache(path, fmt) if cacheable else None

    def dense(key, transpose=True):
        w = _to_f32(tensors[key])
        return {"w": jnp.asarray(w.T if transpose else w, jnp.bfloat16)}

    embed = jnp.asarray(_to_f32(tensors["model.embed_tokens.weight"]),
                        jnp.bfloat16)
    params = {
        "embed": embed,
        "final_norm": jnp.asarray(_to_f32(tensors["model.norm.weight"]),
                                  jnp.bfloat16),
        "lm_head": (dense("lm_head.weight")
                    if "lm_head.weight" in tensors
                    else {"w": embed.T}),  # tied embeddings
        "layers": [],
    }
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        lp = {
            "attn_norm": jnp.asarray(
                _to_f32(tensors[pre + "input_layernorm.weight"]),
                jnp.bfloat16),
            "mlp_norm": jnp.asarray(
                _to_f32(tensors[pre + "post_attention_layernorm.weight"]),
                jnp.bfloat16),
        }
        for hf_name, ours in _HF_LAYER_MAP.items():
            if ours in ("attn_norm", "mlp_norm"):
                continue
            prefix = pre + hf_name
            if fmt == "bf16":
                lp[ours] = dense(prefix + ".weight")
            elif cached is not None and (i, ours) in cached:
                import ml_dtypes
                c = cached[(i, ours)]
                lp[ours] = {"words": jnp.asarray(c["words"]),
                            "scales": jnp.asarray(
                                c["scales"].view(ml_dtypes.bfloat16)),
                            "gs": jnp.float32(c["gs"])}
            else:
                lp[ours] = _make_quantized_layer(tensors, prefix, fmt)
            if prefix + ".bias" in tensors:  # Qwen2 QKV bias, kept bf16
                lp[ours]["b"] = jnp.asarray(
                    _to_f32(tensors[prefix + ".bias"]), jnp.bfloat16)
        params["layers"].append(lp)
    if cacheable and cached is None:
        _save_repack_cache(path, fmt, params["layers"])
    return cfg, params
