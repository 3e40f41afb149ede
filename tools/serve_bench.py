"""End-to-end decode throughput on the GPU: tokens/s/chip.

The north-star metric (BASELINE.json: "tokens/s/chip at 70B NVFP4 decode,
%-of-roofline at bs 1-16"). A Llama-8B-class NVFP4 model decodes with the
full model step (all projections through the FP4 GEMM, KV cache
updates, argmax sampling); steps are chained inside a jitted fori_loop
carrying (cache, tokens, pos) so per-program launch cost does not enter
the measurement (utils/benchlib protocol, marginal cost between two chain
lengths).

Roofline: a decode step must at minimum stream the FP4 weights once
(batch<=16 is weight-bound); %-of-roofline = (weight_bytes / the card's
published HBM bandwidth, utils/benchlib.hbm_peak) / step_time.

Weights are fabricated directly in the quantized layout (random words and
scales) — throughput is layout/shape-dependent, not value-dependent.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from petit_jax.models import llama
from petit_jax.ops import autotune
from petit_jax.ops import layout as layout_mod
from petit_jax.utils import benchlib, compile_cache


def fabricate_qlayer(rng, k, n, pow2_scales=False):
    kp = layout_mod.padded_k(k, layout_mod.K_PAD)
    words = rng.integers(0, 2 ** 32, size=(kp // 8, n),
                         dtype=np.uint64).astype(np.uint32)
    sraw = ((rng.integers(4, 11, size=(kp // 16, n), dtype=np.uint8) << 3)
            | (0 if pow2_scales else  # nvfp4p2 contract: zero mantissa
               rng.integers(0, 8, size=(kp // 16, n), dtype=np.uint8)))
    import ml_dtypes
    from petit_jax.numerics import formats
    scales = formats.e4m3_decode(sraw).astype(ml_dtypes.bfloat16)
    return {"words": jnp.asarray(words), "scales": jnp.asarray(scales),
            "gs": jnp.float32(1.0 / 448.0)}


def fabricate_hybrid_layer(rng, k, n, *, block_nf=1536, block_nd=512):
    """Hybrid FP4+BF16 layer (ops/hybrid.py contract) with fabricated
    contents: FP4 words/scales for the block_nf fraction, dense bf16 for
    the salient block_nd fraction, identity column permutation."""
    step = block_nf + block_nd
    if n % step:  # too narrow to split: pure FP4 fallback (llama.linear)
        return fabricate_qlayer(rng, k, n)
    nn = n // step
    nf, nd = nn * block_nf, nn * block_nd
    base = fabricate_qlayer(rng, k, nf)
    kp = base["words"].shape[0] * 8
    wd = jnp.asarray(rng.standard_normal((kp, nd)).astype(np.float32) / 50,
                     jnp.bfloat16)
    from petit_jax.ops.hybrid import HybridMeta
    return {**base, "wd": wd,
            "inv_perm": jnp.arange(n, dtype=jnp.int32),
            "meta": HybridMeta(block_nf, block_nd, k)}


def build_model(cfg, rng, fmt="nvfp4"):
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    if fmt == "hybrid":
        fab = fabricate_hybrid_layer
    else:
        import functools as _ft
        fab = _ft.partial(fabricate_qlayer,
                          pow2_scales=fmt in ("nvfp4p2", "nvfp4p2z"))
    params = {
        "embed": jnp.asarray(
            rng.standard_normal((v, h)).astype(np.float32) / 50,
            jnp.bfloat16),
        "final_norm": jnp.ones((h,), jnp.bfloat16),
        "layers": [],
    }
    params["lm_head"] = {"w": params["embed"].T}
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn_norm": jnp.ones((h,), jnp.bfloat16),
            "mlp_norm": jnp.ones((h,), jnp.bfloat16),
            # fused projections (llama.quantize_params fuse=True layout)
            "wqkv": fab(rng, h, nq + 2 * nkv),
            "wo": fab(rng, nq, h),
            "w_gateup": fab(rng, h, 2 * f),
            "w_down": fab(rng, f, h),
        })
    return params


def run_engine_bench(args, cfg, params, rng, wbytes):
    """Engine-measured tokens/s: the real Engine.run() with multi-token
    decode blocks (serving.step_block), including scheduling, sampling and
    the per-block host sync — NOT the fori_loop model-step proxy. The gap
    between the two numbers is the engine/host overhead; tokens/s here
    depends on --decode-block (one host round trip per block)."""
    from petit_jax.models import serving

    bs = args.bs
    kv_dtype = (jnp.float8_e4m3fn if args.kv_dtype == "fp8"
                else jnp.bfloat16)
    eng_cls = (serving.PagedEngine if args.backend == "paged"
               else serving.Engine)
    eng = eng_cls(params, cfg, max_batch=bs, fmt=args.format,
                  cache_dtype=kv_dtype,
                  prefill_fmt=args.prefill_fmt)

    def reqs(n_new):
        return [serving.Request(
            uid=i,
            tokens=rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
            max_new_tokens=n_new) for i in range(bs)]

    # warm: compiles prefill bucket + decode block programs. MUST cover the
    # same token count as the timed run — each pow2 kv-window bucket the
    # decode crosses compiles its own block program, and a 32-layer
    # compile landing inside the timed region reads as ~30x engine
    # overhead (measured: 18.4 tok/s with a cold 256-bucket vs 10x+ warm).
    eng.run(reqs(args.new_tokens), decode_block=args.decode_block)
    eng.reset()
    t0 = time.perf_counter()
    out = eng.run(reqs(args.new_tokens), decode_block=args.decode_block)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in out.values())
    t_tok = dt / (toks / bs)
    roofline_t = wbytes / benchlib.hbm_peak()
    print(f"# ENGINE mode: {args.layers}L hidden={cfg.hidden_size} "
          f"fmt={args.format} bs={bs} decode_block={args.decode_block} "
          f"new_tokens={args.new_tokens} backend={args.backend} "
          f"kv={args.kv_dtype}")
    print(f"# engine tokens/s/chip={toks / dt:.1f}  per-token-step="
          f"{t_tok * 1e3:.2f} ms  weight-stream roofline="
          f"{roofline_t * 1e3:.2f} ms ({roofline_t / t_tok:.1%} of "
          f"roofline)")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--n1", type=int, default=8)
    p.add_argument("--n2", type=int, default=40)
    p.add_argument("--format", default="nvfp4",
                   choices=["nvfp4", "mxfp4", "nvfp4p2", "nvfp4p2z",
                            "hybrid"])
    p.add_argument("--prefill-fmt", default=None,
                   choices=[None, "w4a8", "nvfp4"],
                   help="engine mode: run prefill chunks through a "
                        "different GEMM path (w4a8 = int8 product) than decode")
    p.add_argument("--kv-dtype", default="bf16", choices=["bf16", "fp8"],
                   help="KV cache dtype (fp8 = float8_e4m3fn, upcast "
                        "inside the fused attention kernel)")
    p.add_argument("--backend", default="contiguous",
                   choices=["contiguous", "paged"],
                   help="engine mode cache backend; paged is the headed "
                        "(P,Hkv,ps,d) page pool")
    p.add_argument("--engine", action="store_true",
                   help="measure the ACTUAL serving engine (Engine.run "
                        "with multi-token decode blocks), not the "
                        "fori_loop model-step proxy")
    p.add_argument("--decode-block", type=int, default=32,
                   help="decode steps per host round-trip in --engine mode")
    p.add_argument("--new-tokens", type=int, default=128,
                   help="tokens generated per request in --engine mode")
    p.add_argument("--lm-head-fp4", action="store_true",
                   help="quantize lm_head to the same FP4 format (decode "
                        "streams the head every step; bf16 head is ~6% of "
                        "the 8B-class stream). Quality-gate before "
                        "adopting (quality_gate.py --quant-head).")
    p.add_argument("--kv-window", type=int, default=128,
                   help="proxy mode: static attention window bucket (set "
                        "to the engine's operating bucket, e.g. 256, for "
                        "an apples-to-apples engine-vs-proxy comparison)")
    args = p.parse_args()

    # tuned per-device solutions, when a table for this card exists;
    # without one every GEMM takes the heuristic
    compile_cache.enable()
    autotune.load_table()
    cfg = llama.LlamaConfig.llama3_8b(max_seq_len=args.seq,
                                      vocab_size=32768,
                                      num_layers=args.layers)
    rng = np.random.default_rng(0)
    params = build_model(cfg, rng, fmt=args.format)
    bs = args.bs
    cache0 = llama.init_cache(
        cfg, bs, jnp.float8_e4m3fn if args.kv_dtype == "fp8"
        else jnp.bfloat16)
    toks0 = jnp.asarray(rng.integers(0, cfg.vocab_size, bs), jnp.int32)

    if args.lm_head_fp4:
        params["lm_head"] = fabricate_qlayer(
            rng, cfg.hidden_size, cfg.vocab_size,
            pow2_scales=args.format in ("nvfp4p2", "nvfp4p2z"))

    # weight bytes streamed per decode step (FP4 words + bf16 scales)
    wbytes = sum(lp[k]["words"].size * 4 + lp[k]["scales"].size * 2
                 + (lp[k]["wd"].size * 2 if "wd" in lp[k] else 0)
                 for lp in params["layers"]
                 for k in ("wqkv", "wo", "w_gateup", "w_down"))
    if args.lm_head_fp4:  # FP4 head streams words + scales instead
        wbytes += (params["lm_head"]["words"].size * 4
                   + params["lm_head"]["scales"].size * 2)
    else:
        wbytes += params["embed"].size * 2  # lm_head (tied) streams too

    if args.engine:
        run_engine_bench(args, cfg, params, rng, wbytes)
        return

    @jax.jit
    def chain(n_steps, salt, params, cache, toks):
        def body(i, carry):
            cache, toks, acc = carry
            # steady state inside the window bucket (pos < kv_window)
            pos = jnp.full((bs, 1),
                           (args.kv_window - 112) + (i % 64), jnp.int32)
            t_in = (toks + salt.astype(jnp.int32) + i) % cfg.vocab_size
            # the window routes attention through the fused decode kernel,
            # like the serving engines do
            logits, cache = llama.forward(params, t_in[:, None], cfg, cache,
                                          pos, fmt=args.format,
                                          kv_window=args.kv_window)
            nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
            return cache, nxt, acc + jnp.sum(nxt)
        _, _, acc = jax.lax.fori_loop(0, n_steps, body,
                                      (cache, toks0, jnp.int32(0)))
        return acc

    salt = [0]

    def timed(n):
        salt[0] += 1
        t0 = time.perf_counter()
        v = int(chain(n, jnp.float32(salt[0]), params, cache0, toks0))
        return time.perf_counter() - t0

    timed(args.n1)  # compile + warm
    timed(args.n1)  # discard
    tas = [timed(args.n1) for _ in range(3)]
    tbs = [timed(args.n2) for _ in range(3)]
    t_step = max((min(tbs) - min(tas)) / (args.n2 - args.n1), 1e-9)
    roofline_t = wbytes / benchlib.hbm_peak()
    print(f"# model: {args.layers}L hidden={cfg.hidden_size} fmt={args.format} "
          f"inter={cfg.intermediate_size} bs={bs} "
          f"fp4+scales={wbytes / 1e9:.2f} GB")
    print(f"# step={t_step * 1e3:.2f} ms  tokens/s/chip={bs / t_step:.1f}  "
          f"weight-stream roofline={roofline_t * 1e3:.2f} ms "
          f"({roofline_t / t_step:.1%} of roofline)")


if __name__ == "__main__":
    main()
