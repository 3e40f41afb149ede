#!/usr/bin/env python
"""Per-component microsecond budget for one decode token.

Itemizes the FULL model step, the reference's wall-clock way
(tools/benchmarks/matmul/main.cc:244-267):

  1. Each projection GEMM at m=bs, measured alone (marginal-cost loop),
     vs its own weight-stream floor (bytes / the card's published HBM
     bandwidth, utils/benchlib.hbm_peak).
  2. Ablation chains at --layers L (per-layer costs scale linearly; the
     head/sampling rows are per-step):
       full    : the serve_bench fori_loop proxy (sanity row)
       noattn  : rope+cache-update+attention-kernel removed (GEMMs kept)
       nonorm  : the two rms_norms removed
       nohead  : final_norm + lm_head + argmax removed
       gemmonly: ONLY the 4 projections chained (plus slicing glue)
  3. Rows: gemm (direct), attention = full-noattn, norms = full-nonorm,
     head = full-nohead, residual = full - gemm_chain - attention - norms
     - head (dispatch/residual-add/sampling glue).

Run on the GPU: python tools/step_budget.py --layers 8
"""
import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from petit_jax.models import llama
from petit_jax.ops import autotune
from petit_jax.ops import gemm as gemm_mod
from petit_jax.ops.kernels import attention as attn_mod
from petit_jax.utils import benchlib, compile_cache


def load_sb():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sb", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "serve_bench.py"))
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)
    return sb


def proj_shapes(cfg):
    h, f = cfg.hidden_size, cfg.intermediate_size
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    return {"wqkv": (nq + 2 * nkv, h), "wo": (h, nq),
            "w_gateup": (2 * f, h), "w_down": (h, f)}


def gemm_rows(cfg, params, bs, fmt, reps):
    """Isolated per-projection GEMM time at m=bs vs weight-stream floor."""
    mul = {"nvfp4": gemm_mod.mul_nvfp4_a16,
           "nvfp4p2": gemm_mod.mul_nvfp4p2_a16,
           "nvfp4p2z": gemm_mod.mul_nvfp4p2z_a16,
           "mxfp4": gemm_mod.mul_mxfp4_a16}[fmt]
    lp = params["layers"][0]
    rows = {}
    rng = np.random.default_rng(7)
    for name, (n, k) in proj_shapes(cfg).items():
        layer = lp[name]
        a = jnp.asarray(rng.standard_normal((bs, k)).astype(np.float32) / 8,
                        jnp.bfloat16)
        wbytes = layer["words"].size * 4 + layer["scales"].size * 2

        def call(a_, w, s, gs, n=n, k=k):
            return mul(a_, w, s, gs, bs, n, k, -1)

        t = benchlib.marginal_time(call, a, layer["words"], layer["scales"],
                                   layer["gs"], bytes_hint=wbytes,
                                   reps=reps)
        floor = wbytes / benchlib.hbm_peak()
        rows[name] = (t, floor, wbytes)
        print(f"#   gemm {name:9s} (m={bs}, n={n}, k={k}): "
              f"{t * 1e6:7.1f} us  floor={floor * 1e6:7.1f} us "
              f"({floor / t:6.1%} of SoL, "
              f"{wbytes / t / 1e9:5.1f} GB/s)", flush=True)
    return rows


def make_chain(cfg, bs, fmt, kv_window, variant):
    """Jitted chain(n_steps, salt, params, cache, toks) -> scalar; one
    decode step per iteration with the `variant` ablation applied."""
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = cfg.hidden_size

    def lin(x, layer):
        m = x.shape[0]
        n = layer["words"].shape[1]
        k = x.shape[-1]
        mul = {"nvfp4": gemm_mod.mul_nvfp4_a16,
               "nvfp4p2": gemm_mod.mul_nvfp4p2_a16,
               "nvfp4p2z": gemm_mod.mul_nvfp4p2z_a16,
               "mxfp4": gemm_mod.mul_mxfp4_a16}[fmt]
        return mul(x, layer["words"], layer["scales"], layer["gs"],
                   m, n, k, -1)

    def norm(x, w):
        if variant == "nonorm":
            return x
        return llama.rms_norm(x, w, cfg.rms_eps)

    def step(params, cache, toks, pos_s):
        x = params["embed"][toks]                       # (B, h)
        new_cache = []
        pos2 = jnp.full((bs, 1), 0, jnp.int32) + pos_s
        for i, lp in enumerate(params["layers"]):
            hh = norm(x, lp["attn_norm"])
            if variant == "gemmonly":
                qkv = lin(x, lp["wqkv"])
                o = qkv[:, :nq * d]
                y = lin(o, lp["wo"])
                gu = lin(y, lp["w_gateup"])
                dn = lin(gu[:, :cfg.intermediate_size], lp["w_down"])
                x = dn
                new_cache.append(cache[i])
                continue
            qkv = lin(hh, lp["wqkv"])
            if variant == "noattn":
                o = qkv[:, :nq * d]
                c = cache[i]
            else:
                q = qkv[:, :nq * d].reshape(bs, 1, nq, d)
                kk = qkv[:, nq * d:(nq + nkv) * d].reshape(bs, 1, nkv, d)
                vv = qkv[:, (nq + nkv) * d:].reshape(bs, 1, nkv, d)
                if variant != "norope":
                    q = llama.rope(q, pos2, cfg.rope_theta)
                    kk = llama.rope(kk, pos2, cfg.rope_theta)
                if variant == "nowrite":
                    c = cache[i]
                    ck, cv = c
                else:
                    ck, cv = cache[i]
                    # the KV write the model path uses (llama.attention)
                    ck, cv = attn_mod.kv_write(ck, cv, kk, vv, pos2[:, 0])
                    c = (ck, cv)
                S = ck.shape[1]
                window = min(-(-kv_window // 128), S // 128) * 128
                o = attn_mod.decode_attention(
                    q.reshape(bs, nq, d), ck, cv, pos2[:, 0], window=window)
                o = o.reshape(bs, nq * d).astype(x.dtype)
            a = lin(o, lp["wo"])
            x = x + a
            hh = norm(x, lp["mlp_norm"])
            gu = lin(hh, lp["w_gateup"])
            g, u = jnp.split(gu, 2, axis=-1)
            dn = lin(jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype) * u,
                     lp["w_down"])
            x = x + dn
            new_cache.append(c)
        if variant in ("nohead", "gemmonly"):
            # consume EVERY element of x: a narrower consumer (e.g.
            # x[0, :1]) lets XLA column-slice the last layer's GEMMs and
            # dead-code the other batch rows, understating the ablation
            nxt = (toks + jnp.sum(x, axis=-1).astype(jnp.int32)
                   ) % cfg.vocab_size
        else:
            x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
            logits = jnp.dot(x, params["lm_head"]["w"],
                             preferred_element_type=jnp.float32)
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        return new_cache, nxt

    @jax.jit
    def chain(n_steps, salt, params, cache, toks):
        def body(i, carry):
            cache, toks, acc = carry
            pos_s = (kv_window - 112) + (i % 64)
            t_in = (toks + salt.astype(jnp.int32) + i) % cfg.vocab_size
            cache, nxt = step(params, cache, t_in, pos_s)
            return cache, nxt, acc + jnp.sum(nxt)
        _, _, acc = jax.lax.fori_loop(
            0, n_steps, body, (cache, toks, jnp.int32(0)))
        return acc

    return chain


def time_chain(chain, params, cache0, toks0, n1, n2, reps):
    salt = [0]

    def timed(n):
        salt[0] += 1
        t0 = time.perf_counter()
        int(chain(n, jnp.float32(salt[0]), params, cache0, toks0))
        return time.perf_counter() - t0

    timed(n1)
    timed(n1)
    tas = [timed(n1) for _ in range(reps)]
    tbs = [timed(n2) for _ in range(reps)]
    return max((min(tbs) - min(tas)) / (n2 - n1), 1e-9)


def main():
    compile_cache.enable()
    p = argparse.ArgumentParser()
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--kv-window", type=int, default=256)
    p.add_argument("--format", default="nvfp4p2")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--n1", type=int, default=8)
    p.add_argument("--n2", type=int, default=40)
    p.add_argument("--skip-chains", action="store_true",
                   help="only the per-projection GEMM rows")
    args = p.parse_args()

    autotune.load_table()  # per-device tuned solutions (m=8 entries exist)
    sb = load_sb()
    cfg = llama.LlamaConfig.llama3_8b(max_seq_len=args.seq,
                                      vocab_size=32768,
                                      num_layers=args.layers)
    rng = np.random.default_rng(0)
    params = sb.build_model(cfg, rng, fmt=args.format)
    bs, L = args.bs, args.layers

    wbytes_l = sum(params["layers"][0][k]["words"].size * 4
                   + params["layers"][0][k]["scales"].size * 2
                   for k in ("wqkv", "wo", "w_gateup", "w_down"))
    head_bytes = params["embed"].size * 2
    print(f"# step_budget: {L}L bs={bs} fmt={args.format} "
          f"kv_window={args.kv_window} seq={args.seq}", flush=True)
    print(f"# weight bytes: {wbytes_l / 1e6:.1f} MB/layer + "
          f"{head_bytes / 1e6:.1f} MB head; per-layer floor "
          f"{wbytes_l / benchlib.hbm_peak() * 1e6:.1f} us, head floor "
          f"{head_bytes / benchlib.hbm_peak() * 1e6:.1f} us", flush=True)

    rows = gemm_rows(cfg, params, bs, args.format, args.reps)
    gemm_l = sum(t for (t, _, _) in rows.values())
    gemm_fl = sum(f for (_, f, _) in rows.values())
    print(f"# gemm/layer: {gemm_l * 1e6:7.1f} us  floor="
          f"{gemm_fl * 1e6:7.1f} us ({gemm_fl / gemm_l:6.1%} of SoL)",
          flush=True)
    if args.skip_chains:
        return

    cache0 = llama.init_cache(cfg, bs, jnp.bfloat16)
    toks0 = jnp.asarray(rng.integers(0, cfg.vocab_size, bs), jnp.int32)

    res = {}
    for variant in ("full", "noattn", "norope", "nowrite", "nonorm",
                    "nohead", "gemmonly"):
        chain = make_chain(cfg, bs, args.format, args.kv_window, variant)
        t = time_chain(chain, params, cache0, toks0, args.n1, args.n2,
                       args.reps)
        res[variant] = t
        print(f"# chain {variant:9s}: {t * 1e3:7.3f} ms/step", flush=True)

    full = res["full"]
    attn = full - res["noattn"]
    rope_c = full - res["norope"]
    write_c = full - res["nowrite"]
    norms = full - res["nonorm"]
    head = full - res["nohead"]
    resid = full - res["gemmonly"] - attn - norms - head
    floor = (wbytes_l * L + head_bytes) / benchlib.hbm_peak()
    print("#")
    print(f"# BUDGET ({L}L, ms/step; x{32 // L if L <= 32 else 1} for 32L "
          f"per-layer rows):")
    print(f"#   gemm chain      : {res['gemmonly'] * 1e3:7.3f}  "
          f"(isolated sum {gemm_l * L * 1e3:.3f}, "
          f"floor {gemm_fl * L * 1e3:.3f})")
    print(f"#   attention+cache : {attn * 1e3:7.3f}  "
          f"(rope {rope_c * 1e3:.3f}, cache-write {write_c * 1e3:.3f})")
    print(f"#   rms_norms       : {norms * 1e3:7.3f}")
    print(f"#   head+sample     : {head * 1e3:7.3f}  "
          f"(floor {head_bytes / benchlib.hbm_peak() * 1e3:.3f})")
    print(f"#   residual/glue   : {resid * 1e3:7.3f}")
    print(f"#   FULL            : {full * 1e3:7.3f}  floor={floor * 1e3:.3f} "
          f"({floor / full:.1%} of roofline)")


if __name__ == "__main__":
    main()
