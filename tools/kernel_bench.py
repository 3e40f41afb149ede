#!/usr/bin/env python
"""Kernel decisions on the card: each op's kernel time next to XLA's.

For the FP4 GEMM and the grouped (MoE) GEMM, times the Pallas/Triton
kernel against the plain XLA version (dequantize -> dot) at the same
shapes, and checks both against an f32 reference. Also times the W4A8
path against the W4A16 kernel at Llama-3-8B shapes (the prefill crossover)
and the XLA attention ops at serving shapes. Weights are fabricated on the
device from a seed.

    python tools/kernel_bench.py [--phases gemm,grouped,w4a8,attn]

Prints one line per measurement and the card's name and power limit.
Needs a GPU: exits non-zero elsewhere.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax
import jax.numpy as jnp
import numpy as np

from petit_jax.utils import compile_cache

GEMM_SHAPES = [(8192, 8192), (28672, 4096)]        # bench.py SHAPES_NK
LLAMA8B_SHAPES = [(6144, 4096), (4096, 4096), (28672, 4096), (4096, 14336)]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except Exception as e:  # noqa: BLE001 - report, do not fail the bench
        return f"nvidia-smi unavailable ({e})"


def _us(t):
    return f"{t * 1e6:.1f}"


def gemm_case(m, n, k, fmt, key):
    from petit_jax.ops import gemm, solution
    from petit_jax.ops.kernels import fused
    from petit_jax.utils import benchlib, testdata

    layer = testdata.random_fp4_layer(key, k, n, fmt)
    a = jax.random.normal(jax.random.fold_in(key, 7), (m, k), jnp.bfloat16)
    eb = (solution.ElementB.MXFP4 if fmt == "mxfp4"
          else solution.ElementB.NVFP4)
    sid = gemm.resolve_solution(m, n, k, eb)
    w, s, gs = layer["words"], layer["scales"], layer["gs"]

    def tri(a, w, s):
        return fused.fused_mul_kernel(a, w, s, gs, sid=sid)

    def xla(a, w, s):
        return fused._fused_mul_xla(a, w, s, gs, high_precision=False,
                                    out_dtype=jnp.bfloat16)

    with jax.default_matmul_precision("highest"):
        ref = jnp.dot(a.astype(jnp.float32),
                      fused.dequant(w, s, dtype=jnp.float32)) * gs
    denom = jnp.maximum(jnp.max(jnp.abs(ref)), 1.0)
    err_t = float(jnp.max(jnp.abs(jax.jit(tri)(a, w, s) - ref)) / denom)
    err_x = float(jnp.max(jnp.abs(jax.jit(xla)(a, w, s) - ref)) / denom)
    nbytes = w.size * 4 + s.size * 2 + a.size * 2
    t_t = benchlib.marginal_time(tri, a, w, s, bytes_hint=nbytes)
    t_x = benchlib.marginal_time(xla, a, w, s, bytes_hint=nbytes)
    peak = benchlib.hbm_peak()
    print(f"gemm {fmt} m={m} n={n} k={k} sid={sid.repr()} "
          f"triton_us={_us(t_t)} xla_us={_us(t_x)} "
          f"speedup={t_x / t_t:.2f} err_triton={err_t:.2e} "
          f"err_xla={err_x:.2e} triton_hbm_share="
          f"{nbytes / t_t / peak:.3f}", flush=True)


def grouped_case(cap, n, k, key, E=8, fmt="mxfp4"):
    from petit_jax.ops.kernels import fused, grouped
    from petit_jax.utils import benchlib, testdata

    keys = jax.random.split(key, E)
    ls = [testdata.random_fp4_layer(kk, k, n, fmt) for kk in keys]
    w = jnp.stack([x["words"] for x in ls])
    s = jnp.stack([x["scales"] for x in ls])
    gs = jnp.stack([x["gs"] for x in ls])
    xs = jax.random.normal(jax.random.fold_in(key, 3), (E, cap, k),
                           jnp.bfloat16)

    def tri(xs, w, s):
        return grouped.grouped_kernel(xs, w, s, gs)

    def xla(xs, w, s):
        d = jax.vmap(fused.dequant)(w, s)
        return (jnp.einsum("eck,ekn->ecn", xs, d,
                           preferred_element_type=jnp.float32)
                * gs[:, None, None]).astype(jnp.bfloat16)

    got, want = jax.jit(tri)(xs, w, s), jax.jit(xla)(xs, w, s)
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32)
                                - want.astype(jnp.float32)))
                / jnp.maximum(jnp.max(jnp.abs(want.astype(jnp.float32))),
                              1.0))
    nbytes = w.size * 4 + s.size * 2 + xs.size * 2
    t_t = benchlib.marginal_time(tri, xs, w, s, bytes_hint=nbytes)
    t_x = benchlib.marginal_time(xla, xs, w, s, bytes_hint=nbytes)
    print(f"grouped {fmt} E={E} cap={cap} n={n} k={k} "
          f"triton_us={_us(t_t)} xla_us={_us(t_x)} "
          f"speedup={t_x / t_t:.2f} err_vs_xla={err:.2e}", flush=True)


def w4a8_case(m, n, k, key):
    from petit_jax.ops import gemm
    from petit_jax.ops.kernels import fused
    from petit_jax.utils import benchlib, testdata

    layer = testdata.random_fp4_layer(key, k, n, "nvfp4")
    a = jax.random.normal(jax.random.fold_in(key, 9), (m, k), jnp.bfloat16)
    w, s, gs = layer["words"], layer["scales"], layer["gs"]
    r_t, acol = fused.w4a8_requant_constants(s)

    def a8(a, w, s):
        return gemm.mul_nvfp4_a8(a, w, s, gs, m, n, k, r_t=r_t, acol=acol)

    def a16(a, w, s):
        return gemm.mul_nvfp4_a16(a, w, s, gs, m, n, k)

    nbytes = w.size * 4 + s.size * 2
    t8 = benchlib.marginal_time(a8, a, w, s, bytes_hint=nbytes)
    t16 = benchlib.marginal_time(a16, a, w, s, bytes_hint=nbytes)
    print(f"w4a8 m={m} n={n} k={k} a8_us={_us(t8)} a16_us={_us(t16)} "
          f"a16_over_a8={t16 / t8:.2f}", flush=True)


def attn_cases(key):
    from petit_jax.ops.kernels import attention as attn
    from petit_jax.utils import benchlib

    B, H, Hkv, d = 8, 32, 8, 128
    for S, dt in ((4096, jnp.bfloat16), (4096, jnp.float8_e4m3fn)):
        q = jax.random.normal(key, (B, H, d), jnp.bfloat16)
        ck = jax.random.normal(jax.random.fold_in(key, 1), (B, S, Hkv, d),
                               jnp.float32).astype(dt)
        cv = jax.random.normal(jax.random.fold_in(key, 2), (B, S, Hkv, d),
                               jnp.float32).astype(dt)
        pos = jnp.full((B,), S - 1, jnp.int32)

        def dec(q, ck, cv):
            return attn.decode_attention(q, ck, cv, pos, window=S)

        nbytes = 2 * ck.size * ck.dtype.itemsize
        t = benchlib.marginal_time(dec, q, ck, cv, bytes_hint=nbytes)
        print(f"decode_attention xla B={B} S={S} kv={jnp.dtype(dt).name} "
              f"us={_us(t)} hbm_share={nbytes / t / benchlib.hbm_peak():.3f}",
              flush=True)
    T, S = 512, 1024
    q = jax.random.normal(key, (1, T, H, d), jnp.bfloat16)
    ck = jax.random.normal(jax.random.fold_in(key, 3), (1, S, Hkv, d),
                           jnp.bfloat16)
    cv = jax.random.normal(jax.random.fold_in(key, 4), (1, S, Hkv, d),
                           jnp.bfloat16)
    pos0 = jnp.asarray([S - T], jnp.int32)

    def pre(q, ck, cv):
        return attn.prefill_attention(q, ck, cv, pos0, window=S)

    t = benchlib.marginal_time(pre, q, ck, cv, bytes_hint=4 * ck.size)
    print(f"prefill_attention xla T={T} S={S} us={_us(t)}", flush=True)

    ckh = jnp.zeros((B, Hkv, S, d), jnp.bfloat16)
    kn = jax.random.normal(key, (B, Hkv, d), jnp.bfloat16)
    p = jnp.arange(B, dtype=jnp.int32) * 7

    def app(kn, ck):
        return attn.kv_write(ck, ck, kn[:, None], kn[:, None], p,
                             headed=True)[0]

    t = benchlib.marginal_time(app, kn, ckh, bytes_hint=1e6)
    print(f"kv_write xla B={B} S={S} us={_us(t)}", flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--phases", default="gemm,grouped,w4a8,attn")
    args = p.parse_args()
    cache = compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: platform {dev.platform}", file=sys.stderr)
        return 2
    print(f"card: {card()}", flush=True)
    print(f"device: {dev.device_kind} x{len(jax.devices())} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} cache={cache}",
          flush=True)
    key = jax.random.PRNGKey(0)
    phases = args.phases.split(",")
    if "gemm" in phases:
        for fmt in ("nvfp4", "mxfp4"):
            for (n, k) in GEMM_SHAPES:
                for m in (16, 32, 64, 128, 256):
                    gemm_case(m, n, k, fmt, key)
    if "grouped" in phases:
        for cap in (16, 64, 128):
            grouped_case(cap, 2 * 14336, 4096, key)
            grouped_case(cap, 4096, 14336, key)
    if "w4a8" in phases:
        for m in (64, 128, 256, 512):
            for (n, k) in LLAMA8B_SHAPES:
                w4a8_case(m, n, k, key)
    if "attn" in phases:
        attn_cases(key)
    return 0


if __name__ == "__main__":
    sys.exit(main())
