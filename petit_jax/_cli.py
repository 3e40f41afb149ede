"""Console entry points (pyproject [project.scripts]).

`petit-tune` is the packaged analog of the reference's
`bench_matmul --algo tune` CLI (tools/benchmarks/matmul/main.cc:269-325);
`petit-bench` times the FP4 GEMM vs the XLA dense-bf16 baseline
(the hipBLASLt analog) on given shapes. The repo-checkout `bench.py` runs
the full reference suite; these are the installable subsets.
"""

from __future__ import annotations

import argparse


# Default shapes: the Llama-70B-derived pairs the reference sweeps
# (tools/benchmarks/matmul.py:92-117).
_NK_PAIRS = ((4096, 8192), (8192, 8192), (10240, 8192), (57344, 8192),
             (8192, 28672), (28672, 8192), (8192, 1024), (1024, 8192))


def _parse_shapes(spec: str | None, ms: str) -> list[tuple[int, int, int]]:
    m_list = [int(x) for x in ms.split(",")]
    if spec:
        nk = []
        for part in spec.split(";"):
            n, k = part.split(",")
            nk.append((int(n), int(k)))
    else:
        nk = list(_NK_PAIRS)
    return [(m, n, k) for m in m_list for (n, k) in nk]


def tune_main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="petit-tune")
    p.add_argument("--shapes", help="n,k;n,k;... (default: Llama-70B suite)")
    p.add_argument("--ms", default="16,256,512")
    p.add_argument("--format", choices=("nvfp4", "mxfp4"), default="nvfp4")
    p.add_argument("--full", action="store_true",
                   help="walk the ENTIRE feasible space per shape "
                        "(reference --algo tune) instead of the local "
                        "search around the heuristic")
    p.add_argument("--time-budget", type=float, default=None,
                   help="per-shape wall-clock cap in seconds for --full")
    p.add_argument("--no-save", action="store_true")
    args = p.parse_args(argv)

    from .ops import autotune
    from .ops.solution import ElementB
    from .utils import compile_cache

    compile_cache.enable()
    eb = ElementB.NVFP4 if args.format == "nvfp4" else ElementB.MXFP4
    autotune.load_table()
    autotune.tune_suite(_parse_shapes(args.shapes, args.ms), eb,
                        verbose=True, save=not args.no_save,
                        full=args.full, time_budget_s=args.time_budget)


def bench_main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="petit-bench")
    p.add_argument("--shapes", help="n,k;n,k;... (default: Llama-70B suite)")
    p.add_argument("--ms", default="16")
    p.add_argument("--format", choices=("nvfp4", "mxfp4"), default="nvfp4")
    args = p.parse_args(argv)

    import numpy as np
    import jax.numpy as jnp

    from . import mul_nvfp4_a16, mul_mxfp4_a16
    from .numerics import formats
    from .ops import autotune, layout
    from .utils import benchlib, compile_cache

    compile_cache.enable()
    autotune.load_table()
    group = 16 if args.format == "nvfp4" else 32
    mul = mul_nvfp4_a16 if args.format == "nvfp4" else mul_mxfp4_a16
    for (m, n, k) in _parse_shapes(args.shapes, args.ms):
        rng = np.random.default_rng(n + k)
        nib = rng.integers(0, 16, size=(n, k), dtype=np.uint8)
        qw = formats.pack_fp4_pairs(nib)
        words = jnp.asarray(layout.repack_fp4_weights(
            qw, n, k, pad_to=layout.pad_multiple(group)))
        if args.format == "nvfp4":
            raw = ((rng.integers(4, 11, size=(n, k // 16), dtype=np.uint8)
                    << 3)
                   | rng.integers(0, 8, size=(n, k // 16), dtype=np.uint8))
        else:
            raw = rng.integers(110, 140, size=(n, k // 32), dtype=np.uint8)
        s = jnp.asarray(layout.process_fp4_scales(raw, n, k,
                                                  group_size=group))
        a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
        bd = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)

        def fp4_call(a2, w2, s2):
            return mul(a2, w2, s2, 1.0, m, n, k, -1)

        def dense_call(a2, b2):
            return jnp.dot(a2, b2, preferred_element_type=jnp.float32
                           ).astype(jnp.bfloat16)

        t_fp4 = benchlib.marginal_time(
            fp4_call, a, words, s,
            bytes_hint=words.size * 4 + s.size * 2 + a.size * 2)
        t_dense = benchlib.marginal_time(dense_call, a, bd,
                                         bytes_hint=bd.size * 2 + a.size * 2)
        tf = 2 * m * n * k / t_fp4 / 1e12
        print(f"m={m:5d} n={n:6d} k={k:6d}  fp4 {t_fp4 * 1e6:9.1f} us "
              f"({tf:6.2f} TFLOP/s)  dense {t_dense * 1e6:9.1f} us  "
              f"speedup {t_dense / t_fp4:5.2f}x", flush=True)


if __name__ == "__main__":
    bench_main()
