"""Implementation choice for the ops that have a hand-written kernel.

The FP4 GEMM and the grouped MoE GEMM each have a Pallas kernel and a plain
XLA version; both ask `implementation` which one to run, so the rule lives
in one place:

  - ``interpret=True`` (tests) runs the Pallas kernel in interpret mode;
  - on ``gpu`` the Pallas kernel through Triton when the problem is in the
    regime the kernel wins (at most KERNEL_MAX_M rows), else the plain XLA
    version;
  - on ``cpu`` an op runs the plain XLA version;
  - any other platform is an error: no op falls back silently.

Ops with one implementation (W4A8, attention, the KV write) are plain XLA
everywhere and do not come here.
"""

from __future__ import annotations

import jax

OPS = ("fp4_gemm",           # ops/kernels/fused.fused_mul
       "grouped_gemm")       # ops/kernels/grouped.grouped_mul

PLATFORMS = ("gpu", "cpu")

# Rows (m, or the grouped GEMM's per-expert capacity) up to which the FP4
# kernels beat XLA's dequantize -> dot. Measured on an H100 80GB HBM3 at
# (n, k) = (8192, 8192), (28672, 4096) and Mixtral expert shapes (PERF.md,
# kernel decisions): the kernel wins 3.5x at m=16 and 1.2-1.35x at m=128,
# and loses (0.73x) at m=256, where XLA's one dequantization plus a
# tensor-core GEMM beats re-decoding every weight per m-block.
KERNEL_MAX_M = 128


def implementation(op: str, interpret: bool = False,
                   platform: str | None = None,
                   m: int | None = None) -> str:
    """'triton', 'xla' or 'interpret' for `op` on `platform` (default: the
    platform JAX runs on) at `m` rows."""
    if op not in OPS:
        raise KeyError(f"unknown op {op!r}")
    platform = platform or jax.default_backend()
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"no implementation of {op!r} for platform {platform!r}")
    if interpret:
        return "interpret"
    if platform != "gpu" or (m is not None and m > KERNEL_MAX_M):
        return "xla"
    return "triton"
