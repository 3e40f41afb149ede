"""petit_jax — FP4 (NVFP4/MXFP4) weight-only GEMM framework for NVIDIA Hopper.

Built from scratch in JAX/Pallas with the capabilities of
causalflow-ai/petit-kernel (AMD CDNA HIP FP16/BF16 x FP4 GEMM library).
Public surface mirrors the reference's 7-function API
(petit_kernel/__init__.py:17-79):

    repack_nvfp4 / repack_mxfp4        offline weight shuffle -> kernel layout
    process_nvfp4_scales / process_mxfp4_scales
    mul_nvfp4_a16 / mul_mxfp4_a16      fused dequant+GEMM (Pallas/Triton)
    get_fp4_solutions                  kernel-config enumeration
    DataType, PetitSolutionHints       enums / hints

plus extensions: `parallel` (Mesh/TP sharding), `models`
(quantized inference models), `ops.autotune` (offline tuner).
"""

from __future__ import annotations

import enum

import numpy as np
import jax.numpy as jnp

from .numerics import formats as _formats
from .ops import layout as _layout
from .ops import gemm as _gemm
from .ops import solution as _solution
from .ops.gemm import (mul_nvfp4_a16, mul_mxfp4_a16, mul_nvfp4p2_a16,
                       mul_nvfp4p2z_a16, mul_mxfp4z_a16, mul_nvfp4_a8,
                       mul_mxfp4_a8, get_fp4_solutions)
from .ops.solution import (SolutionId, SolutionHints as PetitSolutionHints,
                           ElementB, MatmulType, default_hints)


class DataType(enum.Enum):
    """Parity with petit_kernel.DataType (petit_kernel/__init__.py:8-15)."""
    int4 = 0
    float8_e4m3fn = 1
    float4_e2m1 = 2
    float16 = 3
    bfloat16 = 4
    float8_e5m2fn = 5
    mxfloat4_e2m1 = 6


def repack_nvfp4(qweights, size_n: int, size_k: int):
    """Repack reference-layout NVFP4 weights (uint8 (n, k/2) or int32
    (n, k/8)) into the opaque kernel layout (uint32 (k/8, n)).

    Host-side one-shot transform run at checkpoint load (reference analog:
    RepackNvFp4ToPetitFp4Weights, quantization_utils.cu:729-746)."""
    return jnp.asarray(_layout.repack_fp4_weights(
        np.asarray(qweights), size_n, size_k))


def repack_mxfp4(qweights, size_n: int, size_k: int):
    """Same shuffle as repack_nvfp4 (weights repack identically, only scales
    differ — reference petit_kernel/__init__.py:27-28), but K zero-pads to
    1024 so every kernel k-quarter covers 8-aligned 32-wide scale groups."""
    return jnp.asarray(_layout.repack_fp4_weights(
        np.asarray(qweights), size_n, size_k,
        pad_to=_layout.K_PAD_MX))


def process_nvfp4_scales(scales, size_n: int, size_k: int):
    """E4M3 scales (n, k/16) -> opaque bfloat16 (k/16, n), decoded exactly
    offline; validates the positive-scale invariant."""
    return jnp.asarray(_layout.process_fp4_scales(
        np.asarray(scales), size_n, size_k,
        group_size=_formats.NVFP4_GROUP_SIZE))


def process_mxfp4_scales(scales, size_n: int, size_k: int):
    """E8M0 scales (n, k/32) -> opaque bfloat16 (k/32, n), decoded exactly
    offline (byte 0, 2^-127, becomes exact 0.0)."""
    return jnp.asarray(_layout.process_fp4_scales(
        np.asarray(scales), size_n, size_k,
        group_size=_formats.MXFP4_GROUP_SIZE))


__all__ = [
    "repack_nvfp4",
    "repack_mxfp4",
    "process_nvfp4_scales",
    "process_mxfp4_scales",
    "mul_nvfp4_a16",
    "mul_mxfp4_a16",
    "mul_nvfp4p2_a16",
    "mul_nvfp4p2z_a16",
    "mul_mxfp4z_a16",
    "mul_nvfp4_a8",
    "mul_mxfp4_a8",
    "get_fp4_solutions",
    "DataType",
    "PetitSolutionHints",
    "SolutionId",
    "ElementB",
    "MatmulType",
    "default_hints",
]
