"""Public GEMM entry points + solution resolution.

Analog of the reference host dispatch layer
(lib/gemm/rocm/quantization/fp4/gemm_fp4_fp16_grid.cc:36-95 and
lib/pybind/fp4.cc:163-283): validates the problem, resolves solution_id == -1
through the autotune table then the heuristic chooser, and invokes the FP4
GEMM (ops/kernels/fused.fused_mul, which picks its implementation by
platform).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import solution as solution_mod
from .solution import SolutionId, SolutionHints, ElementB, MatmulType
from .kernels import fused

# Lazily populated by autotune.load_table(); maps
# (m_bucket, n, k, element_b, mfma, hp) -> SolutionId repr.
_TUNED_TABLE: dict = {}


def set_tuned_table(table: dict) -> None:
    _TUNED_TABLE.clear()
    _TUNED_TABLE.update(table)


def _m_bucket(m: int) -> int:
    """Bucket m for table lookup: exact for small decode batches, then
    power-of-two buckets (the reference tunes per exact shape; buckets let
    one table generalize across ragged batch sizes)."""
    if m <= 32:
        return m
    b = 64
    while b < m:
        b *= 2
    return b


def _table_key(m: int, n: int, k: int, element_b: ElementB,
               mfma_type: MatmulType, high_precision: bool,
               grouped: bool = False) -> tuple:
    """Tuned-table key. `grouped` separates the grouped (MoE expert)
    kernel's optima from the dense kernel's at the same per-expert shape."""
    return (_m_bucket(m), n, k, int(element_b), int(mfma_type),
            bool(high_precision), bool(grouped))


def resolve_solution(m: int, n: int, k: int,
                     element_b: ElementB,
                     mfma_type: MatmulType = MatmulType.BF16,
                     high_precision: bool = False,
                     solution_id: int = -1,
                     hints: Optional[SolutionHints] = None) -> SolutionId:
    """solution_id semantics match the reference (fp4.cc:189-199):
    -1 -> tuned table, then heuristic; otherwise an explicit SolutionId.repr()
    which must be feasible or ValueError (kErrorKernelShape analog).

    hints (PetitSolutionHints analog, gemm.h:110-117): b_type must agree
    with element_b; require_high_precision forces high-precision resolution
    and rejects explicit non-hp ids (the reference filters solutions by
    precision-flag parity, algo_chooser.cc:76-80)."""
    if hints is not None:
        if hints.b_type != element_b:
            raise ValueError(
                f"hints.b_type {hints.b_type} mismatches element_b "
                f"{element_b}")
        high_precision = high_precision or hints.require_high_precision
    if solution_id is not None and solution_id >= 0:
        sid = SolutionId.from_repr(solution_id)
        if sid.element_b != element_b:
            raise ValueError(
                f"solution {sid} element_b mismatch (want {element_b})")
        if high_precision and not sid.high_precision:
            raise ValueError(
                f"solution {sid} is not high-precision but hints require it")
        if not solution_mod.is_feasible(sid, m, n, k):
            raise ValueError(
                f"solution {sid} infeasible for m={m} n={n} k={k} "
                "(kErrorKernelShape)")
        return sid
    key = _table_key(m, n, k, element_b, mfma_type, high_precision)
    if key in _TUNED_TABLE:
        sid = SolutionId.from_repr(_TUNED_TABLE[key])
        if solution_mod.is_feasible(sid, m, n, k):
            return sid
    return solution_mod.choose_default_solution(
        m, n, k, element_b, mfma_type, high_precision)


def resolve_grouped_solution(cap: int, n: int, k: int,
                             element_b: ElementB,
                             mfma_type: MatmulType = MatmulType.BF16,
                             solution_id: int = -1) -> SolutionId:
    """Solution resolution for the grouped (MoE expert) kernel: per-expert
    problem shape (cap, n, k). Explicit ids must be feasible and must not
    split K (the expert takes the grid axis split-K uses); -1 resolves
    through the grouped table entry, then the dense entry for the same
    shape, then the heuristic, with split-K switched off."""
    if solution_id is not None and solution_id >= 0:
        sid = SolutionId.from_repr(solution_id)
        if sid.element_b != element_b:
            raise ValueError(
                f"solution {sid} element_b mismatch (want {element_b})")
        if sid.split_k != 1:
            raise ValueError(
                f"solution {sid}: grouped kernel has no split_k "
                "variant (kErrorKernelShape)")
        if not solution_mod.is_feasible(sid, cap, n, k):
            raise ValueError(
                f"solution {sid} infeasible for cap={cap} n={n} k={k} "
                "(kErrorKernelShape)")
        return sid
    for grouped in (True, False):
        key = _table_key(cap, n, k, element_b, mfma_type, False, grouped)
        if key in _TUNED_TABLE:
            sid = SolutionId.from_repr(_TUNED_TABLE[key])
            if solution_mod.is_feasible(sid, cap, n, k):
                return dataclasses.replace(sid, split_k=1)
    sid = solution_mod.choose_default_solution(cap, n, k, element_b,
                                               mfma_type)
    return dataclasses.replace(sid, split_k=1)


def _validate_and_prepare(a, b, s, m, n, k, group: int):
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    s = jnp.asarray(s)
    if a.ndim != 2 or a.shape != (m, k):
        raise ValueError(f"a must be (m, k) = {(m, k)}, got {a.shape}")
    if a.dtype not in (jnp.bfloat16, jnp.float16, jnp.float32):
        raise ValueError(f"a dtype must be bf16/f16/f32, got {a.dtype}")
    if b.dtype != jnp.uint32 and b.dtype != jnp.int32:
        raise ValueError(f"b must be the uint32 repacked weights, got {b.dtype}")
    from . import layout
    kp = layout.padded_k(k, layout.pad_multiple(group))
    if b.shape != (kp // 8, n):
        raise ValueError(
            f"b must be repack output (k_padded/8, n) = {(kp // 8, n)}, "
            f"got {b.shape}")
    if s.dtype != jnp.bfloat16:
        raise ValueError(
            f"s must be bfloat16 processed scales (process_*_scales "
            f"output), got {s.dtype}")
    if s.shape != (kp // 16, n):
        raise ValueError(
            f"s must be processed scales (k_padded/16, n) = "
            f"{(kp // 16, n)}, got {s.shape} (stride-16 rows for both "
            "formats; MXFP4 rows are duplicated by process_mxfp4_scales)")
    if k % 128 != 0:
        raise ValueError(f"k = {k} must be a multiple of 128")
    return a, b.view(jnp.uint32) if b.dtype == jnp.int32 else b, s


def _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
         element_b: ElementB, interpret: bool = False,
         hints: Optional[SolutionHints] = None):
    if size_m == 0 or size_n == 0 or size_k == 0:
        return jnp.zeros((size_m, size_n), dtype=jnp.asarray(a).dtype)
    group = 16 if element_b == ElementB.NVFP4 else 32
    a, b, s = _validate_and_prepare(a, b, s, size_m, size_n, size_k, group)
    in_dtype = a.dtype
    mfma = MatmulType.FP16 if in_dtype == jnp.float16 else MatmulType.BF16
    if hints is None and solution_id < 0:
        # arch-aware defaults (reference auto-enables hp on gfx90a,
        # fp4.cc:24-34,189-191; see solution.default_hints)
        hints = solution_mod.default_hints(b_type=element_b)
    sid = resolve_solution(size_m, size_n, size_k, element_b, mfma,
                           solution_id=solution_id, hints=hints)
    # fp16 activations compute in bf16 (or f32 with a high-precision
    # solution) and cast back. Documented deviation from the reference's
    # true-fp16 MFMA path.
    if sid.high_precision:
        out = fused.fused_mul(a.astype(jnp.float32), b, s,
                              jnp.asarray(global_scale, jnp.float32),
                              sid=sid, out_dtype=jnp.float32,
                              interpret=interpret)
        return out.astype(in_dtype if in_dtype != jnp.float32 else jnp.float32)
    out = fused.fused_mul(a.astype(jnp.bfloat16), b, s,
                          jnp.asarray(global_scale, jnp.float32),
                          sid=sid, out_dtype=jnp.bfloat16,
                          interpret=interpret)
    return out.astype(in_dtype) if in_dtype != jnp.bfloat16 else out


def mul_nvfp4_a16(a, b, s, global_scale, size_m, size_n, size_k,
                  solution_id: int = -1, *, interpret: bool = False,
                  hints: Optional[SolutionHints] = None):
    """c = (a @ dequant_nvfp4(b, s).T_layout) * global_scale -> (m, n).

    API parity with petit_kernel.mul_nvfp4_a16 (petit_kernel/__init__.py:
    37-47); b/s are this framework's repack_nvfp4 / process_nvfp4_scales
    outputs (opaque layout, as in the reference). hints: optional
    SolutionHints; require_high_precision selects the f32/HIGHEST path.
    """
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.NVFP4, interpret=interpret, hints=hints)


def mul_mxfp4_a16(a, b, s, global_scale, size_m, size_n, size_k,
                  solution_id: int = -1, *, interpret: bool = False,
                  hints: Optional[SolutionHints] = None):
    """MXFP4 variant (reference: GemmMxFp4Fp16Grid overriding element_b,
    gemm_fp4_fp16_grid.cc:79-95)."""
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.MXFP4, interpret=interpret, hints=hints)


def mul_mxfp4z_a16(a, b, s, global_scale, size_m, size_n, size_k,
                   solution_id: int = -1, *, interpret: bool = False,
                   hints: Optional[SolutionHints] = None):
    """ZERO-FREE MXFP4 ("mxfp4z", numerics/reference.quantize_mxfp4z):
    same container and kernel as MXFP4; the tensor contract (no stored-zero
    codes) is the quantizer's."""
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.MXFP4, interpret=interpret, hints=hints)


def _mul_w4a8(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
              element_b: ElementB, r_t=None, acol=None):
    if size_m == 0 or size_n == 0 or size_k == 0:
        return jnp.zeros((size_m, size_n), dtype=jnp.asarray(a).dtype)
    group = 16 if element_b == ElementB.NVFP4 else 32
    a, b, s = _validate_and_prepare(a, b, s, size_m, size_n, size_k, group)
    in_dtype = a.dtype
    if solution_id is not None and solution_id >= 0:
        sid = SolutionId.from_repr(solution_id)
        if sid.mfma_type != MatmulType.INT8:
            raise ValueError(
                f"solution {sid} is not an INT8 (W4A8) solution")
        resolve_solution(size_m, size_n, size_k, element_b,
                         MatmulType.INT8, solution_id=solution_id)
    out = fused.fused_mul_w4a8(a.astype(jnp.bfloat16), b, s,
                               jnp.asarray(global_scale, jnp.float32),
                               out_dtype=jnp.bfloat16, r_t=r_t, acol=acol)
    return out.astype(in_dtype) if in_dtype != jnp.bfloat16 else out


def mul_nvfp4_a8(a, b, s, global_scale, size_m, size_n, size_k,
                 solution_id: int = -1, *, interpret: bool = False,
                 r_t=None, acol=None):
    """W4A8: same NVFP4 operands as mul_nvfp4_a16, but activations are
    quantized per token to int8 and the product runs on the int8 tensor
    cores — the analog of the reference's kMatmulMfmaTypeFp8 third compute
    type (gemm.h:63-67, dequant.cuh:326-363). Opt-in numerics trade
    (per-column weight requantization + int8 rounding); quality-gate before
    serving with it (tools/quality_gate.py). Plain XLA on every platform,
    so `interpret` has no effect."""
    del interpret
    return _mul_w4a8(a, b, s, global_scale, size_m, size_n, size_k,
                     solution_id, ElementB.NVFP4, r_t=r_t, acol=acol)


def mul_mxfp4_a8(a, b, s, global_scale, size_m, size_n, size_k,
                 solution_id: int = -1, *, interpret: bool = False,
                 r_t=None, acol=None):
    """MXFP4 W4A8 variant (see mul_nvfp4_a8)."""
    del interpret
    return _mul_w4a8(a, b, s, global_scale, size_m, size_n, size_k,
                     solution_id, ElementB.MXFP4, r_t=r_t, acol=acol)


def mul_nvfp4p2_a16(a, b, s, global_scale, size_m, size_n, size_k,
                    solution_id: int = -1, *, interpret: bool = False,
                    hints: Optional[SolutionHints] = None):
    """NVFP4 with power-of-two scales (beyond-reference format "nvfp4p2",
    numerics/reference.quantize_nvfp4_pow2): identical container, layout
    and kernel to NVFP4; the format is a quantizer contract."""
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.NVFP4, interpret=interpret, hints=hints)


def mul_nvfp4p2z_a16(a, b, s, global_scale, size_m, size_n, size_k,
                     solution_id: int = -1, *, interpret: bool = False,
                     hints: Optional[SolutionHints] = None):
    """ZERO-FREE nvfp4p2 ("nvfp4p2z", numerics/reference.
    quantize_nvfp4_pow2z): same container and kernel as NVFP4; no stored
    zero codes by the quantizer's contract."""
    return _mul(a, b, s, global_scale, size_m, size_n, size_k, solution_id,
                ElementB.NVFP4, interpret=interpret, hints=hints)


# ---------------------------------------------------------------------------
# Differentiable wrapper (custom VJP): lets gradients flow through the FP4
# GEMM for LoRA-style finetuning / the multichip train dry run. Forward is
# the FP4 GEMM; backward dequantizes B once and runs a dense GEMM for dA.
# Quantized operands get float0 cotangents (frozen); global_scale gets a
# real gradient.
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def mul_fp4_diff(fmt: str, size_k: int, a, b, s, gs):
    m, n = a.shape[0], b.shape[1]
    mul = {"nvfp4": mul_nvfp4_a16, "nvfp4p2": mul_nvfp4p2_a16,
           "nvfp4p2z": mul_nvfp4p2z_a16, "mxfp4z": mul_mxfp4z_a16,
           "w4a8": mul_nvfp4_a8, "mxfp4": mul_mxfp4_a16}[fmt]
    return mul(a, b, s, gs, m, n, size_k, -1)


def _mul_fp4_fwd(fmt, size_k, a, b, s, gs):
    y = mul_fp4_diff(fmt, size_k, a, b, s, gs)
    return y, (a, b, s, gs, y)


def _mul_fp4_bwd(fmt, size_k, res, g):
    a, b, s, gs, y = res
    deq = fused.dequant(b, s)                                 # (kp, n) bf16
    w = deq[:size_k] * jnp.asarray(gs, jnp.float32).astype(jnp.bfloat16)
    da = jnp.dot(g.astype(jnp.bfloat16), w.T,
                 preferred_element_type=jnp.float32).astype(a.dtype)
    gsf = jnp.asarray(gs, jnp.float32)
    dgs = jnp.where(gsf != 0,
                    jnp.sum(g.astype(jnp.float32) * y.astype(jnp.float32))
                    / gsf, 0.0).reshape(jnp.shape(gs))
    f0 = jax.dtypes.float0
    return (da, np.zeros(b.shape, f0), np.zeros(s.shape, f0),
            dgs.astype(jnp.float32) if jnp.asarray(gs).dtype != f0 else None)


mul_fp4_diff.defvjp(_mul_fp4_fwd, _mul_fp4_bwd)


def get_fp4_solutions(size_m: int, size_n: int, size_k: int,
                      a_type=jnp.bfloat16, c_type=jnp.bfloat16,
                      element_b: ElementB = ElementB.NVFP4) -> list[int]:
    """Feasible solution reprs for a shape (reference GetNvFp4Solutions,
    fp4.cc:262-283)."""
    mfma = MatmulType.FP16 if a_type == jnp.float16 else MatmulType.BF16
    sols = solution_mod.get_solutions(size_m, size_n, size_k, element_b, mfma)
    sols += solution_mod.get_solutions(size_m, size_n, size_k, element_b,
                                       mfma, high_precision=True)
    return [s.repr() for s in sols]
