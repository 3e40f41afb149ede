"""Kernel solution space: config encoding, registry, feasibility, heuristic.

Analog of the reference's SolutionId 64-bit bitfield + dispatcher +
heuristic chooser (lib/gemm/rocm/quantization/gemm.h:33-105,
fp4/gemm_fp4_fp16_grid.cc:11-34, fp4/algo_chooser.cc:14-132).  Where the
reference enumerates 234 precompiled HIP kernels, here a SolutionId maps to a
parameterization of one Pallas (Triton) kernel factory: block shape, warps,
pipeline stages and the split-K factor. "Compilation" happens lazily per
(solution, shape) via jit and is cached by XLA.

The integer `repr` round-trips (SolutionId.from_repr(sid.repr()) == sid) and
is the persisted autotune-table key, like the reference's
SolutionId::Repr()/FromRepr bijection (gemm.h:94-104).
"""

from __future__ import annotations

import dataclasses
import enum


class ElementB(enum.IntEnum):
    """Quantized weight format (reference MatmulElementB, gemm.h:56-61)."""
    INT4 = 0       # reserved, not implemented (parity with reference enum)
    NVFP4 = 1
    MXFP4 = 2


class MatmulType(enum.IntEnum):
    """Activation/output dtype class (reference MatmulMfmaType, gemm.h:63-67).

    INT8 is the analog of the reference's third mfma type
    (kMatmulMfmaTypeFp8 + the CDNA3 bf8 fast dequant,
    dequant.cuh:326-363): W4A8 — activations quantized per token to int8,
    FP4 weights requantized to int8 with per-column scales, int8 tensor-core
    dots. Opt-in numerics trade for the compute-bound large-m regime."""
    FP16 = 0
    BF16 = 1
    INT8 = 2


# Block quanta: block_m and block_n are powers of two (Triton), block_k is
# one or two 512-deep layout chunks per k-loop iteration (64 word rows each,
# see ops/kernels/fused.py); weights are repacked with K zero-padded to 512
# (layout.K_PAD), so any logical k with k % 128 == 0 is served.
BLOCK_M_UNIT = 16
BLOCK_N_UNIT = 16
BLOCK_K_UNIT = 512


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


@dataclasses.dataclass(frozen=True, order=True)
class SolutionId:
    block_m: int
    block_n: int
    block_k: int = BLOCK_K_UNIT
    element_b: ElementB = ElementB.NVFP4
    mfma_type: MatmulType = MatmulType.BF16
    high_precision: bool = False
    num_warps: int = 4
    num_stages: int = 3
    # Split the k loop over this many blocks and add the partial sums in a
    # second pass: at decode batch the n-blocks alone are too few to fill
    # the card's SMs.
    split_k: int = 1

    def __post_init__(self):
        assert _pow2(self.block_m) and self.block_m >= BLOCK_M_UNIT
        assert _pow2(self.block_n) and self.block_n >= BLOCK_N_UNIT
        assert self.block_k in (512, 1024), self.block_k
        assert self.num_warps in (1, 2, 4, 8)
        assert 1 <= self.num_stages <= 7
        assert _pow2(self.split_k) and self.split_k <= 32768

    # 64-bit layout:
    # [split:4][stages:3][warps:3][m:8][n:10][k:4][element_b:3][mfma:2][hp:1]
    def repr(self) -> int:
        return ((self.split_k.bit_length() - 1) << 34 |
                self.num_stages << 31 |
                (self.num_warps.bit_length() - 1) << 28 |
                (self.block_m // BLOCK_M_UNIT) << 20 |
                (self.block_n // BLOCK_N_UNIT) << 10 |
                (self.block_k // BLOCK_K_UNIT) << 6 |
                int(self.element_b) << 3 |
                int(self.mfma_type) << 1 |
                int(self.high_precision))

    @classmethod
    def from_repr(cls, r: int) -> "SolutionId":
        return cls(
            block_m=((r >> 20) & 0xFF) * BLOCK_M_UNIT,
            block_n=((r >> 10) & 0x3FF) * BLOCK_N_UNIT,
            block_k=((r >> 6) & 0xF) * BLOCK_K_UNIT,
            element_b=ElementB((r >> 3) & 0x7),
            mfma_type=MatmulType((r >> 1) & 0x3),
            high_precision=bool(r & 1),
            num_warps=1 << ((r >> 28) & 0x7),
            num_stages=(r >> 31) & 0x7,
            split_k=1 << ((r >> 34) & 0xF),
        )

    @property
    def group_size(self) -> int:
        return 16 if self.element_b == ElementB.NVFP4 else 32


@dataclasses.dataclass(frozen=True)
class SolutionHints:
    """Soft preferences threaded through solution resolution, analog of
    PetitSolutionHints (gemm.h:110-117). require_high_precision restricts
    resolution to high-precision solutions (f32 A operand, IEEE f32 dots)
    and rejects explicit non-hp solution ids, mirroring the reference's
    precision-flag parity filter (algo_chooser.cc:68-84)."""
    a_type: MatmulType = MatmulType.BF16
    b_type: ElementB = ElementB.NVFP4
    c_type: MatmulType = MatmulType.BF16
    require_high_precision: bool = False


def default_hints(device_kind: str | None = None,
                  b_type: ElementB = ElementB.NVFP4) -> SolutionHints:
    """Arch-aware default hints, analog of the reference's automatic
    high-precision enable on gfx90a (lib/pybind/fp4.cc:24-34), whose MFMA
    flushes denormal inputs. The kernel's decode never produces a denormal
    (stored zeros decode to +0.0 by an integer mask, every other E2M1 value
    times an E4M3 scale is a normal bf16), so no device needs the
    high-precision path for correctness; the hint stays the user's choice."""
    del device_kind
    return SolutionHints(b_type=b_type)


@dataclasses.dataclass(frozen=True)
class DeviceParams:
    """What feasibility and the heuristic need to know of a card."""
    smem_bytes: int     # shared memory one block may use
    sms: int            # streaming multiprocessors to fill


# Keyed by jax.devices()[0].device_kind. "cpu" mirrors the H100 so the CPU
# tests exercise the same choices; any other kind is an error.
_DEVICE_PARAMS: dict[str, DeviceParams] = {
    "NVIDIA H100 80GB HBM3": DeviceParams(232448, 132),
    "NVIDIA H100": DeviceParams(232448, 132),
    "NVIDIA H100 NVL": DeviceParams(232448, 132),
    "NVIDIA H100 PCIe": DeviceParams(232448, 114),
    "NVIDIA H200": DeviceParams(232448, 132),
    "cpu": DeviceParams(232448, 132),
}


def device_params(kind: str | None = None) -> DeviceParams:
    if kind is None:
        import jax
        kind = jax.devices()[0].device_kind
    try:
        return _DEVICE_PARAMS[kind]
    except KeyError:
        raise ValueError(
            f"no solution table for device kind {kind!r}; add it to "
            "ops/solution._DEVICE_PARAMS") from None


_BLOCK_MS = (16, 32, 64, 128)
_BLOCK_NS = (32, 64, 128, 256)
_BLOCK_KS = (512, 1024)
_WARPS = (4, 8)
_STAGES = (2, 3, 4)
_SPLITS = (1, 2, 4, 8, 16)


def _padded_k(k: int, group_size: int = 16) -> int:
    from . import layout
    return layout.padded_k(k, layout.pad_multiple(group_size))


def smem_estimate(sid: SolutionId) -> int:
    """Shared memory of one block: each pipeline stage holds the k-step's A
    tile, packed words and scale rows; the dequantized B operand of one dot
    is staged once."""
    bm, bn, bk = sid.block_m, sid.block_n, sid.block_k
    a_elt = 4 if sid.high_precision else 2
    stage = bm * bk * a_elt + bk * bn // 2 + bk * bn // 8
    operand = (bk // 8) * bn * a_elt
    return sid.num_stages * stage + operand


def is_feasible(sid: SolutionId, m: int, n: int, k: int) -> bool:
    """Feasibility filter, analog of algo_chooser.cc:68-84 (divisibility and
    resource checks). M and N are padded by the host wrapper and K is
    repacked with zero-padding to layout.K_PAD, so divisibility is checked
    against the padded K; block_n/block_m are soft-capped to avoid absurd
    padding."""
    kp = _padded_k(k, sid.group_size)
    if kp % sid.block_k != 0 or (kp // sid.block_k) % sid.split_k != 0:
        return False
    if sid.block_m > 2 * max(m, BLOCK_M_UNIT):
        return False
    if sid.block_n > 2 * max(n, BLOCK_N_UNIT):
        return False
    return smem_estimate(sid) <= device_params().smem_bytes


def get_solutions(m: int, n: int, k: int,
                  element_b: ElementB = ElementB.NVFP4,
                  mfma_type: MatmulType = MatmulType.BF16,
                  high_precision: bool = False) -> list[SolutionId]:
    """Enumerate feasible solutions for a problem shape (analog of
    GemmGetSolutions, algo_chooser.cc:14-62)."""
    out = []
    for bm in _BLOCK_MS:
        for bn in _BLOCK_NS:
            for bk in _BLOCK_KS:
                for w in _WARPS:
                    for st in _STAGES:
                        for sk in _SPLITS:
                            sid = SolutionId(bm, bn, bk, element_b,
                                             mfma_type, high_precision,
                                             w, st, sk)
                            if is_feasible(sid, m, n, k):
                                out.append(sid)
    return out


def choose_default_solution(m: int, n: int, k: int,
                            element_b: ElementB = ElementB.NVFP4,
                            mfma_type: MatmulType = MatmulType.BF16,
                            high_precision: bool = False) -> SolutionId:
    """Heuristic default chooser (analog of ChooseDefaultFp4Fp16Solution,
    algo_chooser.cc:64-132): a snug block_m, a block_n that divides n, and
    split-K until about two blocks per SM are in flight (the decode regime
    has few n-blocks and one m-block)."""
    group = 16 if element_b == ElementB.NVFP4 else 32
    iters = _padded_k(k, group) // BLOCK_K_UNIT
    bm = 16
    while bm < min(m, 64):
        bm *= 2
    bn = 128
    while bn > BLOCK_N_UNIT and n % bn:
        bn //= 2
    blocks = -(-n // bn) * -(-m // bm)
    target = 2 * device_params().sms
    split = 1
    while (blocks * split < target and split < 16
           and iters % (2 * split) == 0):
        split *= 2
    sid = SolutionId(bm, bn, BLOCK_K_UNIT, element_b, mfma_type,
                     high_precision, 4, 3, split)
    while not is_feasible(sid, m, n, k) and sid.num_stages > 1:
        sid = dataclasses.replace(sid, num_stages=sid.num_stages - 1)
    if not is_feasible(sid, m, n, k):
        sols = get_solutions(m, n, k, element_b, mfma_type, high_precision)
        if not sols:
            raise ValueError(f"no feasible solution for m={m} n={n} k={k}")
        sid = sols[0]
    return sid
