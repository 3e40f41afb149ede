"""Correctness sweep over the kernel's solution space.

Analog of the reference's 49-case (m,n,k) x partition sweep
(lib/gemm/rocm/quantization/fp4/gemm_fp4_fp16_rocm_test.cc:322-425): a fixed
list of SolutionIds from the Triton kernel's space — both formats, every
block_m/block_n, both block_k, split-K on and off, warps and stages — each
runs (interpret mode) against the dequant oracle at a shape built to
stress its geometry: ragged m (padding rows, >= 2 m-blocks), ragged n
(zero-scale padded columns), two k-steps per split, and repack k-padding.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import petit_jax as pk
from petit_jax.numerics import formats, reference as refn
from petit_jax.ops.solution import SolutionId, ElementB

# (block_m, block_n, block_k, num_warps, num_stages, split_k)
_CONFIGS = [
    (16, 32, 512, 4, 2, 1), (16, 64, 512, 4, 3, 1), (16, 128, 512, 4, 3, 2),
    (16, 128, 512, 4, 3, 4), (16, 128, 1024, 4, 1, 1),
    (16, 256, 512, 8, 2, 2), (16, 64, 1024, 8, 2, 2),
    (16, 128, 512, 8, 3, 1), (32, 32, 512, 4, 2, 2), (32, 64, 512, 4, 3, 1),
    (32, 128, 512, 4, 2, 4), (32, 128, 1024, 4, 1, 1),
    (32, 256, 512, 8, 1, 1), (32, 64, 1024, 4, 2, 2),
    (64, 32, 512, 4, 2, 1), (64, 64, 512, 4, 2, 2), (64, 128, 512, 4, 2, 1),
    (64, 64, 1024, 8, 1, 2), (64, 256, 512, 8, 1, 1),
    (128, 64, 512, 8, 1, 1), (128, 128, 512, 8, 1, 2),
    (128, 32, 512, 4, 1, 1), (16, 32, 1024, 4, 2, 4), (64, 32, 1024, 4, 1, 1),
]
_CASES = [(SolutionId(bm, bn, bk, eb, num_warps=w, num_stages=st,
                      split_k=sk), eb)
          for eb in (ElementB.NVFP4, ElementB.MXFP4)
          for (bm, bn, bk, w, st, sk) in _CONFIGS]


def _shape_for(sid: SolutionId):
    """Smallest shape stressing this config: ragged m over a block
    boundary, ragged n (half an extra block -> padded columns), two k-steps
    per split."""
    m = sid.block_m + 5
    n = sid.block_n + max(16, sid.block_n // 2)
    k = 2 * sid.block_k * sid.split_k
    return m, n, k


@pytest.mark.parametrize(
    "sid,eb", _CASES,
    ids=[f"{eb.name}-{s.block_m}x{s.block_n}x{s.block_k}-w{s.num_warps}"
         f"s{s.num_stages}-split{s.split_k}" for s, eb in _CASES])
def test_tuned_config_matches_oracle(sid, eb):
    m, n, k = _shape_for(sid)
    rng = np.random.default_rng(sid.repr() & 0xFFFF)
    nib = rng.integers(0, 16, size=(n, k), dtype=np.uint8)
    qw = formats.pack_fp4_pairs(nib)
    if eb == ElementB.NVFP4:
        raw = ((rng.integers(4, 11, size=(n, k // 16), dtype=np.uint8) << 3)
               | rng.integers(0, 8, size=(n, k // 16), dtype=np.uint8))
        b = pk.repack_nvfp4(qw, n, k)
        s = pk.process_nvfp4_scales(raw, n, k)
        mul = pk.mul_nvfp4_a16
        wd = refn.dequant_nvfp4(qw, raw)
    else:
        raw = rng.integers(118, 132, size=(n, k // 32), dtype=np.uint8)
        b = pk.repack_mxfp4(qw, n, k)
        s = pk.process_mxfp4_scales(raw, n, k)
        mul = pk.mul_mxfp4_a16
        wd = refn.dequant_mxfp4(qw, raw)
    import ml_dtypes
    a = (rng.standard_normal((m, k)) / 4).astype(np.float32)
    # oracle must see the SAME bf16-rounded A the kernel consumes (raw f32
    # vs bf16 input rounding alone reads as ~0.4 rel err on
    # near-cancelling rows)
    a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    gs = np.float32(0.75)
    out = mul(jnp.asarray(a, jnp.bfloat16), b, s, gs, m, n, k,
              sid.repr(), interpret=True)
    expect = (a @ wd.T) * gs
    got = np.asarray(out, np.float32)
    err = np.abs(got - expect) / np.maximum(np.abs(expect), 1.0)
    # reference tolerance discipline: |d| < max(1e-2, 1%)
    assert err.max() < 2e-2, (sid, float(err.max()))


def test_sweep_covers_table():
    """The fixed list must be a non-trivial sweep: both formats, split-K on
    and off, every block size, and distinct solution ids."""
    assert len(_CASES) >= 47, len(_CASES)
    assert any(eb == ElementB.MXFP4 for _, eb in _CASES)
    sids = [s for s, _ in _CASES]
    assert len({s.repr() for s in sids}) == len(sids)
    assert {s.split_k for s in sids} >= {1, 2, 4}
    assert {s.block_m for s in sids} == {16, 32, 64, 128}
    assert {s.block_n for s in sids} == {32, 64, 128, 256}
    assert {s.block_k for s in sids} == {512, 1024}
