"""SolutionId encoding, feasibility, heuristic chooser, dispatch semantics.
Analog of the reference's solution-space machinery tests (SolutionId
Repr/FromRepr bijection gemm.h:94-104, chooser algo_chooser.cc:64-132)."""

import pytest

from petit_jax.ops import solution as S
from petit_jax.ops import gemm as G
from petit_jax.ops.solution import SolutionId, ElementB, MatmulType


def test_repr_roundtrip():
    for bm in (16, 64, 512):
        for bn in (16, 128, 1024):
            for bk in (512, 1024):
                for eb in (ElementB.NVFP4, ElementB.MXFP4):
                    for mt in (MatmulType.BF16, MatmulType.FP16):
                        for hp in (False, True):
                            sid = SolutionId(bm, bn, bk, eb, mt, hp)
                            assert SolutionId.from_repr(sid.repr()) == sid


def test_repr_distinct():
    reprs = {s.repr() for s in S.get_solutions(16, 8192, 8192)}
    assert len(reprs) == len(S.get_solutions(16, 8192, 8192))


def test_feasibility_k_divisibility():
    # k=640 pads to 1024: bk=512 gives two k-steps, bk=1024 one; a split
    # must divide the k-steps
    assert S.is_feasible(SolutionId(16, 128, 512), 16, 128, 640)
    assert S.is_feasible(SolutionId(16, 128, 1024, num_stages=1),
                         16, 128, 640)
    assert S.is_feasible(SolutionId(16, 128, 512, split_k=2), 16, 128, 640)
    assert not S.is_feasible(SolutionId(16, 128, 512, split_k=4),
                             16, 128, 640)
    with pytest.raises(AssertionError):      # not a block_k of the kernel
        SolutionId(16, 128, 2048)


def test_feasibility_group_minimum():
    # stride-16 scale rows for both formats (MXFP4 duplicated offline):
    # block_k 512 is feasible for MXFP4 too since the stride-16 change
    assert S.is_feasible(SolutionId(16, 128, 512, ElementB.MXFP4),
                         16, 128, 1024)
    assert S.is_feasible(SolutionId(16, 128, 1024, ElementB.MXFP4,
                                    num_stages=1), 16, 128, 1024)
    assert S.is_feasible(SolutionId(16, 128, 512, ElementB.NVFP4),
                         16, 128, 1024)
    assert not S.is_feasible(SolutionId(16, 128, 1024, ElementB.MXFP4,
                                        split_k=2),
                             16, 128, 1024)  # one k-step cannot split


def test_get_solutions_nonempty_llama_shapes():
    # the reference's active bench suite shapes (tools/benchmarks/matmul.py:92-117)
    for (n, k) in [(10240, 8192), (8192, 8192), (57344, 8192), (8192, 28672),
                   (1024, 8192), (8192, 1024), (28672, 8192), (6144, 4096)]:
        for m in (16, 256, 512):
            sols = S.get_solutions(m, n, k)
            assert sols, (m, n, k)
            sid = S.choose_default_solution(m, n, k)
            assert S.is_feasible(sid, m, n, k)


def test_default_chooser_small_m_prefers_snug_block_m():
    sid = S.choose_default_solution(16, 8192, 8192)
    assert sid.block_m == 16
    sid = S.choose_default_solution(1, 8192, 8192)
    assert sid.block_m == 16
    sid = S.choose_default_solution(512, 8192, 8192)
    assert sid.block_m >= 64


def test_resolve_solution_explicit_id():
    sid = SolutionId(16, 128, 512)
    got = G.resolve_solution(16, 128, 512, ElementB.NVFP4,
                             solution_id=sid.repr())
    assert got == sid
    with pytest.raises(ValueError):  # infeasible explicit id
        G.resolve_solution(16, 128, 640, ElementB.NVFP4,
                           solution_id=SolutionId(16, 128, 512,
                                                  split_k=4).repr())
    with pytest.raises(ValueError):  # element_b mismatch
        G.resolve_solution(16, 128, 512, ElementB.MXFP4,
                           solution_id=sid.repr())


def test_tuned_table_overrides_heuristic():
    sid = SolutionId(32, 256, 512, num_stages=1)
    key = G._table_key(16, 1024, 512, ElementB.NVFP4, MatmulType.BF16,
                       False)
    G.set_tuned_table({key: sid.repr()})
    try:
        assert G.resolve_solution(16, 1024, 512, ElementB.NVFP4) == sid
        # the grouped resolver falls back to the dense entry for the shape
        assert G.resolve_grouped_solution(16, 1024, 512,
                                          ElementB.NVFP4) == sid
        gsid = SolutionId(16, 256, 512, num_stages=2)
        gkey = G._table_key(16, 1024, 512, ElementB.NVFP4,
                            MatmulType.BF16, False, grouped=True)
        G.set_tuned_table({key: sid.repr(), gkey: gsid.repr()})
        # ... but a grouped entry wins when present
        assert G.resolve_grouped_solution(16, 1024, 512,
                                          ElementB.NVFP4) == gsid
        assert G.resolve_solution(16, 1024, 512, ElementB.NVFP4) == sid
    finally:
        G.set_tuned_table({})


def test_resolve_grouped_rejects_weight_cache():
    """The grouped kernel's expert takes the grid axis split-K uses: an
    explicit split-K id is rejected, -1 resolution switches it off."""
    sk = SolutionId(16, 512, 512, split_k=2)
    with pytest.raises(ValueError, match="split_k"):
        G.resolve_grouped_solution(32, 1024, 1024, ElementB.NVFP4,
                                   solution_id=sk.repr())
    assert G.resolve_grouped_solution(16, 8192, 8192,
                                      ElementB.NVFP4).split_k == 1


def test_mbucket():
    assert G._m_bucket(1) == 1 and G._m_bucket(32) == 32
    assert G._m_bucket(33) == 64 and G._m_bucket(300) == 512


def test_hints_require_high_precision_resolution():
    """SolutionHints.require_high_precision is consumed (reference threads
    PetitSolutionHints through selection, fp4.cc:189-191,
    algo_chooser.cc:76-80): -1 resolution yields hp solutions, explicit
    non-hp ids are rejected, matching-b_type is enforced."""
    hints = S.SolutionHints(require_high_precision=True)
    sid = G.resolve_solution(16, 4096, 4096, ElementB.NVFP4, hints=hints)
    assert sid.high_precision
    # explicit non-hp id + hp hints -> ValueError
    plain = G.resolve_solution(16, 4096, 4096, ElementB.NVFP4)
    assert not plain.high_precision
    with pytest.raises(ValueError):
        G.resolve_solution(16, 4096, 4096, ElementB.NVFP4,
                           solution_id=plain.repr(), hints=hints)
    # b_type mismatch -> ValueError
    with pytest.raises(ValueError):
        G.resolve_solution(16, 4096, 4096, ElementB.MXFP4, hints=hints)


def test_default_hints_no_hp_on_gpu():
    h = S.default_hints("NVIDIA H100 80GB HBM3")
    assert not h.require_high_precision


def test_solution_id_new_fields_roundtrip():
    """Warps, stages and split-K round-trip through the int repr and each
    changes it."""
    base = SolutionId(32, 64, 1024, ElementB.MXFP4)
    seen = set()
    for w in (1, 2, 4, 8):
        for st in (1, 2, 3, 4, 7):
            for sk in (1, 2, 4, 8, 16, 1024):
                sid = SolutionId(32, 64, 1024, ElementB.MXFP4,
                                 num_warps=w, num_stages=st, split_k=sk)
                assert SolutionId.from_repr(sid.repr()) == sid
                seen.add(sid.repr())
    assert len(seen) == 4 * 5 * 6 and base.repr() in seen
    with pytest.raises(AssertionError):
        SolutionId(16, 128, 512, split_k=3)       # powers of two only
    with pytest.raises(AssertionError):
        SolutionId(16, 96, 512)


def test_device_params_unknown_kind_raises():
    """An unknown device kind gets no default table."""
    assert S.device_params("NVIDIA H100 80GB HBM3").sms == 132
    assert S.device_params("cpu").smem_bytes == 232448
    with pytest.raises(ValueError, match="device kind"):
        S.device_params("AMD Instinct MI300X")


def test_default_chooser_fills_the_card_at_decode():
    """At decode batch the heuristic splits K until about two blocks per SM
    are in flight, and never at prefill-sized m."""
    sid = S.choose_default_solution(16, 8192, 8192)
    blocks = (8192 // sid.block_n) * sid.split_k
    assert sid.split_k > 1 and blocks >= 2 * 132
    assert S.choose_default_solution(512, 28672, 4096).split_k == 1


def test_hints_hp_mul_matches_oracle():
    """mul_nvfp4_a16(hints=require_high_precision) runs the hp kernel path
    and still matches the dequant oracle."""
    import numpy as np
    import jax.numpy as jnp
    import petit_jax as pk
    from petit_jax.numerics import reference as refn

    rng = np.random.default_rng(5)
    m, n, k = 8, 128, 256
    nib = rng.integers(0, 16, size=(n, k), dtype=np.uint8)
    from petit_jax.numerics import formats
    qw = formats.pack_fp4_pairs(nib)
    scales = ((rng.integers(4, 11, size=(n, k // 16), dtype=np.uint8) << 3)
              | rng.integers(0, 8, size=(n, k // 16), dtype=np.uint8))
    b = pk.repack_nvfp4(qw, n, k)
    s = pk.process_nvfp4_scales(scales, n, k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    hints = pk.PetitSolutionHints(require_high_precision=True)
    out = pk.mul_nvfp4_a16(jnp.asarray(a), b, s, 1.0, m, n, k,
                           interpret=True, hints=hints)
    wd = refn.dequant_nvfp4(qw, scales)   # (n, k) f32
    expect = a @ wd.T
    np.testing.assert_allclose(np.asarray(out, np.float32), expect,
                               rtol=1e-2, atol=1e-2)
