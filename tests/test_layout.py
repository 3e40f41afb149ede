"""Round-trip tests for the petit weight/scale layout, mirroring the
reference's NvFp4ToPetitFp4Test::TestConvert (repack -> dequant-from-tiled
must equal dequant-from-native, quantization_utils_fp4_test.cc:103-133)."""

import numpy as np
import pytest

from petit_jax.numerics import formats, reference
from petit_jax.ops import layout


@pytest.mark.parametrize(("n", "k"), [(16, 128), (32, 256), (48, 512), (128, 1024)])
def test_repack_roundtrip_nibbles(n, k):
    rng = np.random.default_rng(n * k)
    nib = rng.integers(0, 16, size=(n, k), dtype=np.uint8)
    nib[nib == 8] = 0  # repack masks negative zero; compare mask-free
    qw = formats.pack_fp4_pairs(nib)
    words = layout.repack_fp4_weights(qw, n, k)
    kp = layout.padded_k(k)
    assert words.shape == (kp // 8, n) and words.dtype == np.uint32
    back = layout.unpack_fp4_weights(words, n, k)
    assert np.array_equal(back, nib)


def test_repack_masks_negative_zero():
    n, k = 16, 128
    nib = np.full((n, k), 8, dtype=np.uint8)  # all negative zeros
    words = layout.repack_fp4_weights(formats.pack_fp4_pairs(nib), n, k)
    # stored zero is q-code t=1, sign +0, in every slot; under the v6 bit
    # placement that is 0x449 per half (t=1 at bits 6 / 3 / 0 / 10)
    assert np.all(words == 0x04490449)
    back = layout.unpack_fp4_weights(words, n, k)
    assert np.all(back == 0)  # decodes as +0, not -0


def test_repack_accepts_int32_view():
    rng = np.random.default_rng(0)
    n, k = 16, 256
    qw = rng.integers(0, 256, size=(n, k // 2), dtype=np.uint8)
    w1 = layout.repack_fp4_weights(qw, n, k)
    w2 = layout.repack_fp4_weights(qw.view(np.int32), n, k)
    assert np.array_equal(w1, w2)


def test_repack_validation():
    with pytest.raises(ValueError):
        layout.repack_fp4_weights(np.zeros((16, 50), np.uint8), 16, 100)
    with pytest.raises(ValueError):
        layout.repack_fp4_weights(np.zeros((17, 64), np.uint8), 17, 128)
    with pytest.raises(ValueError):
        layout.repack_fp4_weights(np.zeros((16, 60), np.uint8), 16, 128)


def test_process_scales_rejects_overrange_e8m0():
    """MXFP4 scale bytes 253/254 (2^126, 2^127) violate the int-scale
    kernel's exponent-add range (sign-bit carry -> silent sign flips);
    process_fp4_scales must reject them (round-2 advisor, medium)."""
    n, k = 16, 128
    for byte in (253, 254):
        scales = np.full((n, k // 32), byte, np.uint8)
        with pytest.raises(ValueError, match="exponent-add range"):
            layout.process_fp4_scales(scales, n, k, group_size=32)
    # 252 is the documented maximum and must pass
    layout.process_fp4_scales(np.full((n, k // 32), 252, np.uint8), n, k,
                              group_size=32)


@pytest.mark.parametrize("fmt", ["nvfp4", "mxfp4"])
def test_dequant_from_layout_matches_native(fmt):
    rng = np.random.default_rng(42)
    n, k = 64, 512
    group = 16 if fmt == "nvfp4" else 32
    nib = rng.integers(0, 16, size=(n, k), dtype=np.uint8)
    nib[nib == 8] = 0
    qw = formats.pack_fp4_pairs(nib)
    if fmt == "nvfp4":
        scales = (rng.integers(0, 127, size=(n, k // group), dtype=np.uint8)
                  & np.uint8(0x7E))  # positive, non-NaN
        native = reference.dequant_nvfp4(qw, scales)
    else:
        # bytes 253/254 rejected by process_fp4_scales (kernel precondition)
        scales = rng.integers(1, 253, size=(n, k // group), dtype=np.uint8)
        native = reference.dequant_mxfp4(qw, scales)
    words = layout.repack_fp4_weights(qw, n, k,
                                      pad_to=layout.pad_multiple(group))
    st = layout.process_fp4_scales(scales, n, k, group_size=group)
    # stride-16 rows for both formats (MXFP4 duplicated per half-group)
    assert st.shape == (layout.padded_k(k, layout.pad_multiple(group))
                        // layout.SCALE_STRIDE, n)
    tiled = layout.dequant_from_layout(words, st, n, k, group_size=group)
    assert np.array_equal(tiled, native.T)  # bit-exact


def test_scale_validation():
    n, k = 16, 256
    bad = np.full((n, k // 16), 0x80, np.uint8)  # negative scales
    with pytest.raises(ValueError):
        layout.process_fp4_scales(bad, n, k, group_size=16)
    nan = np.full((n, k // 16), 0x7F, np.uint8)
    with pytest.raises(ValueError):
        layout.process_fp4_scales(nan, n, k, group_size=16)
    mx_nan = np.full((n, k // 32), 0xFF, np.uint8)
    with pytest.raises(ValueError):
        layout.process_fp4_scales(mx_nan, n, k, group_size=32)
