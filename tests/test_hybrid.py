"""Hybrid FP4+BF16 mode: correctness vs composed oracle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from petit_jax.ops import hybrid
from petit_jax.numerics import reference as refn


@pytest.mark.parametrize(("m", "n", "k", "bnf", "bnd"), [
    (16, 512, 512, 256, 256),
    (16, 1024, 1024, 384, 128),
    (33, 2048, 768, 256, 256),   # padded m, padded k (768 -> 1024)
])
def test_hybrid_mul_vs_oracle(m, n, k, bnf, bnd):
    rng = np.random.default_rng(m + n + k)
    w = rng.standard_normal((k, n)).astype(np.float32) / 8
    # make a few columns clearly salient: they must land in the dense part
    w[:, rng.choice(n, 5, replace=False)] *= 50
    hq = hybrid.quantize_hybrid(w, block_nf=bnf, block_nd=bnd)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)

    c = hybrid.mul_hybrid(a, hq, interpret=True)
    assert c.shape == (m, n)

    # oracle: quantize-dequantize the SAME column split, dense cols exact
    af = np.asarray(a, np.float32)
    nn = n // (bnf + bnd)
    nd = nn * bnd
    sal = np.abs(w).max(axis=0)
    dense_idx = np.sort(np.argsort(sal)[-nd:])
    mask = np.ones(n, bool); mask[dense_idx] = False
    wq = w.copy()
    qw, scales, gs = refn.quantize_nvfp4(w[:, mask].T)
    wq[:, mask] = refn.dequant_nvfp4(qw, scales).T * gs
    wq[:, dense_idx] = w[:, dense_idx].astype(jnp.bfloat16).astype(np.float32)
    ref = af @ wq
    np.testing.assert_allclose(np.asarray(c, np.float32), ref,
                               rtol=0.02, atol=0.02)


def test_hybrid_salient_columns_exact():
    """Salient (dense-kept) columns of the product must be bit-close to the
    unquantized product — the accuracy rationale for the mode."""
    rng = np.random.default_rng(0)
    k, n = 512, 512
    w = rng.standard_normal((k, n)).astype(np.float32) / 8
    big = rng.choice(n, 8, replace=False)
    w[:, big] *= 100
    hq = hybrid.quantize_hybrid(w, block_nf=256, block_nd=256)
    a = jnp.asarray(rng.standard_normal((4, k)), jnp.bfloat16)
    c = np.asarray(hybrid.mul_hybrid(a, hq, interpret=True), np.float32)
    ref = (np.asarray(a, np.float32)
           @ w.astype(jnp.bfloat16).astype(np.float32))
    for col in big:  # salient columns: dense path, only bf16 rounding
        np.testing.assert_allclose(c[:, col], ref[:, col], rtol=2e-2)


def test_llama_forward_hybrid_fmt():
    """fmt="hybrid" end-to-end: wide layers split, narrow layers fall back
    to pure nvfp4; forward stays close to the dense model."""
    from petit_jax.models import llama

    cfg = llama.LlamaConfig(
        vocab_size=128, hidden_size=512, intermediate_size=1024,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
        max_seq_len=32)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    qparams = llama.quantize_params(params, "hybrid")
    # wide projections got the hybrid split, narrow ones fell back
    l0 = qparams["layers"][0]
    assert "wd" in l0["w_up"]          # n=1024: split
    assert "wd" in l0["w_gate"]
    assert "wd" not in l0["wk"]        # n=128: pure nvfp4 fallback
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, 8), 0,
                              cfg.vocab_size)
    lq, _ = llama.forward(qparams, toks, cfg, fmt="hybrid", interpret=True)
    ld, _ = llama.forward(params, toks, cfg)
    lq = np.asarray(lq, np.float32)
    ld = np.asarray(ld, np.float32)
    assert np.isfinite(lq).all()
    # quantization-noise band: logits track the dense model
    assert np.abs(lq - ld).mean() < 0.5
