"""Paged KV cache == contiguous cache, plus allocator behavior."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from petit_jax.models import llama, paged


@pytest.fixture(scope="module")
def setup():
    cfg = llama.LlamaConfig(
        vocab_size=128, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
        max_seq_len=64)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


@pytest.mark.parametrize("fmt", ["bf16", "nvfp4"])
def test_paged_forward_matches_contiguous(setup, fmt):
    """Prefill + a few decode steps through the paged cache produce the
    same logits as the contiguous cache."""
    cfg, params = setup
    if fmt == "nvfp4":
        params = llama.quantize_params(params, "nvfp4")
    B, T = 2, 8
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, T), 0,
                              cfg.vocab_size)
    # contiguous reference
    cache = llama.init_cache(cfg, B)
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    ref_logits, cache = llama.forward(params, toks, cfg, cache, pos,
                                      fmt=fmt, interpret=True)

    pc = paged.init_paged_cache(cfg, B, page_size=16)
    for b in range(B):
        paged.ensure_capacity(pc, b, T)
    logits, pages = paged.forward_paged(params, toks, cfg, pc.pages,
                                        pc.block_tables, pos,
                                        page_size=pc.page_size, fmt=fmt,
                                        interpret=True)
    pc.pages = pages
    np.testing.assert_allclose(np.asarray(logits, np.float32),
                               np.asarray(ref_logits, np.float32),
                               rtol=2e-2, atol=2e-2)

    # three decode steps
    last = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    ref_last = jnp.argmax(ref_logits[:, -1], -1).astype(jnp.int32)
    assert np.array_equal(np.asarray(last), np.asarray(ref_last))
    for step in range(3):
        p = T + step
        pos1 = jnp.full((B, 1), p, jnp.int32)
        ref_logits, cache = llama.forward(params, ref_last[:, None], cfg,
                                          cache, pos1, fmt=fmt,
                                          interpret=True)
        for b in range(B):
            paged.ensure_capacity(pc, b, p + 1)
        logits, pc.pages = paged.forward_paged(
            params, last[:, None], cfg, pc.pages, pc.block_tables, pos1,
            page_size=pc.page_size, fmt=fmt, interpret=True)
        np.testing.assert_allclose(np.asarray(logits, np.float32),
                                   np.asarray(ref_logits, np.float32),
                                   rtol=2e-2, atol=2e-2)
        last = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        ref_last = jnp.argmax(ref_logits[:, -1], -1).astype(jnp.int32)
        assert np.array_equal(np.asarray(last), np.asarray(ref_last)), step


def test_paged_prefill_is_causal(setup):
    """Regression: paged multi-token prefill equals the no-cache causal
    forward (per-query mask, not last-position-only)."""
    cfg, params = setup
    B, T = 2, 12
    toks = jax.random.randint(jax.random.PRNGKey(9), (B, T), 0,
                              cfg.vocab_size)
    ref_logits, _ = llama.forward(params, toks, cfg)
    pc = paged.init_paged_cache(cfg, B, page_size=16)
    for b in range(B):
        paged.ensure_capacity(pc, b, T)
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    logits, _ = paged.forward_paged(params, toks, cfg, pc.pages,
                                    pc.block_tables, pos,
                                    page_size=pc.page_size)
    np.testing.assert_allclose(np.asarray(logits, np.float32),
                               np.asarray(ref_logits, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_allocator_reuse_and_exhaustion(setup):
    cfg, _ = setup
    pc = paged.init_paged_cache(cfg, batch=2, page_size=16, num_pages=4)
    paged.ensure_capacity(pc, 0, 33)   # 3 pages
    assert len(pc.used[0]) == 3 and len(pc.free) == 1
    paged.ensure_capacity(pc, 1, 16)   # 1 page
    assert not pc.free
    with pytest.raises(RuntimeError):
        paged.ensure_capacity(pc, 1, 17)
    paged.release_slot(pc, 0)
    assert len(pc.free) == 3
    paged.ensure_capacity(pc, 1, 33)   # reuses freed pages
    assert len(pc.used[1]) == 3
