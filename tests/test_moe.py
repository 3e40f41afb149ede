"""MoE grouped FP4 GEMM path: routing math vs dense oracle, tiny Mixtral
forward (BASELINE.json config 4 analog at test scale)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from petit_jax.models import moe, llama
from petit_jax.models.moe import MoEConfig, MixtralConfig


def test_moe_mlp_matches_dense_oracle():
    rng = np.random.default_rng(0)
    T, H, F, E = 16, 128, 256, 4
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    router = jnp.asarray(rng.standard_normal((H, E)) * 0.5, jnp.bfloat16)
    ws = {n: rng.standard_normal((E, kk, nn)).astype(np.float32) / 16
          for n, (kk, nn) in dict(w_gate=(H, F), w_up=(H, F),
                                  w_down=(F, H)).items()}
    qexperts = {n: moe.quantize_moe_linear(ws[n], "mxfp4") for n in ws}
    dexperts = {}
    for n in ws:
        # dense oracle from the exact dequantized expert weights
        from petit_jax.ops import layout as L
        E_, kk, nn = ws[n].shape  # logical dims (repack pads k)
        deq = np.stack([
            L.dequant_from_layout(
                np.asarray(qexperts[n]["words"][e]),
                np.asarray(qexperts[n]["scales"][e]), nn, kk, group_size=32)
            * float(qexperts[n]["gs"][e]) for e in range(E_)])
        dexperts[n] = {"w": jnp.asarray(deq, jnp.bfloat16)}

    cfg = MoEConfig(num_experts=E, top_k=2, capacity_factor=8.0)  # no drops
    out_q = moe.moe_mlp(x, router, qexperts, cfg, fmt="mxfp4",
                        interpret=True)
    out_d = moe._dense_moe(x, router, dexperts, cfg)
    np.testing.assert_allclose(np.asarray(out_q, np.float32),
                               np.asarray(out_d, np.float32),
                               rtol=0.05, atol=0.05)


def test_moe_capacity_drops_overflow():
    """With capacity_factor tiny, overflow tokens must contribute zero (not
    garbage)."""
    rng = np.random.default_rng(1)
    T, H, F, E = 32, 128, 128, 2
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    # router sends everything to expert 0
    router = jnp.asarray(np.stack([np.ones(H), -np.ones(H)], 1),
                         jnp.bfloat16)
    ws = {n: rng.standard_normal((E, kk, nn)).astype(np.float32) / 16
          for n, (kk, nn) in dict(w_gate=(H, F), w_up=(H, F),
                                  w_down=(F, H)).items()}
    qex = {n: moe.quantize_moe_linear(ws[n], "mxfp4") for n in ws}
    cfg = MoEConfig(num_experts=E, top_k=1, capacity_factor=0.5)
    out = moe.moe_mlp(x, router, qex, cfg, fmt="mxfp4", interpret=True)
    out = np.asarray(out, np.float32)
    assert np.isfinite(out).all()
    # capacity = ceil(32*1/2*0.5)=8 -> at most 8 tokens served
    nonzero_rows = (np.abs(out).sum(-1) > 1e-6).sum()
    assert nonzero_rows <= 16


def test_moe_routing_scales_to_many_experts():
    """E=64 (DeepSeek-class) routing: the single-sort router must stay
    correct at large E (the old per-expert argsort loop was O(E) device
    sorts). Pinned against the dense oracle with generous capacity."""
    rng = np.random.default_rng(3)
    T, H, F, E = 32, 128, 128, 64
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    router = jnp.asarray(rng.standard_normal((H, E)) * 0.5, jnp.bfloat16)
    ws = {n: rng.standard_normal((E, kk, nn)).astype(np.float32) / 16
          for n, (kk, nn) in dict(w_gate=(H, F), w_up=(H, F),
                                  w_down=(F, H)).items()}
    qex = {n: moe.quantize_moe_linear(ws[n], "mxfp4") for n in ws}
    from petit_jax.ops import layout as L
    dex = {}
    for n in ws:
        E_, kk, nn = ws[n].shape
        deq = np.stack([
            L.dequant_from_layout(
                np.asarray(qex[n]["words"][e]),
                np.asarray(qex[n]["scales"][e]), nn, kk, group_size=32)
            * float(qex[n]["gs"][e]) for e in range(E_)])
        dex[n] = {"w": jnp.asarray(deq, jnp.bfloat16)}
    cfg = MoEConfig(num_experts=E, top_k=2, capacity_factor=32.0)
    out_q = moe.moe_mlp(x, router, qex, cfg, fmt="mxfp4", interpret=True)
    out_d = moe._dense_moe(x, router, dex, cfg)
    np.testing.assert_allclose(np.asarray(out_q, np.float32),
                               np.asarray(out_d, np.float32),
                               rtol=0.05, atol=0.05)


def test_moe_routing_drop_counter():
    """routing_drop_count reports exactly the assignments the capacity
    buckets reject."""
    rng = np.random.default_rng(4)
    T, H, E = 32, 64, 2
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    router = jnp.asarray(np.stack([np.ones(H), -np.ones(H)], 1),
                         jnp.bfloat16)
    cfg = MoEConfig(num_experts=E, top_k=1, capacity_factor=0.5)
    # cap = max(8, ceil(T*topk/E*cf)) = 8; expected = sum(max(count-8, 0))
    picks = np.asarray(jnp.argmax(
        jnp.dot(x.astype(jnp.float32), router.astype(jnp.float32)), -1))
    want = sum(max(int((picks == e).sum()) - 8, 0) for e in range(E))
    assert want > 0  # the scenario really overflows
    assert int(moe.routing_drop_count(x, router, cfg)) == want
    # generous capacity: nothing drops
    cfg2 = MoEConfig(num_experts=E, top_k=1, capacity_factor=8.0)
    assert int(moe.routing_drop_count(x, router, cfg2)) == 0


def test_tiny_mixtral_forward():
    cfg = MixtralConfig.tiny()
    params = moe.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                cfg.vocab_size)
    # dense forward
    logits_d, _ = moe.forward(params, tokens, cfg)
    assert logits_d.shape == (2, 8, cfg.vocab_size)
    # quantized forward
    qparams = moe.quantize_params(params, cfg, fmt="mxfp4")
    logits_q, _ = moe.forward(qparams, tokens, cfg, interpret=True)
    ld = np.asarray(logits_d, np.float32)
    lq = np.asarray(logits_q, np.float32)
    assert np.isfinite(lq).all()
    # FP4 attention + MXFP4 experts: loose distribution agreement
    pd = jax.nn.log_softmax(ld, -1)
    pq = jax.nn.log_softmax(lq, -1)
    kl = float(jnp.sum(jnp.exp(pd) * (pd - pq), -1).mean())
    assert kl < 0.1, kl


def test_grouped_mul_matches_per_expert():
    """grouped kernel == per-expert fused_mul calls, bit-for-bit."""
    import jax.numpy as jnp
    from petit_jax.models import moe
    from petit_jax.ops.kernels import grouped, fused
    from petit_jax.ops.solution import SolutionId, ElementB

    rng = np.random.default_rng(4)
    E, cap, k, n = 4, 16, 512, 256
    experts = moe.quantize_moe_linear(
        rng.standard_normal((E, k, n)) / 8, "mxfp4")
    xs = jnp.asarray(rng.standard_normal((E, cap, k)), jnp.bfloat16)
    got = grouped.grouped_mul(xs, experts["words"], experts["scales"],
                              experts["gs"], block_n=256, block_k=1024,
                              interpret=True)
    for e in range(E):
        want = fused.fused_mul(
            xs[e], experts["words"][e], experts["scales"][e],
            experts["gs"][e],
            sid=SolutionId(16, 256, 1024, element_b=ElementB.MXFP4),
            interpret=True)
        assert np.array_equal(np.asarray(got[e], np.float32),
                              np.asarray(want, np.float32)), e


def test_mixtral_served_through_engine():
    """The continuous-batching engine serves MoE models via the
    make_engine_forward hook (fused decode attention + masked KV writes),
    matching a straight cached greedy decode through moe.forward at the
    same compiled-graph shapes (bucket-padded prefill, kv_window decode)."""
    import functools
    from petit_jax.models import serving

    cfg = MixtralConfig.tiny()
    params = moe.init_params(cfg, jax.random.PRNGKey(0))
    qparams = moe.quantize_params(params, cfg, fmt="mxfp4")
    fwd_fn = moe.make_engine_forward(cfg, interpret=True)

    prompt = np.array([5, 9, 42, 7, 11], np.int32)
    T0, max_new = len(prompt), 5

    # oracle: same shapes as the engine's compiled programs
    lb = serving._bucket_len(T0)
    padded = np.zeros(lb, np.int32)
    padded[:T0] = prompt
    cache = llama.init_cache(cfg, 1)
    fwd = jax.jit(fwd_fn, static_argnames=("kv_window",))
    logits, cache = fwd(qparams, jnp.asarray(padded)[None], cache,
                        jnp.arange(lb)[None, :])
    tok = int(jnp.argmax(logits[0, T0 - 1]))
    want = [tok]
    for t in range(max_new - 1):
        logits, cache = fwd(qparams, jnp.asarray([[tok]]), cache,
                            jnp.full((1, 1), T0 + t, jnp.int32),
                            kv_window=cfg.max_seq_len)
        tok = int(jnp.argmax(logits[0, -1]))
        want.append(tok)

    eng = serving.Engine(qparams, cfg, max_batch=2, forward_fn=fwd_fn)
    out = eng.run([serving.Request(uid=0, tokens=prompt,
                                   max_new_tokens=max_new)])
    assert out[0] == want


@pytest.mark.parametrize("zfmt,group", [("nvfp4p2z", 16), ("mxfp4z", 32)])
def test_moe_mlp_zero_free_matches_oracle(zfmt, group):
    """Zero-free experts through the grouped kernel (flag-free int path)
    match the dense oracle built from their own per-expert dequant —
    covers both the pow2-NVFP4 and MXFP4 zero-free contracts."""
    rng = np.random.default_rng(4)
    T, H, F, E = 16, 128, 256, 4
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    router = jnp.asarray(rng.standard_normal((H, E)) * 0.5, jnp.bfloat16)
    ws = {n: rng.standard_normal((E, kk, nn)).astype(np.float32) / 16
          for n, (kk, nn) in dict(w_gate=(H, F), w_up=(H, F),
                                  w_down=(F, H)).items()}
    ws["w_gate"][0, :16, 5] = 0.0  # zero-heavy stripe: contract holds
    qz = {n: moe.quantize_moe_linear(ws[n], zfmt) for n in ws}
    # zero-free container invariant across every expert (logical region
    # only: padded-k rows legitimately hold zero words)
    from petit_jax.ops import layout as L
    for nm in qz:
        E_, kk, nn = ws[nm].shape
        for e in range(E_):
            nib = L.unpack_fp4_weights(np.asarray(qz[nm]["words"][e]),
                                       nn, kk)
            assert not ((nib == 0) | (nib == 8)).any()
    dexperts = {}
    for n in ws:
        E_, kk, nn = ws[n].shape
        deq = np.stack([
            L.dequant_from_layout(
                np.asarray(qz[n]["words"][e]),
                np.asarray(qz[n]["scales"][e]), nn, kk, group_size=group)
            for e in range(E_)]) * np.asarray(qz[n]["gs"])[:, None, None]
        dexperts[n] = jnp.asarray(deq, jnp.bfloat16)  # already (E, k, n)
    cfg = MoEConfig(num_experts=E, top_k=2, capacity_factor=2.0)
    y = moe.moe_mlp(x, router, qz, cfg, fmt=zfmt, interpret=True)

    def dense_moe(x, router, dx):
        logits = x.astype(jnp.float32) @ router.astype(jnp.float32)
        topv, topi = jax.lax.top_k(logits, 2)
        w = jax.nn.softmax(topv, axis=-1)
        out = jnp.zeros((T, H), jnp.float32)
        for slot in range(2):
            for e in range(E):
                m = (topi[:, slot] == e).astype(jnp.float32) * w[:, slot]
                g = x @ dx["w_gate"][e]
                u = x @ dx["w_up"][e]
                h = (jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype)
                     * u)
                out += m[:, None] * (h @ dx["w_down"][e]).astype(jnp.float32)
        return out

    ref = dense_moe(x, router, dexperts)
    np.testing.assert_allclose(np.asarray(y, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=0.08, atol=0.08)
