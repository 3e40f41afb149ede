"""Continuous-batching engine: correctness vs straight greedy_decode, slot
reuse, FP8 KV cache (BASELINE.json config 5 components at test scale)."""

import os
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from petit_jax.models import llama, serving


@pytest.fixture(scope="module")
def setup():
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


_PROMPTS = [
    np.array([5, 9, 42, 7], np.int32),
    np.array([100, 3], np.int32),
    np.array([1, 2, 3, 4, 5, 6], np.int32),
]


def _greedy_oracle(params, cfg, prompt, max_new):
    """Greedy decode through the same compiled-graph shapes as the engine
    (jitted bucket-padded prefill, jitted kv_window decode): isolates the
    engine's SCHEDULING/cache plumbing from jit-fusion rounding. A raw
    eager-prefill greedy_decode is a valid decode too, but differs in f32
    low bits, which flips near-tie argmaxes on this random tiny model."""
    import functools
    T0 = len(prompt)
    lb = serving._bucket_len(T0)
    padded = np.zeros(lb, np.int32)
    padded[:T0] = prompt
    cache = llama.init_cache(cfg, 1)
    fwd = jax.jit(functools.partial(llama.forward, cfg=cfg),
                  static_argnames=("kv_window",))
    logits, cache = fwd(params, jnp.asarray(padded)[None],
                        cache=cache, pos=jnp.arange(lb)[None, :])
    tok = int(jnp.argmax(logits[0, T0 - 1]))
    out = [tok]
    for t in range(max_new - 1):
        pos = jnp.full((1, 1), T0 + t, jnp.int32)
        logits, cache = fwd(params, jnp.asarray([[tok]]), cache=cache,
                            pos=pos, kv_window=128)
        tok = int(jnp.argmax(logits[0, -1]))
        out.append(tok)
    return out


def test_engine_matches_greedy_decode(setup):
    """max_batch=1: the engine (bucketed chunked prefill + fused decode
    attention) must match a straight greedy decode exactly."""
    cfg, params = setup
    for i, p in enumerate(_PROMPTS):
        eng = serving.Engine(params, cfg, max_batch=1)
        out = eng.run([serving.Request(uid=i, tokens=p, max_new_tokens=5)])
        assert out[i] == _greedy_oracle(params, cfg, p, 5), i


def test_engine_batch_isolation(setup):
    """Continuous batching must not let requests affect each other: each
    request served TOGETHER (queueing through max_batch=2) matches the same
    request served alone in an engine of the same batch shape. (Exact
    greedy_decode match at batch>1 is not bitwise-stable on this random
    tiny model: XLA's batched-GEMM blocking flips near-tie argmaxes with
    top-2 margins ~1e-2.)"""
    cfg, params = setup
    reqs = [serving.Request(uid=i, tokens=p, max_new_tokens=5)
            for i, p in enumerate(_PROMPTS)]
    out = serving.Engine(params, cfg, max_batch=2).run(reqs)
    assert set(out) == {0, 1, 2}
    for i, p in enumerate(_PROMPTS):
        alone = serving.Engine(params, cfg, max_batch=2).run(
            [serving.Request(uid=i, tokens=p, max_new_tokens=5)])
        assert out[i] == alone[i], i


def test_batched_admission_matches_per_slot(setup):
    """A burst of same-bucket prompts admits through ONE full-batch
    masked-write program (weights stream once per chunk shape); output
    must be identical to the per-slot chunk-prefill path. Quantized
    weights: every projection rides the pallas kernel, whose per-row
    results don't depend on the batch shape (dense XLA dots re-block by
    batch and flip near-tie argmaxes on random tiny models)."""
    cfg, params = setup
    qp = llama.quantize_params(params, "nvfp4")
    reqs = [serving.Request(uid=i, tokens=p, max_new_tokens=6)
            for i, p in enumerate(_PROMPTS)]
    eng_b = serving.Engine(qp, cfg, max_batch=4, fmt="nvfp4",
                           interpret=True)
    assert eng_b._batched_prefill_prog is not None
    out_b = eng_b.run(reqs)
    eng_s = serving.Engine(qp, cfg, max_batch=4, fmt="nvfp4",
                           interpret=True)
    eng_s._batched_prefill_prog = None          # force per-slot admission
    out_s = eng_s.run(reqs)
    assert out_b == out_s


def test_paged_batched_admission_matches_per_slot(setup):
    """PagedEngine analog of the burst-admission pin (VERDICT r4 #4): a
    burst of same-bucket prompts admits through ONE full-batch masked
    paged program (weights stream once per chunk shape; masked rows'
    writes go to the scratch page); tokens must equal the per-slot paged
    admission path exactly."""
    cfg, params = setup
    qp = llama.quantize_params(params, "nvfp4")
    reqs = lambda: [serving.Request(uid=i, tokens=p, max_new_tokens=6)
                    for i, p in enumerate(_PROMPTS)]
    eng_b = serving.PagedEngine(qp, cfg, max_batch=4, fmt="nvfp4",
                                page_size=8, interpret=True)
    assert eng_b._admission_batchable()
    out_b = eng_b.run(reqs())
    eng_s = serving.PagedEngine(qp, cfg, max_batch=4, fmt="nvfp4",
                                page_size=8, interpret=True)
    eng_s._batched_paged_prefill_prog = None    # force per-slot admission
    assert not eng_s._admission_batchable()
    out_s = eng_s.run(reqs())
    assert out_b == out_s


def test_engine_slot_reuse(setup):
    cfg, params = setup
    eng = serving.Engine(params, cfg, max_batch=1)
    r0 = serving.Request(uid=0, tokens=np.array([1, 2], np.int32),
                         max_new_tokens=2)
    r1 = serving.Request(uid=1, tokens=np.array([3, 4], np.int32),
                         max_new_tokens=2)
    out = eng.run([r0, r1])
    assert len(out[0]) == 2 and len(out[1]) == 2
    # slot must be free at the end
    assert eng.has_capacity()


def test_engine_eos_stops(setup):
    cfg, params = setup
    p = np.array([5, 9, 42, 7], np.int32)
    ref = llama.greedy_decode(params, cfg, jnp.asarray(p)[None, :], 8)
    ref = list(np.asarray(ref)[0])
    eos = ref[2]  # stop at the 3rd generated token
    eng = serving.Engine(params, cfg, max_batch=2)
    out = eng.run([serving.Request(uid=0, tokens=p, max_new_tokens=8,
                                   eos_id=eos)])
    assert out[0] == ref[:3]


def test_engine_fp8_kv_cache(setup):
    cfg, params = setup
    p = np.array([5, 9, 42, 7, 11, 13], np.int32)
    eng = serving.Engine(params, cfg, max_batch=2,
                         cache_dtype=jnp.float8_e4m3fn)
    out = eng.run([serving.Request(uid=0, tokens=p, max_new_tokens=4)])
    assert len(out[0]) == 4
    # fp8 KV is lossy; require agreement with bf16 on the FIRST token only
    # (prefill K/V quantization noise compounds later)
    ref = llama.greedy_decode(params, cfg, jnp.asarray(p)[None, :], 1)
    assert out[0][0] == int(np.asarray(ref)[0, 0])


def test_engine_tensor_parallel_matches_single_device(setup):
    """Engine over a (dp=1, tp=4) mesh via make_tp_step == plain engine:
    tensor-parallel continuous batching (north-star configs 3/5)."""
    from jax.sharding import Mesh
    from petit_jax import parallel as par
    from petit_jax.parallel import tp as tp_mod

    cfg, params = setup
    reqs = lambda: [serving.Request(uid=i, tokens=np.arange(3 + i) % 50,
                                    max_new_tokens=6) for i in range(3)]
    # fuse=False: the TP path quantizes projections separately, so the
    # single-device reference must too for token-level agreement
    qparams = llama.quantize_params(params, "nvfp4", fuse=False)
    eng = serving.Engine(qparams, cfg, max_batch=4, fmt="nvfp4",
                         interpret=True)
    want = eng.run(reqs())

    # tiny cfg: wo's k (heads*head_dim = 256) shards to 128 at tp=2 (the
    # kernel k-alignment floor); bigger models use tp=4/8
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    qtp = par.quantize_params_tp(params, cfg, mesh, fmt="nvfp4")
    step = tp_mod.make_tp_step(cfg, mesh, fmt="nvfp4")
    cache = tp_mod.init_cache_tp(cfg, 4, mesh)
    eng_tp = serving.Engine(qtp, cfg, max_batch=4, forward_fn=step,
                            cache=cache)
    got = eng_tp.run(reqs())
    assert set(got) == set(want)
    # greedy argmax chains can diverge after quantization-noise ties; demand
    # agreement on the first tokens of every request
    for uid in want:
        assert got[uid][:2] == want[uid][:2], (uid, got[uid], want[uid])


def test_paged_engine_matches_engine(setup):
    """PagedEngine (block-table KV pool) serves the same tokens as the
    contiguous-cache Engine, releases pages when requests finish, and
    survives slot reuse (freed pages re-allocated to a queued request)."""
    cfg, params = setup
    prompts = [
        np.array([5, 9, 42, 7], np.int32),
        np.array([100, 3], np.int32),
        np.array([1, 2, 3, 4, 5, 6], np.int32),
    ]
    reqs = lambda: [serving.Request(uid=i, tokens=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)]
    want = serving.Engine(params, cfg, max_batch=2).run(reqs())
    # max_batch=2 forces queueing -> request 2 reuses released pages
    eng = serving.PagedEngine(params, cfg, max_batch=2, page_size=8)
    got = eng.run(reqs())
    assert got == want
    assert eng.pages_in_use() == 0
    assert len(eng.pc.free) == eng.pc.num_pages


def test_paged_engine_pool_bound(setup):
    """The pool really bounds memory: a too-small pool raises on exhaustion,
    a sum-of-lengths-sized pool (far below max_batch*max_seq_len) serves."""
    cfg, params = setup
    p = np.arange(8, dtype=np.int32) % 50
    req = lambda: [serving.Request(uid=0, tokens=p, max_new_tokens=4)]
    with pytest.raises(RuntimeError, match="exhausted"):
        serving.PagedEngine(params, cfg, max_batch=2, page_size=8,
                            num_pages=1).run(req())
    eng = serving.PagedEngine(params, cfg, max_batch=2, page_size=8,
                              num_pages=2)  # 16 slots for len 8+4
    out = eng.run(req())
    ref = serving.Engine(params, cfg, max_batch=2).run(req())
    assert out == ref


def test_engine_sampling(setup):
    """Temperature sampling: deterministic under a seed, actually random
    across seeds, top_k=1 collapses to greedy, and the paged engine draws
    the identical sampled chain (same key schedule)."""
    cfg, params = setup
    p = np.array([5, 9, 42, 7], np.int32)
    req = lambda t: [serving.Request(uid=0, tokens=p, max_new_tokens=8,
                                     temperature=t)]
    greedy = serving.Engine(params, cfg, max_batch=2).run(req(0.0))
    a = serving.Engine(params, cfg, max_batch=2, seed=7).run(req(3.0))
    b = serving.Engine(params, cfg, max_batch=2, seed=7).run(req(3.0))
    assert a == b
    c = serving.Engine(params, cfg, max_batch=2, seed=8).run(req(3.0))
    assert a[0] != c[0] or a[0] != greedy[0]
    assert all(0 <= t < cfg.vocab_size for t in a[0])
    # top_k=1 masks everything but the argmax: greedy at any temperature
    d = serving.Engine(params, cfg, max_batch=2, seed=7,
                       top_k=1).run(req(5.0))
    assert d == greedy
    e = serving.PagedEngine(params, cfg, max_batch=2, seed=7,
                            page_size=8).run(req(3.0))
    assert e == a


def test_serve_bench_chain_smoke():
    """tools/serve_bench's fori_loop decode chain compiles and runs (tiny
    config, CPU interpret) — guards the end-to-end throughput harness."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "serve_bench", os.path.join(os.path.dirname(__file__), "..",
                                    "tools", "serve_bench.py"))
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)
    cfg = llama.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_layers=1, num_heads=4, num_kv_heads=2, head_dim=64,
        max_seq_len=128)
    rng = np.random.default_rng(0)
    params = sb.build_model(cfg, rng)
    cache = llama.init_cache(cfg, 2)
    toks = jnp.zeros((2,), jnp.int32)

    def body(i, carry):
        cache, toks = carry
        pos = jnp.full((2, 1), 8 + i, jnp.int32)
        logits, cache = llama.forward(params, toks[:, None], cfg, cache,
                                      pos, fmt="nvfp4", interpret=True)
        return cache, jnp.argmax(logits[:, -1], -1).astype(jnp.int32)

    cache, toks = jax.lax.fori_loop(0, 3, body, (cache, toks))
    assert np.isfinite(np.asarray(toks, np.float32)).all()


def test_prefill_compile_count_bounded(setup):
    """Mixed-length workload must compile at most len(PREFILL_BUCKETS)
    prefill programs (the round-1 engine compiled one per distinct prompt
    length — unbounded in real serving)."""
    cfg, params = setup
    rng = np.random.default_rng(0)
    lengths = [1, 2, 3, 7, 15, 17, 33, 40, 70, 100, 110]
    reqs = [serving.Request(uid=i,
                            tokens=rng.integers(0, cfg.vocab_size,
                                                size=L).astype(np.int32),
                            max_new_tokens=2)
            for i, L in enumerate(lengths)]
    eng = serving.Engine(params, cfg, max_batch=4)
    out = eng.run(reqs)
    assert len(out) == len(lengths)
    assert eng._prefill_prog._cache_size() <= len(
        serving.PREFILL_BUCKETS)


def test_long_prompt_chunked_prefill(setup):
    """A prompt longer than PREFILL_CHUNK is admitted over several ticks
    (decode of other requests proceeds in between) and still decodes
    correctly vs the single-shot oracle."""
    cfg, params = setup
    # tiny cfg has max_seq_len=128 < PREFILL_CHUNK: shrink the chunk
    old_chunk, old_buckets = serving.PREFILL_CHUNK, serving.PREFILL_BUCKETS
    serving.PREFILL_CHUNK = 32
    serving.PREFILL_BUCKETS = (16, 32)
    try:
        rng = np.random.default_rng(1)
        p = rng.integers(0, cfg.vocab_size, size=70).astype(np.int32)
        eng = serving.Engine(params, cfg, max_batch=2)
        out = eng.run([serving.Request(uid=0, tokens=p, max_new_tokens=4)])
        # oracle: same chunked prefill through the jitted forward
        import functools
        cache = llama.init_cache(cfg, 1)
        fwd = jax.jit(functools.partial(llama.forward, cfg=cfg),
                      static_argnames=("kv_window",))
        off = 0
        while off < len(p):
            chunk = p[off:off + 32]
            lb = serving._bucket_len(len(chunk))
            padded = np.zeros(lb, np.int32)
            padded[:len(chunk)] = chunk
            pos = off + jnp.arange(lb)[None, :]
            logits, cache = fwd(params, jnp.asarray(padded)[None],
                                cache=cache, pos=pos)
            last_n = len(chunk)
            off += len(chunk)
        tok = int(jnp.argmax(logits[0, last_n - 1]))
        expect = [tok]
        for t in range(3):
            pos = jnp.full((1, 1), len(p) + t, jnp.int32)
            logits, cache = fwd(params, jnp.asarray([[tok]]), cache=cache,
                                pos=pos, kv_window=128)
            tok = int(jnp.argmax(logits[0, -1]))
            expect.append(tok)
        assert out[0] == expect
    finally:
        serving.PREFILL_CHUNK, serving.PREFILL_BUCKETS = old_chunk, old_buckets


def test_decode_block_matches_single_step(setup):
    """run(decode_block=K) (K decode steps per host round-trip inside one
    jitted lax.scan) must emit exactly the same greedy tokens as K=1, for
    both cache backends, including eos finishing mid-block."""
    cfg, params = setup
    reqs = lambda: [serving.Request(uid=i, tokens=p, max_new_tokens=9)
                    for i, p in enumerate(_PROMPTS)]
    for mk in (lambda: serving.Engine(params, cfg, max_batch=2),
               lambda: serving.PagedEngine(params, cfg, max_batch=2,
                                           page_size=8)):
        want = mk().run(reqs())
        got = mk().run(reqs(), decode_block=4)
        assert got == want, type(mk()).__name__
    # eos mid-block: surplus tokens are discarded, output identical
    ref = serving.Engine(params, cfg, max_batch=2).run(
        [serving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=9)])
    eos = ref[0][4]  # stops on the 5th token — mid-block at K=4
    for k in (1, 4):
        out = serving.Engine(params, cfg, max_batch=2).run(
            [serving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=9,
                             eos_id=eos)], decode_block=k)
        assert out[0] == ref[0][:5], k
    # uneven lengths with NO queued admissions: the block is capped by the
    # LONGEST remaining request (waiters=False) and the short slot's
    # surplus is discarded — outputs must still equal K=1
    uneven = lambda: [
        serving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=3),
        serving.Request(uid=1, tokens=_PROMPTS[1], max_new_tokens=9)]
    for mk in (lambda: serving.Engine(params, cfg, max_batch=2),
               lambda: serving.PagedEngine(params, cfg, max_batch=2,
                                           page_size=8)):
        want = mk().run(uneven())
        got = mk().run(uneven(), decode_block=8)
        assert got == want, type(mk()).__name__


def test_concurrent_decode_does_not_corrupt_prefill(setup):
    """Regression (round-2 advisor, high): while a long prompt is admitted
    over several chunked-prefill ticks, OTHER slots keep decoding — and the
    batched decode step used to write KV for ALL rows at each row's pos, so
    the mid-prefill slot (pos=0) had position 0 of its already-written
    prompt KV overwritten with garbage every tick. The long request must
    produce exactly the tokens it produces when served alone."""
    cfg, params = setup
    old_chunk, old_buckets = serving.PREFILL_CHUNK, serving.PREFILL_BUCKETS
    serving.PREFILL_CHUNK = 16
    serving.PREFILL_BUCKETS = (16,)
    try:
        rng = np.random.default_rng(2)
        long_p = rng.integers(0, cfg.vocab_size, size=70).astype(np.int32)
        short_p = np.array([5, 9, 42], np.int32)
        # short request decodes (many tokens) while the long one prefills
        reqs = lambda: [
            serving.Request(uid=0, tokens=short_p, max_new_tokens=12),
            serving.Request(uid=1, tokens=long_p, max_new_tokens=4),
        ]
        for mk in (lambda: serving.Engine(params, cfg, max_batch=2),
                   lambda: serving.PagedEngine(params, cfg, max_batch=2,
                                               page_size=8)):
            together = mk().run(reqs())
            alone = mk().run([serving.Request(uid=1, tokens=long_p,
                                              max_new_tokens=4)])
            assert together[1] == alone[1], type(mk()).__name__
    finally:
        serving.PREFILL_CHUNK, serving.PREFILL_BUCKETS = old_chunk, old_buckets


def test_spec_concurrent_decode_does_not_corrupt_prefill(setup):
    """Same regression for SpecEngine: the verify step writes KV at
    pos..pos+gamma for every row; mid-prefill rows must be masked."""
    cfg, params = setup
    old_chunk, old_buckets = serving.PREFILL_CHUNK, serving.PREFILL_BUCKETS
    serving.PREFILL_CHUNK = 16
    serving.PREFILL_BUCKETS = (16,)
    try:
        rng = np.random.default_rng(3)
        long_p = rng.integers(0, cfg.vocab_size, size=40).astype(np.int32)
        short_p = np.array([7, 2], np.int32)
        reqs = lambda: [
            serving.Request(uid=0, tokens=short_p, max_new_tokens=10),
            serving.Request(uid=1, tokens=long_p, max_new_tokens=4),
        ]
        mk = lambda: serving.SpecEngine(params, cfg, params, gamma=3,
                                        max_batch=2)
        together = mk().run(reqs())
        alone = mk().run([serving.Request(uid=1, tokens=long_p,
                                          max_new_tokens=4)])
        assert together[1] == alone[1]
    finally:
        serving.PREFILL_CHUNK, serving.PREFILL_BUCKETS = old_chunk, old_buckets


def test_spec_engine_matches_plain_greedy(setup):
    """Speculative decoding is greedy-exact: SpecEngine's tokens equal the
    plain Engine's for BOTH a perfect draft (the target itself) and an
    unrelated random draft (low acceptance)."""
    cfg, params = setup
    reqs = lambda: [serving.Request(uid=i, tokens=p, max_new_tokens=6)
                    for i, p in enumerate(_PROMPTS)]
    want = serving.Engine(params, cfg, max_batch=2).run(reqs())

    # (a) draft == target: near-total acceptance
    eng_a = serving.SpecEngine(params, cfg, params, gamma=4, max_batch=2)
    got_a = eng_a.run(reqs())
    assert got_a == want
    assert eng_a.spec_stats["accepted"] > 0

    # (b) unrelated draft model: still exact, lower acceptance
    draft = llama.init_params(cfg, jax.random.PRNGKey(99))
    eng_b = serving.SpecEngine(params, cfg, draft, gamma=4, max_batch=2)
    got_b = eng_b.run(reqs())
    assert got_b == want


def test_spec_engine_draft_smaller_model(setup):
    """Draft with a different (smaller) architecture sharing the vocab."""
    cfg, params = setup
    import dataclasses
    dcfg = dataclasses.replace(cfg, num_layers=1)
    draft = llama.init_params(dcfg, jax.random.PRNGKey(3))
    p = _PROMPTS[0]
    want = serving.Engine(params, cfg, max_batch=1).run(
        [serving.Request(uid=0, tokens=p, max_new_tokens=6)])
    eng = serving.SpecEngine(params, cfg, draft, dcfg, gamma=3,
                             max_batch=1)
    got = eng.run([serving.Request(uid=0, tokens=p, max_new_tokens=6)])
    assert got == want


def test_spec_engine_adaptive_gamma(setup):
    """Acceptance-adaptive draft depth: a perfect draft (target = draft)
    walks gamma UP toward the ceiling; a garbage draft walks it DOWN to
    the smallest bucket. Emitted tokens stay greedy-exact throughout, and
    gamma never exceeds the remaining-token budget (no wasted proposals
    when every active slot is nearly done)."""
    cfg, params = setup
    p = _PROMPTS[2]
    want = serving.Engine(params, cfg, max_batch=1).run(
        [serving.Request(uid=0, tokens=p, max_new_tokens=24)])

    eng_up = serving.SpecEngine(params, cfg, params, gamma=11, max_batch=1)
    eng_up._acc_ema = 0.9  # pretend history says acceptance is high
    eng_up.gamma = 3
    got = eng_up.run([serving.Request(uid=0, tokens=p, max_new_tokens=24)])
    assert got == want
    assert eng_up.gamma > 3  # walked up the buckets

    draft = llama.init_params(cfg, jax.random.PRNGKey(123))
    eng_dn = serving.SpecEngine(params, cfg, draft, gamma=11, max_batch=1)
    got = eng_dn.run([serving.Request(uid=0, tokens=p, max_new_tokens=24)])
    assert got == want
    assert eng_dn.gamma == 3  # random draft: acceptance ~0, walked down

    # remaining-budget cap: 2 tokens wanted => first tick drafts at most 3
    eng_cap = serving.SpecEngine(params, cfg, params, gamma=11,
                                 max_batch=1, gamma_adaptive=False)
    out = eng_cap.run([serving.Request(uid=0, tokens=p, max_new_tokens=2)])
    assert out[0] == want[0][:2]
    assert eng_cap.spec_stats["proposed"] <= 3


def test_engine_prefill_fmt_w4a8(setup):
    """Regime-specialized compute: prefill through the int8 W4A8 path,
    decode through NVFP4 dequant, over one weight container. The first
    generated token comes from the prefill forward, so it must equal the
    all-w4a8 engine's; incompatible containers are rejected."""
    cfg, params = setup
    qp = llama.quantize_params(params, "nvfp4", fuse=False)
    p = np.array([5, 9, 42, 7, 11, 13], np.int32)
    req = lambda: [serving.Request(uid=0, tokens=p, max_new_tokens=4)]

    mixed = serving.Engine(qp, cfg, max_batch=2, fmt="nvfp4",
                           prefill_fmt="w4a8", interpret=True)
    assert mixed.prefill_chunk is None      # no w4a8-specific chunking
    got = mixed.run(req())
    all8 = serving.Engine(qp, cfg, max_batch=2, fmt="w4a8", interpret=True)
    want = all8.run(req())
    assert len(got[0]) == 4
    assert got[0][0] == want[0][0]


def test_w4a8_linear_runs_int8_path_at_every_m(setup):
    """linear(fmt="w4a8") runs the int8 product at any row count (no
    routing to the FP4 GEMM): at m=4 its output is the explicit
    gemm.mul_nvfp4_a8 call's, bit for bit, and within the W4A8 contract
    (rel L2 < 3e-2) of the exact nvfp4 GEMM without equalling it."""
    from petit_jax.ops import gemm
    cfg, params = setup
    qp = llama.quantize_params(params, "nvfp4", fuse=False)
    layer = qp["layers"][0]["wq"]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((4, cfg.hidden_size)) / 8,
                    jnp.bfloat16)
    y8 = np.asarray(llama.linear(x, layer, fmt="w4a8", interpret=True),
                    np.float32)
    k, n = cfg.hidden_size, layer["words"].shape[1]
    direct = gemm.mul_nvfp4_a8(x, layer["words"], layer["scales"],
                               layer["gs"], 4, n, k)
    assert np.array_equal(y8, np.asarray(direct, np.float32))
    y4 = np.asarray(llama.linear(x, layer, fmt="nvfp4", interpret=True),
                    np.float32)
    assert not np.array_equal(y8, y4)
    assert np.linalg.norm(y8 - y4) / np.linalg.norm(y4) < 3e-2

    with pytest.raises(ValueError):
        serving.Engine(qp, cfg, fmt="mxfp4", prefill_fmt="w4a8")
    with pytest.raises(ValueError):
        serving.PagedEngine(qp, cfg, fmt="mxfp4", prefill_fmt="w4a8")


def test_prefill_chunk_knob(setup):
    """Per-engine prefill_chunk (the admission chunk size): token streams
    must be identical to the default-chunk engine for chunked and
    unchunked prompts alike."""
    cfg, params = setup
    long_prompt = np.tile(_PROMPTS[0], 8)[:40].astype(np.int32)
    reqs = lambda: [
        serving.Request(uid=0, tokens=long_prompt, max_new_tokens=6),
        serving.Request(uid=1, tokens=_PROMPTS[1], max_new_tokens=6)]
    want = serving.Engine(params, cfg, max_batch=2).run(reqs())
    got = serving.Engine(params, cfg, max_batch=2,
                         prefill_chunk=16).run(reqs())
    assert got == want
    eng = serving.Engine(params, cfg, max_batch=2, prefill_chunk=16)
    assert eng.prefill_chunk == 16


def test_engine_tp_fp8_headed_cache_matches_single_device(setup):
    """TP engine with an FP8 HEADED KV cache (init_cache_tp default for
    fp8: (B, Hkv, S, d) with Hkv sharded over "tp") == single-device fp8
    engine — the north-star 70B-TP8 + FP8-KV config's sharding path
    (VERDICT r3 #3: the round-3 flat-layout pin is gone; per-shard decode
    attention rides the headed kernel with the shard's own hkv)."""
    from jax.sharding import Mesh
    from petit_jax import parallel as par
    from petit_jax.parallel import tp as tp_mod

    cfg, params = setup
    reqs = lambda: [serving.Request(uid=i, tokens=np.arange(3 + i) % 50,
                                    max_new_tokens=5) for i in range(2)]
    qparams = llama.quantize_params(params, "nvfp4", fuse=False)
    eng = serving.Engine(qparams, cfg, max_batch=2, fmt="nvfp4",
                         cache_dtype=jnp.float8_e4m3fn, interpret=True)
    want = eng.run(reqs())

    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "tp"))
    qtp = par.quantize_params_tp(params, cfg, mesh, fmt="nvfp4")
    step = tp_mod.make_tp_step(cfg, mesh, fmt="nvfp4")
    cache = tp_mod.init_cache_tp(cfg, 2, mesh, dtype=jnp.float8_e4m3fn)
    # the fp8 default really is headed, sharded on the head axis
    ck0 = cache[0][0]
    assert ck0.shape == (2, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
    eng_tp = serving.Engine(qtp, cfg, max_batch=2, forward_fn=step,
                            cache=cache)
    got = eng_tp.run(reqs())
    assert set(got) == set(want)
    # fp8 KV + per-shard quantization noise: require first-token agreement
    for uid in want:
        assert got[uid][0] == want[uid][0], (uid, got[uid], want[uid])


def test_init_cache_headed_ambiguous_shape_rejected():
    cfg = llama.LlamaConfig.tiny(max_seq_len=2, num_kv_heads=2)
    # bf16 headed caches are not auto-padded, so S == Hkv stays ambiguous
    with pytest.raises(ValueError, match="max_seq_len"):
        llama.init_cache(cfg, 1, jnp.bfloat16, headed=True)
    # flat layout is fine at the same shape
    llama.init_cache(cfg, 1, jnp.bfloat16)


def test_init_cache_fp8_unaligned_seq_autopads():
    """fp8 caches default to the headed layout at exactly max_seq_len
    positions, aligned or not (attention reads any S), and the ambiguous
    S == num_kv_heads shape is rejected like bf16's."""
    cfg = llama.LlamaConfig.tiny(max_seq_len=192, num_kv_heads=2,
                                 head_dim=64)
    cache = llama.init_cache(cfg, 1, jnp.float8_e4m3fn)
    ck, cv = cache[0]
    assert ck.shape == (1, 2, 192, 64)           # headed, S as configured
    assert cv.shape == ck.shape
    cfg2 = llama.LlamaConfig.tiny(max_seq_len=2, num_kv_heads=2)
    with pytest.raises(ValueError, match="max_seq_len"):
        llama.init_cache(cfg2, 1, jnp.float8_e4m3fn)
    cfg3 = llama.LlamaConfig.tiny(max_seq_len=512, num_kv_heads=2,
                                  head_dim=64)
    ck3, _ = llama.init_cache(cfg3, 1, jnp.float8_e4m3fn)[0]
    assert ck3.shape[2] == 512


def test_pipelined_drain_matches_single_step(setup):
    """run(decode_block=K) with no queued admissions drains through
    _drain_blocks_pipelined — one block always in flight, block N+1
    dispatched from block N's device-resident tail token before N is
    read back. Token streams must equal K=1 exactly across several
    chained blocks, for both cache backends."""
    cfg, params = setup
    reqs = lambda: [serving.Request(uid=i, tokens=p, max_new_tokens=17)
                    for i, p in enumerate(_PROMPTS[:2])]
    for mk in (lambda: serving.Engine(params, cfg, max_batch=2),
               lambda: serving.PagedEngine(params, cfg, max_batch=2,
                                           page_size=8)):
        want = mk().run(reqs())                  # K=1 oracle
        got = mk().run(reqs(), decode_block=4)   # ~5 pipelined blocks
        assert got == want, type(mk()).__name__


def test_pipelined_drain_eos_midflight(setup):
    """A slot hitting eos while the NEXT block is already in flight: the
    in-flight block was dispatched with a stale active mask, so the
    finished slot's surplus tokens must be discarded while the surviving
    slot's tokens from that same block remain exact."""
    cfg, params = setup
    ref = serving.Engine(params, cfg, max_batch=2).run(
        [serving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=17),
         serving.Request(uid=1, tokens=_PROMPTS[2], max_new_tokens=17)])
    eos = ref[0][6]   # slot 0 stops on its 7th token — mid-block at K=4
    reqs = lambda: [
        serving.Request(uid=0, tokens=_PROMPTS[0], max_new_tokens=17,
                        eos_id=eos),
        serving.Request(uid=1, tokens=_PROMPTS[2], max_new_tokens=17,
                        eos_id=eos)]
    for mk in (lambda: serving.Engine(params, cfg, max_batch=2),
               lambda: serving.PagedEngine(params, cfg, max_batch=2,
                                           page_size=8)):
        want = mk().run(reqs())                  # K=1, same eos semantics
        got = mk().run(reqs(), decode_block=4)
        assert got == want, type(mk()).__name__
