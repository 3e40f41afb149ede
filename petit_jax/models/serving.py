"""Continuous-batching serving engine for FP4 models.

The reference delegates serving to SGLang/vLLM (README.md:21); the north
star requires a native path (BASELINE.json config 5: continuous batching,
FP8 KV cache). This is the engine core: a slot-based batch with
static shapes (jit-stable), per-slot positions, insert-on-free-slot and
evict-on-finish — the scheduler half of continuous batching, with the
model step as the compiled inner loop.

Design notes:
  - All state is fixed-shape jnp arrays: cache (per layer, (B, S, h, d)),
    pos (B,), active (B,) — one compiled decode-step program serves any
    mix of requests (no recompiles as requests come and go).
  - Prefill runs per request into its slot (right-aligned positions);
    decode steps the whole batch each tick, masking inactive slots.
  - FP8 KV: pass cache_dtype=jnp.float8_e4m3fn.
  - Multi-host DP: run one engine per host over its DP shard; TP is inside
    the model forward (parallel/tp.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import llama


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray          # prompt token ids, (T,)
    max_new_tokens: int = 32
    eos_id: int = -1            # -1: never stops on eos
    temperature: float = 0.0    # 0: greedy; >0: gumbel-max sampling


# Chunked-prefill geometry: prompts are processed in chunks of at most
# PREFILL_CHUNK tokens (one chunk per engine tick, so decode latency stays
# bounded during long-prompt admission), and each chunk is right-padded to
# a bucket — the prefill path compiles at most len(PREFILL_BUCKETS)
# programs total, however many distinct prompt lengths arrive.
PREFILL_BUCKETS = (16, 32, 64, 128, 256)
PREFILL_CHUNK = PREFILL_BUCKETS[-1]


def _bucket_len(n: int, cap: Optional[int] = None) -> int:
    """Smallest bucket >= n; with `cap` (a per-engine prefill_chunk), the
    bucket set becomes the standard buckets below cap plus cap itself —
    still O(len(PREFILL_BUCKETS)) compiled prefill programs."""
    bs = list(PREFILL_BUCKETS)
    if cap is not None:
        bs = [b for b in bs if b < cap] + [cap]
    for b in bs:
        if n <= b:
            return b
    return bs[-1]


@dataclasses.dataclass
class _PrefillJob:
    req: "Request"
    slot: int
    offset: int = 0             # tokens already written to the cache


def sample_next(logits, key, temps, top_k: int = 0):
    """Per-slot next token from (B, V) logits: greedy where temps[b]==0,
    temperature sampling otherwise (gumbel-max — one argmax, no host
    sync), optionally restricted to the top_k logits. jit-safe."""
    lg = logits.astype(jnp.float32)
    greedy = jnp.argmax(lg, -1).astype(jnp.int32)
    if top_k:
        # lax.top_k is O(V log k) vs a full vocab sort every step
        kth = jax.lax.top_k(lg, top_k)[0][:, -1:]
        lg = jnp.where(lg >= kth, lg, -jnp.inf)
    safe_t = jnp.where(temps > 0, temps, 1.0)[:, None]
    g = jax.random.gumbel(key, lg.shape, jnp.float32)
    sampled = jnp.argmax(lg / safe_t + g, -1).astype(jnp.int32)
    return jnp.where(temps > 0, sampled, greedy)


def _make_chunk_prefill(prefill_fn, takes_window: bool, top_k: int):
    """Build the one-program chunk-prefill: dynamic-slice the slot's cache
    rows, run `prefill_fn` on the (1, bucket) chunk, dynamic-update the
    rows back, and sample the token at `last_idx` — a single device program
    per chunk (the host-side per-layer slice/writeback it replaces cost
    ~4*layers dispatches per chunk). Returns (first_token, new_cache); the
    caller reads first_token back only when the prompt completes."""

    @functools.partial(jax.jit, donate_argnums=(1,),
                       static_argnames=("kv_window",))
    def prog(params, cache, toks, pos, slot, last_idx, key, temp,
             kv_window=None):
        rows = [(jax.lax.dynamic_slice_in_dim(k, slot, 1, axis=0),
                 jax.lax.dynamic_slice_in_dim(v, slot, 1, axis=0))
                for (k, v) in cache]
        if takes_window:
            logits, new_rows = prefill_fn(params, toks, rows, pos,
                                          kv_window=kv_window)
        else:
            logits, new_rows = prefill_fn(params, toks, rows, pos)
        cache = [(jax.lax.dynamic_update_slice_in_dim(
                      k, k1.astype(k.dtype), slot, axis=0),
                  jax.lax.dynamic_update_slice_in_dim(
                      v, v1.astype(v.dtype), slot, axis=0))
                 for (k, v), (k1, v1) in zip(cache, new_rows)]
        lg = jax.lax.dynamic_index_in_dim(logits, last_idx, axis=1,
                                          keepdims=False)       # (1, V)
        first = sample_next(lg, key, temp[None], top_k)[0]
        return first, cache

    return prog


def _make_batched_prefill(prefill_fn, takes_window: bool, top_k: int):
    """Batched chunk admission: one FULL-BATCH program advances several
    queued prompts by one chunk each. Rows not being admitted ride along
    with write_mask[b]=False — their cache rows pass through bit-exact
    (the masked KV write restores the old slice) and their sampled tokens
    are discarded on host. Compared to per-slot _make_chunk_prefill this
    streams the weights ONCE per chunk shape instead of once per prompt,
    and needs no cache row slicing at all."""

    @functools.partial(jax.jit, donate_argnums=(1,),
                       static_argnames=("kv_window",))
    def prog(params, cache, toks, pos, last_idx, mask, key, temps,
             kv_window=None):
        kw = {"kv_window": kv_window} if takes_window else {}
        logits, cache = prefill_fn(params, toks, cache, pos,
                                   write_mask=mask, **kw)
        lg = jnp.take_along_axis(
            logits, last_idx[:, None, None], axis=1)[:, 0]      # (B, V)
        first = sample_next(lg, key, temps, top_k)
        return first, cache

    return prog


class Engine:
    """Slot-based continuous batching over a llama-family FP4 model."""

    # run() may keep one decode block in flight while the previous one is
    # read back (_drain_blocks_pipelined); SpecEngine opts out — its
    # step_block degrades to spec ticks with their own scheduling.
    _pipeline_blocks = True

    def __init__(self, params, cfg: llama.LlamaConfig, *, max_batch: int = 8,
                 fmt: str = "nvfp4", cache_dtype=jnp.bfloat16,
                 interpret: bool = False, forward_fn=None, cache=None,
                 top_k: int = 0, seed: int = 0,
                 prefill_fmt: Optional[str] = None,
                 prefill_chunk: Optional[int] = None):
        """forward_fn(params, tokens (B, T), cache, pos (B, T)) ->
        (logits, new_cache) overrides the model forward — e.g.
        parallel.tp.make_tp_step for tensor-parallel serving (pass the
        matching sharded cache via `cache`, parallel.tp.init_cache_tp).
        Sampling: per-request temperature (Request.temperature, 0=greedy)
        with an engine-wide optional top_k cutoff.

        prefill_fmt: run PREFILL chunks through a different GEMM path than
        decode over the SAME weight container: prefill_fmt="w4a8" with
        fmt="nvfp4" runs prefill on the int8 product. Only
        container-compatible pairs are allowed; prefill numerics then
        differ from decode (w4a8 is quality-gated, tools/quality_gate.py).
        On the H100 the w4a8 GEMM is slower than the FP4 one at every
        prefill size measured (PERF.md), so this is a numerics option, not
        a speed one. Ignored when forward_fn is given."""
        self.params = params
        self.cfg = cfg
        self.B = max_batch
        self.fmt = fmt
        self.prefill_fmt = prefill_fmt or fmt
        self.prefill_chunk = (min(prefill_chunk, cfg.max_seq_len)
                              if prefill_chunk else None)
        self.interpret = interpret
        self.top_k = top_k
        self._key = jax.random.PRNGKey(seed)
        prefill_fn = forward_fn
        if forward_fn is None:
            def _make(f):
                def fwd(p, toks, cache_, pos_, kv_window=None,
                        write_mask=None):
                    return llama.forward(p, toks, cfg, cache_, pos_,
                                         fmt=f, interpret=interpret,
                                         kv_window=kv_window,
                                         write_mask=write_mask)
                return fwd
            forward_fn = _make(fmt)
            if self.prefill_fmt != fmt:
                same_container = {"nvfp4", "w4a8"}
                if not {fmt, self.prefill_fmt} <= same_container:
                    raise ValueError(
                        f"prefill_fmt={self.prefill_fmt!r} is not "
                        f"container-compatible with fmt={fmt!r}")
                prefill_fn = _make(self.prefill_fmt)
            else:
                prefill_fn = forward_fn
        self._forward = forward_fn
        # custom forward_fns (e.g. parallel.tp.make_tp_step) may not take
        # kv_window / write_mask; detect once and fall back
        import inspect
        _fwd_params = inspect.signature(forward_fn).parameters
        self._fwd_takes_window = "kv_window" in _fwd_params
        self._fwd_takes_mask = "write_mask" in _fwd_params
        self.cache = (cache if cache is not None
                      else llama.init_cache(cfg, max_batch, cache_dtype))
        self.pos = np.zeros(max_batch, np.int32)       # next position
        self.active = np.zeros(max_batch, bool)
        self.last_tok = np.zeros(max_batch, np.int32)
        self.temps = np.zeros(max_batch, np.float32)
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self.generated: dict[int, list[int]] = {}
        self.finished: dict[int, list[int]] = {}
        self._pf: list[_PrefillJob] = []   # chunked-prefill queue
        # jitted prefill forward: XLA's jit cache keys on the (1, bucket)
        # shape (x kv_window bucket when supported), so the prefill path
        # compiles a handful of programs however many lengths arrive.
        # (score_forward's full-batch eval path; chunk admission uses
        # _prefill_prog below.)
        if self._fwd_takes_window:
            self._prefill_forward = jax.jit(
                lambda p, t, c, q, kv_window=None: prefill_fn(
                    p, t, c, q, kv_window=kv_window),
                static_argnames=("kv_window",))
        else:
            self._prefill_forward = jax.jit(
                lambda p, t, c, q: prefill_fn(p, t, c, q))
        # One-program chunk prefill: slice the slot's cache rows, run the
        # chunk forward, write the rows back, and sample the chunk's last
        # real-position token — ALL inside one jit, instead of ~4*layers
        # tiny device programs per chunk for a host-side per-layer row
        # slice + .at[].set writeback.
        self._prefill_prog = _make_chunk_prefill(
            prefill_fn, self._fwd_takes_window, top_k)
        # Batched admission (base engine only): ONE full-batch program
        # prefills every queued prompt whose next chunk shares a (bucket,
        # window) key — the FP4 weights stream once per chunk shape
        # instead of once per prompt: a burst of J short prompts pays one
        # weight stream per chunk shape instead of J.
        self._batched_prefill_prog = (
            _make_batched_prefill(prefill_fn, self._fwd_takes_window,
                                  top_k)
            if self._fwd_takes_mask else None)

        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("kv_window",))
        def _decode_step(params, cache, toks, pos, key, temps, active,
                         kv_window=None):
            kw = {}
            if self._fwd_takes_window:
                kw["kv_window"] = kv_window
            if self._fwd_takes_mask:
                # inactive / mid-prefill rows must not have their KV
                # overwritten by the batched step (their sampled token is
                # discarded, but a corrupted cache row would be attended
                # by every later decode step of that slot)
                kw["write_mask"] = active
            logits, cache = forward_fn(params, toks[:, None], cache,
                                       pos[:, None], **kw)
            return sample_next(logits[:, -1], key, temps, top_k), cache

        self._decode_step = _decode_step

        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("kv_window", "steps"))
        def _decode_block(params, cache, toks, pos, key, temps, active,
                          steps, kv_window=None):
            # K decode steps per host round-trip (lax.scan): the engine's
            # per-token host sync (np.asarray each tick) costs one host
            # round trip — a block amortizes it over K tokens.
            def body(carry, _):
                cache, toks, pos, key = carry
                key, sub = jax.random.split(key)
                kw = {}
                if self._fwd_takes_window:
                    kw["kv_window"] = kv_window
                if self._fwd_takes_mask:
                    kw["write_mask"] = active
                logits, cache = forward_fn(params, toks[:, None], cache,
                                           pos[:, None], **kw)
                nxt = sample_next(logits[:, -1], sub, temps, top_k)
                return (cache, nxt, pos + 1, key), nxt
            (cache, _, _, _), out = jax.lax.scan(
                body, (cache, toks, pos, key), None, length=steps)
            return out, cache                       # out: (steps, B)

        self._decode_block = _decode_block

    def _next_key(self) -> jax.Array:
        self._key, sub = jax.random.split(self._key)
        return sub

    # -- scheduling ---------------------------------------------------------

    def reset(self) -> None:
        """Clear all scheduling state (keep compiled programs and cache
        storage): benchmark warm-up runs reuse one engine instance, since
        the jitted closures are per-instance."""
        self.pos[:] = 0
        self.active[:] = False
        self.last_tok[:] = 0
        self.temps[:] = 0.0
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                self._release(slot)
        self.slot_req = [None] * self.B
        self.generated = {}
        self.finished = {}
        self._pf = []

    def has_capacity(self) -> bool:
        return any(r is None for r in self.slot_req)

    def add_request(self, req: Request) -> int:
        """Reserve a free slot and enqueue the prompt for chunked prefill
        (advanced one chunk per step(); the slot starts decoding the tick
        after its last chunk). Returns the slot index."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        T = len(req.tokens)
        assert T + req.max_new_tokens <= self.cfg.max_seq_len
        self.temps[slot] = req.temperature
        self.slot_req[slot] = req
        self.pos[slot] = 0
        self._pf.append(_PrefillJob(req, slot))
        return slot

    def _chunk_key(self, job) -> tuple:
        """(bucket_len, kv_window) of the job's NEXT chunk — the jit keys
        of its prefill program, and the grouping key for batched
        admission."""
        cap = self.prefill_chunk or PREFILL_CHUNK
        n = min(len(job.req.tokens) - job.offset, cap)
        lb = _bucket_len(n, self.prefill_chunk)
        # bucketed attention window for the chunk (flash prefill reads
        # only ceil(window/128) KV blocks); power-of-two so the compile
        # count stays O(#buckets x log max_seq)
        w = 128
        while w < job.offset + lb:
            w *= 2
        return lb, min(w, self.cfg.max_seq_len)

    def _advance_prefill(self) -> None:
        """Advance the prefill queue by one chunk. Base engine: every
        queued prompt whose next chunk shares the oldest job's (bucket,
        window) key is admitted in ONE full-batch program — the FP4
        weights stream once per chunk shape instead of once per prompt
        (a bs=8 burst of short prompts admits ~8x faster). Subclasses
        that override _prefill_chunk (paged pools, spec draft cache) take
        the per-slot path."""
        job = self._pf[0]
        cap = self.prefill_chunk or PREFILL_CHUNK
        lb, kv_window = self._chunk_key(job)
        group = ([j for j in self._pf
                  if self._chunk_key(j) == (lb, kv_window)]
                 if self._admission_batchable() else [job])
        if len(group) >= 2:
            self._admit_batched(group, lb, kv_window, cap)
            return
        toks = np.asarray(job.req.tokens)
        chunk = toks[job.offset:job.offset + cap]
        n = len(chunk)
        padded = np.zeros(lb, np.int32)
        padded[:n] = chunk
        pos = job.offset + jnp.arange(lb, dtype=jnp.int32)[None, :]
        # first generated token comes from the last REAL position; the
        # sample rides inside the chunk program and is only read back
        # (one host round trip) when the prompt completes
        first = self._prefill_chunk(job.slot, jnp.asarray(padded)[None, :],
                                    pos, kv_window, last_idx=n - 1,
                                    key=self._next_key())
        job.offset += n
        if job.offset == len(toks):
            self._pf.pop(0)
            slot = job.slot
            first = int(first)
            self.pos[slot] = len(toks)
            self.active[slot] = True
            self.last_tok[slot] = first
            self.generated[job.req.uid] = [first]

    def _admission_batchable(self) -> bool:
        """Whether _advance_prefill may group same-key jobs into one
        full-batch admission program. Base engine: yes when the forward
        takes write_mask and no subclass re-routed the per-slot chunk path
        (spec draft caches override _prefill_chunk and stay per-slot)."""
        return (self._batched_prefill_prog is not None
                and type(self)._prefill_chunk is Engine._prefill_chunk)

    def _run_batched_admission(self, group, toks_b, pos_b, last_b, mask_b,
                               kv_window) -> jax.Array:
        """Backend hook: run ONE full-batch masked admission program and
        return the per-row sampled tokens (device array)."""
        first, self.cache = self._batched_prefill_prog(
            self.params, self.cache, toks_b, pos_b, last_b, mask_b,
            self._next_key(), jnp.asarray(self.temps, jnp.float32),
            kv_window=kv_window if self._fwd_takes_window else None)
        return first

    def _admit_batched(self, group, lb: int, kv_window: int,
                       cap: int) -> None:
        """One full-batch masked-write program admits one chunk for every
        job in `group` (distinct slots by construction)."""
        B = self.B
        toks_b = np.zeros((B, lb), np.int32)
        pos_b = np.zeros((B, lb), np.int32)
        last_b = np.zeros(B, np.int32)
        mask_b = np.zeros(B, bool)
        ns = {}
        for j in group:
            chunk = np.asarray(j.req.tokens)[j.offset:j.offset + cap]
            n = len(chunk)
            toks_b[j.slot, :n] = chunk
            pos_b[j.slot] = j.offset + np.arange(lb)
            last_b[j.slot] = n - 1
            mask_b[j.slot] = True
            ns[j.slot] = n
        first = self._run_batched_admission(
            group, jnp.asarray(toks_b), jnp.asarray(pos_b),
            jnp.asarray(last_b), jnp.asarray(mask_b), kv_window)
        firsts = None
        for j in list(group):
            j.offset += ns[j.slot]
            if j.offset == len(j.req.tokens):
                self._pf.remove(j)
                if firsts is None:
                    firsts = np.asarray(first)  # ONE read for the batch
                slot = j.slot
                self.pos[slot] = len(j.req.tokens)
                self.active[slot] = True
                self.last_tok[slot] = int(firsts[slot])
                self.generated[j.req.uid] = [int(firsts[slot])]

    # -- cache backend hooks (overridden by PagedEngine) ---------------------

    def _prefill_chunk(self, slot: int, toks, pos, kv_window=None,
                       last_idx: int = 0, key=None) -> jax.Array:
        """Run one right-padded prefill chunk (1, Lb) at absolute positions
        `pos` through slot's cache rows — ONE jitted program (row slicing,
        forward, row writeback and the last-real-position sample all fused;
        see _make_chunk_prefill). Returns the sampled token at `last_idx`
        as a DEVICE scalar (callers read it back only on prompt
        completion). Padded positions write garbage KV beyond the true
        length — harmless: the causal mask hides them and decode
        overwrites row by row."""
        key = self._next_key() if key is None else key
        first, self.cache = self._prefill_prog(
            self.params, self.cache, toks, pos, jnp.int32(slot),
            jnp.int32(last_idx), key,
            jnp.asarray(self.temps[slot], jnp.float32),
            kv_window=kv_window if self._fwd_takes_window else None)
        return first

    def score_forward(self, toks: jax.Array) -> jax.Array:
        """Full-sequence logits (B, L, V) THROUGH this engine's serving
        forward (same jitted graphs, cache dtype/sharding — incl. a TP
        cache): the eval harness scores what would actually be served
        (models/eval.py engine= path). Uses a zeroed clone of the engine's
        cache; engine state is untouched. B must equal max_batch (eval
        pads its batches to it)."""
        B, L = toks.shape
        assert B == self.B, (B, self.B)
        cache = jax.tree.map(jnp.zeros_like, self.cache)
        pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None], (B, L))
        if self._fwd_takes_window:
            w = 128
            while w < L:
                w *= 2
            logits, _ = self._prefill_forward(
                self.params, toks, cache, pos,
                kv_window=min(w, self.cfg.max_seq_len))
        else:
            logits, _ = self._prefill_forward(self.params, toks, cache, pos)
        return logits

    def _kv_window(self, extra: int = 0, pos=None) -> Optional[int]:
        """Bucketed max attended length over active slots: a power-of-two
        multiple of 128, so the decode step compiles O(log max_seq) distinct
        programs while attention traffic tracks actual context. `extra`
        reserves headroom for a multi-step decode block; `pos` overrides
        self.pos with a projected position vector (pipelined dispatch,
        where host state lags the in-flight block)."""
        if not self._fwd_takes_window or not self.active.any():
            return None
        p = self.pos if pos is None else pos
        need = int(p[self.active].max()) + 1 + extra
        w = 128
        while w < need:
            w *= 2
        return min(w, self.cfg.max_seq_len)

    def _decode(self, toks: jax.Array, pos: jax.Array) -> jax.Array:
        """One batched decode step; returns next-token ids (B,)."""
        nxt, self.cache = self._decode_step(self.params, self.cache, toks,
                                            pos, self._next_key(),
                                            jnp.asarray(self.temps),
                                            jnp.asarray(self.active),
                                            kv_window=self._kv_window())
        return nxt

    def _release(self, slot: int) -> None:
        """Free per-slot cache resources (no-op for the contiguous cache:
        prefill of the next occupant overwrites the rows)."""

    def _grow_for_block(self, pos, steps: int) -> None:
        """Pre-dispatch capacity hook: the contiguous cache needs nothing
        (the budget already bounds writes to max_seq_len); PagedEngine
        grows block tables to cover the block's write range."""

    def _dispatch_block(self, toks, pos, steps: int, kv_window):
        """Dispatch one K-step decode block (async; no host read)."""
        out, self.cache = self._decode_block(
            self.params, self.cache, toks, pos, self._next_key(),
            jnp.asarray(self.temps), jnp.asarray(self.active), steps,
            kv_window=kv_window)
        return out

    def _run_decode_block(self, toks, pos, steps: int):
        """Device half of step_block: K chained decode steps, one host
        round-trip. Returns (steps, B) token ids."""
        self._grow_for_block(self.pos, steps)
        return self._dispatch_block(toks, pos, steps,
                                    self._kv_window(extra=steps))

    # ------------------------------------------------------------------------

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        self.finished[req.uid] = self.generated.pop(req.uid)
        self.active[slot] = False
        self.slot_req[slot] = None
        self.temps[slot] = 0.0
        self._release(slot)

    def step(self) -> int:
        """One engine tick: advance at most one prefill chunk, then one
        batched decode step over all active slots; returns #active+queued."""
        if self._pf:
            self._advance_prefill()
        if self.active.any():
            toks = jnp.asarray(self.last_tok)
            pos = jnp.asarray(self.pos)
            nxt = np.asarray(self._decode(toks, pos))
            for slot in np.flatnonzero(self.active):
                req = self.slot_req[slot]
                self.generated[req.uid].append(int(nxt[slot]))
                self.pos[slot] += 1
                self.last_tok[slot] = int(nxt[slot])
                done = (len(self.generated[req.uid]) >= req.max_new_tokens
                        or int(nxt[slot]) == req.eos_id
                        or self.pos[slot] + 1 >= self.cfg.max_seq_len)
                if done:
                    self._finish(slot)
        return int(self.active.sum()) + len(self._pf)

    def _block_budget(self, max_steps: int, waiters: bool = True) -> int:
        """Largest decode-block size that (a) never writes KV past
        max_seq_len for any active slot and (b) with `waiters`, does not
        overshoot the shortest remaining request (so finishing slots free
        promptly for queued admissions). With no waiters there is nothing
        to admit into a freed slot, so the block is capped only by the
        LONGEST remaining request — slots that finish mid-block have their
        surplus tokens discarded (the eos contract), trading a little
        wasted device work for one host round trip per block. Greedy
        token streams
        are identical to K=1 either way."""
        k = max_steps
        longest = 1
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            k = min(k, self.cfg.max_seq_len - int(self.pos[slot]) - 1)
            remaining = req.max_new_tokens - len(self.generated[req.uid])
            longest = max(longest, remaining)
            if waiters:
                k = min(k, remaining)
        return max(1, min(k, longest))

    def step_block(self, max_steps: int, waiters: bool = True) -> int:
        """Like step(), but decodes up to max_steps tokens per active slot
        in ONE jitted program (lax.scan) — one host round-trip per block
        instead of per token. Slots hitting eos mid-block have their
        surplus tokens discarded on host; the surplus KV those steps wrote
        is overwritten position-by-position before it is ever attended
        (the chunked-prefill garbage contract). Prefill chunks still
        advance one per call."""
        if self._pf:
            self._advance_prefill()
        if not self.active.any():
            return len(self._pf)
        steps = self._block_budget(max_steps, waiters or bool(self._pf))
        if steps <= 1:
            return self.step()
        out = np.asarray(self._run_decode_block(
            jnp.asarray(self.last_tok), jnp.asarray(self.pos), steps))
        self._absorb_block(out, steps)
        return int(self.active.sum()) + len(self._pf)

    def _absorb_block(self, out: np.ndarray, steps: int) -> None:
        """Host half of a decode block: append tokens per active slot,
        advance pos, finish slots at eos/max_new (surplus block tokens
        past a finish are discarded — the eos contract)."""
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            done = False
            for t in range(steps):
                tok = int(out[t, slot])
                self.generated[req.uid].append(tok)
                self.pos[slot] += 1
                self.last_tok[slot] = tok
                done = (len(self.generated[req.uid]) >= req.max_new_tokens
                        or tok == req.eos_id
                        or self.pos[slot] + 1 >= self.cfg.max_seq_len)
                if done:
                    break
            if done:
                self._finish(slot)

    def _drain_blocks_pipelined(self, max_steps: int) -> None:
        """Decode all active slots with ONE block always in flight: block
        N+1 is dispatched from block N's device-resident tail token
        (out[steps-1]) BEFORE block N's tokens are read back, so the
        per-block host round-trip and the
        absorb bookkeeping overlap device execution instead of
        serializing with it. Used by run() only when no admissions are
        waiting (with waiters the plain step_block path frees slots
        promptly for the queue).

        Token streams are identical to the sequential path: slot chains
        are independent, so a block dispatched with a pre-absorb active
        mask still computes the true continuation for surviving slots;
        a slot that finishes mid-block has its surplus tokens discarded
        on host and its surplus KV never attended (the chunked-prefill
        garbage contract), and the projected budget keeps every write
        below max_seq_len."""
        def budget(extra: int) -> int:
            k, longest = max_steps, 0
            for slot in np.flatnonzero(self.active):
                req = self.slot_req[slot]
                k = min(k, self.cfg.max_seq_len
                        - (int(self.pos[slot]) + extra) - 1)
                longest = max(longest, req.max_new_tokens
                              - len(self.generated[req.uid]) - extra)
            return max(0, min(k, longest))

        s1 = budget(0)
        if s1 <= 0:
            return
        if s1 == 1:
            self.step()
            return
        self._grow_for_block(self.pos, s1)
        out1 = self._dispatch_block(
            jnp.asarray(self.last_tok), jnp.asarray(self.pos), s1,
            self._kv_window(extra=s1))
        while True:
            s2 = budget(s1)
            out2 = None
            if s2 > 1:
                pos_proj = self.pos.copy()
                pos_proj[self.active] += s1
                self._grow_for_block(pos_proj, s2)
                out2 = self._dispatch_block(
                    out1[s1 - 1], jnp.asarray(pos_proj), s2,
                    self._kv_window(extra=s2, pos=pos_proj))
            res1 = np.asarray(out1)        # overlaps block-2 execution
            self._absorb_block(res1, s1)
            if out2 is None or not self.active.any():
                return          # an unread out2 is discarded (rare: every
                                # slot hit eos inside block 1)
            out1, s1 = out2, s2

    def run(self, requests: list[Request],
            decode_block: int = 1) -> dict[int, list[int]]:
        """Serve a list of requests to completion with continuous batching:
        new requests join as slots free up, decode proceeds every tick.
        decode_block > 1 chains that many decode steps per host round-trip
        (step_block) whenever no prefill is pending — the engine-throughput
        mode (greedy streams are identical to decode_block=1)."""
        pending = list(requests)
        while pending or self.active.any() or self._pf:
            while pending and self.has_capacity():
                self.add_request(pending.pop(0))
            if decode_block > 1 and not self.active.any():
                # nothing is decoding yet: drain the prefill backlog in one
                # burst instead of interleaving one chunk per tick — the
                # chunk-per-tick pacing exists to bound DECODE latency,
                # which is moot with no active slot, and each avoided tick
                # saves a single-token decode round trip
                while self._pf:
                    self._advance_prefill()
            if decode_block > 1 and not self._pf:
                if not pending and self._pipeline_blocks:
                    # no admissions waiting: drain with one block always
                    # in flight (readback/bookkeeping overlap device work)
                    self._drain_blocks_pipelined(decode_block)
                else:
                    self.step_block(decode_block, waiters=bool(pending))
            else:
                self.step()
        return dict(self.finished)


class SpecEngine(Engine):
    """Draft-verify speculative decoding over the contiguous-cache engine
    (greedy-exact: emitted tokens are identical to plain greedy decoding
    of the target model — only the number of target forwards changes).

    Per tick: the draft model proposes `gamma` tokens autoregressively
    (gamma cheap forwards), the target verifies all of them in ONE
    multi-token cached forward (the flash-prefill path), and each slot
    accepts the longest agreeing prefix plus the target's own next token.
    Acceptance is capped at gamma-1 so the draft cache always holds KV for
    every accepted position (the gamma-th proposal is never written to the
    draft cache); rejected-tail KV in both caches is stale garbage that
    the per-query causal mask hides and later writes overwrite — the same
    contract as chunked prefill.

    Greedy only (temperature sampling would need rejection sampling);
    requires target and draft to share the vocabulary.
    """

    #: spec ticks have their own scheduling — no block pipelining
    _pipeline_blocks = False

    #: admissible draft depths when gamma_adaptive: each value compiles one
    #: (B, g+1) verify program, so the set is small and fixed
    GAMMA_BUCKETS = (3, 5, 7, 11)

    def __init__(self, params, cfg: llama.LlamaConfig, draft_params,
                 draft_cfg: Optional[llama.LlamaConfig] = None, *,
                 gamma: int = 7, gamma_adaptive: bool = True,
                 max_batch: int = 8, fmt: str = "nvfp4",
                 draft_fmt: str = "bf16", cache_dtype=jnp.bfloat16,
                 interpret: bool = False, seed: int = 0):
        super().__init__(params, cfg, max_batch=max_batch, fmt=fmt,
                         cache_dtype=cache_dtype, interpret=interpret,
                         seed=seed)
        self.gamma = gamma
        self.gamma_adaptive = gamma_adaptive
        self._gamma_max = max(gamma, 3)
        # acceptance EMA (fraction of the g-1 cap used), drives the bucket
        # walk: high acceptance -> deeper drafts, low -> shallower
        self._acc_ema = 0.5
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg or cfg
        assert self.draft_cfg.vocab_size == cfg.vocab_size
        assert self.draft_cfg.max_seq_len >= cfg.max_seq_len
        self.dcache = llama.init_cache(self.draft_cfg, max_batch,
                                       cache_dtype)
        self.spec_stats = {"proposed": 0, "accepted": 0, "ticks": 0}

        #: synthetic acceptance floor in [0, 1): each draft position is
        #: force-accepted with this probability REGARDLESS of agreement.
        #: 0.0 (default) is the exact greedy path. >0 makes token QUALITY
        #: meaningless (the target cache keeps draft-token KV inside the
        #: forced prefix) but leaves the COMPUTE path identical — the knob
        #: exists so e2e tok/s vs acceptance can be MEASURED on fabricated
        #: weights with only the acceptance axis synthetic
        #: (tools/spec_serve_bench.py; VERDICT r4 #6).
        self.force_accept = 0.0

        @functools.partial(jax.jit, donate_argnums=(2, 3),
                           static_argnames=("g", "kv_window"))
        def _spec_tick(params_, dparams, cache, dcache, last_tok, pos,
                       active, fkey, f_acc, g, kv_window=None):
            """The WHOLE speculative tick as one device program: gamma
            draft forwards (lax.scan), the multi-token target verify, and
            the leading-agreement accept count: one host round trip per
            tick instead of g+1 for a host loop over g draft programs and a
            verify. Returns (tgt (B, g+1),
            n_acc (B,), cache, dcache); one host read per tick."""
            def body(carry, t):
                cur, dc = carry
                lg, dc = llama.forward(
                    dparams, cur[:, None], self.draft_cfg, dc,
                    (pos + t)[:, None], fmt=draft_fmt, interpret=interpret,
                    kv_window=kv_window, write_mask=active)
                nxt = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
                return (nxt, dc), nxt
            (_, dcache), drafts = jax.lax.scan(
                body, (last_tok, dcache), jnp.arange(g, dtype=jnp.int32))
            drafts = drafts.T                                  # (B, g)
            seq = jnp.concatenate([last_tok[:, None], drafts], axis=1)
            tpos = pos[:, None] + jnp.arange(g + 1, dtype=jnp.int32)[None]
            logits, cache = llama.forward(params_, seq, cfg, cache, tpos,
                                          fmt=fmt, interpret=interpret,
                                          kv_window=kv_window,
                                          write_mask=active)
            tgt = jnp.argmax(logits, -1).astype(jnp.int32)     # (B, g+1)
            # longest agreeing prefix, capped at g-1 (the g-th proposal's
            # KV is never in the draft cache): leading-ones count
            agree = (tgt[:, :g - 1] == drafts[:, :g - 1]).astype(jnp.int32)
            # synthetic acceptance floor (self.force_accept; measurement
            # knob, 0.0 in production — see the attribute doc above)
            force = (jax.random.uniform(fkey, agree.shape)
                     < f_acc).astype(jnp.int32)
            agree = jnp.maximum(agree, force)
            n_acc = jnp.sum(jnp.cumprod(agree, axis=1), axis=1)
            return tgt, n_acc, cache, dcache

        self._spec_tick = _spec_tick
        # draft cache must be prefilled alongside the target's (same
        # one-program chunk shape as the target; sampled token unused)
        self._draft_prefill_prog = _make_chunk_prefill(
            lambda p, t, c, q, kv_window=None: llama.forward(
                p, t, self.draft_cfg, c, q, fmt=draft_fmt,
                interpret=interpret),
            True, 0)

    def step_block(self, max_steps: int, waiters: bool = True) -> int:
        """Speculative ticks already emit multiple tokens per round trip;
        a plain decode block would bypass the draft model AND desync the
        draft cache. run(decode_block=K) therefore degrades to spec ticks."""
        return self.step()

    def _prefill_chunk(self, slot, toks, pos, kv_window=None,
                       last_idx: int = 0, key=None):
        # draft cache prefills alongside the target's — same one-program
        # row slice/forward/writeback shape (the sampled token is ignored:
        # the draft's first proposal is recomputed at tick time)
        key = self._next_key() if key is None else key
        _, self.dcache = self._draft_prefill_prog(
            self.draft_params, self.dcache, toks, pos, jnp.int32(slot),
            jnp.int32(last_idx), key, jnp.float32(0.0))
        return super()._prefill_chunk(slot, toks, pos, kv_window,
                                      last_idx=last_idx, key=key)

    def _pick_gamma(self) -> int:
        """Draft depth for this tick: acceptance-adaptive bucket walk,
        capped by the largest remaining token budget among active slots
        (no point proposing tokens nobody can emit). Fixed-gamma mode
        (gamma_adaptive=False) reproduces round-2 behavior exactly."""
        remaining = max(
            (self.slot_req[s].max_new_tokens
             - len(self.generated[self.slot_req[s].uid])
             for s in np.flatnonzero(self.active)), default=1)
        cap = max(2, remaining + 1)  # n_acc <= g-1, +1 for the bonus token
        if not self.gamma_adaptive:
            return max(2, min(self.gamma, cap))
        # EMA of fraction-of-cap acceptance: >0.7 -> deeper, <0.35 -> shallower
        # (constructor gamma is the ceiling; buckets bound compile count)
        bs = [b for b in self.GAMMA_BUCKETS if b <= self._gamma_max]
        i = min(range(len(bs)), key=lambda j: abs(bs[j] - self.gamma))
        if self._acc_ema > 0.7 and i + 1 < len(bs):
            self.gamma = bs[i + 1]
        elif self._acc_ema < 0.35 and i > 0:
            self.gamma = bs[i - 1]
        return max(2, min(self.gamma, cap))

    def step(self) -> int:
        if self._pf:
            self._advance_prefill()
        if not self.active.any():
            return len(self._pf)
        assert not np.any(self.temps[self.active] > 0), \
            "SpecEngine is greedy-only"
        g = self._pick_gamma()
        window = self._kv_window() or self.cfg.max_seq_len
        # headroom: the verify step writes KV at pos..pos+g
        window = min(self.cfg.max_seq_len,
                     max(window, _next_pow2_128(int(
                         self.pos[self.active].max()) + g + 1)))

        # 1+2+3 device half: draft scan + verify + accept count in ONE
        # program, one host read per tick (see _spec_tick)
        tgt_d, nacc_d, self.cache, self.dcache = self._spec_tick(
            self.params, self.draft_params, self.cache, self.dcache,
            jnp.asarray(self.last_tok), jnp.asarray(self.pos),
            jnp.asarray(self.active), self._next_key(),
            jnp.float32(self.force_accept), g=g, kv_window=window)
        tgt, n_accs = jax.device_get((tgt_d, nacc_d))   # (B, g+1), (B,)

        # host half: per-slot emit of the accepted prefix + bonus token
        accs = []
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            n_acc = int(n_accs[slot])
            emitted = [int(t) for t in tgt[slot, :n_acc + 1]]
            accs.append(n_acc)
            self.spec_stats["proposed"] += g
            self.spec_stats["accepted"] += n_acc
            done = False
            for tok in emitted:
                self.generated[req.uid].append(tok)
                self.pos[slot] += 1
                self.last_tok[slot] = tok
                done = (len(self.generated[req.uid]) >= req.max_new_tokens
                        or tok == req.eos_id
                        or self.pos[slot] + g + 1 >= self.cfg.max_seq_len)
                if done:
                    break
            if done:
                self._finish(slot)
        if accs:
            self._acc_ema = (0.8 * self._acc_ema
                             + 0.2 * (sum(accs) / len(accs)) / max(g - 1, 1))
        self.spec_stats["ticks"] += 1
        return int(self.active.sum()) + len(self._pf)


def _next_pow2_128(n: int) -> int:
    w = 128
    while w < n:
        w *= 2
    return w


class PagedEngine(Engine):
    """Engine with a paged KV cache (vLLM-style block tables): KV pages are
    allocated on demand as sequences grow and returned to the shared pool
    when a request finishes, so HBM holds sum-of-actual-lengths instead of
    max_batch * max_seq_len. Scheduling is inherited from Engine; only the
    cache backend differs (models/paged.py)."""

    def __init__(self, params, cfg: llama.LlamaConfig, *, max_batch: int = 8,
                 fmt: str = "nvfp4", page_size: int = 256,
                 num_pages: Optional[int] = None, cache_dtype=jnp.bfloat16,
                 interpret: bool = False, top_k: int = 0, seed: int = 0,
                 prefill_fmt: Optional[str] = None,
                 prefill_chunk: Optional[int] = None):
        from . import paged  # local import: keeps serving importable alone
        self._paged = paged
        page_size = min(page_size, cfg.max_seq_len)  # match init_paged_cache
        self.params = params
        self.cfg = cfg
        self.B = max_batch
        self.fmt = fmt
        self.prefill_fmt = prefill_fmt or fmt
        self.prefill_chunk = (min(prefill_chunk, cfg.max_seq_len)
                              if prefill_chunk else None)
        if self.prefill_fmt != fmt and \
                not {fmt, self.prefill_fmt} <= {"nvfp4", "w4a8"}:
            raise ValueError(
                f"prefill_fmt={self.prefill_fmt!r} is not "
                f"container-compatible with fmt={fmt!r}")
        self.interpret = interpret
        self.top_k = top_k
        self._key = jax.random.PRNGKey(seed)
        self.pc = paged.init_paged_cache(
            cfg, max_batch, page_size=page_size, num_pages=num_pages,
            dtype=cache_dtype)
        self.pos = np.zeros(max_batch, np.int32)
        self.active = np.zeros(max_batch, bool)
        self.last_tok = np.zeros(max_batch, np.int32)
        self.temps = np.zeros(max_batch, np.float32)
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self.generated: dict[int, list[int]] = {}
        self.finished: dict[int, list[int]] = {}

        self._pf = []
        self._fwd_takes_window = True
        # the contiguous-cache batched program does not apply to page
        # pools; paged admission batches through
        # _batched_paged_prefill_prog instead (hooks below)
        self._batched_prefill_prog = None

        # Full-batch masked paged admission (VERDICT r4 #4): every queued
        # prompt whose next chunk shares a (bucket, window) key admits in
        # ONE donated program — the FP4 weights stream once per chunk
        # shape instead of once per prompt (a bs=8 burst of short prompts
        # previously streamed them 8x through the per-slot path). Masked
        # rows' writes are redirected to the scratch page by
        # paged._write_kv, so their pages pass through untouched.
        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("kv_window",))
        def _batched_paged_prog(params, pages, bt, toks, pos, last_idx,
                                mask, key, temps, kv_window=None):
            logits, pages = paged.forward_paged(
                params, toks, cfg, pages, bt, pos, page_size=page_size,
                fmt=self.prefill_fmt, interpret=interpret,
                kv_window=kv_window, write_mask=mask)
            lg = jnp.take_along_axis(
                logits, last_idx[:, None, None], axis=1)[:, 0]    # (B, V)
            first = sample_next(lg, key, temps, top_k)
            return first, pages

        self._batched_paged_prefill_prog = _batched_paged_prog
        # jitted full-batch paged forward (score_forward's eval path only;
        # chunk admission uses the donated one-program _prefill_prog below)
        self._prefill_forward = jax.jit(
            lambda p, t, pages, bt, q: paged.forward_paged(
                p, t, cfg, pages, bt, q, page_size=page_size,
                fmt=self.prefill_fmt, interpret=interpret))

        # One-program paged chunk prefill, pools DONATED: the round-3 path
        # jitted forward_paged without donation, so every admission chunk's
        # per-layer scatter materialized a fresh copy of each (P+1, h, ps,
        # d) pool, and it sampled outside the program + ignored kv_window
        # (full-pool gather per layer). This is the paged analog of
        # _make_chunk_prefill (VERDICT r3 #4).
        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("kv_window",))
        def _paged_prefill_prog(params, pages, bt_row, toks, pos, last_idx,
                                key, temp, kv_window=None):
            logits, pages = paged.forward_paged(
                params, toks, cfg, pages, bt_row, pos,
                page_size=page_size, fmt=self.prefill_fmt,
                interpret=interpret, kv_window=kv_window)
            lg = jax.lax.dynamic_index_in_dim(logits, last_idx, axis=1,
                                              keepdims=False)       # (1, V)
            first = sample_next(lg, key, temp[None], top_k)[0]
            return first, pages

        self._paged_prefill_prog = _paged_prefill_prog

        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("kv_window",))
        def _decode_step(params, pages, bt, toks, pos, key, temps, active,
                         kv_window=None):
            logits, pages = paged.forward_paged(
                params, toks[:, None], cfg, pages, bt, pos[:, None],
                page_size=page_size, fmt=fmt, interpret=interpret,
                kv_window=kv_window, write_mask=active)
            return sample_next(logits[:, -1], key, temps, top_k), pages

        self._decode_step = _decode_step

        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnames=("kv_window", "steps"))
        def _decode_block(params, pages, bt, toks, pos, key, temps, active,
                          steps, kv_window=None):
            def body(carry, _):
                pages, toks, pos, key = carry
                key, sub = jax.random.split(key)
                logits, pages = paged.forward_paged(
                    params, toks[:, None], cfg, pages, bt, pos[:, None],
                    page_size=page_size, fmt=fmt, interpret=interpret,
                    kv_window=kv_window, write_mask=active)
                nxt = sample_next(logits[:, -1], sub, temps, top_k)
                return (pages, nxt, pos + 1, key), nxt
            (pages, _, _, _), out = jax.lax.scan(
                body, (pages, toks, pos, key), None, length=steps)
            return out, pages

        self._decode_block = _decode_block

    def score_forward(self, toks: jax.Array) -> jax.Array:
        """Eval scoring through the paged serving forward (scratch pool)."""
        from . import paged as paged_mod
        B, L = toks.shape
        ps = self.pc.page_size
        pc = paged_mod.init_paged_cache(
            self.cfg, B, page_size=ps,
            num_pages=B * (-(-L // ps)),
            dtype=self.pc.pages[0][0].dtype)
        for b in range(B):
            paged_mod.ensure_capacity(pc, b, L)
        pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None], (B, L))
        logits, _ = self._prefill_forward(self.params, toks, pc.pages,
                                          pc.block_tables, pos)
        return logits

    def _admission_batchable(self) -> bool:
        return self._batched_paged_prefill_prog is not None

    def _run_batched_admission(self, group, toks_b, pos_b, last_b, mask_b,
                               kv_window) -> jax.Array:
        # grow each admitted slot's block table to cover its padded chunk
        # (same garbage-tail contract as the per-slot path below)
        for j in group:
            self._paged.ensure_capacity(
                self.pc, j.slot, int(np.asarray(pos_b)[j.slot, -1]) + 1)
        first, self.pc.pages = self._batched_paged_prefill_prog(
            self.params, self.pc.pages, self.pc.block_tables, toks_b,
            pos_b, last_b, mask_b, self._next_key(),
            jnp.asarray(self.temps, jnp.float32), kv_window=kv_window)
        return first

    def _prefill_chunk(self, slot: int, toks, pos, kv_window=None,
                       last_idx: int = 0, key=None) -> jax.Array:
        # grow the block table to cover the whole padded chunk: the padded
        # tail writes garbage into real pages beyond the true length, which
        # the causal mask hides and decode overwrites position by position
        # (same contract as the contiguous cache). The chunk runs as ONE
        # donated program: paged flash prefill over ceil(kv_window/ps)
        # pages + in-program sampling, no pool copy (VERDICT r3 #4).
        self._paged.ensure_capacity(self.pc, slot, int(pos[0, -1]) + 1)
        key = self._next_key() if key is None else key
        first, self.pc.pages = self._paged_prefill_prog(
            self.params, self.pc.pages,
            self.pc.block_tables[slot:slot + 1], toks, pos,
            jnp.int32(last_idx), key,
            jnp.asarray(self.temps[slot], jnp.float32),
            kv_window=kv_window)
        return first

    def _decode(self, toks: jax.Array, pos: jax.Array) -> jax.Array:
        # grow block tables so this tick's write position is covered;
        # inactive slots stay parked on the scratch page at position 0
        for slot in np.flatnonzero(self.active):
            self._paged.ensure_capacity(self.pc, slot,
                                        int(self.pos[slot]) + 1)
        nxt, self.pc.pages = self._decode_step(
            self.params, self.pc.pages, self.pc.block_tables, toks, pos,
            self._next_key(), jnp.asarray(self.temps),
            jnp.asarray(self.active), kv_window=self._kv_window())
        return nxt

    def _grow_for_block(self, pos, steps: int) -> None:
        # grow block tables to cover the whole block's write range up front
        # (pos may be a PROJECTED position vector under pipelined dispatch)
        for slot in np.flatnonzero(self.active):
            self._paged.ensure_capacity(self.pc, slot,
                                        int(pos[slot]) + steps)

    def _dispatch_block(self, toks, pos, steps: int, kv_window):
        out, self.pc.pages = self._decode_block(
            self.params, self.pc.pages, self.pc.block_tables, toks, pos,
            self._next_key(), jnp.asarray(self.temps),
            jnp.asarray(self.active), steps, kv_window=kv_window)
        return out

    def _release(self, slot: int) -> None:
        self._paged.release_slot(self.pc, slot)
        self.pos[slot] = 0
        self.last_tok[slot] = 0

    def pages_in_use(self) -> int:
        return sum(len(u) for u in self.pc.used)
