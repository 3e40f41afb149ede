"""Decode and prefill attention, and the KV-cache write, in plain XLA.

The engines call these with a static window: decode attends only the
first ``nb * page_size`` cache positions (or the first ``nb`` block-table
pages), prefill only the first ``ns`` KV blocks, so the bytes read track
the batch's bucketed length rather than max_seq_len. Within the window a
per-query causal mask against absolute positions does the rest. Inputs
stay in their storage dtype (bf16 or float8_e4m3fn) until the dots, where
XLA fuses the upcast; Q@K is a bf16 dot with f32 accumulation, softmax
and P@V are f32. GQA groups the query heads per KV head instead of repeating
KV.

These ops have one implementation, plain XLA, so they take no part in
the kernel dispatch (ops/dispatch.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_NEG_INF = -1e30


def _operands(*xs):
    """Round the Q@K operands to bf16. The GPU multiplies bf16 with f32
    accumulation; XLA's CPU backend has no bf16 x bf16 -> f32 dot for
    every layout, so there the (exactly representable) values are widened
    to f32 — the same products and sums."""
    dt = jnp.float32 if jax.default_backend() == "cpu" else jnp.bfloat16
    return [x.astype(jnp.bfloat16).astype(dt) for x in xs]


def _attend(q: jax.Array, k: jax.Array, v: jax.Array, qpos: jax.Array, *,
            headed: bool) -> jax.Array:
    """q (B, T, H, d); k/v (B, S, Hkv, d) flat or (B, Hkv, S, d) headed;
    qpos (B, T) absolute query positions; kv position s is visible to a
    query at p when s <= p. Returns (B, T, H, d) bf16."""
    B, T, H, d = q.shape
    Hkv, S = (k.shape[1], k.shape[2]) if headed else (k.shape[2], k.shape[1])
    kv = "bksd" if headed else "bskd"
    qg, k, v = _operands(q.reshape(B, T, Hkv, H // Hkv, d), k, v)
    logits = jnp.einsum(f"btkgd,{kv}->bkgts", qg, k,
                        preferred_element_type=jnp.float32)
    logits = logits * np.float32(1.0 / np.sqrt(d))
    mask = jnp.arange(S)[None, None, :] <= qpos[:, :, None]        # (B,T,S)
    logits = jnp.where(mask[:, None, None], logits, _NEG_INF)
    p = jax.nn.softmax(logits, axis=-1)
    o = jnp.einsum(f"bkgts,{kv}->btkgd", p, v.astype(jnp.float32),
                   preferred_element_type=jnp.float32)
    return o.reshape(B, T, H, d).astype(jnp.bfloat16)


def _gather_pages(pages: jax.Array, bt: jax.Array, headed: bool):
    """(P, ps, Hkv, d) / headed (P, Hkv, ps, d) pool + (B, nb) page ids ->
    the sequences' windows (B, nb*ps, Hkv, d) / (B, Hkv, nb*ps, d)."""
    g = pages[bt]                                    # (B, nb, ...)
    B, nb = bt.shape
    if headed:
        _, Hkv, ps, d = pages.shape
        return g.transpose(0, 2, 1, 3, 4).reshape(B, Hkv, nb * ps, d)
    _, ps, Hkv, d = pages.shape
    return g.reshape(B, nb * ps, Hkv, d)


@functools.partial(jax.jit, static_argnames=("nb", "page_size", "headed"))
def paged_decode_attention(q: jax.Array, k_pages: jax.Array,
                           v_pages: jax.Array, block_tables: jax.Array,
                           pos: jax.Array, *, nb: int, page_size: int,
                           headed: bool = False) -> jax.Array:
    """One-token-per-sequence attention over paged KV.

    q            : (B, H, d)   current-step queries (post-RoPE)
    k_pages      : (P, ps, Hkv, d) page pool (bf16 or float8_e4m3fn), or
                   (P, Hkv, ps, d) with headed=True (the paged engines'
                   layout)
    v_pages      : same shape/layout as k_pages
    block_tables : (B, max_pages) int32 page ids (>= nb columns)
    pos          : (B,) int32 absolute position of each query
    nb           : pages to visit (static) — callers pass the batch max
                   length bucketed, ceil((max(pos)+1)/ps)
    returns      : (B, H, d) bf16
    """
    ps = k_pages.shape[2] if headed else k_pages.shape[1]
    assert ps == page_size and block_tables.shape[1] >= nb
    bt = block_tables[:, :nb].astype(jnp.int32)
    k = _gather_pages(k_pages, bt, headed)
    v = _gather_pages(v_pages, bt, headed)
    o = _attend(q[:, None], k, v, pos.astype(jnp.int32)[:, None],
                headed=headed)
    return o[:, 0]


def _window(c: jax.Array, window: int, headed: bool) -> jax.Array:
    """The first `window` positions of a contiguous cache (static)."""
    S = c.shape[2] if headed else c.shape[1]
    return c[:, :, :window] if headed else c[:, :min(window, S)]


@functools.partial(jax.jit, static_argnames=("window", "headed"))
def decode_attention(q: jax.Array, ck: jax.Array, cv: jax.Array,
                     pos: jax.Array, *, window: int,
                     headed: bool = False) -> jax.Array:
    """The decode-attention op: q (B, H, d) against the first `window`
    positions of a contiguous cache ((B, S, Hkv, d), or (B, Hkv, S, d)
    with headed=True), causal at pos (B,). Returns (B, H, d) bf16."""
    o = _attend(q[:, None], _window(ck, window, headed),
                _window(cv, window, headed),
                pos.astype(jnp.int32)[:, None], headed=headed)
    return o[:, 0]


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= n (>= lo): the compile-count-bounding
    bucket for the static window (<= log2(max_seq/ps) programs)."""
    b = lo
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Causal prefill: multi-token queries against KV that already holds the
# chunk (the chunked-prefill contract: query t of row b sits at
# pos0[b] + t and attends kv positions <= its own).
# ---------------------------------------------------------------------------


def _chunk_positions(pos0: jax.Array, T: int) -> jax.Array:
    return pos0.astype(jnp.int32)[:, None] + jnp.arange(T, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("ns",))
def flash_prefill_paged(q: jax.Array, k_pages: jax.Array,
                        v_pages: jax.Array, block_tables: jax.Array,
                        pos0: jax.Array, *, ns: int) -> jax.Array:
    """Causal chunk prefill over PAGED KV (headed (P, Hkv, ps, d) pool),
    reading the first ns block-table pages of each row.

    q    : (B, T, H, d) post-RoPE; query t of row b sits at pos0[b] + t
    returns (B, T, H, d) bf16."""
    assert block_tables.shape[1] >= ns
    bt = block_tables[:, :ns].astype(jnp.int32)
    k = _gather_pages(k_pages, bt, headed=True)
    v = _gather_pages(v_pages, bt, headed=True)
    return _attend(q, k, v, _chunk_positions(pos0, q.shape[1]), headed=True)


@functools.partial(jax.jit, static_argnames=("window", "headed"))
def prefill_attention(q: jax.Array, ck: jax.Array, cv: jax.Array,
                      pos0: jax.Array, *, window: int,
                      headed: bool = False) -> jax.Array:
    """The prefill-attention op: a chunk of queries q (B, T, H, d) at
    positions pos0[b] + t against the first `window` positions of a
    contiguous cache that already holds the chunk. Returns (B, T, H, d)
    bf16."""
    return _attend(q, _window(ck, window, headed), _window(cv, window, headed),
                   _chunk_positions(pos0, q.shape[1]), headed=headed)


# ---------------------------------------------------------------------------
# KV-cache write: one step's K/V rows per sequence at per-sequence
# positions, as a dynamic_update_slice on the (donated) cache.
# ---------------------------------------------------------------------------

def quantize_kv(x: jax.Array, dtype) -> jax.Array:
    """Cast new K/V values to the cache dtype with the narrowing PINNED at
    x's own dtype.

    Without the barrier, XLA is free to compile the upstream chain
    f32 -> bf16 (model dtype) -> fp8 (cache dtype) as either two RNE
    roundings or one fused f32 -> fp8 convert, and it can choose
    differently per program, so two write paths would store different fp8
    bytes for the same values. The barrier makes the x-dtype value a real
    program point, so every write path stores fp8(bf16(v)) identically.
    Reference bar: bit-exact round-trips
    (quantization/fp4/quantization_utils_fp4_test.cc:103-133)."""
    if x.dtype == dtype:
        return x
    return jax.lax.optimization_barrier(x).astype(dtype)


def kv_write(ck: jax.Array, cv: jax.Array, k_new: jax.Array,
             v_new: jax.Array, pos: jax.Array,
             mask: jax.Array | None = None, *, headed: bool = False):
    """Write T new positions per sequence into the cache.

    ck/cv       : (B, S, Hkv, d) flat or (B, Hkv, S, d) with headed=True
    k_new/v_new : (B, T, Hkv, d) (any float dtype; cast to cache dtype)
    pos         : (B,) int32 first write position per sequence
    mask        : optional (B,) bool; rows with mask[b]=False keep their
                  cache content bit-exactly (a mid-prefill slot swept along
                  in a batched decode step must not be overwritten)
    returns the updated (ck, cv); under jit with donated caches XLA updates
    them in place."""
    if headed:
        k_new = k_new.transpose(0, 2, 1, 3)
        v_new = v_new.transpose(0, 2, 1, 3)
    axis = 2 if headed else 1

    def start(s):
        return tuple(s if a == axis - 1 else 0 for a in range(3))

    def upd(c, new, s, keep):
        if keep is not None:
            old = jax.lax.dynamic_slice(c, start(s), new.shape)
            new = jnp.where(keep, new, old)
        return jax.lax.dynamic_update_slice(c, new, start(s))

    pos = pos.astype(jnp.int32)
    out = []
    for c, new in ((ck, k_new), (cv, v_new)):
        new = quantize_kv(new, c.dtype)
        if mask is None:
            out.append(jax.vmap(lambda c, n, s: upd(c, n, s, None))(
                c, new, pos))
        else:
            out.append(jax.vmap(upd)(c, new, pos, mask))
    return tuple(out)

