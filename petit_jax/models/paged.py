"""Paged KV cache: fixed-size pages + per-sequence block tables.

Serving-memory parity with vLLM-style engines (beyond the reference, which
has no serving layer): instead of one contiguous (B, max_seq, h, d) cache
per layer — whose HBM is reserved at max_seq for every slot — KV lives in
a shared pool of pages allocated on demand as sequences grow, so ragged
batches only pay for what they use.

Static-shape design: the device side is pure fixed-shape
gather/scatter — a (B, max_pages) block table indexes the page pool; the
decode step dynamic-update-slices one (h, d) row into the right
(page, offset) and attention gathers each sequence's pages into a
(max_pages * page_size, h, d) view masked by position. The page allocator
(free list, per-slot page counts) is plain host Python in the engine loop,
exactly like slot scheduling.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import llama
from ..ops.kernels import attention as attn_kernels


@dataclasses.dataclass
class PagedKVCache:
    """Host handle: per-layer page pools + block tables + allocator state.

    The pool holds ``num_pages`` allocatable pages plus one extra physical
    *scratch* page (index ``num_pages``). Block tables of slots with no
    allocation point at the scratch page, so a batched decode step that
    includes stale/inactive slots scribbles only into scratch — never into
    a page that was released and re-allocated to another sequence.
    """
    pages: List[Tuple[jax.Array, jax.Array]]   # per layer (k, v):
    #   (num_pages + 1, n_kv, page_size, d) — "headed" layout
    block_tables: jax.Array                     # (B, max_pages) int32
    page_size: int
    num_pages: int                              # allocatable (excl. scratch)
    free: list                                  # host free-page list
    used: list                                  # per-slot list of page ids

    @property
    def max_pages(self) -> int:
        return int(self.block_tables.shape[1])

    @property
    def scratch_page(self) -> int:
        return self.num_pages


def init_paged_cache(cfg: llama.LlamaConfig, batch: int, *,
                     page_size: int = 256, num_pages: int | None = None,
                     dtype=jnp.bfloat16) -> PagedKVCache:
    # Clamped for tiny test configs.
    page_size = min(page_size, cfg.max_seq_len)
    assert cfg.max_seq_len % page_size == 0
    if num_pages is None:  # enough for every slot at max_seq_len
        num_pages = batch * (cfg.max_seq_len // page_size)
    max_pages = cfg.max_seq_len // page_size
    shape = (num_pages + 1, cfg.num_kv_heads, page_size, cfg.head_dim)
    pages = [(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))
             for _ in range(cfg.num_layers)]
    return PagedKVCache(
        pages=pages,
        block_tables=jnp.full((batch, max_pages), num_pages, jnp.int32),
        page_size=page_size, num_pages=num_pages,
        free=list(range(num_pages - 1, -1, -1)),
        used=[[] for _ in range(batch)])


def ensure_capacity(cache: PagedKVCache, slot: int, upto_pos: int) -> None:
    """Host-side allocator: grow slot's block table to cover position
    upto_pos (exclusive). Raises when the pool is exhausted."""
    need = -(-(upto_pos) // cache.page_size)
    bt = cache.block_tables
    while len(cache.used[slot]) < need:
        if not cache.free:
            raise RuntimeError("paged KV pool exhausted")
        page = cache.free.pop()
        bt = bt.at[slot, len(cache.used[slot])].set(page)
        cache.used[slot].append(page)
    cache.block_tables = bt


def release_slot(cache: PagedKVCache, slot: int) -> None:
    """Return a slot's pages to the pool and point its block table back at
    the scratch page (stale decode writes must not hit reusable pages)."""
    cache.free.extend(reversed(cache.used[slot]))
    cache.used[slot] = []
    cache.block_tables = cache.block_tables.at[slot].set(cache.scratch_page)


def _write_kv(pages_kv, bt_rows, new_k, new_v, pos, page_size,
              write_mask=None):
    """Scatter one step's k/v (B, T, h, d) into the pools at positions
    pos (B, T) using block-table rows bt_rows (B, max_pages).

    One flat scatter per pool (not a dynamic_update_slice per token): in
    the headed (P, h, ps, d) layout each (token, head) pair is one row
    index into the pool viewed as (P * h * ps, d), so XLA emits one
    vectorized scatter over a (B*T, h) index array.

    write_mask (B,) bool: rows with False get their writes redirected to
    the scratch page (last physical page) — a mid-prefill slot swept along
    in a batched decode step must not scribble into its own real pages.
    """
    k_pages, v_pages = pages_kv
    B, T = pos.shape
    nh = k_pages.shape[1]
    page_idx = jnp.take_along_axis(bt_rows, pos // page_size, axis=1)
    if write_mask is not None:
        scratch = k_pages.shape[0] - 1
        page_idx = jnp.where(write_mask[:, None], page_idx, scratch)
        pos = jnp.where(write_mask[:, None], pos, 0)
    # (B*T, h) row ids into the (P*h*ps, d) view
    row_idx = ((page_idx.reshape(-1)[:, None] * nh
                + jnp.arange(nh, dtype=jnp.int32)[None, :]) * page_size
               + (pos % page_size).reshape(-1)[:, None])

    def write_one(pages, new):
        P, h, ps, d = pages.shape
        flat = pages.reshape(P * h * ps, d)
        flat = flat.at[row_idx].set(attn_kernels.quantize_kv(
            new.reshape(B * T, h, d), pages.dtype))
        return flat.reshape(P, h, ps, d)

    return write_one(k_pages, new_k), write_one(v_pages, new_v)


def attention_paged(x, lp, pages_kv, bt_rows, pos, cfg, *, fmt,
                    page_size, interpret, kv_window=None, write_mask=None):
    """llama.attention with the KV in pages. Returns (out, new_pages).

    With kv_window set and T == 1 decode attention reads ONLY the first
    ceil(kv_window/page_size) block-table entries per sequence (unallocated
    slots point at the scratch page), so decode traffic is proportional to
    actual context, not max_seq."""
    B, T, H = x.shape
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lin = lambda inp, layer: llama.linear(inp, layer, fmt=fmt,
                                          interpret=interpret)
    if "wqkv" in lp:
        qkv = lin(x, lp["wqkv"])
        s0, s1 = nq * d, (nq + nkv) * d
        q, k, v = qkv[..., :s0], qkv[..., s0:s1], qkv[..., s1:]
        q = q.reshape(B, T, nq, d)
        k = k.reshape(B, T, nkv, d)
        v = v.reshape(B, T, nkv, d)
    else:
        q = lin(x, lp["wq"]).reshape(B, T, nq, d)
        k = lin(x, lp["wk"]).reshape(B, T, nkv, d)
        v = lin(x, lp["wv"]).reshape(B, T, nkv, d)
    q = llama.rope(q, pos, cfg.rope_theta)
    k = llama.rope(k, pos, cfg.rope_theta)

    new_pages = _write_kv(pages_kv, bt_rows, k, v, pos, page_size,
                          write_mask=write_mask)
    k_pages, v_pages = new_pages
    if kv_window is not None and T == 1:
        nb = min(-(-kv_window // page_size), bt_rows.shape[1])
        o = attn_kernels.paged_decode_attention(
            q.reshape(B, nq, d), k_pages, v_pages, bt_rows, pos[:, 0],
            nb=nb, page_size=page_size, headed=True)
        o = o.reshape(B, T, nq * d).astype(x.dtype)
        return lin(o, lp["wo"]), new_pages
    if kv_window is not None:
        # paged chunk prefill over the first ceil(window/ps) pages instead
        # of the whole (B, max_pages*ps, h, d) pool view (chunked-prefill
        # contract: pos[b, t] = pos[b, 0] + t)
        ns = min(-(-kv_window // page_size), bt_rows.shape[1])
        o = attn_kernels.flash_prefill_paged(
            q, k_pages, v_pages, bt_rows, pos[:, 0], ns=ns)
        o = o.reshape(B, T, nq * d).astype(x.dtype)
        return lin(o, lp["wo"]), new_pages
    # gather each sequence's pages (headed (P,h,ps,d)) -> (B, S_view, nkv, d)
    k_all = k_pages[bt_rows].transpose(0, 1, 3, 2, 4).reshape(
        B, -1, nkv, d).astype(x.dtype)
    v_all = v_pages[bt_rows].transpose(0, 1, 3, 2, 4).reshape(
        B, -1, nkv, d).astype(x.dtype)
    S = k_all.shape[1]
    # per-query causal mask (see llama.attention): (B,1,T,S)
    kv_pos = jnp.arange(S)[None, None, :]
    attn_mask = (kv_pos <= pos[:, :, None])[:, None]

    rep = nq // nkv
    k_all = jnp.repeat(k_all, rep, axis=2)
    v_all = jnp.repeat(v_all, rep, axis=2)
    qf = q.astype(jnp.float32) / np.sqrt(d)
    logits = jnp.einsum("bthd,bshd->bhts", qf, k_all.astype(jnp.float32))
    logits = jnp.where(attn_mask, logits, -1e30)
    p = jax.nn.softmax(logits, axis=-1)
    o = jnp.einsum("bhts,bshd->bthd", p, v_all.astype(jnp.float32))
    o = o.reshape(B, T, nq * d).astype(x.dtype)
    return lin(o, lp["wo"]), new_pages


def forward_paged(params, tokens, cfg: llama.LlamaConfig, pages, bt, pos, *,
                  page_size: int, fmt: str = "nvfp4",
                  interpret: bool = False, kv_window=None, write_mask=None):
    """llama.forward with paged KV: (logits, new_pages). `pages` is the
    per-layer list, `bt` the (B, max_pages) block table (pre-grown via
    ensure_capacity), pos (B, T) absolute positions. kv_window: see
    llama.forward. write_mask (B,) bool: rows with False write to the
    scratch page only (see _write_kv)."""
    B, T = tokens.shape
    x = params["embed"][tokens]
    new_pages = []
    for i, lp in enumerate(params["layers"]):
        h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        a, np_i = attention_paged(h, lp, pages[i], bt, pos, cfg, fmt=fmt,
                                  page_size=page_size, interpret=interpret,
                                  kv_window=kv_window,
                                  write_mask=write_mask)
        new_pages.append(np_i)
        x = x + a
        h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + llama.mlp(h, lp, fmt=fmt, interpret=interpret)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = llama.linear(x, params["lm_head"], fmt=fmt, interpret=interpret)
    return logits, new_pages
