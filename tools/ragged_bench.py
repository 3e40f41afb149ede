#!/usr/bin/env python
"""Ragged-batch decode attention scaling (VERDICT r2 weak #4 / r3 #5).

Measures whether a ragged batch pays PER-SLOT KV traffic or batch-max
traffic in the fused decode-attention kernel. Three cases at a fixed
static page-block axis (nb = batch-max bucket):

  long    : every slot at the long context      -> B x nb pages of traffic
  ragged  : ONE slot long, the rest short       -> nb + (B-1) pages
  short   : every slot short (same nb!)         -> B pages

A batch-max implementation times long == ragged; the per-slot early-exit
(clamped index map + @pl.when skip, ops/kernels/attention.py) should put
ragged near short + (nb-1) pages. `short@nb=1` is the bucketed floor the
engines actually dispatch (pow2_bucket).

No reference analog (attention is SGLang's job there); the scaling target
is the paged-attention ideal: traffic proportional to sum of context
lengths, not B x max.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from petit_jax.ops.kernels import attention as att
from petit_jax.utils import benchlib


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--hkv", type=int, default=8)
    p.add_argument("--g", type=int, default=4)        # GQA group
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--ps", type=int, default=128)
    p.add_argument("--long-ctx", type=int, default=4096)
    p.add_argument("--short-ctx", type=int, default=128)
    p.add_argument("--n1", type=int, default=50)
    args = p.parse_args()

    B, Hkv, G, d, ps = args.bs, args.hkv, args.g, args.d, args.ps
    H = Hkv * G
    nb = args.long_ctx // ps
    pool_pages = B * nb + 8

    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.standard_normal((B, H, d)), jnp.bfloat16)
    kp = jnp.asarray(rng.standard_normal((pool_pages, ps, Hkv, d)) * 0.1,
                     jnp.bfloat16)
    vp = jnp.asarray(rng.standard_normal((pool_pages, ps, Hkv, d)) * 0.1,
                     jnp.bfloat16)
    bt = jnp.asarray(
        rng.permutation(pool_pages)[:B * nb].reshape(B, nb).astype(np.int32))

    long_pos = args.long_ctx - 1
    short_pos = args.short_ctx - 1
    cases = {
        "long  ": (nb, np.full(B, long_pos, np.int32)),
        "ragged": (nb, np.array([long_pos] + [short_pos] * (B - 1),
                                np.int32)),
        "short ": (nb, np.full(B, short_pos, np.int32)),
        "short@nb_bucketed": (att.pow2_bucket(args.short_ctx // ps),
                              np.full(B, short_pos, np.int32)),
    }

    kv_bytes_page = ps * Hkv * d * 2 * 2  # k + v, bf16
    print(f"# B={B} H={H} (Hkv={Hkv} G={G}) d={d} ps={ps} "
          f"long={args.long_ctx} short={args.short_ctx} nb={nb}")
    results = {}
    for name, (nb_c, pos_np) in cases.items():
        pos = jnp.asarray(pos_np)

        def call(q2, kp2, vp2):
            return att.paged_decode_attention(
                q2, kp2, vp2, bt, pos, nb=nb_c, page_size=ps)

        pages = int(np.sum(np.minimum(pos_np // ps + 1, nb_c)))
        t = benchlib.marginal_time(call, q, kp, vp, n1=args.n1,
                                   bytes_hint=pages * kv_bytes_page)
        results[name.strip()] = t
        print(f"# {name}: {t * 1e6:8.1f} us  "
              f"({pages} pages = {pages * kv_bytes_page / 1e6:.1f} MB, "
              f"{pages * kv_bytes_page / t / 1e9:6.1f} GB/s)", flush=True)

    t_long, t_rag, t_short = (results["long"], results["ragged"],
                              results["short"])
    # 0 = batch-max behavior (ragged == long); 1 = perfect per-slot
    frac = (t_long - t_rag) / max(t_long - t_short, 1e-12)
    import json
    print(json.dumps({
        "metric": "ragged_decode_per_slot_saving_frac",
        "value": round(float(frac), 3),
        "unit": "fraction of (long - short) recovered",
        "vs_baseline": round(float(t_long / t_rag), 3),
    }))


if __name__ == "__main__":
    main()
