#!/usr/bin/env python
"""Speculative-decoding tick latency on the real chip.

Measures SpecEngine.step() wall time per tick — with the fused tick
(serving._spec_tick: draft lax.scan + multi-token verify + accept count in
ONE device program) this is ~(device draft+verify) + ONE host round trip,
vs the round-2 host loop's g+1 round trips per tick.

Acceptance with fabricated random weights is ~0 (a random draft never
agrees with the target), so tokens/s here is NOT meaningful — an honest
end-to-end spec speedup needs a trained draft/target pair. What IS
meaningful and measured: the tick's fixed cost, which bounds the draft
overhead spec decoding pays per emitted token at any acceptance rate.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from petit_jax.models import llama, serving


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--draft-layers", type=int, default=2)
    p.add_argument("--gamma", type=int, default=5)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--format", default="nvfp4p2")
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sb", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "serve_bench.py"))
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)

    cfg = llama.LlamaConfig.llama3_8b(max_seq_len=args.seq,
                                      vocab_size=32768,
                                      num_layers=args.layers)
    dcfg = llama.LlamaConfig.llama3_8b(max_seq_len=args.seq,
                                       vocab_size=32768,
                                       num_layers=args.draft_layers)
    rng = np.random.default_rng(0)
    params = sb.build_model(cfg, rng, fmt=args.format)
    dparams = sb.build_model(dcfg, rng, fmt=args.format)
    eng = serving.SpecEngine(params, cfg, dparams, dcfg, gamma=args.gamma,
                             gamma_adaptive=False, max_batch=args.bs,
                             fmt=args.format, draft_fmt=args.format)
    reqs = [serving.Request(
        uid=i, tokens=rng.integers(0, 32768, 16).astype(np.int32),
        max_new_tokens=200) for i in range(args.bs)]
    for r in reqs:
        eng.add_request(r)
    while eng._pf:
        eng._advance_prefill()
    eng.step()   # compile tick program
    eng.step()   # discard first post-compile call
    ts = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        eng.step()
        ts.append(time.perf_counter() - t0)
    tick = min(ts)
    acc = eng.spec_stats["accepted"] / max(eng.spec_stats["proposed"], 1)
    print(f"# SPEC tick: target {args.layers}L draft {args.draft_layers}L "
          f"g={args.gamma} bs={args.bs} fmt={args.format}")
    print(f"# tick={tick * 1e3:.1f} ms min / "
          f"{np.median(ts) * 1e3:.1f} ms median  "
          f"(fabricated-weights acceptance {acc:.2f} — tokens/s not "
          f"meaningful without a trained pair)")
    import json
    print(json.dumps({"metric": "spec_tick_ms",
                      "value": round(tick * 1e3, 2), "unit": "ms",
                      "vs_baseline": round(
                          (args.gamma + 1) * 35.0 / (tick * 1e3), 2)}))


if __name__ == "__main__":
    main()
