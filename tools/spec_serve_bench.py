#!/usr/bin/env python
"""Serve-scale speculative decoding: MEASURED e2e tok/s vs acceptance
(VERDICT r4 #6 — replaces the round-4 1.36x projection).

Fabricated weights give ~0 true acceptance, so the acceptance axis is
swept synthetically with SpecEngine.force_accept (each draft position is
force-accepted with probability f inside the verify program — compute
path identical to real serving, only token QUALITY is meaningless).
Everything else is measured on the real chip with the real kernels:
32L 8B-class nvfp4p2 target, 2L draft, real caches, real tick programs.

Output: tok/s per (gamma, f) cell, the plain decode-block baseline at the
same batch, and the acceptance break-even per gamma.

Run: python tools/spec_serve_bench.py --layers 32 --reps 3
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from petit_jax.models import llama, serving
from petit_jax.ops import autotune


def load_sb():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sb", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "serve_bench.py"))
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)
    return sb


def time_ticks(eng, n_ticks: int, reps: int):
    """Median-of-reps wall time for n_ticks engine steps (each step reads
    its tokens back — the real serving sync pattern)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            eng.step()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def spec_cell(sb, cfg, dcfg, params, dparams, bs, gamma, f, fmt,
              n_ticks, reps, rng):
    eng = serving.SpecEngine(params, cfg, dparams, dcfg, gamma=gamma,
                             gamma_adaptive=False, max_batch=bs,
                             fmt=fmt, draft_fmt=fmt)
    eng.force_accept = f
    reqs = [serving.Request(
        uid=i, tokens=rng.integers(0, 32768, 16).astype(np.int32),
        max_new_tokens=cfg.max_seq_len - 16 - gamma - 2)
        for i in range(bs)]
    for r in reqs:
        eng.add_request(r)
    while eng._pf:
        eng._advance_prefill()
    eng.step()          # compile
    eng.step()          # discard first post-compile call
    eng.spec_stats = {"proposed": 0, "accepted": 0, "ticks": 0}
    gen0 = {u: len(v) for u, v in eng.generated.items()}
    t = time_ticks(eng, n_ticks, reps)
    # tokens emitted during the LAST timed rep's ticks: emitted/tick is
    # stationary (stats accumulate over all reps; use the per-tick mean)
    ticks = eng.spec_stats["ticks"]
    emitted = sum(len(v) for v in eng.generated.values()) \
        + sum(len(v) for v in eng.finished.values()) - sum(gen0.values())
    per_tick = emitted / max(ticks, 1)
    tok_s = per_tick * n_ticks / t
    acc = eng.spec_stats["accepted"] / max(eng.spec_stats["proposed"], 1)
    return tok_s, t / n_ticks, per_tick, acc


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--draft-layers", type=int, default=2)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--format", default="nvfp4p2")
    p.add_argument("--gammas", default="3,5,7")
    p.add_argument("--force", default="0.0,0.5,0.8,0.95")
    p.add_argument("--ticks", type=int, default=12)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--block", type=int, default=32,
                   help="decode-block size for the plain baseline")
    args = p.parse_args()

    autotune.load_table()
    sb = load_sb()
    cfg = llama.LlamaConfig.llama3_8b(max_seq_len=args.seq,
                                      vocab_size=32768,
                                      num_layers=args.layers)
    dcfg = llama.LlamaConfig.llama3_8b(max_seq_len=args.seq,
                                       vocab_size=32768,
                                       num_layers=args.draft_layers)
    rng = np.random.default_rng(0)
    params = sb.build_model(cfg, rng, fmt=args.format)
    dparams = sb.build_model(dcfg, rng, fmt=args.format)

    # plain decode-block baseline (same target, same batch)
    eng0 = serving.Engine(params, cfg, max_batch=args.bs, fmt=args.format)
    reqs = [serving.Request(
        uid=i, tokens=rng.integers(0, 32768, 16).astype(np.int32),
        max_new_tokens=cfg.max_seq_len - 32) for i in range(args.bs)]
    for r in reqs:
        eng0.add_request(r)
    while eng0._pf:
        eng0._advance_prefill()
    K = args.block
    toks = jnp.asarray(eng0.last_tok)
    pos = jnp.asarray(eng0.pos)
    out = eng0._run_decode_block(toks, pos, K)      # compile
    np.asarray(out)
    ts = []
    for _ in range(args.reps + 1):
        t0 = time.perf_counter()
        out = eng0._run_decode_block(toks, pos, K)
        np.asarray(out)
        ts.append(time.perf_counter() - t0)
    base_tok_s = args.bs * K / min(ts[1:])
    print(f"# baseline decode-block K={K}: {base_tok_s:.1f} tok/s "
          f"({min(ts[1:]) / K * 1e3:.2f} ms/step)", flush=True)

    rows = []
    for gamma in map(int, args.gammas.split(",")):
        for f in map(float, args.force.split(",")):
            tok_s, tick_s, per_tick, acc = spec_cell(
                sb, cfg, dcfg, params, dparams, args.bs, gamma, f,
                args.format, args.ticks, args.reps, rng)
            be = "WIN" if tok_s > base_tok_s else "lose"
            print(f"# g={gamma} f={f:.2f}: {tok_s:7.1f} tok/s  "
                  f"tick={tick_s * 1e3:6.1f} ms  emitted/tick="
                  f"{per_tick:5.2f} (batch total)  measured-acc={acc:.2f}"
                  f"  [{be}]", flush=True)
            rows.append({"gamma": gamma, "force": f,
                         "tok_s": round(tok_s, 1),
                         "tick_ms": round(tick_s * 1e3, 2),
                         "per_tick": round(per_tick, 2),
                         "acc": round(acc, 3)})
    print(json.dumps({"baseline_tok_s": round(base_tok_s, 1),
                      "cells": rows}))


if __name__ == "__main__":
    main()
