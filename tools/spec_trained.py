#!/usr/bin/env python
"""Speculative decoding with a TRAINED draft/target pair.

Fabricated-random weights accept ~0 proposals, so they cannot show spec
serving winning anything. This tool makes the acceptance half measurable:

  Task: a deterministic second-order chain x[t+1] = perm[(x[t] + x[t-1])
  % V] over a fixed random permutation. Both models learn it from data;
  generation then walks the chain IN-distribution indefinitely — unlike
  the recall task, whose continuation is a single token. The target (4L,
  h=128) learns it near-perfectly; the draft (1L, h=64) imperfectly — a
  real skill gap, so acceptance is a measured property of trained models,
  not an assumption.

  Measured: (a) draft/target standalone next-token accuracy, (b) REAL
  acceptance through SpecEngine.spec_stats, (c) end-to-end tokens/s of
  SpecEngine.run vs Engine.run(decode_block=K) on the same target —
  wall-clock, the reference's bench discipline — and (d) the serve-scale
  break-even: with the round-3 measured tick/block costs at 8B-class
  scale, the acceptance this pair achieves maps to a projected speedup
  (printed as a curve, flagged as a projection).

  Caveat printed with the result: at gate scale (h=128) device compute is
  ~free and per-PROGRAM cost dominates, where decode blocks amortize
  better than spec ticks (K tokens/program vs <=gamma) — so at THIS scale
  spec can lose e2e even at high acceptance. The honest claim is the
  acceptance + the break-even curve; the serve-scale win requires a
  serve-scale trained pair no environment without checkpoints can have.

Usage: python tools/spec_trained.py [--platform cpu] [--gamma 5]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

V = 64
SEQ = 32


def make_chain_batch(rng, batch, perm, L=SEQ):
    toks = np.zeros((batch, L), np.int32)
    toks[:, 0] = rng.integers(0, V, batch)
    toks[:, 1] = rng.integers(0, V, batch)
    for t in range(2, L):
        toks[:, t] = perm[(toks[:, t - 1] + toks[:, t - 2]) % V]
    return toks


def train_chain_model(cfg, perm, steps, seed, lr=2e-3, seq=SEQ,
                      batch=64):
    import jax
    import jax.numpy as jnp
    from petit_jax.models import llama

    params = llama.init_params(cfg, jax.random.PRNGKey(seed),
                               dtype=jnp.float32)

    def loss_fn(p, toks):
        logits, _ = llama.forward(p, toks[:, :-1], cfg)
        lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        tgt = toks[:, 1:]
        nll = -jnp.take_along_axis(lp, tgt[..., None], -1)[..., 0]
        return nll[:, 1:].mean()   # positions >= 2 are rule-determined

    @jax.jit
    def step(p, m, v, t, toks):
        lr_t = lr * (0.5 * (1 + jnp.cos(jnp.pi * t / steps)) * 0.9 + 0.1)
        loss, g = jax.value_and_grad(loss_fn)(p, toks)
        m = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, m, g)
        v = jax.tree.map(lambda a, b: 0.999 * a + 0.001 * (b * b), v, g)
        mh = jax.tree.map(lambda a: a / (1 - 0.9 ** t), m)
        vh = jax.tree.map(lambda a: a / (1 - 0.999 ** t), v)
        p = jax.tree.map(
            lambda a, b, c: a - lr_t * b / (jnp.sqrt(c) + 1e-8), p, mh, vh)
        return p, m, v, loss

    m = jax.tree.map(jnp.zeros_like, params)
    v = jax.tree.map(jnp.zeros_like, params)
    rng = np.random.default_rng(seed + 1)
    for t in range(1, steps + 1):
        params, m, v, loss = step(params, m, v, jnp.float32(t),
                                  jnp.asarray(make_chain_batch(
                                      rng, batch, perm, L=seq)))
    # held-out rule accuracy (positions >= 2), at the TRAINING length
    ho = make_chain_batch(np.random.default_rng(seed + 2), 128, perm,
                          L=seq)
    logits, _ = llama.forward(params, jnp.asarray(ho[:, :-1]), cfg)
    pred = np.asarray(jnp.argmax(logits, -1))
    acc = float((pred[:, 1:] == ho[:, 2:]).mean())
    return params, acc


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--gamma", type=int, default=5)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--draft-steps", type=int, default=700)
    p.add_argument("--bs", type=int, default=4)
    p.add_argument("--new-tokens", type=int, default=96)
    p.add_argument("--decode-block", type=int, default=32)
    p.add_argument("--platform", default="cpu",
                   help="cpu (training/acceptance are CPU work) or empty "
                        "for the default device's e2e timing")
    # serve-scale costs for the break-even projection: measured on the
    # card by the caller (tools/spec_serve_bench.py); no projection
    # without them
    p.add_argument("--serve-tick-ms", type=float, default=None,
                   help="measured 8B-class fused spec tick (gamma), ms")
    p.add_argument("--serve-block-ms", type=float, default=None,
                   help="measured 8B-class per-token decode-block cost, ms")
    p.add_argument("--serve-draft-ms", type=float, default=None,
                   help="per-draft-forward ms inside the serve tick "
                        "(default: derived as (tick - block)/gamma)")
    p.add_argument("--draft-seq", type=int, default=128,
                   help="draft training sequence length. The serving "
                        "rollout walks the deterministic chain ~112 "
                        "positions deep into its CYCLE states; a draft "
                        "trained at SEQ=32 sees mostly transient states "
                        "and agrees with the target only ~0.30 on the "
                        "rollout distribution (vs 0.876 teacher-forced, "
                        "measured r4) — train it long enough to cover "
                        "what it must propose on")
    p.add_argument("--target-seq", type=int, default=128,
                   help="target training sequence length — must cover the "
                        "serving rollout depth (prompt 16 + new_tokens), "
                        "or the target itself leaves the true chain at "
                        "unseen rope positions and the draft cannot track "
                        "its idiosyncratic OOD behavior")
    p.add_argument("--retrain-draft", action="store_true",
                   help="with --load: keep the loaded target, retrain "
                        "only the draft")
    p.add_argument("--save", default=None,
                   help="save trained target/draft params to this .npz "
                        "and exit training-only")
    p.add_argument("--load", default=None,
                   help="load params from a --save'd .npz instead of "
                        "training")
    p.add_argument("--debug-agreement", action="store_true",
                   help="also report draft-vs-target argmax agreement "
                        "teacher-forced on (a) random-start batches and "
                        "(b) the plain engine's own rollout — separates "
                        "distribution shift from engine bugs")
    args = p.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    import jax
    import jax.numpy as jnp
    from petit_jax.models import llama, serving

    rng = np.random.default_rng(3)
    perm = rng.permutation(V)

    cfg = llama.LlamaConfig(
        vocab_size=V, hidden_size=128, intermediate_size=256,
        num_layers=4, num_heads=4, num_kv_heads=4, head_dim=32,
        max_seq_len=256)
    dcfg = llama.LlamaConfig(
        vocab_size=V, hidden_size=64, intermediate_size=128,
        num_layers=1, num_heads=2, num_kv_heads=2, head_dim=32,
        max_seq_len=256)

    if args.load:
        import pickle
        with open(args.load, "rb") as f:
            blob = pickle.load(f)
        params = jax.tree.map(jnp.asarray, blob["params"])
        dparams = jax.tree.map(jnp.asarray, blob["dparams"])
        acc_t, acc_d = blob["acc_t"], blob["acc_d"]
        print(f"# loaded: target acc {acc_t:.3f}, draft acc {acc_d:.3f}",
              flush=True)
        if args.retrain_draft:
            t0 = time.perf_counter()
            dparams, acc_d = train_chain_model(
                dcfg, perm, args.draft_steps, seed=9, seq=args.draft_seq,
                batch=32)
            print(f"# retrained draft at seq={args.draft_seq}: acc "
                  f"{acc_d:.3f}  [{time.perf_counter() - t0:.0f}s]",
                  flush=True)
    else:
        t0 = time.perf_counter()
        params, acc_t = train_chain_model(cfg, perm, args.steps, seed=0,
                                          seq=args.target_seq, batch=32)
        dparams, acc_d = train_chain_model(dcfg, perm, args.draft_steps,
                                           seed=9, seq=args.draft_seq,
                                           batch=32)
        print(f"# trained: target acc {acc_t:.3f} (4L h128, "
              f"seq={args.target_seq}), draft acc {acc_d:.3f} (1L h64, "
              f"seq={args.draft_seq})  "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)
    if args.save:
        import pickle
        with open(args.save, "wb") as f:
            pickle.dump({"params": jax.tree.map(np.asarray, params),
                         "dparams": jax.tree.map(np.asarray, dparams),
                         "acc_t": acc_t, "acc_d": acc_d}, f)
        print(f"# saved to {args.save}")
        if not args.debug_agreement:
            return

    def reqs():
        prompts = make_chain_batch(np.random.default_rng(77), args.bs,
                                   perm, L=16)
        return [serving.Request(uid=i, tokens=prompts[i],
                                max_new_tokens=args.new_tokens)
                for i in range(args.bs)]

    if args.debug_agreement:
        # (a) teacher-forced draft-vs-target argmax agreement, random starts
        ho = make_chain_batch(np.random.default_rng(5), 128, perm)
        lt, _ = llama.forward(params, jnp.asarray(ho[:, :-1]), cfg)
        ld, _ = llama.forward(dparams, jnp.asarray(ho[:, :-1]), dcfg)
        at = np.asarray(jnp.argmax(lt, -1))
        ad = np.asarray(jnp.argmax(ld, -1))
        agree_tf = float((at[:, 1:] == ad[:, 1:]).mean())
        # (b) agreement on the ROLLOUT distribution: greedy-decode the
        # target from the bench prompts, then teacher-force both models
        # over those exact sequences
        prompts = make_chain_batch(np.random.default_rng(77), args.bs,
                                   perm, L=16)
        seqs = prompts.copy()
        for _ in range(args.new_tokens):
            lg, _ = llama.forward(params, jnp.asarray(seqs), cfg)
            nxt = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None]
            seqs = np.concatenate([seqs, nxt], axis=1)
        lt, _ = llama.forward(params, jnp.asarray(seqs[:, :-1]), cfg)
        ld, _ = llama.forward(dparams, jnp.asarray(seqs[:, :-1]), dcfg)
        at = np.asarray(jnp.argmax(lt, -1))[:, 15:]
        ad = np.asarray(jnp.argmax(ld, -1))[:, 15:]
        agree_ro = float((at == ad).mean())
        # does the TARGET stay on the true chain deep in its own rollout?
        # (if not, the disagreement is position-extrapolation OOD for
        # both models, not draft weakness — train at the serving length)
        # at[:, i] predicts the token at position 16+i; the true chain
        # value there is perm[(seqs[15+i] + seqs[14+i]) % V]
        true_next = perm[(seqs[:, 15:-1] + seqs[:, 14:-2]) % V]
        on_chain = float((at[:, :true_next.shape[1]] == true_next).mean())
        print(f"# agreement draft==target argmax: teacher-forced random "
              f"starts {agree_tf:.3f}, rollout distribution {agree_ro:.3f}"
              f" (engine acceptance should track the rollout number); "
              f"target-on-true-chain in rollout: {on_chain:.3f}",
              flush=True)

    # --- (a) spec engine: REAL acceptance + greedy exactness + wall clock
    spec = serving.SpecEngine(params, cfg, dparams, dcfg,
                              gamma=args.gamma, gamma_adaptive=False,
                              max_batch=args.bs, fmt="bf16",
                              draft_fmt="bf16")
    spec.run(reqs())                      # warm/compile
    spec.reset()
    spec.spec_stats = {"proposed": 0, "accepted": 0, "ticks": 0}
    t0 = time.perf_counter()
    out_spec = spec.run(reqs())
    t_spec = time.perf_counter() - t0
    st = spec.spec_stats
    acc_rate = st["accepted"] / max(st["proposed"], 1)
    tokens = sum(len(v) for v in out_spec.values())
    tok_per_tick = tokens / max(st["ticks"], 1)

    # --- (b) plain engine, decode blocks, same target
    plain = serving.Engine(params, cfg, max_batch=args.bs, fmt="bf16")
    plain.run(reqs(), decode_block=args.decode_block)   # warm
    plain.reset()
    t0 = time.perf_counter()
    out_plain = plain.run(reqs(), decode_block=args.decode_block)
    t_plain = time.perf_counter() - t0

    exact = out_spec == out_plain
    print(f"# spec: acceptance {acc_rate:.2f} of proposals "
          f"({st['accepted']}/{st['proposed']}), {tok_per_tick:.2f} "
          f"tokens/tick at gamma={args.gamma}, greedy-exact={exact}")
    print(f"# e2e tokens/s (THIS scale, h=128): spec {tokens / t_spec:.1f} "
          f"vs blocks({args.decode_block}) {tokens / t_plain:.1f} — at gate "
          f"scale per-program cost dominates and blocks amortize it "
          f"{args.decode_block}x/program vs spec's <= gamma+1")

    # --- (c) serve-scale break-even projection from measured costs
    g = args.gamma
    a_cap = min(1.0, acc_rate * g / (g - 1))
    proj = None
    if args.serve_tick_ms is not None and args.serve_block_ms is not None:
        draft_ms = (args.serve_draft_ms if args.serve_draft_ms is not None
                    else max((args.serve_tick_ms - args.serve_block_ms)
                             / g, 0.1))
        print("# serve-scale projection (tick "
              f"{args.serve_tick_ms} ms, block {args.serve_block_ms} "
              f"ms/token, draft {draft_ms:.2f} ms/forward):")
        # fraction of the g-1 acceptance CAP this pair achieves (the
        # tick's emitted tokens = a_cap*(g-1) accepted prefix + 1 bonus)
        tick_ms = g * draft_ms + args.serve_block_ms
        rows = []
        for a in sorted({0.2, 0.4, 0.6, 0.8, round(a_cap, 2), 1.0}):
            emitted = a * (g - 1) + 1
            rows.append((round(a, 2), round(
                args.serve_block_ms * emitted / tick_ms, 2)))
        be = next((a for a, s in rows if s >= 1.0), None)
        print(f"#   acceptance(frac of cap)->speedup: {rows}  (spec wins "
              f"from ~{be}; this pair sits at {a_cap:.2f})")
        proj = round(args.serve_block_ms * (a_cap * (g - 1) + 1)
                     / tick_ms, 3)
    print(json.dumps({
        "metric": "spec_trained_acceptance", "value": round(a_cap, 3),
        "unit": "fraction_of_cap", "vs_baseline": proj,
        "greedy_exact": exact,
        "target_acc": round(acc_t, 3), "draft_acc": round(acc_d, 3),
        "tokens_per_tick": round(tok_per_tick, 2),
        "e2e_tok_s": {"spec": round(tokens / t_spec, 1),
                      "blocks": round(tokens / t_plain, 1)}}))


if __name__ == "__main__":
    main()
