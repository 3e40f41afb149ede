#!/usr/bin/env python
"""Smoke test of the FP4 serving path on the GPU.

    python chip_smoke.py              # one card: gemm, serve, logits, moe
    python chip_smoke.py --chips 4    # four cards: TP=4, EP=4, 2x TP2 cluster

Drives the system through its user entry points at published model widths
with random weights fabricated on the device from --seed, runs every
kernel as compiled for the card, and checks each result against a plain
f32 reference. Each phase prints one line; the card's name and power limit
come first and one JSON object comes last:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Exits non-zero, with no result line, when JAX finds no GPU; exits non-zero
when any phase fails. One process drives the card(s); the `gpu`-marked
tests run first in a child that ends before this process opens the card.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Tolerances, each with its reason:
# GEMM: the repo's kernel tolerance (tests/test_tuned_sweep.py), max|err| /
# max(|ref|, 1) against an f32 product of the same dequantized weight and
# bf16-rounded A: only the f32 summation order and the bf16 output differ.
GEMM_TOL = 2e-2
# W4A8: per-token int8 activations and per-column int8 weights add
# quantization noise; the repo's W4A8 contract (tests/test_gemm_api.py) is
# relative L2 < 3e-2 against the exact product.
W4A8_TOL = 3e-2
# Logits: bf16 activations against an f32 forward over 32 layers of the
# SAME (dequantized) weights; bf16 rounding (2^-9) per op accumulates over
# depth, so relative L2 < 5e-2, and the argmax may flip only on near-ties.
LOGIT_TOL = 5e-2
TOP1_MIN = 0.9
# MoE: bf16 activations and a bf16 SwiGLU intermediate against f32 experts.
MOE_TOL = 2e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip()


def run_gpu_tests() -> tuple[bool, str]:
    """The `gpu`-marked tests, in a child that exits before this process
    opens the card."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    tail = (r.stdout.strip().splitlines() or ["no output"])[-1]
    return r.returncode == 0, tail


# ---------------------------------------------------------------------------
# phases (one card)
# ---------------------------------------------------------------------------

def phase_gemm(key):
    import jax
    import jax.numpy as jnp
    from petit_jax.ops import gemm
    from petit_jax.ops.kernels import fused
    from petit_jax.utils import benchlib, testdata

    a16 = {"nvfp4": gemm.mul_nvfp4_a16, "mxfp4": gemm.mul_mxfp4_a16,
           "nvfp4p2": gemm.mul_nvfp4p2_a16,
           "nvfp4p2z": gemm.mul_nvfp4p2z_a16, "mxfp4z": gemm.mul_mxfp4z_a16}
    a8 = {"nvfp4": gemm.mul_nvfp4_a8, "mxfp4": gemm.mul_mxfp4_a8}
    worst, times, ok = {}, [], True
    for (n, k) in ((8192, 8192), (28672, 4096)):       # bench.py SHAPES_NK
        for fmt in ("nvfp4", "mxfp4"):
            layer = testdata.random_fp4_layer(jax.random.fold_in(key, n),
                                              k, n, fmt)
            w, s, gs = layer["words"], layer["scales"], layer["gs"]
            deq = fused.dequant(w, s, dtype=jnp.float32)
            for m in (16, 256):
                a = jax.random.normal(jax.random.fold_in(key, m), (m, k),
                                      jnp.bfloat16)
                with jax.default_matmul_precision("highest"):
                    ref = jnp.dot(a.astype(jnp.float32), deq) * gs
                denom = jnp.maximum(jnp.max(jnp.abs(ref)), 1.0)
                fmts = [fmt] + ([f for f in a16 if f.startswith(fmt)
                                 and f != fmt] if m == 16 else [])
                for f in fmts:
                    y = a16[f](a, w, s, gs, m, n, k).astype(jnp.float32)
                    e = float(jnp.max(jnp.abs(y - ref)) / denom)
                    worst[f"{f}_a16"] = max(worst.get(f"{f}_a16", 0), e)
                    ok &= e < GEMM_TOL
                y8 = a8[fmt](a, w, s, gs, m, n, k).astype(jnp.float32)
                e8 = float(jnp.linalg.norm(y8 - ref) / jnp.linalg.norm(ref))
                worst[f"{fmt}_a8"] = max(worst.get(f"{fmt}_a8", 0), e8)
                ok &= e8 < W4A8_TOL
                if fmt == "nvfp4":
                    call = (lambda a, w, s, m=m: a16["nvfp4"](
                        a, w, s, gs, m, n, k))
                    xla = (lambda a, w, s: fused._fused_mul_xla(
                        a, w, s, gs, high_precision=False,
                        out_dtype=jnp.bfloat16))
                    nb = w.size * 4 + s.size * 2
                    t_k = benchlib.marginal_time(call, a, w, s, bytes_hint=nb)
                    t_x = benchlib.marginal_time(xla, a, w, s, bytes_hint=nb)
                    times.append(f"m{m}n{n}k{k}:{t_k * 1e6:.1f}/"
                                 f"{t_x * 1e6:.1f}us")
    errs = " ".join(f"{f}={e:.2e}" for f, e in sorted(worst.items()))
    return ok, (f"worst err {errs} (a16 max-norm tol {GEMM_TOL}, a8 rel-L2 "
                f"tol {W4A8_TOL}); nvfp4 a16 dispatch vs xla dequant->dot "
                f"{' '.join(times)}")


def _requests(seed):
    import numpy as np
    from petit_jax.models import serving
    rng = np.random.default_rng(seed)
    lens = (16, 64, 200, 256, 500, 700, 900, 1024)    # spread over 16-1024
    return [serving.Request(uid=i, tokens=rng.integers(0, 128256, L),
                            max_new_tokens=32) for i, L in enumerate(lens)]


def phase_serve(params, cfg, seed):
    import jax.numpy as jnp
    from petit_jax.models import serving
    parts, ok = [], True
    for name, cls in (("Engine", serving.Engine),
                      ("PagedEngine", serving.PagedEngine)):
        for dt in (jnp.bfloat16, jnp.float8_e4m3fn):
            t0 = time.perf_counter()
            # one prefill chunk per prompt: few distinct programs to compile
            eng = cls(params, cfg, max_batch=8, fmt="nvfp4", cache_dtype=dt,
                      prefill_chunk=1024)
            out = eng.run(_requests(seed), decode_block=8)
            full = (len(out) == 8
                    and all(len(v) == 32 for v in out.values()))
            ok &= full
            parts.append(f"{name}/{jnp.dtype(dt).name}:"
                         f"{sum(map(len, out.values()))}tok"
                         f"/{time.perf_counter() - t0:.0f}s")
            del eng
    return ok, "8 requests x 32 new tokens, prompts 16-1024: " + " ".join(
        parts)


def phase_logits(params, cfg):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from petit_jax.models import llama
    from petit_jax.ops.kernels import fused

    T, steps = 64, 4
    toks = jax.random.randint(jax.random.PRNGKey(7), (1, T), 0,
                              cfg.vocab_size)
    fwd = jax.jit(lambda p, t, c, q, w: llama.forward(
        p, t, cfg, c, q, fmt="nvfp4", kv_window=w),
        static_argnums=(4,), donate_argnums=(2,))
    cache = llama.init_cache(cfg, 1)
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    lg, cache = fwd(params, toks, cache, pos, 128)
    got = [lg[0, -1]]
    seq = [toks]
    for i in range(steps):
        nxt = jnp.argmax(got[-1])[None, None].astype(jnp.int32)
        seq.append(nxt)
        lg, cache = fwd(params, nxt, cache,
                        jnp.full((1, 1), T + i, jnp.int32), 128)
        got.append(lg[0, -1])
    got = jnp.stack(got).astype(jnp.float32)
    full = jnp.concatenate(seq, axis=1)[:, :T + steps]

    @jax.jit
    def dense(lp):
        out = {k: v for k, v in lp.items() if not isinstance(v, dict)}
        for nm in ("wqkv", "wo", "w_gateup", "w_down"):
            q = lp[nm]
            out[nm] = {"w": fused.dequant(q["words"], q["scales"],
                                          dtype=jnp.float32) * q["gs"]}
        return out

    mask = jnp.tril(jnp.ones((T + steps,) * 2, bool))[None, None]
    tpos = jnp.arange(T + steps)[None]

    @jax.jit
    def layer(x, lp):
        with jax.default_matmul_precision("highest"):
            h = llama.rms_norm(x, lp["attn_norm"], cfg.rms_eps)
            a, _ = llama.attention(h, lp, None, tpos, cfg, mask,
                                   fmt="bf16", interpret=False)
            x = x + a
            h = llama.rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
            return x + llama.mlp(h, lp, fmt="bf16", interpret=False)

    x = params["embed"][full].astype(jnp.float32)
    for lp in params["layers"]:
        x = layer(x, dense(lp))
    with jax.default_matmul_precision("highest"):
        x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
        ref = jnp.dot(x, params["lm_head"]["w"].astype(jnp.float32))[0]
    ref = ref[T - 1:T + steps]
    rel = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))
    top1 = float(np.mean(np.asarray(jnp.argmax(got, -1)
                                    == jnp.argmax(ref, -1))))
    ok = rel < LOGIT_TOL and top1 >= TOP1_MIN
    return ok, (f"prefill {T} + {steps} cached decode steps vs f32 "
                f"reference: rel L2 {rel:.3e} (tol {LOGIT_TOL}), top-1 "
                f"agreement {top1:.2f} (min {TOP1_MIN})")


def _mixtral_experts(key, fmt="mxfp4"):
    import jax
    import jax.numpy as jnp
    from petit_jax.models import moe
    from petit_jax.utils import testdata

    cfg = moe.MixtralConfig.mixtral_8x7b()
    H, F, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    experts = {}
    for i, (nm, k, n) in enumerate((("w_gate", H, F), ("w_up", H, F),
                                    ("w_down", F, H))):
        ls = [testdata.random_fp4_layer(jax.random.fold_in(key, 10 * i + e),
                                        k, n, fmt) for e in range(E)]
        experts[nm] = {f: jnp.stack([jnp.asarray(x[f]) for x in ls])
                       for f in ("words", "scales", "gs")}
    router = jax.random.normal(jax.random.fold_in(key, 99), (H, E),
                               jnp.bfloat16)
    return cfg, experts, router


def _dense_experts(experts):
    import jax
    import jax.numpy as jnp
    from petit_jax.ops.kernels import fused
    deq = jax.jit(jax.vmap(lambda w, s, g: fused.dequant(
        w, s, dtype=jnp.float32) * g))
    return {nm: {"w": deq(q["words"], q["scales"], q["gs"])}
            for nm, q in experts.items()}


def phase_moe(key):
    import jax
    import jax.numpy as jnp
    from petit_jax.models import moe

    cfg, experts, router = _mixtral_experts(key)
    mcfg = moe.MoEConfig(cfg.num_experts, cfg.top_k)
    T = 64
    x = jax.random.normal(jax.random.fold_in(key, 5), (T, cfg.hidden_size),
                          jnp.bfloat16)
    drops = int(moe.routing_drop_count(x, router, mcfg))
    y = jax.jit(lambda x, r, e: moe.moe_mlp(x, r, e, mcfg, fmt="mxfp4"))(
        x, router, experts).astype(jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = moe._dense_moe(x.astype(jnp.float32), router,
                             _dense_experts(experts), mcfg)
    err = float(jnp.max(jnp.abs(y - ref))
                / jnp.maximum(jnp.max(jnp.abs(ref)), 1.0))
    ok = err < MOE_TOL and drops == 0
    return ok, (f"Mixtral-8x7B widths (hidden {cfg.hidden_size}, expert "
                f"{cfg.intermediate_size}, 8 experts, top-2), {T} tokens, "
                f"{drops} dropped: max err {err:.2e} vs f32 dense "
                f"(tol {MOE_TOL})")


# ---------------------------------------------------------------------------
# phases (four cards)
# ---------------------------------------------------------------------------

def _devices_of(tree) -> int:
    import jax
    devs = set()
    for leaf in jax.tree.leaves(tree):
        if getattr(leaf, "ndim", 0) >= 2:
            devs |= set(leaf.sharding.device_set)
    return len(devs)


def _dequantized(qparams, params):
    """qparams' FP4 projections dequantized to f32 dense {"w"} layers (k
    rows taken from the dense `params`), on qparams' device."""
    import jax
    import jax.numpy as jnp
    from petit_jax.ops.kernels import fused

    deq = jax.jit(lambda w, s, g: fused.dequant(w, s, dtype=jnp.float32) * g)
    layers = []
    for lq, lp in zip(qparams["layers"], params["layers"]):
        layers.append({nm: ({"w": deq(q["words"], q["scales"], q["gs"])
                                  [:lp[nm]["w"].shape[0]]}
                            if isinstance(q, dict) and "words" in q else q)
                       for nm, q in lq.items()})
    return {**qparams, "layers": layers}


def phase_tp4(key, cfg):
    """TP=4 through the program's own placement (quantize_params_tp) vs the
    same dense weights quantized for one card (llama.quantize_params,
    unfused: the same per-matrix scales) and run in f32 there."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from petit_jax.models import llama
    from petit_jax.parallel import tp as tp_mod

    tp = 4
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))
    params = llama.init_params(cfg, key)
    qp = tp_mod.quantize_params_tp(params, cfg, mesh)
    shards = _devices_of(qp)
    one = jax.devices()[0]
    ref_params = jax.device_put(
        _dequantized(llama.quantize_params(params, fuse=False), params), one)

    T = 32
    toks = jax.random.randint(jax.random.PRNGKey(3), (1, T), 0,
                              cfg.vocab_size)
    pos = jnp.arange(T, dtype=jnp.int32)[None]
    got_f = tp_mod.make_tp_forward(cfg, mesh)(qp, toks)
    step = jax.jit(tp_mod.make_tp_step(cfg, mesh))
    cache = tp_mod.init_cache_tp(cfg, 1, mesh)
    got_s, cache = step(qp, toks, cache, pos)
    with jax.default_matmul_precision("highest"):
        ref, _ = jax.jit(lambda p, t: llama.forward(p, t, cfg, fmt="bf16"))(
            ref_params, jax.device_put(toks, one))

    def rel(x):
        x = jax.device_put(x.astype(jnp.float32), one)
        return float(jnp.linalg.norm(x - ref) / jnp.linalg.norm(ref))
    e_f, e_s = rel(got_f), rel(got_s)
    ok = shards == tp and e_f < LOGIT_TOL and e_s < LOGIT_TOL
    return ok, (f"TP=4 hidden {cfg.hidden_size}, depth cut to "
                f"{cfg.num_layers} layers, weights placed by "
                f"quantize_params_tp on {shards} devices; make_tp_forward "
                f"rel L2 {e_f:.3e}, make_tp_step {e_s:.3e} vs one-card f32 "
                f"(tol {LOGIT_TOL})")


def phase_ep4(key):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from petit_jax.models import moe
    from petit_jax.parallel import ep

    cfg, experts, router = _mixtral_experts(key)
    mcfg = moe.MoEConfig(cfg.num_experts, cfg.top_k)
    mesh = Mesh(np.array(jax.devices()[:4]), ("ep",))
    x = jax.random.normal(jax.random.fold_in(key, 5), (64, cfg.hidden_size),
                          jnp.bfloat16)
    one = jax.devices()[0]
    want = jax.jit(lambda x, r, e: moe.moe_mlp(x, r, e, mcfg, fmt="mxfp4"))(
        *jax.device_put((x, router, experts), one)).astype(jnp.float32)
    e_sh, r_sh = ep.place_experts_ep(experts, router, mesh)
    shards = _devices_of(e_sh)
    got = ep.make_moe_mlp_ep(mcfg, mesh, fmt="mxfp4")(x, r_sh, e_sh)
    got = jax.device_put(got.astype(jnp.float32), one)
    err = float(jnp.max(jnp.abs(got - want))
                / jnp.maximum(jnp.max(jnp.abs(want)), 1.0))
    ok = shards == 4 and err < MOE_TOL
    return ok, (f"EP=4 Mixtral widths: experts on {shards} devices, max err "
                f"{err:.2e} vs one-card moe_mlp (tol {MOE_TOL})")


def phase_cluster(key, cfg):
    """2 replicas x TP2 (make_tp_cluster) serving greedy requests through the
    router, checked against a single-card Engine on the same weights."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from petit_jax.models import cluster, llama, serving

    params = llama.init_params(cfg, key)
    cl = cluster.make_tp_cluster(params, cfg, dp=2, tp=2, max_batch=2)
    # the replicas' weight matrices (scalar global scales are replicated)
    devsets = [frozenset(d for leaf in jax.tree.leaves(r.params)
                         if leaf.ndim >= 2 for d in leaf.sharding.device_set)
               for r in cl.replicas]
    disjoint = (len(devsets) == 2 and not (devsets[0] & devsets[1])
                and all(len(s) == 2 for s in devsets))
    rng = np.random.default_rng(0)
    new = 16
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (24, 60, 100, 150)]

    def reqs():
        return [serving.Request(uid=i, tokens=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
    out = cl.run(reqs())
    full = len(out) == 4 and all(len(v) == new for v in out.values())
    # single card, same weights: unfused quantization has the per-matrix
    # scales quantize_params_tp uses
    one = jax.devices()[0]
    eng = serving.Engine(
        jax.device_put(llama.quantize_params(params, fuse=False), one), cfg,
        max_batch=4)
    want = eng.run(reqs())
    same = sum(out.get(i) == want[i] for i in range(4))
    # teacher-forced: the single card's logits over each prompt followed by
    # the cluster's tokens; each token the cluster chose must be the single
    # card's best up to the logit noise, 2 * LOGIT_TOL * rms of the row
    # (two logits, each off by about LOGIT_TOL * rms)
    toks = np.zeros((4, max(map(len, prompts)) + new), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p) + new] = np.concatenate([p, out.get(i, [0] * new)])
    ref = np.asarray(eng.score_forward(jnp.asarray(toks)), np.float32)
    gap = 0.0
    for i, p in enumerate(prompts):
        rows = ref[i, len(p) - 1:len(p) - 1 + new]
        chosen = rows[np.arange(new), np.asarray(out.get(i, [0] * new))]
        rms = np.sqrt(np.mean(rows ** 2, axis=-1))
        gap = max(gap, float(np.max((rows.max(-1) - chosen) / rms)))
    # each replica's own serving forward on the same sequences
    rels = []
    for r in cl.replicas:
        got = np.concatenate([np.asarray(r.score_forward(
            jnp.asarray(toks[j:j + 2])), np.float32) for j in (0, 2)])
        rels.append(float(np.linalg.norm(got - ref) / np.linalg.norm(ref)))
    ok = (disjoint and full and gap <= 2 * LOGIT_TOL
          and max(rels) < LOGIT_TOL)
    return ok, (f"2 replicas x TP2, hidden {cfg.hidden_size}, depth cut to "
                f"{cfg.num_layers} layers, on disjoint cards "
                f"({sorted(len(s) for s in devsets)} devices each, "
                f"disjoint={disjoint}): {sum(map(len, out.values()))} tokens "
                f"for 4 requests; {same}/4 token streams equal to a one-card "
                f"Engine; worst chosen-token gap to the one-card best "
                f"{gap:.3e} rms (tol {2 * LOGIT_TOL}); replica logits rel L2 "
                f"{' '.join(f'{e:.3e}' for e in rels)} (tol {LOGIT_TOL})")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tp-layers", type=int, default=2,
                   help="depth of the TP=4 Llama-3-70B check (of 80)")
    p.add_argument("--cluster-layers", type=int, default=2,
                   help="depth of the 2 x TP2 Llama-3-8B cluster (of 32)")
    args = p.parse_args()

    try:
        import petit_jax  # noqa: F401
    except ImportError as e:
        print(f"petit_jax is not importable next to chip_smoke.py: {e}",
              file=sys.stderr)
        return 1
    pre = []
    if args.chips == 1:
        pre.append(("gpu_tests", run_gpu_tests))

    import jax
    from petit_jax.utils import compile_cache
    cache_dir = compile_cache.enable()
    results = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            ok, msg = fn(*a)
        except Exception as e:  # noqa: BLE001 - a phase reports, never hides
            ok, msg = False, f"raised {e!r}"
            traceback.print_exc()
        dt = time.perf_counter() - t0
        print(f"[{name}] {'ok' if ok else 'FAILED'} ({dt:.0f}s) {msg}",
              flush=True)
        results.append(ok)

    for name, fn in pre:      # before this process opens the card
        run(name, fn)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX platform is {devs[0].platform!r}",
              file=sys.stderr)
        return 1
    if len(devs) < args.chips:
        print(f"need {args.chips} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    print(f"setup: {devs[0].device_kind} x{len(devs)}, XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}, compile cache {cache_dir}",
          flush=True)
    key = jax.random.PRNGKey(args.seed)
    if args.chips == 1:
        from petit_jax.models import llama
        run("gemm", phase_gemm, key)
        cfg = llama.LlamaConfig.llama3_8b()
        params = llama.init_quantized_params(cfg, jax.random.fold_in(key, 1))
        run("serve", phase_serve, params, cfg, args.seed)
        run("logits", phase_logits, params, cfg)
        del params
        run("moe", phase_moe, key)
    else:
        from petit_jax.models import llama
        print(f"depth cuts: TP=4 Llama-3-70B {args.tp_layers} of 80 layers, "
              f"cluster Llama-3-8B {args.cluster_layers} of 32 layers "
              f"(full widths)", flush=True)
        run("tp4", phase_tp4, key, llama.LlamaConfig.llama3_70b(
            num_layers=args.tp_layers, max_seq_len=256))
        run("ep4", phase_ep4, key)
        run("cluster", phase_cluster, jax.random.fold_in(key, 2),
            llama.LlamaConfig.llama3_8b(num_layers=args.cluster_layers,
                                        max_seq_len=256))
    st = compile_cache.stats()
    print(f"compile cache: {st['hits']} hits, {st['misses']} misses in "
          f"{cache_dir}", flush=True)
    ok = all(results)
    print(json.dumps({"ok": ok, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
