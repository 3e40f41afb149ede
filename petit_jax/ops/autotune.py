"""Offline autotuner: enumerate -> time -> persist best solution per shape.

Analog of the reference's `bench_matmul --algo tune` flow
(tools/benchmarks/matmul/main.cc:269-325): for each problem shape, time
feasible kernel configs and keep the fastest. The reference README
"strongly recommends" offline tuning because kernels are
hyperparameter-sensitive (README.md:35); the same holds for the Triton
block shape, warps, stages and split-K per GPU.

Every config costs a Triton compile, so the candidate set is a local
search around the heuristic default unless full=True.

Tables persist as JSON keyed by the problem shape, holding a
SolutionId.repr(), one file per device kind
(jax.devices()[0].device_kind) under tuned/. With no table for the card,
the heuristic chooses.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import gemm as gemm_mod
from . import solution as solution_mod
from .kernels import fused
from .solution import SolutionId, ElementB, MatmulType

def _table_dir() -> str:
    """Repo-checkout tuned/ when present, else a per-user cache dir (the
    package may be installed site-wide with a read-only prefix)."""
    repo = os.path.join(os.path.dirname(__file__), "..", "..", "tuned")
    if os.path.isdir(repo) or os.access(os.path.dirname(repo), os.W_OK):
        return repo
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "petit_jax", "tuned")


_TABLE_DIR = _table_dir()


def _device_kind() -> str:
    return jax.devices()[0].device_kind.replace(" ", "_")


def table_path(kind: str | None = None) -> str:
    return os.path.join(_TABLE_DIR, f"{kind or _device_kind()}.json")


def candidate_solutions(m: int, n: int, k: int,
                        element_b: ElementB = ElementB.NVFP4,
                        mfma_type: MatmulType = MatmulType.BF16,
                        max_candidates: int = 8) -> list[SolutionId]:
    """Pruned candidate set: the heuristic default plus its neighbors in
    block shape, warps, stages and split-K."""
    base = solution_mod.choose_default_solution(m, n, k, element_b, mfma_type)
    cands: list[SolutionId] = [base]

    def add(**kw):
        try:
            s = dataclasses.replace(base, **kw)
        except AssertionError:
            return
        if s not in cands and solution_mod.is_feasible(s, m, n, k):
            cands.append(s)

    bm, bn, sk = base.block_m, base.block_n, base.split_k
    for v in (bn * 2, bn // 2):
        add(block_n=v)
    for v in (sk * 2, sk // 2):
        add(split_k=v)
    add(num_warps=8 if base.num_warps == 4 else 4)
    add(num_stages=base.num_stages + 1)
    add(num_stages=base.num_stages - 1)
    add(block_k=1024, num_stages=2)
    for v in (bm * 2, bm // 2):
        add(block_m=v)
    return cands[:max_candidates]


def time_solution(sid: SolutionId, a, b, s, gs, *, n1=5, reps=3) -> float:
    """Per-call device time of one solution (utils/benchlib protocol)."""
    from ..utils import benchlib

    def call(a2, b2, s2):
        return fused.fused_mul(
            a2, b2, s2, gs, sid=sid,
            out_dtype=jnp.float32 if sid.high_precision else jnp.bfloat16)

    bytes_hint = b.size * 4 + s.size * 2 + a.size * 2
    try:
        return benchlib.marginal_time(call, a, b, s, n1=n1, reps=reps,
                                      bytes_hint=bytes_hint)
    except Exception:
        return math.inf


def tune_shape(m: int, n: int, k: int,
               element_b: ElementB = ElementB.NVFP4,
               mfma_type: MatmulType = MatmulType.BF16,
               *, verbose: bool = False, update_table: bool = True,
               max_candidates: int = 24, full: bool = False,
               time_budget_s: float | None = None,
               top: int = 5) -> SolutionId:
    """Tune one shape on the current device; returns the fastest SolutionId
    and (by default) records it in the in-memory dispatch table.

    full=True walks the ENTIRE feasible space like the reference's
    `--algo tune` (tools/benchmarks/matmul/main.cc:269-325), printing the
    top-`top` solutions; each config is a compile, so an optional
    time_budget_s caps the walk (candidates are ordered heuristic-first so
    a truncated walk still covers the most promising region)."""
    from ..utils import testdata

    fmt = "nvfp4" if element_b == ElementB.NVFP4 else "mxfp4"
    key = jax.random.PRNGKey(1234)
    layer = testdata.random_fp4_layer(key, k, n, fmt)
    a = jax.random.normal(jax.random.fold_in(key, 1), (m, k), jnp.bfloat16)
    b, s, gs = layer["words"], layer["scales"], layer["gs"]

    cands = candidate_solutions(m, n, k, element_b, mfma_type,
                                max_candidates)
    if full:
        cands += [sid for sid in solution_mod.get_solutions(
            m, n, k, element_b, mfma_type) if sid not in cands]
    import time as _time
    t0 = _time.perf_counter()
    timed: list[tuple[float, SolutionId]] = []
    for idx, sid in enumerate(cands):
        if (time_budget_s is not None and idx > 0
                and _time.perf_counter() - t0 > time_budget_s):
            if verbose:
                print(f"# tune budget hit after {idx}/{len(cands)} "
                      "candidates")
            break
        t = time_solution(sid, a, b, s, gs)
        timed.append((t, sid))
        if verbose:
            tf = 2 * m * n * k / t / 1e12 if t < math.inf else 0.0
            print(f"#   {sid}  {t * 1e6:10.1f} us  {tf:7.2f} TFLOP/s")
    timed.sort(key=lambda ts: ts[0])
    if full and verbose:
        print(f"# top-{top} for m={m} n={n} k={k}:")
        for t, sid in timed[:top]:
            tf = 2 * m * n * k / t / 1e12 if t < math.inf else 0.0
            print(f"#   {tf:7.2f} TFLOP/s  {t * 1e6:9.1f} us  {sid}")
    best = timed[0][1]
    if update_table:
        key = gemm_mod._table_key(m, n, k, element_b, mfma_type, False)
        gemm_mod._TUNED_TABLE[key] = best.repr()
    return best


def tune_grouped_shape(E: int, cap: int, n: int, k: int,
                       element_b: ElementB = ElementB.MXFP4,
                       *, verbose: bool = False,
                       update_table: bool = True) -> SolutionId:
    """Tune the grouped (MoE expert) kernel for a per-expert shape
    (cap, n, k) with E experts; records under the grouped table key.
    Candidates are the dense neighborhood with split-K off (the expert
    takes that grid axis)."""
    from . import layout as layout_mod
    from .kernels import grouped as grouped_mod
    from ..utils import benchlib

    rng = np.random.default_rng(99)
    group = 16 if element_b == ElementB.NVFP4 else 32
    kp = layout_mod.padded_k(k, layout_mod.pad_multiple(group))
    xs = jnp.asarray(rng.standard_normal((E, cap, k)), jnp.bfloat16)
    words = jnp.asarray(rng.integers(0, 2 ** 32, size=(E, kp // 8, n),
                                     dtype=np.uint64).astype(np.uint32))
    st = jnp.asarray(rng.standard_normal((E, kp // 16, n)) * 0.1 + 1.0,
                     jnp.bfloat16)
    gs = jnp.ones((E,), jnp.float32)
    bytes_hint = words.size * 4 + st.size * 2 + xs.size * 2

    cands = list(dict.fromkeys(
        dataclasses.replace(s, split_k=1)
        for s in candidate_solutions(cap, n, k, element_b)))
    best, best_t = None, math.inf
    for sid in cands:
        def call(x2, w2, s2):
            return grouped_mod.grouped_mul(x2, w2, s2, gs,
                                           solution_id=sid.repr())
        try:
            t = benchlib.marginal_time(call, xs, words, st, n1=10, reps=3,
                                       bytes_hint=bytes_hint)
        except Exception:
            t = math.inf
        if verbose:
            tf = 2 * E * cap * n * k / t / 1e12 if t < math.inf else 0.0
            print(f"# grouped {sid}  {t * 1e6:10.1f} us  "
                  f"{tf:7.2f} TFLOP/s")
        if t < best_t:
            best, best_t = sid, t
    assert best is not None
    if update_table:
        key = gemm_mod._table_key(cap, n, k, element_b,
                                  MatmulType.BF16, False, grouped=True)
        gemm_mod._TUNED_TABLE[key] = best.repr()
    return best


def tune_suite(shapes: Sequence[tuple[int, int, int]],
               element_b: ElementB = ElementB.NVFP4,
               *, verbose: bool = False, save: bool = True,
               full: bool = False,
               time_budget_s: float | None = None) -> dict:
    """Tune a suite of (m, n, k) shapes and persist the table."""
    for (m, n, k) in shapes:
        sid = tune_shape(m, n, k, element_b, verbose=verbose, full=full,
                         time_budget_s=time_budget_s)
        if verbose:
            print(f"# best for m={m} n={n} k={k}: {sid}")
    if save:
        save_table()
    return dict(gemm_mod._TUNED_TABLE)


def save_table(kind: str | None = None) -> str:
    os.makedirs(_TABLE_DIR, exist_ok=True)
    path = table_path(kind)
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing.update({",".join(map(str, k)): v
                     for k, v in gemm_mod._TUNED_TABLE.items()})
    with open(path, "w") as f:
        json.dump(existing, f, indent=1, sort_keys=True)
    return path


def load_table(kind: str | None = None) -> bool:
    """Load the persisted table for this device kind into the dispatcher."""
    path = table_path(kind)
    if not os.path.exists(path):
        return False
    with open(path) as f:
        raw = json.load(f)
    table = {}
    for ks, v in raw.items():
        parts = ks.split(",")
        key = (int(parts[0]), int(parts[1]), int(parts[2]), int(parts[3]),
               int(parts[4]), parts[5] == "True", parts[6] == "True")
        table[key] = v
    gemm_mod.set_tuned_table(table)
    return True
