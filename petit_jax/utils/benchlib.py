"""On-device timing and the device peaks the tools divide by.

Kernels are timed inside a jitted fori_loop at two iteration counts and the
marginal cost (T(n2) - T(n1)) / (n2 - n1) is reported, the minimum over
repetitions of each: the loop removes per-dispatch host cost, and the
difference removes the fixed cost of one program launch. Each iteration
perturbs the input with a fresh salt and consumes the output via
sum(abs(.)), so XLA can neither fold repeated executions nor dead-code the
computation. Analog of the reference's wall-clock-around-Execute+sync
timing (tools/benchmarks/matmul/main.cc:244-251).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

_SALT = [0]

# Published device-memory bandwidth (bytes/s) per device kind, from NVIDIA's
# data sheets. A roofline line is printed only for a kind listed here.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # H100 SXM5
    "NVIDIA H100": 3.35e12,
    "NVIDIA H100 NVL": 3.9e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H200": 4.8e12,
}


def hbm_peak(kind: str | None = None) -> float:
    """Published HBM bandwidth of the device; raises for an unknown kind
    (a CPU run has no device peak to divide by)."""
    kind = kind or jax.devices()[0].device_kind
    try:
        return HBM_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(f"no published HBM bandwidth for {kind!r}") from None


def timed_loop(call, *args, debug: bool = False):
    """Build timed(iters) -> wall seconds for `iters` chained calls of
    call(a, *rest) where a is perturbed per iteration."""

    @jax.jit
    def run(iters, salt, a, *rest):
        def body(i, acc):
            a2 = a.at[0, 0].add((salt + (i % 7)).astype(a.dtype))
            c = call(a2, *rest)
            return acc + jnp.sum(jnp.abs(c.astype(jnp.float32)))
        return jax.lax.fori_loop(0, iters, body, jnp.float32(0.0))

    def timed(iters):
        _SALT[0] += 1
        t0 = time.perf_counter()
        v = run(iters, jnp.float32(_SALT[0]), *args).block_until_ready()
        dt = time.perf_counter() - t0
        if debug:
            print(f"#     run({iters}, salt={_SALT[0]}) = {float(v):.6g}"
                  f"  [{dt * 1e3:.2f} ms]", flush=True)
        return dt

    return timed


def marginal_time(call, *args, n1: int = 5, n2: int | None = None,
                  reps: int = 3, bytes_hint: float | None = None,
                  debug: bool = False) -> float:
    """Min-floor marginal per-iteration device time of call(*args).

    n2 is sized from bytes_hint so the extra iterations take about 20 ms
    at device-memory speed."""
    timed = timed_loop(call, *args, debug=debug)
    timed(n1)  # compile + warm
    if n2 is None:
        est = (bytes_hint or 32e6) / 3e12
        n2 = n1 + min(2000, max(20, int(0.020 / est)))
    tas = [timed(n1) for _ in range(reps)]
    tbs = [timed(n2) for _ in range(reps)]
    if debug:
        print(f"#   T({n1})={[f'{t * 1e3:.1f}' for t in tas]} ms  "
              f"T({n2})={[f'{t * 1e3:.1f}' for t in tbs]} ms", flush=True)
    return max((min(tbs) - min(tas)) / (n2 - n1), 1e-9)
