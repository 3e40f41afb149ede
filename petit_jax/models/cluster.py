"""Data-parallel serving orchestration over engine replicas.

The reference delegates multi-GPU serving to SGLang's router above the
library (README.md:3,21); the north star (BASELINE.json config 5) requires
continuous batching "across >=2 hosts". The design (SURVEY.md §2.3/§5):
tensor parallelism runs inside one replica's device group
(parallel/tp.py, device collectives), while data-parallel replicas
exchange only requests and finished tokens — host-side Python, never
device collectives. So the replica tier is an orchestration problem, not
a kernel problem, and this module is deliberately framework code:

  - ``hybrid_mesh``: the (dp, tp) device mesh, dp the outer axis —
    ``mesh_utils.create_hybrid_device_mesh`` when several processes
    (hosts) take part, a plain reshape in one process.
  - ``replica_meshes`` / ``make_tp_cluster``: partition local devices into
    disjoint per-replica TP meshes (one replica per device group; across
    hosts each process builds exactly one replica from its
    ``jax.local_devices()``).
  - ``Cluster``: least-loaded request router over N engine replicas with
    failure detection — a replica whose step raises is marked dead and its
    in-flight requests are replayed from the prompt on the survivors
    (decode state is not migrated; KV caches are device-resident and
    replay is the honest recovery on a slot-based engine).

Determinism: greedy requests produce identical tokens whichever replica
serves them (same params, same program), so routing is free to be purely
load-based.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from . import llama, serving


def hybrid_mesh(dp: int, tp: int, devices=None) -> Mesh:
    """Build the (dp, tp) mesh: tp inside one process's devices, dp
    across replicas.

    With several processes (process_count > 1) this delegates to
    ``mesh_utils.create_hybrid_device_mesh`` — per-process mesh shape
    (1, tp), cross-process shape (dp, 1) — so each tp group stays within
    one process. In one process it reshapes ``devices`` row-major
    (consecutive devices = one tp group).
    """
    if devices is None:
        devices = jax.devices()
    if jax.process_count() > 1:
        from jax.experimental import mesh_utils
        arr = mesh_utils.create_hybrid_device_mesh(
            (1, tp), (dp, 1), devices=devices)
    else:
        if dp * tp > len(devices):
            raise ValueError(f"dp*tp={dp * tp} > {len(devices)} devices")
        arr = np.array(devices[:dp * tp]).reshape(dp, tp)
    return Mesh(arr, ("dp", "tp"))


def replica_meshes(tp: int, n: int, devices=None) -> list[Mesh]:
    """Partition local devices into ``n`` disjoint (dp=1, tp) meshes —
    one per DP replica. Across hosts each process calls this with n=1 over
    ``jax.local_devices()``."""
    if devices is None:
        devices = jax.devices()
    if n * tp > len(devices):
        raise ValueError(f"need {n * tp} devices, have {len(devices)}")
    return [Mesh(np.array(devices[i * tp:(i + 1) * tp]).reshape(1, tp),
                 ("dp", "tp")) for i in range(n)]


def make_tp_cluster(params, cfg: llama.LlamaConfig, *, dp: int, tp: int,
                    fmt: str = "nvfp4", max_batch: int = 4,
                    devices=None) -> "Cluster":
    """dp TP-engine replicas over disjoint local device slices.

    This is the single-process form of the deployment recipe: across
    hosts, each host runs ``dp=1`` of this (its own engine over its local
    devices) and a front-end process runs the ``Cluster`` router over RPC
    stubs (models/rpc.py); here the replicas are in-process, so the router
    logic (admission, balancing, failure replay) is exercised for real
    with host memory as the transport.
    """
    from ..parallel import tp as tp_mod

    qparams = tp_mod.quantize_tp(params, tp, fmt)     # once for all replicas
    replicas = []
    for mesh in replica_meshes(tp, dp, devices):
        qtp = tp_mod.place_params_tp(qparams, mesh)
        step = tp_mod.make_tp_step(cfg, mesh, fmt=fmt)
        cache = tp_mod.init_cache_tp(cfg, max_batch, mesh)
        replicas.append(serving.Engine(qtp, cfg, max_batch=max_batch,
                                       forward_fn=step, cache=cache))
    return Cluster(replicas)


class ReplicaFailed(RuntimeError):
    """Raised internally when a replica's step raises; carried in
    ``Cluster.failures`` for observability."""


#: substrings of exception reprs that mark a TRANSIENT fault — load/resource
#: pressure the replica survives (shed the in-flight work, keep serving) as
#: opposed to device/process loss (dead until re-probe). The paged pool
#: exhaustion is the canonical case: one oversized batch must not
#: permanently kill a replica (VERDICT r3 weak #5).
TRANSIENT_MARKERS = ("pool exhausted", "no free slot", "ResourceExhausted")


class Cluster:
    """Least-loaded router + failure taxonomy + replay over replicas.

    Engines are ordinary ``serving.Engine`` (or Paged/Spec) instances or
    ``rpc.SubprocessReplica`` proxies — anything with add_request /
    has_capacity / step / step_block (+ optional load / has_work /
    drain_finished / reset / ping / respawn, used when present).

    Failure taxonomy (``_classify``): a TRANSIENT error (resource
    pressure, e.g. paged-pool exhaustion) sheds the replica's in-flight
    requests back to pending and resets it — the replica keeps serving.
    A FATAL error (anything else: device loss, process death) marks it
    dead; every ``probe_cooldown`` ticks dead replicas are re-probed
    (``ping``/``respawn`` for subprocess replicas, ``reset`` for
    in-process engines) and rejoin on success.
    """

    def __init__(self, replicas: list, probe_cooldown: int = 8):
        if not replicas:
            raise ValueError("Cluster needs >= 1 replica")
        self.replicas = list(replicas)
        self.alive = [True] * len(replicas)
        self.probe_cooldown = probe_cooldown
        self.cooldown = [0] * len(replicas)
        self.pending: deque = deque()
        self.assigned: dict[int, int] = {}      # uid -> replica index
        self._req: dict[int, serving.Request] = {}   # uid -> request
        self.finished: dict[int, list[int]] = {}
        self.failures: list[tuple[int, str]] = []    # (replica, why)
        self.transients: list[tuple[int, str]] = []  # (replica, why)
        self.replayed: list[int] = []                # uids replayed
        self.revived: list[int] = []                 # replica indices

    # -- load accounting ---------------------------------------------------
    def load(self, i: int) -> int:
        eng = self.replicas[i]
        if hasattr(eng, "load"):
            return int(eng.load())
        return int(eng.active.sum()) + len(eng._pf)

    def _has_work(self, eng) -> bool:
        if hasattr(eng, "has_work"):
            return bool(eng.has_work())
        return bool(eng.active.any() or eng._pf)

    def _pick_replica(self) -> Optional[int]:
        best, best_load = None, None
        for i, eng in enumerate(self.replicas):
            if not self.alive[i]:
                continue
            try:  # a dead process can surface at ANY rpc, not just step
                if not eng.has_capacity():
                    continue
                ld = self.load(i)
            except Exception as e:
                self._fail(i, repr(e))
                continue
            if best_load is None or ld < best_load:
                best, best_load = i, ld
        return best

    # -- request flow ------------------------------------------------------
    def submit(self, requests: list[serving.Request]) -> None:
        for r in requests:
            if r.uid in self._req:
                raise ValueError(f"duplicate uid {r.uid}")
            self._req[r.uid] = r
            self.pending.append(r.uid)

    def _admit(self) -> None:
        while self.pending:
            i = self._pick_replica()
            if i is None:
                return
            uid = self.pending.popleft()
            try:
                self.replicas[i].add_request(self._req[uid])
            except Exception as e:
                self.pending.appendleft(uid)
                self._fail(i, repr(e))
                continue
            self.assigned[uid] = i

    def _collect(self, i: int) -> None:
        eng = self.replicas[i]
        if hasattr(eng, "drain_finished"):
            fin = eng.drain_finished()
        else:
            fin = {uid: eng.finished.pop(uid) for uid in list(eng.finished)}
        for uid, toks in fin.items():
            self.finished[uid] = toks
            self.assigned.pop(uid, None)

    # -- failure handling ----------------------------------------------------
    @staticmethod
    def _classify(why: str) -> str:
        return ("transient" if any(m in why for m in TRANSIENT_MARKERS)
                else "fatal")

    def _requeue_inflight(self, i: int) -> None:
        for uid, rep in list(self.assigned.items()):
            if rep == i:
                del self.assigned[uid]
                self.replayed.append(uid)
                self.pending.appendleft(uid)

    def _fail(self, i: int, why: str) -> None:
        """Apply the taxonomy. Transient: shed in-flight work (replayed on
        any replica, possibly this one) + reset; the replica stays alive.
        Fatal: mark dead, replay elsewhere, arm the re-probe cooldown.

        Decode state (KV cache) lives on the failing replica's devices, so
        recovery restarts generation from the prompt — duplicated work,
        surfaced via ``replayed`` so operators can account for it."""
        if self._classify(why) == "transient":
            self.transients.append((i, why))
            self._requeue_inflight(i)
            try:
                self.replicas[i].reset()
                return                      # still alive
            except Exception as e:          # reset itself failed: escalate
                why = f"{why}; reset failed: {e!r}"
        self.alive[i] = False
        self.cooldown[i] = self.probe_cooldown
        self.failures.append((i, why))
        self._requeue_inflight(i)
        if not any(self.alive):
            raise ReplicaFailed(f"all replicas dead (last: {why})")

    def _probe_dead(self) -> None:
        """Re-probe dead replicas whose cooldown expired: subprocess
        replicas get ping-then-respawn, in-process engines a reset probe.
        Failed probes re-arm a doubled cooldown (bounded backoff)."""
        for i, eng in enumerate(self.replicas):
            if self.alive[i]:
                continue
            if self.cooldown[i] > 0:
                self.cooldown[i] -= 1
                continue
            ok = False
            try:
                if hasattr(eng, "ping"):
                    ok = eng.ping() or (hasattr(eng, "respawn")
                                        and eng.respawn())
                else:
                    eng.reset()
                    ok = eng.has_capacity()
            except Exception:
                ok = False
            if ok:
                self.alive[i] = True
                self.revived.append(i)
            else:
                self.cooldown[i] = min(self.cooldown[i] * 2 + 2, 64)

    def tick(self, decode_block: int = 1) -> int:
        """One cluster round: re-probe dead replicas, admit pending, tick
        every live replica (decode_block > 1 => multi-token blocks per host
        round-trip), collect finishes. Returns outstanding work count."""
        self._probe_dead()
        self._admit()
        for i, eng in enumerate(self.replicas):
            if not self.alive[i]:
                continue
            try:  # failure detection on EVERY replica interaction
                if not self._has_work(eng):
                    continue
                if decode_block > 1:
                    eng.step_block(decode_block)
                else:
                    eng.step()
                self._collect(i)
            except Exception as e:  # taxonomy: requeue + continue
                self._fail(i, repr(e))
        return len(self.pending) + len(self.assigned)

    def run(self, requests: list[serving.Request],
            decode_block: int = 1) -> dict[int, list[int]]:
        self.submit(requests)
        while self.tick(decode_block):
            pass
        return dict(self.finished)
