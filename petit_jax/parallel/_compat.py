"""shard_map with the repo's historical keyword (check_rep -> check_vma)."""

from __future__ import annotations

from jax import shard_map as _shard_map_fn


def shard_map(f, mesh, in_specs, out_specs, check_rep=False):
    return _shard_map_fn(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=check_rep)
