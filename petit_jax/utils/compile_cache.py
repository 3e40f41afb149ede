"""Persistent XLA compile cache for the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing here
overrides it. Otherwise the cache lives at one fixed directory inside the
checkout (``.jax_cache/``, listed in .gitignore): the path is part of what
makes a later run find the entries again, so it never depends on a
temporary name, a process id or the time.
"""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")

_EVENTS = {"hits": 0, "misses": 0}


def _listener(event: str, **_kw) -> None:
    if event == "/jax/compilation_cache/cache_hits":
        _EVENTS["hits"] += 1
    elif event == "/jax/compilation_cache/cache_misses":
        _EVENTS["misses"] += 1


def enable() -> str:
    """Point JAX at the compile cache; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        path = env
    else:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.monitoring.register_event_listener(_listener)
    return path


def stats() -> dict:
    """Persistent-cache hits and misses counted since enable()."""
    return dict(_EVENTS)
