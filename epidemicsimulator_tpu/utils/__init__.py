"""Runtime utilities: persistent compilation caches, timers.

The reference pays its startup cost in world-building (399.5s for Y&H,
`epidemic_sim_v1.6_17739074.log`); ours is XLA compilation of the step.
The persistent compilation cache amortises that across processes; world
builds are separately amortised by the npz world cache (`World.save_npz` +
CLI --use-cache).

Cache location (:func:`cache_root`): ``$JAX_COMPILATION_CACHE_DIR`` when it
is set, which JAX itself reads for its compilation cache; otherwise the
fixed directory ``.cache/`` at the root of the checkout, which git ignores.
The StableHLO export cache of world/device_build.py lives under the same
root.
"""

from __future__ import annotations

import os
import time

#: Root of the checkout this package runs from.
CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_root() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT_ROOT, ".cache"
    )


def enable_compilation_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    With ``$JAX_COMPILATION_CACHE_DIR`` set, JAX already keeps its cache
    there and this sets no other directory; otherwise the cache goes to
    ``<checkout>/.cache/xla``.  Safe to call more than once.
    """
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = os.path.join(cache_root(), "xla")
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


class Timer:
    """Named wall-clock block, the reference's `Timer` (statistics.rs:47-95)
    minus the RSS print (device memory is reported by the profiler instead).

    >>> with Timer("build world") as t: ...
    then ``t.elapsed`` holds seconds.
    """

    def __init__(self, name: str, logger=None):
        self.name = name
        self.logger = logger
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.logger is not None:
            self.logger.info("%s: %.2fs", self.name, self.elapsed)
        return False
