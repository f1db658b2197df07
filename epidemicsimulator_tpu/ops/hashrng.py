"""Counter-based hash uniforms for the per-citizen draws.

Each citizen draws from a stateless integer hash of ``(per-step seed,
global citizen index)`` — a murmur3 fmix32 finalizer over a splitmix-style
mixed counter — instead of a threefry pass over the whole lane.  Properties
that matter here:

* identical values from every formulation and every backend (pure integer
  ops, then an exact conversion) — formulation-equivalence tests stay
  bitwise, and a shard or replica hashing its global ids reproduces the
  single-device stream;
* avalanche-quality mixing (murmur3 fmix32 passes SMHasher), far beyond the
  `thread_rng` the reference uses (citizen.rs:221-248, non-reproducible);
* a fresh stream per step via the seed, itself drawn from the sim's
  threefry key, so runs remain reproducible from one root seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def hash_bits(seed_u32, idx_u32):
    """uint32 hash stream: fmix32(idx * golden + seed)."""
    x = idx_u32 * np.uint32(0x9E3779B9) + seed_u32
    x = (x ^ (x >> 16)) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> 13)) * np.uint32(0xC2B2AE35)
    return x ^ (x >> 16)


def hash_uniform(seed_u32, idx_u32):
    """f32 uniforms in [0, 1): fmix32(idx * golden + seed) scaled to 24 bits.

    ``seed_u32``: scalar uint32 (vary per step).  ``idx_u32``: uint32 counter
    array (citizen indices).  Exactly representable in f32; u < q is never
    true for q == 0 and always true for q >= 1.

    Mixing constants are np.uint32 scalars on purpose: module-level jnp
    scalars become captured executable constants under jit; numpy scalars
    inline as jaxpr literals.
    """
    x = idx_u32 * np.uint32(0x9E3779B9) + seed_u32
    x = (x ^ (x >> 16)) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> 13)) * np.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    # >>8 leaves 24 bits, so the int32 view is nonnegative and converts
    # to f32 exactly.
    x24 = jax.lax.bitcast_convert_type(x >> 8, jnp.int32)
    return x24.astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
