"""The one place that resolves what the engines run and where.

Every engine (engine/fastpath.py, engine/packed.py, parallel/fastmesh.py,
parallel/ensemble_mesh.py) reads its citizen-phase formulation from
:func:`use_fused_citizen`.  The rule looks at the world and the config
only, never at the device: every formulation is plain JAX that XLA
compiles for whichever backend runs it, and nothing drops to an
interpreter.

:func:`device_info` names the device a run actually got, for the CLI's log
and the benchmark's output.
"""

from __future__ import annotations

#: Longest household the fused citizen phase's shift window handles (its
#: packed statics hold household position and size in 5 bits).
FUSED_MAX_HOUSEHOLD = 24


def use_fused_citizen(cfg, max_household_size: int) -> bool:
    """Resolve ``SimConfig.use_fused_citizen`` for a world.

    ``None`` (auto) selects the fused citizen phase (ops/citizen.py)
    whenever the world's households fit its window.  The fused phase
    reports per-step contributor counts, which route the sortless work and
    bus branches; those replace the work-order and rider-order permutation
    sorts on most hours.  Both formulations give bitwise-identical
    trajectories.  An explicit True on a world whose households do not fit
    raises.
    """
    fits = 0 < max_household_size <= FUSED_MAX_HOUSEHOLD
    want = cfg.use_fused_citizen
    if want is None:
        return fits
    if want and not fits:
        raise ValueError(
            f"use_fused_citizen requires 0 < max_household_size <= "
            f"{FUSED_MAX_HOUSEHOLD} (got {max_household_size})"
        )
    return bool(want)


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` of the default JAX backend."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
