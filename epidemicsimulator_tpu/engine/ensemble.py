"""Parameter ensembles: vmapped replicate sweeps in one compilation.

The reference can only run one configuration per process; here disease
parameters and intervention thresholds are traced pytrees, so a stacked
``Params`` (leading replicate axis on every leaf) runs R simulations
simultaneously on one chip — the BASELINE.md "64 vmapped disease-parameter
replicates" target.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Params, SimConfig
from ..world.schema import World
from .state import SimState, init_state
from .step import step


def stack_params(param_list: list[Params]) -> Params:
    """Stack a list of Params into one with a leading replicate axis."""
    arrs = [p.as_arrays() for p in param_list]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *arrs)


def init_ensemble_state(world: World, n_replicates: int, *, seed: int = 0,
                        starting_infected: int = 10) -> SimState:
    """Batched SimState: independent seeding + rng stream per replicate."""
    states = [
        init_state(world, seed=seed + r, starting_infected=starting_infected)
        for r in range(n_replicates)
    ]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def make_ensemble_runner(world: World, cfg: SimConfig):
    """jitted ``chunk(stacked_params, batched_state)`` running all
    replicates for cfg.chunk_size steps.

    Only the SEIRV series is kept per replicate, so per-OA exposure
    recording is disabled (it would cost a scan per replicate per step).
    """
    # Replicated orders stay off inside vmap: batching flattens the sparse
    # transports' lax.conds into always-both-branches selects, so the dense
    # fallbacks would run every step.
    cfg = dataclasses.replace(
        cfg, record_exposures_per_oa=False, use_replicated_orders=False,
        vaccination_fixed_priority=False,
    )

    from .scan import _RUNNER_CACHE, world_signature

    key = ("ensemble", cfg, world_signature(world))
    vm = _RUNNER_CACHE.get(key)
    if vm is None:
        # Hour masks for the batch-wide gate predicates: computed OUTSIDE the
        # vmapped step so the work-side/bus lax.conds stay conds (a batched
        # predicate would flatten them into always-execute selects).  The
        # gated blocks are no-ops when pressure is zero, so the conservative
        # hour-based predicate is correctness-neutral.
        ws_np = np.asarray(world.work_start).astype(np.int64)
        we_np = np.asarray(world.work_end).astype(np.int64)
        work_hours = np.zeros(24, bool)
        for h in range(24):
            work_hours[h] = bool(np.any((ws_np <= h) & (h <= we_np)))
        bus_hours = np.zeros(24, bool)
        bus_hours[np.unique((ws_np - 1) % 24)] = True
        bus_hours[np.unique((we_np - 1) % 24)] = True

        one = jax.vmap(
            lambda world, params, state, wp, bp: _scan_free_step(
                world, params, cfg, state, wp, bp
            ),
            in_axes=(None, 0, 0, None, None),
        )

        def chunk(world, work_mask, bus_mask, params, state):
            # Loop-invariant PRNG keys hoisted out of the carry (see
            # engine/scan.py — carried key leaves pay per-iteration
            # memory-space copies).
            base_keys = state.rng_key
            state = dataclasses.replace(state, rng_key=None)

            def body(carry, _):
                h24 = (carry.hour[0] + 1) % 24
                work_pred = work_mask[h24] | jnp.any(carry.at_work)
                bus_pred = bus_mask[h24] | jnp.any(carry.on_bus)
                ns, seirv = one(
                    world, params,
                    dataclasses.replace(carry, rng_key=base_keys),
                    work_pred, bus_pred,
                )
                return dataclasses.replace(ns, rng_key=None), seirv

            ns, seirv_t = jax.lax.scan(body, state, None, length=cfg.chunk_size)
            ns = dataclasses.replace(ns, rng_key=base_keys)
            # scan stacks over time: (chunk, R, 5) -> (R, chunk, 5)
            return ns, jnp.transpose(seirv_t, (1, 0, 2))

        # Same provenance pin as make_chunk_runner: device-built worlds are
        # committed=True and would otherwise specialize a second executable
        # (see engine/scan.py).
        s = jax.sharding.SingleDeviceSharding(jax.devices()[0])
        jitted = jax.jit(
            chunk, donate_argnums=(4,), in_shardings=(s, s, s, s, s)
        )
        masks = (jnp.asarray(work_hours), jnp.asarray(bus_hours))
        vm = (jitted, masks)
        _RUNNER_CACHE[key] = vm

    jitted, (work_mask, bus_mask) = vm

    def run_chunk(params, state):
        return jitted(world, work_mask, bus_mask, params, state)

    return run_chunk


def _scan_free_step(world, params, cfg, state, work_pred, bus_pred):
    ns, out = step(world, params, cfg, state, gate_overrides=(work_pred, bus_pred))
    return ns, out.seirv


def run_ensemble(
    world: World,
    params_list: list[Params],
    cfg: SimConfig,
    *,
    seed: int = 0,
    engine: str = "packed",
    devices: int | None = None,
):
    """Run R replicates to max_steps; returns (R, T, 5) SEIRV series.

    ``engine="packed"`` (default) tiles the replicas into ONE world and
    steps them with the fused fast-path formulation (engine/packed.py);
    the two engines' throughput is not yet measured on the GPU.
    ``engine="vmap"`` keeps
    the vmapped formulation (stacked Params pytree, one compilation) —
    the right tool when replicas must share a device-resident world
    (e.g. very large base worlds where R tiled copies exceed HBM).

    ``devices``: >1 shards the packed R axis replicate-per-device
    (parallel/ensemble_mesh.py — pure data parallelism, zero per-step
    collectives; replicas must divide evenly).  Trajectories then run in
    id-keyed bus-RNG mode (SimConfig.id_keyed_ensemble_rng) so results
    are bitwise-identical at any mesh size.

    Early exit happens only when ALL replicates are done.
    """
    if devices is not None and devices > 1:
        if engine != "packed":
            raise ValueError("sharded ensembles require engine='packed'")
        from ..parallel.ensemble_mesh import run_packed_ensemble_sharded

        return run_packed_ensemble_sharded(
            world, params_list, cfg, n_devices=devices, seed=seed
        )
    if engine == "packed":
        from .packed import run_packed_ensemble

        return run_packed_ensemble(world, params_list, cfg, seed=seed)
    if engine != "vmap":
        raise ValueError(f"unknown ensemble engine {engine!r}")
    world = world.device_put()
    stacked = stack_params(params_list)
    state = init_ensemble_state(
        world, len(params_list), seed=seed,
        starting_infected=cfg.starting_infected,
    )
    runner = make_ensemble_runner(world, cfg)

    chunks = []
    steps = 0
    while steps < cfg.max_steps:
        state, seirv = runner(stacked, state)
        seirv = np.asarray(seirv)  # (R, chunk, 5)
        chunks.append(seirv)
        steps += cfg.chunk_size
        alive = seirv[:, -1, :3].sum(axis=1) > 0
        if not alive.any():
            break
    return np.concatenate(chunks, axis=1)[:, : cfg.max_steps]
