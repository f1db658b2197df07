"""Compiled multi-step execution: ``lax.scan`` chunks with host early-exit.

The reference loop (simulator.rs:108-127) runs up to ``max_time_step`` hours
and breaks when the disease is gone — ``disease_exists`` is true while any of
exposed/infected/susceptible is nonzero (statistics.rs:289-291), so the run
actually ends only when vaccination + recovery have emptied all three pools.

The loop body is traced once and scanned.  To keep the early exit, we
scan a chunk of ``cfg.chunk_size`` steps per device call and let the host
check the exit condition between chunks; dead epidemics don't pay for the
full 5000 steps, and live ones amortise dispatch overhead across the chunk.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp

from ..config import Params, SimConfig
from ..world.schema import World
from .state import SimState
from .step import StepOutput, step


def world_signature(world: World):
    """Hashable (shapes, dtypes, statics) key for runner memoisation."""
    leaves = jax.tree.leaves(world)
    return (
        tuple((tuple(x.shape), str(getattr(x, "dtype", type(x)))) for x in leaves),
        world.n_buildings, world.n_rooms, world.n_output_areas,
    )


_RUNNER_CACHE: dict = {}

#: Population floor for regime-adaptive sparse-apply dispatch in :func:`run`.
#: Below this only one executable is built (a rule not yet measured on the
#: GPU).
ADAPTIVE_SPARSE_MIN_N = 16_000_000


def adaptive_sparse_runners(world: World, cfg: SimConfig, state: SimState):
    """``(fn_lockdown, fn_moving)`` chunk runners for regime-adaptive
    dispatch, or ``None`` when a single executable is the right answer.

    Sparse apply for moving chunks, dense for lockdown; retired whenever
    the dense apply's own sortless branches are active (they serve both
    regimes from one executable).  All executables are bitwise-identical,
    so :func:`run` picks per chunk off the host-visible lockdown flag it
    already materialises.  Only applies when ``cfg.use_sparse_apply`` is
    None (explicit settings pin one executable) and the sparse path is
    actually eligible (fused citizen phase, non-replicated engine).
    Runners compile
    lazily, so a run that never leaves one regime never builds the other
    executable.
    """
    if cfg.use_sparse_apply is not None:
        return None
    if world.n_citizens < ADAPTIVE_SPARSE_MIN_N:
        return None
    import dataclasses as _dc

    from .fastpath import wants_sortless_dense, wants_sparse_apply

    # With the dense apply's sortless branches active, one executable
    # serves both regimes.
    if wants_sortless_dense(
        world, _dc.replace(cfg, use_sparse_apply=False), state
    ):
        return None
    cfg_sparse = _dc.replace(cfg, use_sparse_apply=True)
    if not wants_sparse_apply(world, cfg_sparse, state):
        return None
    # Legacy pair for worlds/configs where sortless-dense is unavailable
    # or explicitly off: sparse for moving, dense for lockdown.
    cfg_lock = _dc.replace(cfg, use_sparse_apply=False)
    return (
        make_chunk_runner(world, cfg_lock),
        make_chunk_runner(world, cfg_sparse),
    )


def make_chunk_runner(world: World, cfg: SimConfig):
    """Returns ``chunk(params, state) -> (state, StepOutput[chunk])``.

    The world is a traced argument, not a closure constant (no N-sized
    constants baked into the executable), and runners are memoised on
    (cfg, world signature) so repeated runs reuse one jitted callable
    instead of compiling structurally identical twins.
    """
    key = (cfg, world_signature(world))
    jitted = _RUNNER_CACHE.get(key)
    if jitted is None:

        def chunk(world, params: Params, state: SimState, rider_statics):
            # Prebuild the fused citizen phase's static lanes once per
            # chunk so the bit-packing is loop-invariant (not per step).
            from .fastpath import (
                make_rider_statics,
                wants_fused_citizen,
                wants_replicated,
            )

            fused_statics = None
            fused = wants_fused_citizen(world, cfg)
            packed = False
            if fused:
                from ..ops.citizen import make_citizen_statics

                fused_statics = make_citizen_statics(world)
                # Scan-internal packed carry: the five schedule bools ride
                # ONE int8 lane through the citizen phase
                # (state.py::pack_sched); pack/unpack cost two fusions per
                # CHUNK, not per step.
                from .fastpath import wants_packed_sched
                from .state import pack_sched, unpack_sched

                packed = wants_packed_sched(world, cfg)
                if packed:
                    state = pack_sched(state)
            # rider_statics arrive as a jit ARGUMENT precomputed at
            # runner-build time — building them here (traced) would re-run
            # the two N-sized gathers on every chunk.  () = not wanted by
            # this cfg.
            if rider_statics == ():
                rider_statics = None

            gate_overrides = None
            if cfg.debug_force_gates is not None:
                gate_overrides = tuple(
                    None if g is None else jnp.asarray(bool(g))
                    for g in cfg.debug_force_gates
                )

            # The PRNG key is loop-INVARIANT (every step folds the hour
            # into it afresh), but a scan carry leaf gets copied every
            # iteration.  Closing over it makes it a hoisted while-loop
            # operand.
            import dataclasses as _dc

            base_key = state.rng_key
            state = _dc.replace(state, rng_key=None)

            def body(carry, _):
                new_state, out = step(
                    world, params, cfg, _dc.replace(carry, rng_key=base_key),
                    fused_statics=fused_statics,
                    rider_statics=rider_statics,
                    gate_overrides=gate_overrides,
                )
                # One (10,) vector instead of six tiny per-step output
                # leaves: each stacked leaf pays its own per-iteration
                # store/copy; split back OUTSIDE the loop below.
                small = jnp.concatenate([
                    out.seirv.astype(jnp.int32),
                    jnp.stack([
                        out.n_bus_exposures.astype(jnp.int32),
                        out.n_exposures.astype(jnp.int32),
                        out.lockdown.astype(jnp.int32),
                        out.mask_status.astype(jnp.int32),
                        out.n_vaccinated_now.astype(jnp.int32),
                    ]),
                ])
                return (
                    _dc.replace(new_state, rng_key=None),
                    (small, out.exposures_per_oa),
                )

            state, (small_t, oa_t) = jax.lax.scan(
                body, state, None, length=cfg.chunk_size
            )
            state = _dc.replace(state, rng_key=base_key)
            if packed:
                state = unpack_sched(state)
            # Per-OA counts are bounded by OA population (~hundreds); ship
            # them int16 (saturating — only pathological worlds with >32k
            # single-OA exposures per hour would clip) — this (chunk, n_oa)
            # buffer dominates the device->host transfer.
            outs = StepOutput(
                seirv=small_t[:, :5],
                exposures_per_oa=jnp.minimum(oa_t, 32767).astype(jnp.int16),
                n_bus_exposures=small_t[:, 5],
                n_exposures=small_t[:, 6],
                lockdown=small_t[:, 7].astype(jnp.bool_),
                mask_status=small_t[:, 8].astype(jnp.int8),
                n_vaccinated_now=small_t[:, 9],
            )
            return state, outs

        # Explicit in_shardings so compilation is independent of input
        # *provenance*: device-built worlds arrive committed=True and
        # host-built ones committed=False, and jit would otherwise
        # specialize a second program for them.  Pinning one
        # SingleDeviceSharding for all args makes both provenances share
        # one executable.
        s = jax.sharding.SingleDeviceSharding(jax.devices()[0])
        jitted = jax.jit(
            chunk, donate_argnums=(2,), in_shardings=(s, s, s, s)
        )
        _RUNNER_CACHE[key] = jitted

    # Precompute the rider-order schedule statics ONCE per runner (two
    # eager N-sized gathers) instead of per traced chunk.  The wants_*
    # predicates read only static facts unless use_replicated_orders is
    # explicitly on (the replicated engine needs the live state twins to
    # decide — resolved lazily per call below, and its rider statics are
    # the same arrays either way).
    from .fastpath import (
        make_rider_statics,
        wants_replicated,
        wants_sortless_dense,
        wants_sortless_work,
    )

    class _StaticProbe:
        status_ws = None

    _probe = _StaticProbe()
    rs = ()
    if (
        wants_sortless_work(world, cfg, _probe)
        or wants_sortless_dense(world, cfg, _probe)
        or cfg.use_replicated_orders
    ):
        rs = make_rider_statics(world)

    def run_chunk(params, state):
        rs_l = rs
        if rs_l == () and wants_replicated(world, cfg, state):
            rs_l = make_rider_statics(world)
        return jitted(world, params, state, rs_l)

    return run_chunk


def run(
    world: World,
    params: Params,
    cfg: SimConfig,
    state: SimState,
    *,
    callback=None,
    timing: dict | None = None,
    overlap: bool = True,
):
    """Run until the epidemic ends or ``cfg.max_steps`` is reached.

    Returns ``(final_state, outputs)`` where outputs is a StepOutput pytree of
    stacked host numpy arrays, truncated after the step at which
    ``disease_exists`` first became false (matching the reference's break,
    simulator.rs:114-123).

    Device->host transfers of the bulky per-OA series are overlapped with the
    next chunk's compute: ``copy_to_host_async`` starts the DMA, the next
    chunk is dispatched, and only then does the blocking ``np.asarray``
    conversion happen, so the host never waits on a copy it could overlap.
    ``timing``, if given, accumulates wall-clock by category:
    ``dispatch`` (chunk_fn call), ``sync`` (blocking conversion of the
    *previous* chunk while the current one computes), ``callback``.

    ``overlap=False`` restores strictly synchronous per-chunk consumption —
    required when the callback snapshots ``state`` (checkpointing): with
    overlap the state passed to the callback belongs to a chunk whose buffers
    the *next* dispatch has already donated.
    """
    import time as _time

    import numpy as np

    tm = timing if timing is not None else {}
    tm.setdefault("dispatch", 0.0)
    tm.setdefault("sync", 0.0)
    tm.setdefault("callback", 0.0)

    adaptive = adaptive_sparse_runners(world, cfg, state)
    if adaptive is None:
        chunk_fn = make_chunk_runner(world, cfg)
    params = params.as_arrays()

    # Regime bit for adaptive dispatch: the lockdown flag of the last
    # materialised step.  Under overlap this trails the dispatch frontier by
    # up to two chunks — the wrong-regime cost after a transition is bounded
    # and both executables produce bitwise-identical trajectories.  The
    # initial value reads the (host-visible) carry scalar, upgraded by
    # predicting step-1 lockdown from the seeded infected fraction
    # (interventions.rs:114-128 threshold semantics) so a big-seed run's
    # first chunks don't compile and run the moving executable for nothing.
    lockdown_now = bool(jax.device_get(state.lockdown))
    if adaptive is not None and not lockdown_now:
        try:
            from ..config import STATUS_INFECTED

            thr = float(jax.device_get(
                jnp.asarray(params.thresholds.lockdown)))
            if thr >= 0:
                frac = float(jax.device_get(
                    jnp.mean((state.status == STATUS_INFECTED)
                             .astype(jnp.float32))))
                # Strict comparison to mirror step.py's `th.lockdown < pct`
                # (interventions.rs:114 `threshold < percentage_infected`).
                lockdown_now = thr < frac
        except (AttributeError, TypeError) as e:
            # Perf-only heuristic: a refactor that renames the fields it
            # touches must not break runs, but should not go unnoticed.
            logging.getLogger(__name__).debug(
                "step-1 lockdown prediction skipped: %s", e)

    chunks = []
    steps_dispatched = 0
    steps_seen = 0  # steps materialised on the host so far
    pending = None  # device-side StepOutput of the previous chunk

    def _materialise(out):
        # The (chunk, n_oa) per-OA series stays a device array until the
        # run ends; everything the exit check, progress printing and
        # checkpointing need is in the small leaves.
        t0 = _time.perf_counter()
        big = out.exposures_per_oa
        out = jax.tree.map(np.asarray, out._replace(exposures_per_oa=None))
        out = out._replace(exposures_per_oa=big)
        tm["sync"] += _time.perf_counter() - t0
        return out

    def _consume(out, out_state):
        nonlocal steps_seen, lockdown_now
        prev = _materialise(out)
        lockdown_now = bool(prev.lockdown[-1])
        chunks.append(prev)
        steps_seen += prev.seirv.shape[0]
        t0 = _time.perf_counter()
        if callback is not None:
            callback(steps_seen, prev, out_state)
        tm["callback"] += _time.perf_counter() - t0
        alive = prev.seirv[:, 0] + prev.seirv[:, 1] + prev.seirv[:, 2] > 0
        return bool(alive[-1])

    while steps_dispatched < cfg.max_steps:
        t0 = _time.perf_counter()
        if adaptive is not None:
            chunk_fn = adaptive[0] if lockdown_now else adaptive[1]
        state, out = chunk_fn(params, state)
        steps_dispatched += cfg.chunk_size
        # Start DMAing this chunk's outputs while the host inspects the
        # previous chunk and (next iteration) dispatches more compute.
        for leaf in jax.tree.leaves(out):
            try:
                leaf.copy_to_host_async()
            except Exception:
                break
        tm["dispatch"] += _time.perf_counter() - t0

        if not overlap:
            if not _consume(out, state):
                break
            continue

        if pending is not None and not _consume(*pending):
            # Epidemic ended in the previous chunk; `out` was dispatched
            # speculatively — its steps get trimmed by the truncation below.
            pending = (out, state)
            break
        pending = (out, state)

    if pending is not None:
        _consume(*pending)

    outputs = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *chunks)
    outputs = jax.tree.map(lambda x: x[: cfg.max_steps], outputs)

    # Truncate after the first dead step, as the reference stops stepping
    # the moment disease_exists() returns false.
    seirv = outputs.seirv
    alive = seirv[:, 0] + seirv[:, 1] + seirv[:, 2] > 0
    if not alive.all():
        end = int(np.argmin(alive)) + 1  # keep the step that reported death
        outputs = jax.tree.map(lambda x: x[:end], outputs)
    return state, outputs
