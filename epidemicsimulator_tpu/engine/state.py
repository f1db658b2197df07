"""Mutable simulation state: the ``lax.scan`` carry.

The reference's state is the whole object graph; here it is six small lanes
plus a handful of carried scalars.  Everything else (positions, schedules,
mixing groups) is a pure function of the static :class:`~..world.schema.World`
and the hour.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MASK_NONE, STATUS_INFECTED, TIMER_DTYPE, TIMER_TWIN_DTYPE
from ..world.schema import World


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SimState:
    """Scan carry.  Per-citizen lanes have shape (N,); the rest are scalars."""

    # --- per-citizen ---
    status: Any          # int8 STATUS_* (disease.rs:36-44)
    timer: Any           # TIMER_DTYPE hours in current E/I state (disease.rs:39-41)
    at_work: Any         # bool: current position is work_building.  Carried
                         # (not derived from the hour) because lockdown
                         # freezes transitions (citizen.rs:176).
    on_bus: Any          # bool: on public transport this step.  Carried for
                         # the same reason: riders at the moment lockdown
                         # starts stay on their bus until it lifts.
    bus_to_work: Any     # bool: route direction home->work vs work->home
    eligible: Any        # bool: in the vaccination-eligible pool

    # --- scalars ---
    hour: Any            # int32, 1-based time step
    lockdown: Any        # bool (interventions.rs:114-128: pure threshold fn)
    vaccination_started: Any  # bool, latches on (interventions.rs:131-140)
    mask_status: Any     # int8 MASK_* (interventions.rs:142-180)
    rng_key: Any         # jax PRNG key for the step's draws

    # fast-path twins of at_work/on_bus maintained in work order (the fast
    # step evolves them with the same schedule rules on the work-permuted
    # static lanes, avoiding a runtime permutation).  Shape (N,) when the
    # world has fast tables, (0,) otherwise.
    at_work_ws: Any = None
    on_bus_ws: Any = None

    # replicated-order twins (SimConfig.use_replicated_orders): disease
    # state maintained in work order and rider order so the hot loop never
    # permutes lanes — cross-order deltas arrive as sparse scatters.
    # Shapes (N,)/(N,) and (R,)/(R,)/(R,); (0,) when the mode is off.
    status_ws: Any = None
    timer_ws: Any = None
    status_r: Any = None
    timer_r: Any = None
    on_bus_r: Any = None

    # sampled-vaccination pool (SimConfig.vaccination_fixed_priority;
    # allocated by init_state(..., fixed_priority_vax=True), (0,) otherwise).
    # vax_pool[:vax_pool_size] holds the citizen ids of a superset of the
    # eligible pool (entries go stale when citizens leave; draws reject
    # against the live eligible lane); rebuilt by one device sort when the
    # pool halves.  Built the step the program activates.
    vax_pool: Any = None
    vax_pool_size: Any = None

    # packed schedule lane (int8, bits 0-4 = at_work, on_bus, bus_to_work,
    # at_work_ws, on_bus_ws).  None in the public representation; the fused
    # chunk runner packs the five bool lanes into this ONE lane for the
    # duration of its scan (pack_sched/unpack_sched below) so the citizen
    # phase moves 1 schedule lane per step instead of 5.
    sched: Any = None


_SCHED_LANES = ("at_work", "on_bus", "bus_to_work", "at_work_ws", "on_bus_ws")


def sched_packed(state: SimState) -> bool:
    """Trace-time check: is the packed schedule lane the source of truth?
    (0,)-shaped sentinels mean 'not packed', matching the codebase's
    convention for optional lanes."""
    return (
        state.sched is not None
        and state.sched.shape[0] == state.status.shape[0]
    )


def pack_sched(state: SimState) -> SimState:
    """Scan-internal representation: five schedule bools -> one s8 lane.
    The bool fields become (0,) sentinels so the carry has a single source
    of truth.  No-op if already packed."""
    if sched_packed(state):
        return state
    lanes = [jnp.asarray(getattr(state, f), jnp.int8) for f in _SCHED_LANES]
    sched = lanes[0]
    for i, lane in enumerate(lanes[1:], start=1):
        if lane.shape == sched.shape:  # ws twins may be (0,) sentinels
            sched = sched | (lane << i)
    empty = jnp.zeros((0,), jnp.bool_)
    return dataclasses.replace(
        state, sched=sched,
        **{f: empty for f in _SCHED_LANES},
    )


def unpack_sched(state: SimState, *, ws_present: bool = True) -> SimState:
    """Inverse of pack_sched (public bool-lane representation)."""
    if not sched_packed(state):
        return state
    s = state.sched
    empty = jnp.zeros((0,), jnp.bool_)
    return dataclasses.replace(
        state,
        at_work=(s & 1) != 0,
        on_bus=(s & 2) != 0,
        bus_to_work=(s & 4) != 0,
        at_work_ws=((s & 8) != 0) if ws_present else empty,
        on_bus_ws=((s & 16) != 0) if ws_present else empty,
        sched=jnp.zeros((0,), jnp.int8),
    )


def with_status(state: SimState, world: World, status) -> SimState:
    """Replace the status lane, keeping the replicated-order twins in sync.

    Use this instead of ``dataclasses.replace(state, status=...)`` whenever
    the world carries fast tables — the replicated fast path
    (SimConfig.use_replicated_orders) reads work-/rider-order copies that
    must describe the same citizens.
    """
    status = jnp.asarray(status, jnp.int8)
    kwargs = dict(status=status)
    if state.status_ws is not None and state.status_ws.shape[0]:
        kwargs["status_ws"] = jnp.take(status, jnp.asarray(world.work_perm))
    if state.status_r is not None and state.status_r.shape[0]:
        kwargs["status_r"] = jnp.take(status, jnp.asarray(world.rider_perm))
    return dataclasses.replace(state, **kwargs)


def init_state(
    world: World,
    *,
    seed: int = 0,
    starting_infected: int = 10,
    np_seed: int | None = None,
    fixed_priority_vax: bool = False,
) -> SimState:
    """Initial state with seeded infections.

    The reference seeds ``STARTING_INFECTED_COUNT`` citizens ``Infected(0)``
    by choosing a uniform output area, then a uniform citizen inside it
    (simulator_builder.rs:1111-1142) — note this is *not* uniform over the
    population; small areas are overrepresented.  We reproduce that two-level
    choice on the host.
    """
    n = world.n_citizens
    rng = np.random.default_rng(seed if np_seed is None else np_seed)
    status = np.zeros(n, np.int8)
    home_oa = np.asarray(world.home_oa)
    if n and (np.diff(home_oa) >= 0).all():
        # Vectorised uniform-OA-then-uniform-citizen choice: home_oa is
        # sorted in the canonical ordering, so OA membership is a
        # searchsorted range.
        oas = rng.integers(0, world.n_output_areas, starting_infected)
        lo = np.searchsorted(home_oa, oas, side="left")
        hi = np.searchsorted(home_oa, oas, side="right")
        nonempty = hi > lo
        picks = lo[nonempty] + (
            rng.random(int(nonempty.sum())) * (hi - lo)[nonempty]
        ).astype(np.int64)
        status[picks] = STATUS_INFECTED
    else:
        for _ in range(starting_infected):
            oa = rng.integers(0, world.n_output_areas)
            members = np.flatnonzero(home_oa == oa)
            if len(members):
                status[rng.choice(members)] = STATUS_INFECTED

    has_fast = getattr(world, "has_fast_tables", False)
    n_ws = n if has_fast else 0
    if has_fast:
        status_ws = status[np.asarray(world.work_perm)]
        rp = np.asarray(world.rider_perm)
        status_r = status[rp]
        n_r = rp.shape[0]
    else:
        status_ws = np.zeros(0, np.int8)
        status_r = np.zeros(0, np.int8)
        n_r = 0
    return SimState(
        status=jnp.asarray(status),
        timer=jnp.zeros(n, TIMER_DTYPE),
        at_work=jnp.zeros(n, jnp.bool_),
        on_bus=jnp.zeros(n, jnp.bool_),
        bus_to_work=jnp.zeros(n, jnp.bool_),
        eligible=jnp.zeros(n, jnp.bool_),
        sched=jnp.zeros((0,), jnp.int8),
        at_work_ws=jnp.zeros(n_ws, jnp.bool_),
        on_bus_ws=jnp.zeros(n_ws, jnp.bool_),
        status_ws=jnp.asarray(status_ws),
        timer_ws=jnp.zeros(n_ws, TIMER_TWIN_DTYPE),
        status_r=jnp.asarray(status_r),
        timer_r=jnp.zeros(n_r, TIMER_TWIN_DTYPE),
        on_bus_r=jnp.zeros(n_r, jnp.bool_),
        vax_pool=jnp.zeros(n if fixed_priority_vax else 0, jnp.int32),
        vax_pool_size=jnp.zeros((), jnp.int32),
        hour=jnp.asarray(0, jnp.int32),
        lockdown=jnp.asarray(False),
        vaccination_started=jnp.asarray(False),
        mask_status=jnp.asarray(MASK_NONE, jnp.int8),
        rng_key=jax.random.key(seed),
    )
