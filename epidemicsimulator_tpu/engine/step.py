"""The fused per-hour simulation step.

One jitted, scannable function replaces the reference's three-phase loop
(``generate_exposures`` -> ``apply_exposures`` -> ``apply_interventions``,
simulator.rs:131-152).  Stage order inside the step matches the reference's
observable ordering exactly; each stage cites the behaviour it reproduces.

Everything is shape-stable: no per-building loops, no citizen migration.
Infection pressure is two segment reductions (buildings, school rooms) plus
the per-step bus sort.  The rayon fork/join and all mutexes vanish into XLA
vectorisation on-chip.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import (
    TIMER_DTYPE,
    MASK_EVERYWHERE,
    MASK_NONE,
    MASK_PUBLIC_TRANSPORT,
    STATUS_EXPOSED,
    STATUS_INFECTED,
    STATUS_SUSCEPTIBLE,
    STATUS_VACCINATED,
    Params,
    SimConfig,
)
from ..ops.maths import binomial_at_least_one, truncate_u8
from ..ops.segments import bus_infection_counts
from ..world.schema import World
from .state import SimState


class StepOutput(NamedTuple):
    """Per-step observables (the ``StatisticEntry`` analog, statistics.rs:208)."""

    seirv: jnp.ndarray          # (5,) int32: S, E, I, R, V after this step's
                                # timer advance + exposures (pre-vaccination,
                                # matching when the reference snapshots counts)
    exposures_per_oa: jnp.ndarray  # (n_oa,) int32 or (0,) if disabled
    n_bus_exposures: jnp.ndarray   # () int32
    n_exposures: jnp.ndarray       # () int32 total successful exposures
    lockdown: jnp.ndarray          # () bool, post-update
    mask_status: jnp.ndarray       # () int8, post-update
    n_vaccinated_now: jnp.ndarray  # () int32 set to V this step


def step(
    world: World,
    params: Params,
    cfg: SimConfig,
    state: SimState,
    axis_name: str | None = None,
    gate_overrides=None,
    fused_statics=None,
    rider_statics=None,
):
    """Advance one hour.  Returns (new_state, StepOutput).

    ``axis_name``: when set, the step runs inside ``shard_map`` over a
    citizen-sharded mesh axis of that name.  Per-citizen lanes are local
    shards; infection-pressure tables and global counters are combined with
    ``lax.psum`` over the axis (the mesh analog of the reference's cross-OA
    migration merge, simulator.rs:218-257 — except no agent state ever
    moves, only B-sized count tables cross the interconnect).

    Single-device calls dispatch to the gather-free fast path
    (engine/fastpath.py) when the world carries fast tables and
    ``cfg.use_fast_path`` is set.
    """
    if axis_name is None and cfg.use_fast_path and world.has_fast_tables:
        from .fastpath import fast_step

        return fast_step(
            world, params, cfg, state,
            gate_overrides=gate_overrides, fused_statics=fused_statics,
            rider_statics=rider_statics,
        )
    d = params.disease
    th = params.thresholds
    n = world.n_citizens

    def gsum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    hour = state.hour + 1
    key = jax.random.fold_in(state.rng_key, hour)
    if axis_name:
        # Distinct per-device streams for the per-citizen draws.
        key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
    k_bus, k_draw, k_vax = jax.random.split(key, 3)

    # ------------------------------------------------------------------
    # 1. Disease timer advance (disease.rs:47-71).  E->I when the *old*
    #    timer has reached exposed_time; I->R likewise.
    # ------------------------------------------------------------------
    status, timer = state.status, jnp.asarray(state.timer, jnp.int32)
    is_e = status == STATUS_EXPOSED
    is_i = status == STATUS_INFECTED
    e_to_i = is_e & (timer >= d.exposed_time)
    i_to_r = is_i & (timer >= d.infected_time)
    status = jnp.where(e_to_i, STATUS_INFECTED, status)
    status = jnp.where(i_to_r, jnp.int8(3), status)  # STATUS_RECOVERED
    timer = jnp.where(e_to_i, 0, jnp.where(is_e | is_i, timer + 1, timer))
    timer = jnp.where(i_to_r, 0, timer)
    status = status.astype(jnp.int8)

    # ------------------------------------------------------------------
    # 2. Movement (citizen.rs:168-216).  A first-match schedule on hour%24,
    #    frozen entirely under lockdown (including the on-bus flag: riders
    #    caught by a lockdown keep riding until it lifts — reference
    #    behaviour, citizen.rs:176 skips the whole match).
    # ------------------------------------------------------------------
    h24 = (hour % 24).astype(jnp.int8)
    ws, we = world.work_start, world.work_end
    arm_bus_out = (h24 == ws - 1) & world.uses_transport
    arm_to_work = h24 == ws
    arm_bus_home = (h24 == we - 1) & world.uses_transport
    arm_to_home = h24 == we

    move = ~state.lockdown
    on_bus = jnp.where(move, arm_bus_out | arm_bus_home, state.on_bus)
    bus_to_work = jnp.where(move, arm_bus_out, state.bus_to_work)
    at_work = jnp.where(
        move,
        jnp.where(arm_to_work, True, jnp.where(arm_to_home, False, state.at_work)),
        state.at_work,
    )

    # ------------------------------------------------------------------
    # 3. Census the population after the advance — the reference records
    #    stats during generate_exposures, i.e. post-advance, pre-exposure
    #    (simulator.rs:178).
    # ------------------------------------------------------------------
    seirv0 = gsum(
        jnp.stack(
            [jnp.sum((status == s).astype(jnp.int32)) for s in range(5)]
        )
    )

    # ------------------------------------------------------------------
    # 4. Infection pressure.  Infected citizens contribute at their current
    #    building unless on a bus (simulator.rs:181-198: riders go into the
    #    bus manifest *instead of* the building map).
    #
    #    Single-device fast path: membership is static, so per-building and
    #    per-room infected counts are contiguous-range sums over two static
    #    orders — two cumsums + static gathers, no scatter at all.
    #    Sharded path: local segment_sum + psum of the B-sized tables.
    # ------------------------------------------------------------------
    inf_active = (status == STATUS_INFECTED) & ~on_bus
    at_home_pos = ~at_work | (world.work_building == world.home_building)
    contrib_home = inf_active & at_home_pos
    contrib_work = inf_active & at_work & (world.work_building != world.home_building)

    use_prefix = axis_name is None and world.has_index_tables
    if use_prefix:
        cs_home = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(contrib_home.astype(jnp.int32))]
        )
        n_h = jnp.take(cs_home, world.home_hi) - jnp.take(cs_home, world.home_lo)
        cw = jnp.take(contrib_work, world.work_perm)
        cs_work = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(cw.astype(jnp.int32))]
        )
        n_w = jnp.take(cs_work, world.wb_hi) - jnp.take(cs_work, world.wb_lo)
        draws_room = jnp.take(cs_work, world.room_hi) - jnp.take(
            cs_work, world.room_lo
        )
    else:
        pos_building = jnp.where(at_work, world.work_building, world.home_building)
        n_inf_building = gsum(
            jax.ops.segment_sum(
                inf_active.astype(jnp.int32),
                pos_building,
                num_segments=world.n_buildings,
            )
        )
        # School rooms: infected positioned at their school, per class/office
        # (building.rs:494-522 confines exposure to the infected's room).
        inf_in_school = inf_active & at_work & world.is_school_work
        n_inf_room = gsum(
            jax.ops.segment_sum(
                inf_in_school.astype(jnp.int32),
                world.room,
                num_segments=world.n_rooms + 1,
            )
        )
        n_h = jnp.take(n_inf_building, world.home_building)
        n_w = jnp.take(n_inf_building, world.work_building)
        draws_room = jnp.take(n_inf_room, world.room)

    # ------------------------------------------------------------------
    # 5. Per-citizen exposure chance (disease.rs:131-154 + citizen.rs:221-248).
    #    The reference's mask plumbing is inverted: compliant citizens pass
    #    MaskStatus::None to get_exposure_chance, so only NON-compliant
    #    citizens benefit from an Everywhere mandate, and the
    #    PublicTransport-only mandate never reduces anyone's chance.
    # ------------------------------------------------------------------
    if cfg.reference_mask_semantics:
        mask_active = (state.mask_status == MASK_EVERYWHERE) & ~world.mask_compliant
    else:
        mask_active = world.mask_compliant & (
            (state.mask_status == MASK_EVERYWHERE)
            | ((state.mask_status == MASK_PUBLIC_TRANSPORT) & on_bus)
        )
    p_cit = d.exposure_chance * jnp.where(mask_active, 1.0 - d.mask_effectiveness, 1.0)
    p_cit = jnp.asarray(p_cit, jnp.float32)

    def trunc(x):
        return truncate_u8(x) if cfg.reference_u8_truncation else x

    # Candidate gating: a citizen can be exposed by a building only while in
    # the building's output area (simulator.rs:323-325 skips citizens whose
    # current area differs) — and the reference exposes a building's
    # *registered occupants*, physically present or not, within that area.
    cur_oa = jnp.where(at_work, world.work_oa, world.home_oa)

    # Home side: the household exposes all residents once per step with
    # n = infected positioned there (building.rs:202-204, simulator.rs:307).
    q_home = jnp.where(
        cur_oa == world.home_oa,
        binomial_at_least_one(p_cit, trunc(n_h)),
        0.0,
    )

    # Work side: workplaces expose all employees once (building.rs:278-280);
    # schools run one draw per infected in the citizen's room, each with
    # n = total infected in the whole school (simulator.rs:307-308 +
    # building.rs:494-522 — find_exposures may return a citizen multiple
    # times; a repeated Bernoulli(q) is equivalent to 1-(1-q)^draws).
    # The unemployed have work_building == home_building; the reference holds
    # a single BuildingID so only one draw happens — hence the != gate.
    draws_w = jnp.where(
        world.is_school_work,
        draws_room,
        (n_w > 0).astype(jnp.int32),
    )
    q_single = binomial_at_least_one(p_cit, trunc(n_w))
    q_work = jnp.where(
        (cur_oa == world.work_oa) & (world.work_building != world.home_building),
        -jnp.expm1(draws_w.astype(jnp.float32) * jnp.log1p(-q_single)),
        0.0,
    )

    # Bus side (simulator.rs:360-401): only evaluated on hours where anyone
    # rides; lax.cond skips the sort for the other ~22/24 steps.
    if use_prefix and world.rider_perm is not None:
        # Rider-compacted: only the static transport users (~20% of N,
        # citizen.rs:159) enter the per-step route sort; their (home, work)
        # commute pair is static, so the dense route ids are precomputed.
        def bus_branch(_):
            rp = world.rider_perm
            rb_on = jnp.take(on_bus, rp)
            rb_inf = jnp.take(status, rp) == STATUS_INFECTED
            n_r = bus_infection_counts(
                k_bus, rb_on, world.rider_route, rb_inf & rb_on, cfg.bus_capacity
            )
            return jnp.zeros((n,), jnp.int32).at[rp].set(n_r, mode="drop")

    else:
        route_src = jnp.where(bus_to_work, world.home_oa, world.work_oa)
        route_dst = jnp.where(bus_to_work, world.work_oa, world.home_oa)
        route_key = route_src * jnp.int32(world.n_output_areas) + route_dst

        def bus_branch(_):
            is_inf = status == STATUS_INFECTED
            return bus_infection_counts(
                k_bus, on_bus, route_key, is_inf & on_bus, cfg.bus_capacity
            )

    # Buses are formed per device shard: with citizens sharded by home-OA
    # blocks, same-route riders are almost always co-resident.  (A global
    # formulation via all_to_all is a future optimisation; divergence is a
    # slightly higher partial-bus rate at shard boundaries.)
    any_rider = gsum(jnp.any(on_bus).astype(jnp.int32)) > 0
    n_inf_my_bus = jax.lax.cond(
        any_rider, bus_branch, lambda _: jnp.zeros((n,), jnp.int32), None
    )
    q_bus = jnp.where(
        n_inf_my_bus > 0, binomial_at_least_one(p_cit, n_inf_my_bus), 0.0
    )

    # ------------------------------------------------------------------
    # 6. Exposure draws.  Three independent uniforms mirror the reference's
    #    independent expose() calls per source; success order for stats
    #    attribution is home -> work -> bus (the reference's order is the
    #    nondeterministic rayon schedule).
    # ------------------------------------------------------------------
    u = jax.random.uniform(k_draw, (3, n), jnp.float32)
    susceptible = status == STATUS_SUSCEPTIBLE
    hit_home = susceptible & (u[0] < q_home)
    hit_work = susceptible & (u[1] < q_work)
    hit_bus = susceptible & (u[2] < q_bus)
    newly_exposed = hit_home | hit_work | hit_bus

    status = jnp.where(newly_exposed, jnp.int8(STATUS_EXPOSED), status)
    timer = jnp.where(newly_exposed, 0, timer)

    # Vaccine-pool pruning: the reference prunes only bus exposures (the
    # building path prunes an OutputArea-level list that is never
    # initialised; see SimConfig.faithful_vaccine_bugs).
    if cfg.faithful_vaccine_bugs:
        eligible = state.eligible & ~(hit_bus & ~hit_home & ~hit_work)
    else:
        eligible = state.eligible & ~newly_exposed

    # Exposure bookkeeping (statistics.rs:181-195): building-sourced
    # exposures count against the building's OA; bus exposures only globally.
    n_new = gsum(jnp.sum(newly_exposed.astype(jnp.int32)))
    from_home = hit_home
    from_work = hit_work & ~hit_home
    from_bus = hit_bus & ~hit_home & ~hit_work
    n_bus_exp = gsum(jnp.sum(from_bus.astype(jnp.int32)))
    if cfg.record_exposures_per_oa:
        oa_attr = jnp.where(from_home, world.home_oa, world.work_oa)
        counted = from_home | from_work
        exposures_per_oa = gsum(
            jax.ops.segment_sum(
                counted.astype(jnp.int32),
                jnp.where(counted, oa_attr, world.n_output_areas),
                num_segments=world.n_output_areas + 1,
            )[: world.n_output_areas]
        )
    else:
        exposures_per_oa = jnp.zeros((0,), jnp.int32)

    # Post-exposure census, as the reference's entry ends up after
    # citizen_exposed() shifts S -> E (statistics.rs:275-287).
    seirv = seirv0.at[STATUS_SUSCEPTIBLE].add(-n_new).at[STATUS_EXPOSED].add(n_new)

    # ------------------------------------------------------------------
    # 7. Intervention state machine (interventions.rs:110-184), evaluated on
    #    infected / total of THIS step's entry (simulator.rs:455-459;
    #    infected count is unaffected by same-step exposures).
    # ------------------------------------------------------------------
    total = jnp.sum(seirv).astype(jnp.float32)
    pct = seirv[STATUS_INFECTED].astype(jnp.float32) / total

    lockdown = (th.lockdown >= 0) & (th.lockdown < pct)

    newly_started = (
        ~state.vaccination_started & (th.vaccination >= 0) & (th.vaccination < pct)
    )
    vaccination_started = state.vaccination_started | newly_started
    # Pool snapshot at trigger: everyone susceptible after this step's
    # exposures (apply_interventions runs after apply_exposures).
    eligible = jnp.where(newly_started, status == STATUS_SUSCEPTIBLE, eligible)

    ms = state.mask_status
    ms_next = jnp.where(
        ms == MASK_NONE,
        jnp.where(pct > th.mask_public_transport, MASK_PUBLIC_TRANSPORT, MASK_NONE),
        jnp.where(
            ms == MASK_PUBLIC_TRANSPORT,
            jnp.where(
                pct < th.mask_public_transport,
                MASK_NONE,
                jnp.where(
                    pct > th.mask_everywhere, MASK_EVERYWHERE, MASK_PUBLIC_TRANSPORT
                ),
            ),
            jnp.where(pct < th.mask_everywhere, MASK_PUBLIC_TRANSPORT, MASK_EVERYWHERE),
        ),
    ).astype(jnp.int8)

    # ------------------------------------------------------------------
    # 8. Vaccination (simulator.rs:524-553): pick vaccination_rate uniform
    #    citizens from the eligible pool and set them Vaccinated outright.
    #    Exact-k selection without dynamic shapes: random scores, top-k of
    #    the k_max smallest, rank-gate by the traced rate.
    # ------------------------------------------------------------------
    def vaccinate(args):
        status, eligible, key = args
        k_max = min(cfg.max_vaccinations_per_step, n)
        scores = jax.random.uniform(key, (n,), jnp.float32)
        scores = jnp.where(eligible, scores, 2.0)
        neg_top, idxs = jax.lax.top_k(-scores, k_max)
        if axis_name:
            # Exact global-k selection: gather every shard's local top-k_max
            # scores, find the global rank-k threshold, and vaccinate local
            # candidates at or below it.  O(devices * k) over the mesh.
            all_scores = jax.lax.all_gather(-neg_top, axis_name).reshape(-1)
            global_sorted = jnp.sort(all_scores)
            kth = jnp.take(
                global_sorted,
                jnp.clip(d.vaccination_rate - 1, 0, global_sorted.shape[0] - 1),
            )
            chosen = (-neg_top <= kth) & (-neg_top <= 1.0)
        else:
            ranks = jnp.arange(k_max, dtype=jnp.int32)
            chosen = (ranks < d.vaccination_rate) & (-neg_top <= 1.0)
        if cfg.faithful_vaccine_bugs:
            # Chosen citizens become Vaccinated regardless of current status,
            # and stay in the pool (the reference never removes them).
            new_status = jnp.where(chosen, jnp.int8(STATUS_VACCINATED), status[idxs])
            status = status.at[idxs].set(new_status, mode="drop")
        else:
            ok = chosen & (status[idxs] == STATUS_SUSCEPTIBLE)
            new_status = jnp.where(ok, jnp.int8(STATUS_VACCINATED), status[idxs])
            status = status.at[idxs].set(new_status, mode="drop")
            eligible = eligible.at[idxs].set(
                jnp.where(chosen, False, eligible[idxs]), mode="drop"
            )
        n_vax = gsum(jnp.sum(chosen.astype(jnp.int32)))
        return status, eligible, n_vax

    status, eligible, n_vax = jax.lax.cond(
        vaccination_started,
        vaccinate,
        lambda args: (args[0], args[1], jnp.int32(0)),
        (status, eligible, k_vax),
    )

    new_state = SimState(
        status=status,
        timer=timer.astype(TIMER_DTYPE),
        at_work=at_work,
        on_bus=on_bus,
        bus_to_work=bus_to_work,
        eligible=eligible,
        at_work_ws=state.at_work_ws,
        on_bus_ws=state.on_bus_ws,
        sched=state.sched,
        # replicated-order twins are not evolved by the portable step —
        # carried through untouched for pytree stability (they are only
        # read by the replicated fast path, which never mixes with this
        # formulation within a run)
        status_ws=state.status_ws,
        timer_ws=state.timer_ws,
        status_r=state.status_r,
        timer_r=state.timer_r,
        on_bus_r=state.on_bus_r,
        vax_pool=state.vax_pool,
        vax_pool_size=state.vax_pool_size,
        hour=hour,
        lockdown=lockdown,
        vaccination_started=vaccination_started,
        mask_status=ms_next,
        rng_key=state.rng_key,
    )
    out = StepOutput(
        seirv=seirv,
        exposures_per_oa=exposures_per_oa,
        n_bus_exposures=n_bus_exp,
        n_exposures=n_new,
        lockdown=lockdown,
        mask_status=ms_next,
        n_vaccinated_now=n_vax,
    )
    return new_state, out
