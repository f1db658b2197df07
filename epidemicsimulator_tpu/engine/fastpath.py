"""Single-device fast step: the gather-free formulation of engine/step.py.

Semantics are identical to :func:`engine.step.step` (see its stage comments
and reference citations); only the *computation* of the infection-pressure
counts and bookkeeping changes:

* household / workplace / school-room infected counts: contiguous-run totals
  via boundary-masked scans (ops/runsums.py) instead of segment_sum+gather.
* the work side runs in a static "work order" (citizens sorted by
  (work_building, room)); a lane is moved between citizen order and work
  order with one static-key sort in each direction per step, carrying packed
  int8 payloads.  Work-order copies of the static lanes live in the World.
* per-OA exposure counts: one cumsum + two (n_oa,)-sized gathers per side.
* vaccination: exact-k uniform selection via binary search for the k-th
  smallest random score (a handful of compare+reduce passes) instead of
  top_k + scatter.

Everything per-citizen is elementwise, scans, or sorts — no random access
proportional to N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import (
    TIMER_DTYPE,
    TIMER_TWIN_DTYPE,
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
from ..backend import use_fused_citizen
from ..ops.maths import binomial_at_least_one, truncate_u8
from ..ops.runsums import (
    permute_by_sort, range_totals, run_totals, run_totals_multi,
)
from ..ops.segments import bus_hits
from ..world.schema import World
from .state import SimState
from .step import StepOutput


def _advance_disease(status, timer_i32, d):
    """disease.rs:47-71 timer advance, shared by every replicated order."""
    is_e = status == STATUS_EXPOSED
    is_i = status == STATUS_INFECTED
    e_to_i = is_e & (timer_i32 >= d.exposed_time)
    i_to_r = is_i & (timer_i32 >= d.infected_time)
    status1 = jnp.where(e_to_i, STATUS_INFECTED, status)
    status1 = jnp.where(i_to_r, jnp.int8(3), status1).astype(jnp.int8)
    timer1 = jnp.where(
        e_to_i | i_to_r, 0, jnp.where(is_e | is_i, timer_i32 + 1, timer_i32)
    )
    return status1, timer1


def _movement(h24, ws, we, uses_transport, move, at_work, on_bus, bus_to_work):
    """citizen.rs:168-216 schedule match, frozen under lockdown."""
    arm_bus_out = (h24 == ws - 1) & uses_transport
    arm_to_work = h24 == ws
    arm_bus_home = (h24 == we - 1) & uses_transport
    arm_to_home = h24 == we
    on_bus = jnp.where(move, arm_bus_out | arm_bus_home, on_bus)
    new_btw = jnp.where(move, arm_bus_out, bus_to_work) if bus_to_work is not None else None
    at_work = jnp.where(
        move,
        jnp.where(arm_to_work, True, jnp.where(arm_to_home, False, at_work)),
        at_work,
    )
    return at_work, on_bus, new_btw


def _exposure_p(exposure_chance, mask_effectiveness, mask_status, compliant,
                on_bus, reference_semantics):
    if reference_semantics:
        active = (mask_status == MASK_EVERYWHERE) & ~compliant
    else:
        active = compliant & (
            (mask_status == MASK_EVERYWHERE)
            | ((mask_status == MASK_PUBLIC_TRANSPORT) & on_bus)
        )
    return jnp.asarray(
        exposure_chance * jnp.where(active, 1.0 - mask_effectiveness, 1.0),
        jnp.float32,
    )


def _work_pressure(world, contrib_ws):
    """Work-order infected counts per workplace building and the number
    of draws each worker takes: one per infected building, or one per
    infected room-mate at school (building.rs:278-280, 494-522;
    simulator.rs:307-308).  Returns ``(n_building, draws)``."""
    n_b, n_room = run_totals_multi(
        contrib_ws,
        [
            (world.ws_wb_start_mask, world.ws_wb_end_mask),
            (world.ws_room_start_mask, world.ws_room_end_mask),
        ],
    )
    draws = jnp.where(world.ws_is_school, n_room, (n_b > 0).astype(jnp.int32))
    return n_b, draws


def _kth_score_threshold(scores_u32, eligible, k):
    """Smallest uint32 t with |{eligible & score <= t}| >= k, plus the count
    strictly below t — for exact-k tie handling.  32 compare+reduce passes."""

    def body(state):
        lo, hi, _ = state
        mid = lo + (hi - lo) // jnp.uint32(2)
        cnt = jnp.sum((eligible & (scores_u32 <= mid)).astype(jnp.int32))
        hit = cnt >= k
        return (
            jnp.where(hit, lo, mid + jnp.uint32(1)),
            jnp.where(hit, mid, hi),
            state[2] + 1,
        )

    lo, _, _ = jax.lax.while_loop(
        lambda s: s[2] < 32, body, (jnp.uint32(0), jnp.uint32(0xFFFFFFFF), 0)
    )
    return lo


def wants_fused_citizen(world: World, cfg: SimConfig) -> bool:
    """Whether fast_step will use the fused citizen phase — callers that
    scan many steps prebuild CitizenStatics when this is True."""
    if not (cfg.use_fast_path and world.has_fast_tables):
        return False
    return use_fused_citizen(cfg, world.max_household_size)


def wants_replicated(world: World, cfg: SimConfig, state: SimState) -> bool:
    """Whether fast_step runs the replicated-order formulation (state twins
    present + enabled).  Chunk runners use this to prebuild rider statics."""
    rep = cfg.use_replicated_orders
    if rep is None:
        # Auto: off.  An explicit opt-in formulation; trajectories are
        # bitwise-identical to the classic one.
        rep = False
    return (
        bool(rep)
        and cfg.use_fast_path
        and world.has_fast_tables
        and world.rpos is not None
        and jnp.size(world.rpos) == world.n_citizens
        and state.status_ws is not None
        and state.status_ws.shape[0] == world.n_citizens
    )


def wants_packed_sched(world: World, cfg: SimConfig) -> bool:
    """Whether the fused chunk runner carries the packed schedule lane.
    Auto (None): on >= 16M citizens (a rule not yet measured on the
    GPU)."""
    ps = cfg.use_packed_sched
    if ps is None:
        ps = world.n_citizens >= 16_000_000
    return bool(ps) and wants_fused_citizen(world, cfg)


def wants_fixed_priority_vax(world: World, cfg: SimConfig) -> bool:
    """Whether the sampled (pool-draw) vaccination selector should be used —
    init_state callers use this to allocate the pool lanes.  Auto (None):
    on for fast-path worlds >= 16M citizens, where the default selector's
    pool-wide threshold search grows with N (a rule not yet measured on
    the GPU)."""
    fp = cfg.vaccination_fixed_priority
    if fp is None:
        fp = world.n_citizens >= 16_000_000
    return bool(fp) and cfg.use_fast_path and world.has_fast_tables


def wants_sparse_apply(world: World, cfg: SimConfig, state: SimState) -> bool:
    """Whether fast_step applies the gated work/bus hits as K-bounded
    scatters (SimConfig.use_sparse_apply).  Requires the fused citizen
    phase (which applies home hits in-pass and reports their count in
    its counts[:, 7]) and the classic (non-replicated) formulation; the
    legacy no-OA-table per-OA recording branch still needs dense hit
    lanes, so it opts out too.

    Auto (None) resolves to the dense apply; ``engine.scan.run`` can layer
    regime-adaptive dispatch on top for big worlds (dense executable while
    lockdown holds, sparse once movement resumes) — the two formulations
    are bitwise-identical, so switching per chunk is free of semantic
    risk."""
    sa = cfg.use_sparse_apply
    if sa is None:
        sa = False
    return (
        bool(sa)
        and wants_fused_citizen(world, cfg)
        and not wants_replicated(world, cfg, state)
        and not (cfg.record_exposures_per_oa and world.oa_lo.shape[0] == 0)
    )


def wants_sortless_work(world: World, cfg: SimConfig, state: SimState) -> bool:
    """Whether the sparse-apply work branch runs the sortless formulation
    (SimConfig.use_sortless_work).  Auto (None): on for populations >=
    16M — i.e. the regime-adaptive dispatcher's moving executable at UK
    scale (a rule not yet measured on the GPU)."""
    sl = cfg.use_sortless_work
    if sl is None:
        sl = world.n_citizens >= 16_000_000
    return bool(sl) and wants_sparse_apply(world, cfg, state)


def wants_sortless_dense(world: World, cfg: SimConfig, state: SimState) -> bool:
    """Whether the DENSE apply's work branch runs the sortless formulation
    (SimConfig.use_sortless_dense): the same K-bounded drains as the
    sparse path's sortless branch, with hits scattered straight back to
    citizen order.  Requires the fused citizen phase (its contributor
    counts route the dispatch switch) and the classic
    formulation; mutually exclusive with the sparse apply by construction
    (that path has its own sortless branch)."""
    sd = cfg.use_sortless_dense
    if sd is None:
        # Auto: on at every scale; one executable serves every regime
        # (engine/scan.py).
        sd = True
    return (
        bool(sd)
        and wants_fused_citizen(world, cfg)
        and not wants_replicated(world, cfg, state)
        and not wants_sparse_apply(world, cfg, state)
        and not (cfg.record_exposures_per_oa and world.oa_lo.shape[0] == 0)
    )


def sortless_rounds(n_citizens: int, cfg: SimConfig) -> int:
    """Resolved ``sortless_max_rounds`` (None = auto: 16 below 16M, 64 at
    >=16M — a drain round costs about the same at any N while the sort it
    replaces grows with N; not yet measured on the GPU)."""
    r = cfg.sortless_max_rounds
    if r is None:
        r = 64 if n_citizens >= 16_000_000 else 16
    return max(1, int(r))


def make_rider_statics(world: World):
    """Rider-order schedule lanes for the replicated bus path — one-time
    gathers, built outside the scan so they are loop-invariant."""
    rp = world.rider_perm
    return (
        jnp.take(jnp.asarray(world.work_start), rp),
        jnp.take(jnp.asarray(world.work_end), rp),
    )


def fast_step(
    world: World,
    params: Params,
    cfg: SimConfig,
    state: SimState,
    gate_overrides=None,
    fused_statics=None,
    rider_statics=None,
):
    """``gate_overrides``: optional (work_pred, bus_pred) scalars replacing
    the internally-computed lax.cond predicates.  The gated blocks are
    semantic no-ops when their infection pressure is zero, so any
    conservative predicate is correctness-neutral — the ensemble runner
    passes batch-wide predicates computed OUTSIDE vmap so the conds stay
    conds instead of flattening into selects.

    ``fused_statics``: prebuilt :class:`~..ops.citizen.CitizenStatics`
    (bit-packed static lanes) for the fused citizen phase; the chunk
    runner builds them once outside its scan.  Built inline if None.
    """
    d = params.disease
    th = params.thresholds
    n = world.n_citizens
    K = world.max_household_size
    use_fused = use_fused_citizen(cfg, K)

    hour = state.hour + 1
    key = jax.random.fold_in(state.rng_key, hour)
    k_bus, k_h, k_w, k_b, k_vax = jax.random.split(key, 5)
    # Derive every cond branch's RNG seed here, at the top level of the
    # step, and close over the ready u32 scalars.
    seed_w = jax.random.bits(k_w, (), jnp.uint32)
    seed_vax0 = jax.random.bits(k_vax, (), jnp.uint32)
    seed_vax1 = jax.random.bits(jax.random.fold_in(k_vax, 1), (), jnp.uint32)
    h24 = (hour % 24).astype(jnp.int8)
    move = ~state.lockdown

    def trunc(x):
        return truncate_u8(x) if cfg.reference_u8_truncation else x

    if use_fused:
        # Stages 1-4 + the cond-operand packing in one fused pass
        # (ops/citizen.py), home hits applied in-pass.
        from ..ops.citizen import citizen_phase, make_citizen_statics
        from .state import pack_sched, sched_packed

        statics = (
            fused_statics if fused_statics is not None
            else make_citizen_statics(world)
        )
        packed_carry = sched_packed(state)
        sched_in = state.sched if packed_carry else pack_sched(state).sched
        (status, timer, sched1, fwd_packed, partials) = citizen_phase(
            statics,
            state.status, state.timer, sched_in,
            h24=h24, move=move, mask_status=state.mask_status,
            seed=jax.random.bits(k_h, (), jnp.uint32),
            exposed_time=d.exposed_time, infected_time=d.infected_time,
            exposure_chance=d.exposure_chance,
            mask_effectiveness=d.mask_effectiveness,
            K=K,
            ref_mask_sem=cfg.reference_mask_semantics,
            u8_trunc=cfg.reference_u8_truncation,
        )
        # hit_home survives as bit 2 of fwd_packed (the dense re-apply
        # below is idempotent, so both apply modes are bitwise-identical).
        hit_home = (fwd_packed & 4) != 0
        seirv0 = jnp.sum(partials[:, :5], axis=0)
        n_home = jnp.sum(partials[:, 7])
        work_pred_default = jnp.sum(partials[:, 5]) > 0
        bus_pred_default = jnp.sum(partials[:, 6]) > 0
        timer = jnp.asarray(timer, jnp.int32)

        # Unpacked views: materialised ONLY where eagerly needed (the
        # replicated engine / legacy bool-lane carry); the gated work/bus
        # branches unpack inside their cond bodies so the bits never
        # materialise on skipped steps.
        if rep_needed := wants_replicated(world, cfg, state):
            at_work_ws = (sched1 & 8) != 0
            on_bus_ws = (sched1 & 16) != 0
        if not packed_carry:
            at_work = (sched1 & 1) != 0
            on_bus = (sched1 & 2) != 0
            bus_to_work = (sched1 & 4) != 0
            if not rep_needed:
                at_work_ws = (sched1 & 8) != 0
                on_bus_ws = (sched1 & 16) != 0
    else:
        packed_carry = False
        from .state import sched_packed, unpack_sched

        if sched_packed(state):  # packed carry reached a non-fused step
            state = unpack_sched(state)

        # 1. disease timers (disease.rs:47-71)
        status, timer = _advance_disease(
            state.status, jnp.asarray(state.timer, jnp.int32), d
        )

        # 2. movement, in citizen order and (independently, same rules +
        #    scalars) in work order
        at_work, on_bus, bus_to_work = _movement(
            h24, world.work_start, world.work_end, world.uses_transport,
            move, state.at_work, state.on_bus, state.bus_to_work,
        )
        at_work_ws, on_bus_ws, _ = _movement(
            h24, world.ws_work_start, world.ws_work_end,
            world.ws_uses_transport,
            move, state.at_work_ws, state.on_bus_ws, None,
        )

        # 3. census post-advance (simulator.rs:178)
        seirv0 = jnp.stack(
            [jnp.sum((status == s).astype(jnp.int32)) for s in range(5)]
        )

        # 4. home-side pressure + draw, all in citizen order
        inf_active = (status == STATUS_INFECTED) & ~on_bus
        work_neq_home = world.work_building != world.home_building
        contrib_home = inf_active & (~at_work | ~work_neq_home)
        # Households are tiny, so a shift-window sum over [-K, K] neighbours
        # (gated by the static within-household position lanes) beats the
        # generic three-scan run total; fall back to scans for outlier
        # worlds.
        if 0 < K <= 24:
            c8 = contrib_home.astype(jnp.int8)
            pos = world.hh_pos
            size = world.hh_size
            acc = contrib_home.astype(jnp.int32)
            for dd in range(1, K):
                fwd = jnp.roll(c8, -dd)          # neighbour at pos + dd
                bwd = jnp.roll(c8, dd)           # neighbour at pos - dd
                acc = acc + jnp.where(pos + dd < size, fwd, 0)
                acc = acc + jnp.where(pos - dd >= 0, bwd, 0)
            n_h = acc
        else:
            n_h = run_totals(
                contrib_home, world.home_start_mask, world.home_end_mask
            )

        p_cit = _exposure_p(
            d.exposure_chance, d.mask_effectiveness, state.mask_status,
            world.mask_compliant, on_bus, cfg.reference_mask_semantics,
        )
        cur_oa = jnp.where(at_work, world.work_oa, world.home_oa)
        q_home = jnp.where(
            cur_oa == world.home_oa,
            binomial_at_least_one(p_cit, trunc(n_h)),
            0.0,
        )
        susceptible = status == STATUS_SUSCEPTIBLE
        # Same counter-hash stream as the fused phase (seed from k_h,
        # indexed by citizen id): fused and non-fused home draws are
        # bitwise-identical, and the sharded fast path reproduces them by
        # hashing on its global-id lane (parallel/fastmesh.py).
        from ..ops.hashrng import hash_uniform as _hu

        seed_h = jax.random.bits(k_h, (), jnp.uint32)
        hit_home = susceptible & (
            _hu(seed_h, jnp.arange(n, dtype=jnp.uint32)) < q_home
        )

        contrib_work = inf_active & at_work & work_neq_home
        # one merged gates lane (same layout as the fused phase's):
        # bits 0-2 feed the work cond, bits 1/3/4 the bus cond
        fwd_packed = (
            contrib_work.astype(jnp.int8)
            | (susceptible.astype(jnp.int8) << 1)
            | (hit_home.astype(jnp.int8) << 2)
            | (on_bus.astype(jnp.int8) << 3)
            | ((status == STATUS_INFECTED).astype(jnp.int8) << 4)
        )
        work_pred_default = jnp.any(contrib_work)
        bus_pred_default = jnp.any(on_bus & (status == STATUS_INFECTED))

    # --- replicated-order twins (SimConfig.use_replicated_orders) ---------
    # Disease state is also carried in work order and rider order; the work
    # and bus branches then read their inputs natively instead of paying an
    # N-sized permutation sort, and only the per-step deltas (new
    # exposures, vaccinations) cross orders as K-bounded sparse scatters
    # (ops/sparse.py).  Trajectories are bitwise-identical to the classic
    # formulation: every draw stream is indexed by static order positions.
    rep = wants_replicated(world, cfg, state)
    sparse_apply = wants_sparse_apply(world, cfg, state)
    KS = cfg.sparse_transport_slots
    R = world.rider_perm.shape[0]
    # Build the rider-order schedule fallback ONCE here, at the top level
    # of the step (never inside a traced lax.cond branch): direct
    # fast_step callers that don't prebuild (scan.py does) would
    # otherwise re-pay the two N-sized gathers on every sortless bus
    # hour instead of letting XLA hoist them as loop-invariant operands.
    if rider_statics is None and (
        rep
        or (
            (
                wants_sortless_work(world, cfg, state)
                or wants_sortless_dense(world, cfg, state)
            )
            and R > 0
            and world.rpos is not None
            and world.rpos.shape[0] == n
        )
    ):
        rider_statics = make_rider_statics(world)
    if rep:
        from ..ops.sparse import compact_positions, scatter_bits

        status_ws1, timer_ws1 = _advance_disease(
            state.status_ws, jnp.asarray(state.timer_ws, jnp.int32), d
        )
        status_r1, timer_r1 = _advance_disease(
            state.status_r, jnp.asarray(state.timer_r, jnp.int32), d
        )
        ws_r, we_r = rider_statics
        # riders all use transport; only the on_bus bit matters for buses
        arm_r = (h24 == ws_r - 1) | (h24 == we_r - 1)
        on_bus_r1 = jnp.where(move, arm_r, state.on_bus_r)

        def _fan_out(mask):
            """Compact a citizen-order bit lane and scatter it into work
            order and rider order (dense permutation fallback past KS)."""
            pos, live, cnt = compact_positions(mask, KS)
            safe = jnp.minimum(pos, n - 1)
            ws_idx = jnp.take(world.wpos, safe)
            r_idx = jnp.take(world.rpos, safe)
            sp_ws = scatter_bits(n, ws_idx, live)
            sp_r = scatter_bits(R, r_idx, live)  # drop handles non-riders

            def dense(x):
                ws = permute_by_sort(
                    world.wpos, x.astype(jnp.int8), bits=1
                ).astype(bool)
                return ws, jnp.take(x, world.rider_perm)

            return jax.lax.cond(
                cnt > KS, dense, lambda x: (sp_ws, sp_r), mask
            )

        hh_ws, hh_r = jax.lax.cond(
            jnp.any(hit_home),
            _fan_out,
            lambda _: (jnp.zeros(n, bool), jnp.zeros(R, bool)),
            hit_home,
        )
        contrib_ws_bits = (
            ((status_ws1 == STATUS_INFECTED) & ~on_bus_ws & at_work_ws
             & world.ws_work_neq_home).astype(jnp.int8)
            | ((status_ws1 == STATUS_SUSCEPTIBLE).astype(jnp.int8) << 1)
            | (hh_ws.astype(jnp.int8) << 2)
        )

    # 5-7. work side, gated: infected are positioned at work buildings only
    #    during work hours (or frozen there by lockdown) — for the other
    #    ~16/24 steps the whole block (two permutation sorts + scans) is a
    #    no-op and lax.cond skips it.
    record_oa = cfg.record_exposures_per_oa and world.oa_lo.shape[0] > 0

    def work_side(fwd):
        # fwd: the merged gates lane (contrib_work | susceptible<<1 |
        # hit_home<<2 | on_bus<<3 | infected<<4), packed OUTSIDE the cond so
        # the work AND bus branches share one s8 operand instead of several
        # pred lanes (each lax.cond operand/result costs an N-sized buffer
        # copy).  Only bits 0-2 matter here; 3-4 ride the sort inertly.
        fwd_ws = permute_by_sort(world.wpos, fwd, bits=5)
        contrib_w_ws = (fwd_ws & 1).astype(jnp.int32)
        susc_ws = (fwd_ws & 2) != 0
        hit_home_ws = (fwd_ws & 4) != 0

        # work-order pressure + draw (building.rs:278-280 for workplaces;
        # school room confinement + whole-school n per building.rs:494-522 /
        # simulator.rs:307-308)
        n_w_ws, draws_ws = _work_pressure(world, contrib_w_ws)
        # schedule bits unpack INSIDE the branch (fused mode) so the lanes
        # never materialise on steps where the cond is skipped
        if use_fused:
            at_work_ws_l = (sched1 & 8) != 0
            on_bus_ws_l = (sched1 & 16) != 0
        else:
            at_work_ws_l, on_bus_ws_l = at_work_ws, on_bus_ws
        p_ws = _exposure_p(
            d.exposure_chance, d.mask_effectiveness, state.mask_status,
            world.ws_mask_compliant, on_bus_ws_l, cfg.reference_mask_semantics,
        )
        cur_oa_ws = jnp.where(at_work_ws_l, world.ws_work_oa, world.ws_home_oa)
        q_single = binomial_at_least_one(p_ws, trunc(n_w_ws))
        q_work_ws = jnp.where(
            (cur_oa_ws == world.ws_work_oa) & world.ws_work_neq_home,
            -jnp.expm1(draws_ws.astype(jnp.float32) * jnp.log1p(-q_single)),
            0.0,
        )
        # counter-hash uniforms: ~5x cheaper than a threefry pass at N=3.5M
        from ..ops.hashrng import hash_uniform

        u_w = hash_uniform(seed_w, jnp.arange(n, dtype=jnp.uint32))
        hit_work_ws = susc_ws & (u_w < q_work_ws)
        from_work_ws = hit_work_ws & ~hit_home_ws
        # per-OA attribution of work exposures, computed here so the cumsum
        # (an N-sized reduce-window) only runs when the branch is live and
        # the cond returns an (n_oa,) table instead of an (N,) lane
        if record_oa:
            oa_work = range_totals(from_work_ws, world.ws_oa_lo, world.ws_oa_hi)
        else:
            oa_work = jnp.zeros((0,), jnp.int32)

        # ship the work hit back to citizen order.  Default: K-bounded
        # compaction of the (few) hit slots + scatter through work_perm
        # (SimConfig.use_sparse_workback) instead of the backward u32
        # sort: hits per hour are typically tens-to-thousands.  The >K
        # fallback keeps the lane bitwise-identical at any hit count.
        swb = cfg.use_sparse_workback
        if swb is None:
            swb = True
        if swb:
            from ..ops.sparse import compact_positions, scatter_bits

            KB = max(1, min(cfg.workback_slots, n))
            pos_h, live_h, cnt_h = compact_positions(hit_work_ws, KB)
            cit_h = jnp.take(world.work_perm, jnp.minimum(pos_h, n - 1))
            sp_back = scatter_bits(
                n, jnp.minimum(cit_h, n - 1), live_h & (cit_h < n)
            )
            hit_work = jax.lax.cond(
                cnt_h > KB,
                lambda lane: permute_by_sort(
                    world.work_perm, lane.astype(jnp.int8), bits=1
                ).astype(bool),
                lambda _: sp_back,
                hit_work_ws,
            )
        else:
            hit_work = permute_by_sort(
                world.work_perm, hit_work_ws.astype(jnp.int8), bits=1
            ).astype(bool)
        return hit_work, oa_work

    def work_side_rep(packed):
        # packed (ws order, i8): contrib | susceptible<<1 | hit_home<<2 —
        # read straight off the work-order twin state; no forward sort.
        contrib_w_ws = (packed & 1).astype(jnp.int32)
        susc_ws = (packed & 2) != 0
        hit_home_ws = (packed & 4) != 0

        n_w_ws, draws_ws = _work_pressure(world, contrib_w_ws)
        p_ws = _exposure_p(
            d.exposure_chance, d.mask_effectiveness, state.mask_status,
            world.ws_mask_compliant, on_bus_ws, cfg.reference_mask_semantics,
        )
        cur_oa_ws = jnp.where(at_work_ws, world.ws_work_oa, world.ws_home_oa)
        q_single = binomial_at_least_one(p_ws, trunc(n_w_ws))
        q_work_ws = jnp.where(
            (cur_oa_ws == world.ws_work_oa) & world.ws_work_neq_home,
            -jnp.expm1(draws_ws.astype(jnp.float32) * jnp.log1p(-q_single)),
            0.0,
        )
        from ..ops.hashrng import hash_uniform
        from ..ops.sparse import compact_positions, scatter_bits

        u_w = hash_uniform(seed_w, jnp.arange(n, dtype=jnp.uint32))
        hit_work_ws = susc_ws & (u_w < q_work_ws)
        from_work_ws = hit_work_ws & ~hit_home_ws
        if record_oa:
            oa_work = range_totals(from_work_ws, world.ws_oa_lo, world.ws_oa_hi)
        else:
            oa_work = jnp.zeros((0,), jnp.int32)

        # fan the ws-order hits out to citizen and rider order
        pos, live, cnt = compact_positions(hit_work_ws, KS)
        cit_idx = jnp.take(world.work_perm, jnp.minimum(pos, n - 1))
        sp_cit = scatter_bits(n, cit_idx, live)
        sp_r = scatter_bits(R, jnp.take(world.rpos, cit_idx), live)

        def dense(ws_lane):
            cit = permute_by_sort(
                world.work_perm, ws_lane.astype(jnp.int8), bits=1
            ).astype(bool)
            return cit, jnp.take(cit, world.rider_perm)

        hit_work, hit_work_r = jax.lax.cond(
            cnt > KS, dense, lambda _: (sp_cit, sp_r), hit_work_ws
        )
        return hit_work, hit_work_r, hit_work_ws, oa_work

    def work_side_sparse(fwd):
        # Same pressure + draws as work_side (same RNG streams), but the
        # hits RETURN as the work-order mask + exact counts: the N-sized
        # backward permutation sort disappears, and the caller drains hit
        # positions apply_sparse_slots at a time (sparse apply, §9).
        fwd_ws = permute_by_sort(world.wpos, fwd, bits=5)
        contrib_w_ws = (fwd_ws & 1).astype(jnp.int32)
        susc_ws = (fwd_ws & 2) != 0
        hit_home_ws = (fwd_ws & 4) != 0

        n_w_ws, draws_ws = _work_pressure(world, contrib_w_ws)
        at_work_ws_l = (sched1 & 8) != 0
        on_bus_ws_l = (sched1 & 16) != 0
        p_ws = _exposure_p(
            d.exposure_chance, d.mask_effectiveness, state.mask_status,
            world.ws_mask_compliant, on_bus_ws_l, cfg.reference_mask_semantics,
        )
        cur_oa_ws = jnp.where(at_work_ws_l, world.ws_work_oa, world.ws_home_oa)
        q_single = binomial_at_least_one(p_ws, trunc(n_w_ws))
        q_work_ws = jnp.where(
            (cur_oa_ws == world.ws_work_oa) & world.ws_work_neq_home,
            -jnp.expm1(draws_ws.astype(jnp.float32) * jnp.log1p(-q_single)),
            0.0,
        )
        from ..ops.hashrng import hash_uniform

        u_w = hash_uniform(seed_w, jnp.arange(n, dtype=jnp.uint32))
        hit_work_ws = susc_ws & (u_w < q_work_ws)
        from_work_ws = hit_work_ws & ~hit_home_ws
        n_from_ws = jnp.sum(from_work_ws.astype(jnp.int32))
        if record_oa:
            # Work-OA counts, sparse like oa_home below: ws order groups
            # work-building OAs contiguously (schema.py::oa_ranges), so a
            # K-bounded compact + id-lane scatter-add equals the dense
            # range extraction bit-for-bit; dense only past K hits.
            k_oa_w = cfg.oa_sparse_slots
            if k_oa_w is None:
                k_oa_w = 8192 if n >= 16_000_000 else 0
            if k_oa_w > 0:
                from ..ops.sparse import compact_positions as _cp

                def oa_work_sparse(m):
                    pos, live, _ = _cp(m, k_oa_w)
                    ids = jnp.take(
                        world.ws_work_oa, jnp.minimum(pos, n - 1), mode="clip"
                    )
                    n_oa_w = world.ws_oa_lo.shape[0]
                    return (
                        jnp.zeros((n_oa_w,), jnp.int32)
                        .at[jnp.where(live, ids, n_oa_w)]
                        .add(1, mode="drop")
                    )

                oa_work = jax.lax.cond(
                    n_from_ws <= k_oa_w,
                    oa_work_sparse,
                    lambda m: range_totals(
                        m, world.ws_oa_lo, world.ws_oa_hi
                    ),
                    from_work_ws,
                )
            else:
                oa_work = range_totals(
                    from_work_ws, world.ws_oa_lo, world.ws_oa_hi
                )
        else:
            oa_work = jnp.zeros((0,), jnp.int32)
        return (
            hit_work_ws,
            jnp.sum(hit_work_ws.astype(jnp.int32)),
            n_from_ws,
            oa_work,
        )

    def work_side_sortless(fwd, dense_out: bool = False):
        # Sortless work branch.  Same pressure tables, hash streams and
        # hit set as work_side_sparse — but the forward N-sized u32
        # permutation sort is replaced by two K-bounded
        # scatter/compact drains: (a) the infected work-contributor bits
        # scatter into work order through the static ``wpos`` lane, and
        # (b) the post-draw candidates (``u < q`` — already the tiny
        # post-RNG set) compact back, with the susceptible / hit-home bits
        # gathered from the citizen-order gates lane at their
        # ``work_perm`` images.  Bitwise-identical to work_side_sparse and
        # exact at ANY count (the drains loop to the exact popcount); the
        # caller's switch routes contributor-heavy peak hours to the
        # sorted body instead because rounds eventually cost more than
        # one sort.  No lax.cond lives inside — a nested N-operand cond
        # costs a full-lane copy per step.
        from ..ops.sparse import block_hierarchy, compact_from_hierarchy

        K_SL = max(1, min(cfg.sortless_slots, n))
        contrib_mask = (fwd & 1) != 0
        # one full-lane block pass, shared by every drain round (XLA does
        # not hoist it out of the while body on its own).  block/sb=128
        # halves the per-slot hierarchy work.
        h_c = block_hierarchy(contrib_mask, block=128)
        n_oa_w = world.ws_oa_lo.shape[0] if record_oa else 0

        def c_round(c):
            done, lane = c
            pos, live, _ = compact_from_hierarchy(
                h_c, K_SL, offset=done, n=n, sb=128
            )
            wsi = jnp.take(world.wpos, jnp.minimum(pos, n - 1))
            lane = lane.at[jnp.where(live, wsi, n)].set(
                jnp.int8(1), mode="drop"
            )
            return done + jnp.sum(live.astype(jnp.int32)), lane

        _, contrib_ws8 = jax.lax.while_loop(
            lambda c: c[0] < h_c[2],
            c_round,
            (jnp.int32(0), jnp.zeros((n,), jnp.int8)),
        )
        contrib_w_ws = contrib_ws8.astype(jnp.int32)

        n_w_ws, draws_ws = _work_pressure(world, contrib_w_ws)
        at_work_ws_l = (sched1 & 8) != 0
        on_bus_ws_l = (sched1 & 16) != 0
        p_ws = _exposure_p(
            d.exposure_chance, d.mask_effectiveness, state.mask_status,
            world.ws_mask_compliant, on_bus_ws_l,
            cfg.reference_mask_semantics,
        )
        cur_oa_ws = jnp.where(
            at_work_ws_l, world.ws_work_oa, world.ws_home_oa
        )
        q_single = binomial_at_least_one(p_ws, trunc(n_w_ws))
        q_work_ws = jnp.where(
            (cur_oa_ws == world.ws_work_oa) & world.ws_work_neq_home,
            -jnp.expm1(
                draws_ws.astype(jnp.float32) * jnp.log1p(-q_single)
            ),
            0.0,
        )
        from ..ops.hashrng import hash_uniform

        u_w = hash_uniform(seed_w, jnp.arange(n, dtype=jnp.uint32))
        cand = u_w < q_work_ws
        h_cand = block_hierarchy(cand, block=128)

        def h_round(c):
            done, lane, cw, nw, oa = c
            pos, live, _ = compact_from_hierarchy(
                h_cand, K_SL, offset=done, n=n, sb=128
            )
            posw = jnp.minimum(pos, n - 1)
            cit = jnp.take(world.work_perm, posw)
            fbits = jnp.take(fwd, cit)
            hitk = ((fbits & 2) != 0) & live
            fw = hitk & ((fbits & 4) == 0)
            # dense_out: scatter hits straight to CITIZEN order (the
            # dense apply consumes an (n,) citizen lane, so the ws-order
            # lane + work-back conversion is skipped entirely)
            lane = lane.at[
                jnp.where(hitk, cit if dense_out else pos, n)
            ].set(True, mode="drop")
            cw = cw + jnp.sum(hitk.astype(jnp.int32))
            nw = nw + jnp.sum(fw.astype(jnp.int32))
            if record_oa:
                ids = jnp.take(world.ws_work_oa, posw, mode="clip")
                oa = oa.at[jnp.where(fw, ids, n_oa_w)].add(1, mode="drop")
            return done + jnp.sum(live.astype(jnp.int32)), lane, cw, nw, oa

        _, hit_lane, cnt_w, n_from, oa_work = jax.lax.while_loop(
            lambda c: c[0] < h_cand[2],
            h_round,
            (
                jnp.int32(0),
                jnp.zeros((n,), bool),
                jnp.int32(0),
                jnp.int32(0),
                jnp.zeros((n_oa_w,), jnp.int32),
            ),
        )
        if not record_oa:
            oa_work = jnp.zeros((0,), jnp.int32)
        return hit_lane, cnt_w, n_from, oa_work

    work_pred = (
        work_pred_default
        if gate_overrides is None or gate_overrides[0] is None
        else gate_overrides[0]
    )
    n_oa_out = world.oa_lo.shape[0] if record_oa else 0
    if rep:
        hit_work, hit_work_r, hit_work_ws_lane, oa_work = jax.lax.cond(
            work_pred,
            work_side_rep,
            lambda _: (
                jnp.zeros((n,), bool),
                jnp.zeros((R,), bool),
                jnp.zeros((n,), bool),
                jnp.zeros((n_oa_out,), jnp.int32),
            ),
            contrib_ws_bits,
        )
    elif sparse_apply:

        def _work_zeros(fwd):
            return (
                jnp.zeros((n,), bool),
                jnp.int32(0),
                jnp.int32(0),
                jnp.zeros((n_oa_out,), jnp.int32),
            )

        if wants_sortless_work(world, cfg, state):
            # One switch, predicates all from already-materialised scalars
            # (partials[:, 5] is the exact contributor count in fused
            # mode) — nested N-operand conds each cost a full-lane copy
            # per step, so the sorted-fallback decision must NOT live
            # inside the branch.  sparse_apply requires the fused citizen
            # phase (wants_sparse_apply), so its counts are always
            # available here.
            assert use_fused
            tot_c_free = jnp.sum(partials[:, 5])
            bound_w = max(1, min(cfg.sortless_slots, n)) * sortless_rounds(
                n, cfg
            )
            sel_w = jnp.where(
                work_pred,
                jnp.where(tot_c_free > bound_w, 1, 2),
                0,
            ).astype(jnp.int32)
            hit_ws_lane, cnt_w, n_work_new, oa_work = jax.lax.switch(
                sel_w,
                [_work_zeros, work_side_sparse, work_side_sortless],
                fwd_packed,
            )
        else:
            hit_ws_lane, cnt_w, n_work_new, oa_work = jax.lax.cond(
                work_pred,
                work_side_sparse,
                _work_zeros,
                fwd_packed,
            )
    else:

        def _work_zeros_d(fwd):
            return (
                jnp.zeros((n,), bool),
                jnp.zeros((n_oa_out,), jnp.int32),
            )

        if wants_sortless_dense(world, cfg, state):
            # Same dispatch shape as the sparse path's sortless switch:
            # contributor-light hours run the drains (no forward sort),
            # heavy hours route to the sorted body; predicates come from
            # the citizen-phase counts so no N-lane work precedes the
            # switch.
            assert use_fused

            def work_side_sortless_d(fwd):
                lane, _cnt, _nf, oa = work_side_sortless(
                    fwd, dense_out=True
                )
                return lane, oa

            tot_c_free_d = jnp.sum(partials[:, 5])
            bound_wd = max(1, min(cfg.sortless_slots, n)) * sortless_rounds(
                n, cfg
            )
            sel_wd = jnp.where(
                work_pred,
                jnp.where(tot_c_free_d > bound_wd, 1, 2),
                0,
            ).astype(jnp.int32)
            hit_work, oa_work = jax.lax.switch(
                sel_wd,
                [_work_zeros_d, work_side, work_side_sortless_d],
                fwd_packed,
            )
        else:
            hit_work, oa_work = jax.lax.cond(
                work_pred,
                work_side,
                _work_zeros_d,
                fwd_packed,
            )

    # 8. bus side (rider-compacted; simulator.rs:360-401).  One packed key
    #    sort on the static rider-compaction rank moves (on_bus, infected,
    #    susceptible) into rider order (gather fallback for worlds cached
    #    before the rpos lane existed); the rest is gather-free
    #    (ops/segments.py::bus_hits): bits ride the shuffle sort, per-bus
    #    counts are run totals, and only the few successful hits scatter
    #    back.
    def p_fn(compliant, on_bus_lane):
        return _exposure_p(
            d.exposure_chance, d.mask_effectiveness, state.mask_status,
            compliant, on_bus_lane, cfg.reference_mask_semantics,
        )

    def bus_branch(packed):
        # packed = the merged gates lane: on_bus bit 3, infected bit 4,
        # susceptible bit 1
        rp = world.rider_perm
        if world.rpos is not None and world.rpos.shape[0] == n:
            pk = permute_by_sort(world.rpos, packed, bits=5)[: rp.shape[0]]
        else:
            pk = jnp.take(packed, rp)

        return bus_hits(
            k_bus, k_b,
            (pk & 8) != 0, (pk & 16) != 0, (pk & 2) != 0,
            world.rider_mask_compliant,
            world.rider_route, rp, cfg.bus_capacity, p_fn, n,
        )[0]

    bus_pred = (
        bus_pred_default
        if gate_overrides is None or gate_overrides[1] is None
        else gate_overrides[1]
    )
    if rep:
        # Rider-order bits come straight off the rider twin — the N-sized
        # rider-compaction sort disappears from bus hours entirely.
        k_top = min(16384, R)

        def bus_branch_rep(packed_r):
            return bus_hits(
                k_bus, k_b,
                (packed_r & 1) != 0, (packed_r & 2) != 0, (packed_r & 4) != 0,
                world.rider_mask_compliant,
                world.rider_route, world.rider_perm, cfg.bus_capacity,
                p_fn, n,
            )

        packed_r = (
            on_bus_r1.astype(jnp.int8)
            | ((status_r1 == STATUS_INFECTED).astype(jnp.int8) << 1)
            | ((status_r1 == STATUS_SUSCEPTIBLE).astype(jnp.int8) << 2)
        )
        (hit_bus, hit_bus_r, bus_rider_ids, bus_live, n_bus_hits,
         _bus_cit_ids) = jax.lax.cond(
            bus_pred,
            bus_branch_rep,
            lambda _: (
                jnp.zeros((n,), bool),
                jnp.zeros((R,), bool),
                jnp.zeros((k_top,), jnp.int32),
                jnp.zeros((k_top,), bool),
                jnp.int32(0),
                jnp.zeros((k_top,), jnp.int32),
            ),
            packed_r,
        )
        # bus hits into work order: via the compacted rider slots, dense
        # permutation fallback on overflow
        from ..ops.sparse import scatter_bits as _scatter_bits

        cit_ids_b = jnp.take(
            world.rider_perm, jnp.minimum(bus_rider_ids, max(R - 1, 0)),
            mode="clip",
        )
        sp_ws_b = _scatter_bits(n, jnp.take(world.wpos, cit_ids_b), bus_live)
        hit_bus_ws = jax.lax.cond(
            n_bus_hits > k_top,
            lambda lane: permute_by_sort(
                world.wpos, lane.astype(jnp.int8), bits=1
            ).astype(bool),
            lambda _: sp_ws_b,
            hit_bus,
        )
    elif sparse_apply:
        k_bt = (
            min(16384, R)
            if cfg.debug_bus_hit_slots is None
            else max(1, min(cfg.debug_bus_hit_slots, R))
        )

        def bus_branch_sparse(packed):
            rp = world.rider_perm
            if world.rpos is not None and world.rpos.shape[0] == n:
                pk = permute_by_sort(world.rpos, packed, bits=5)[: rp.shape[0]]
            else:
                pk = jnp.take(packed, rp)
            _, rider_lane, _, live, n_hits, cit_ids = bus_hits(
                k_bus, k_b,
                (pk & 8) != 0, (pk & 16) != 0, (pk & 2) != 0,
                world.rider_mask_compliant,
                world.rider_route, rp, cfg.bus_capacity, p_fn, n,
                max_hits=k_bt, want_cit_lane=False,
            )
            return rider_lane, cit_ids, live, n_hits

        sortless_bus = (
            wants_sortless_work(world, cfg, state)
            and R > 0
            and world.rpos is not None
            and world.rpos.shape[0] == n
        )

        def _bus_zeros(packed):
            return (
                jnp.zeros((R,), bool),
                jnp.zeros((k_bt,), jnp.int32),
                jnp.zeros((k_bt,), bool),
                jnp.int32(0),
            )

        if sortless_bus:
            ws_r_sl, we_r_sl = rider_statics

            def bus_branch_sl(packed):
                # Sortless bus transport (same lever as the sortless work
                # branch): on moving hours the rider-order inputs need no
                # citizen->rider permutation sort — on_bus comes from the
                # static rider schedule (== the replicated engine's arm_r,
                # bitwise-tested), the few infected riders scatter through
                # rpos (exact drain), and susceptibility gates the
                # compacted post-draw candidates.  The caller's switch
                # keeps frozen (lockdown) hours and infected-heavy peaks
                # on the sorted branch; only the (astronomically rare)
                # candidate-compaction overflow pays the inner fallback
                # cond.
                from ..ops.segments import bus_hits_sortless
                from ..ops.sparse import (
                    block_hierarchy, compact_from_hierarchy,
                )

                K_SL = max(1, min(cfg.sortless_slots, n))
                inf_onbus = (packed & 24) == 24
                h_ib = block_hierarchy(inf_onbus, block=128)

                def i_round(c):
                    done, lane = c
                    pos, live, _ = compact_from_hierarchy(
                        h_ib, K_SL, offset=done, n=n, sb=128
                    )
                    r_idx = jnp.take(
                        world.rpos, jnp.minimum(pos, n - 1)
                    )
                    lane = lane.at[jnp.where(live, r_idx, R)].set(
                        True, mode="drop"
                    )
                    return done + jnp.sum(live.astype(jnp.int32)), lane

                _, rb_inf = jax.lax.while_loop(
                    lambda c: c[0] < h_ib[2],
                    i_round,
                    (jnp.int32(0), jnp.zeros((R,), bool)),
                )
                arm_r = (h24 == ws_r_sl - 1) | (h24 == we_r_sl - 1)

                def susc_of_rider(rider_ids):
                    cit = jnp.take(
                        world.rider_perm,
                        jnp.minimum(rider_ids, max(R - 1, 0)),
                        mode="clip",
                    )
                    return (jnp.take(packed, cit) & 2) != 0

                rider_lane, _, live, n_hits, cit_ids, cand_total = (
                    bus_hits_sortless(
                        k_bus, k_b, arm_r, rb_inf,
                        world.rider_mask_compliant,
                        world.rider_route, world.rider_perm,
                        cfg.bus_capacity, p_fn, susc_of_rider,
                        max_hits=k_bt,
                    )
                )
                return jax.lax.cond(
                    cand_total <= k_bt,
                    lambda _: (rider_lane, cit_ids, live, n_hits),
                    bus_branch_sparse,
                    packed,
                )

            # tot_ib (infected riders on a bus) is free from the
            # citizen-phase counts; the switch predicate costs no N-lane
            # work.  sortless_bus implies sparse_apply implies the fused
            # citizen phase.
            assert use_fused
            tot_ib = jnp.sum(partials[:, 6])
            bound_b = max(1, min(cfg.sortless_slots, n)) * sortless_rounds(
                n, cfg
            )
            sel_b = jnp.where(
                bus_pred,
                jnp.where(move & (tot_ib <= bound_b), 2, 1),
                0,
            ).astype(jnp.int32)
            bus_rider_hit_lane, bus_cit_ids, bus_live, n_bus_hits = (
                jax.lax.switch(
                    sel_b,
                    [_bus_zeros, bus_branch_sparse, bus_branch_sl],
                    fwd_packed,
                )
            )
        else:
            bus_rider_hit_lane, bus_cit_ids, bus_live, n_bus_hits = (
                jax.lax.cond(
                    bus_pred,
                    bus_branch_sparse,
                    _bus_zeros,
                    fwd_packed,
                )
            )
    else:
        sortless_bus_d = (
            wants_sortless_dense(world, cfg, state)
            and R > 0
            and world.rpos is not None
            and world.rpos.shape[0] == n
            and rider_statics is not None
        )
        if sortless_bus_d:
            # Dense twin of the sparse path's sortless bus branch: skip
            # the citizen->rider permutation sort on moving hours (on_bus
            # from the static rider schedule; the few infected riders
            # scatter through rpos; susceptibility gates the compacted
            # post-draw candidates) and scatter the hit citizen ids
            # straight into the (n,) lane.  Bitwise the sorted branch's
            # hit set; candidate overflow falls back to it.
            assert use_fused
            ws_r_d, we_r_d = rider_statics
            k_bt_d = (
                min(16384, R)
                if cfg.debug_bus_hit_slots is None
                else max(1, min(cfg.debug_bus_hit_slots, R))
            )

            def bus_branch_sl_dense(packed):
                from ..ops.segments import bus_hits_sortless
                from ..ops.sparse import (
                    block_hierarchy, compact_from_hierarchy,
                )

                K_SL = max(1, min(cfg.sortless_slots, n))
                inf_onbus = (packed & 24) == 24
                h_ib = block_hierarchy(inf_onbus, block=128)

                def i_round(c):
                    done, lane = c
                    pos, live, _ = compact_from_hierarchy(
                        h_ib, K_SL, offset=done, n=n, sb=128
                    )
                    r_idx = jnp.take(
                        world.rpos, jnp.minimum(pos, n - 1)
                    )
                    lane = lane.at[jnp.where(live, r_idx, R)].set(
                        True, mode="drop"
                    )
                    return done + jnp.sum(live.astype(jnp.int32)), lane

                _, rb_inf = jax.lax.while_loop(
                    lambda c: c[0] < h_ib[2],
                    i_round,
                    (jnp.int32(0), jnp.zeros((R,), bool)),
                )
                arm_r = (h24 == ws_r_d - 1) | (h24 == we_r_d - 1)

                def susc_of_rider(rider_ids):
                    cit = jnp.take(
                        world.rider_perm,
                        jnp.minimum(rider_ids, max(R - 1, 0)),
                        mode="clip",
                    )
                    return (jnp.take(packed, cit) & 2) != 0

                _, _, live, _, cit_ids, cand_total = bus_hits_sortless(
                    k_bus, k_b, arm_r, rb_inf,
                    world.rider_mask_compliant,
                    world.rider_route, world.rider_perm,
                    cfg.bus_capacity, p_fn, susc_of_rider,
                    max_hits=k_bt_d,
                )
                lane = (
                    jnp.zeros((n,), bool)
                    .at[jnp.where(live, cit_ids, n)]
                    .set(True, mode="drop")
                )
                return jax.lax.cond(
                    cand_total <= k_bt_d,
                    lambda _: lane,
                    bus_branch,
                    packed,
                )

            assert use_fused
            tot_ib_d = jnp.sum(partials[:, 6])
            bound_bd = max(1, min(cfg.sortless_slots, n)) * sortless_rounds(
                n, cfg
            )
            sel_bd = jnp.where(
                bus_pred,
                jnp.where(move & (tot_ib_d <= bound_bd), 2, 1),
                0,
            ).astype(jnp.int32)
            hit_bus = jax.lax.switch(
                sel_bd,
                [
                    lambda _: jnp.zeros((n,), bool),
                    bus_branch,
                    bus_branch_sl_dense,
                ],
                fwd_packed,
            )
        else:
            hit_bus = jax.lax.cond(
                bus_pred, bus_branch, lambda _: jnp.zeros((n,), bool),
                fwd_packed,
            )

    # 9. combine + bookkeeping (statistics.rs:181-195, 275-287)
    if sparse_apply:
        # §9-sparse: the citizen phase already applied this step's home
        # hits; the
        # gated work/bus hits (zero on most hours, a handful at peaks) are
        # drained as K-bounded scatter rounds — no N-wide select chains, no
        # dense citizen-order hit lanes, exact at any hit count (the while
        # loops take a second round only past apply_sparse_slots hits).
        # Same value semantics as the dense branch below, bitwise.
        from ..ops.sparse import compact_positions

        K_AP = max(1, min(cfg.apply_sparse_slots, n))

        def _scatter(lane, idx, live, value):
            return lane.at[jnp.where(live, idx, lane.shape[0])].set(
                value, mode="drop"
            )

        eligible = state.eligible
        if not cfg.faithful_vaccine_bugs:
            eligible = eligible & ~hit_home

        def w_round(c):
            done, st, tm, el = c
            pos_ws, live, _ = compact_positions(
                hit_ws_lane, K_AP, offset=done
            )
            cit = jnp.take(world.work_perm, jnp.minimum(pos_ws, n - 1))
            st = _scatter(st, cit, live, STATUS_EXPOSED)
            tm = _scatter(tm, cit, live, 0)
            if not cfg.faithful_vaccine_bugs:
                el = _scatter(el, cit, live, False)
            return (done + jnp.sum(live.astype(jnp.int32)), st, tm, el)

        _, status, timer, eligible = jax.lax.while_loop(
            lambda c: c[0] < cnt_w, w_round,
            (jnp.int32(0), status, timer, eligible),
        )

        # Bus hits: the first k_bt arrive pre-compacted (ascending rider
        # slot); overflow rounds continue at the same rank order off the
        # exact rider-order lane.  from_bus flags (simulator.rs:447-449)
        # come from K-bounded gathers: hit_home is bit 2 of fwd_packed,
        # work membership reads the work-order hit mask through wpos.
        def _bus_flags(cit, live):
            home_b = (jnp.take(fwd_packed, cit) & 4) != 0
            work_b = jnp.take(
                hit_ws_lane, jnp.minimum(jnp.take(world.wpos, cit), n - 1)
            )
            return live & ~home_b & ~work_b

        safe_cit = jnp.minimum(bus_cit_ids, n - 1)
        fb = _bus_flags(safe_cit, bus_live)
        n_bus_new = jnp.sum(fb.astype(jnp.int32))
        status = _scatter(status, safe_cit, bus_live, STATUS_EXPOSED)
        timer = _scatter(timer, safe_cit, bus_live, 0)
        eligible = _scatter(
            eligible, safe_cit,
            fb if cfg.faithful_vaccine_bugs else bus_live, False,
        )
        if R > 0:

            def b_round(c):
                done, st, tm, el, nb = c
                pos_r, live, _ = compact_positions(
                    bus_rider_hit_lane, K_AP, offset=done
                )
                cit = jnp.minimum(
                    jnp.take(world.rider_perm, jnp.minimum(pos_r, R - 1)),
                    n - 1,
                )
                fbr = _bus_flags(cit, live)
                st = _scatter(st, cit, live, STATUS_EXPOSED)
                tm = _scatter(tm, cit, live, 0)
                el = _scatter(
                    el, cit,
                    fbr if cfg.faithful_vaccine_bugs else live, False,
                )
                return (
                    done + jnp.sum(live.astype(jnp.int32)),
                    st, tm, el, nb + jnp.sum(fbr.astype(jnp.int32)),
                )

            _, status, timer, eligible, n_bus_new = jax.lax.while_loop(
                lambda c: c[0] < n_bus_hits, b_round,
                (jnp.minimum(n_bus_hits, jnp.int32(k_bt)), status, timer,
                 eligible, n_bus_new),
            )
        n_new = n_home + n_work_new + n_bus_new
        n_bus_exp = n_bus_new
    else:
        newly_exposed = hit_home | hit_work | hit_bus
        status = jnp.where(newly_exposed, jnp.int8(STATUS_EXPOSED), status)
        timer = jnp.where(newly_exposed, 0, timer)
        if rep:
            newly_ws = hh_ws | hit_work_ws_lane | hit_bus_ws
            status_ws1 = jnp.where(newly_ws, jnp.int8(STATUS_EXPOSED), status_ws1)
            timer_ws1 = jnp.where(newly_ws, 0, timer_ws1)
            newly_r = hh_r | hit_work_r | hit_bus_r
            status_r1 = jnp.where(newly_r, jnp.int8(STATUS_EXPOSED), status_r1)
            timer_r1 = jnp.where(newly_r, 0, timer_r1)
        from_bus = hit_bus & ~hit_home & ~hit_work
        if cfg.faithful_vaccine_bugs:
            eligible = state.eligible & ~from_bus
        else:
            eligible = state.eligible & ~newly_exposed

        n_new = jnp.sum(newly_exposed.astype(jnp.int32))
        n_bus_exp = jnp.sum(from_bus.astype(jnp.int32))
    if record_oa:
        # Sparse path: most hours expose far fewer citizens than K, so the
        # per-OA home counts come from compacting the hit positions
        # (ops/sparse.py::compact_positions — no N-sized cumsum) + a
        # K-bounded scatter-add; the dense range-totals extraction
        # (cumsum + OA-sized gathers) only runs on peak hours.  Identical counts either way (OA-major order).
        n_oa_rec = world.oa_lo.shape[0]
        K_OA = cfg.oa_sparse_slots
        if K_OA is None:
            K_OA = 8192 if n >= 16_000_000 else 0

        def oa_sparse(hit):
            from ..ops.sparse import compact_positions

            pos, live, _ = compact_positions(hit, K_OA)
            ids = jnp.take(
                world.home_oa, jnp.minimum(pos, n - 1), mode="clip"
            )
            return (
                jnp.zeros((n_oa_rec,), jnp.int32)
                .at[jnp.where(live, ids, n_oa_rec)]
                .add(1, mode="drop")
            )

        if K_OA < 0:
            # debug only: sparse with no cond (truncates past |K_OA| hits)
            K_OA = -K_OA
            oa_home = oa_sparse(hit_home)
        elif K_OA > 0:
            oa_home = jax.lax.cond(
                (n_home if use_fused else jnp.sum(hit_home.astype(jnp.int32)))
                <= K_OA,
                oa_sparse,
                lambda hit: range_totals(hit, world.oa_lo, world.oa_hi),
                hit_home,
            )
        else:
            oa_home = range_totals(hit_home, world.oa_lo, world.oa_hi)
        exposures_per_oa = oa_home + oa_work
    elif cfg.record_exposures_per_oa:
        counted = hit_home | (hit_work & ~hit_home)
        oa_attr = jnp.where(hit_home, world.home_oa, world.work_oa)
        exposures_per_oa = jax.ops.segment_sum(
            counted.astype(jnp.int32),
            jnp.where(counted, oa_attr, world.n_output_areas),
            num_segments=world.n_output_areas + 1,
        )[: world.n_output_areas]
    else:
        exposures_per_oa = jnp.zeros((0,), jnp.int32)

    seirv = seirv0.at[STATUS_SUSCEPTIBLE].add(-n_new).at[STATUS_EXPOSED].add(n_new)

    # 10. interventions (interventions.rs:110-184)
    total = jnp.sum(seirv).astype(jnp.float32)
    pct = seirv[STATUS_INFECTED].astype(jnp.float32) / total
    lockdown = (th.lockdown >= 0) & (th.lockdown < pct)
    newly_started = (
        ~state.vaccination_started & (th.vaccination >= 0) & (th.vaccination < pct)
    )
    vaccination_started = state.vaccination_started | newly_started
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

    # 11. vaccination: exact-k uniform selection (simulator.rs:524-553;
    #     pool quirks per SimConfig.faithful_vaccine_bugs).  Two selectors:
    #     the default draws a fresh hash-score threshold per step; the
    #     fixed-priority mode (SimConfig.vaccination_fixed_priority) ranks
    #     citizens ONCE by a per-run priority at activation and takes the k
    #     lowest-priority pool members — same joint distribution (iid
    #     priorities + priority-independent prunes keep survivor ranks
    #     uniform), one K-bounded compaction instead of a pool-wide search.
    fixed_pri = (
        wants_fixed_priority_vax(world, cfg)
        and state.vax_pool is not None
        and state.vax_pool.shape[0] == n
    )
    if fixed_pri:
        # Compacted candidate pool: eligible citizen ids form the prefix
        # (one device sort).  Built at activation; rebuilt when the live
        # pool halves (stale entries are rejected at draw time against the
        # live `eligible` lane, so correctness never depends on freshness).
        n_elig_now = jnp.sum(eligible.astype(jnp.int32))

        def _rebuild(_):
            iota = jnp.arange(n, dtype=jnp.int32)
            _, pool = jax.lax.sort(
                ((~eligible).astype(jnp.int8), iota),
                num_keys=1, is_stable=True,
            )
            return pool, n_elig_now

        need_rebuild = newly_started | (
            vaccination_started & (n_elig_now * 2 < state.vax_pool_size)
        )
        vax_pool, vax_pool_size = jax.lax.cond(
            need_rebuild,
            _rebuild,
            lambda _: (state.vax_pool, state.vax_pool_size),
            None,
        )
    else:
        vax_pool, vax_pool_size = state.vax_pool, state.vax_pool_size

    def vaccinate(args):
        status, eligible = args[0], args[1]
        from ..ops.hashrng import hash_bits
        from ..ops.select import kth_threshold

        n_elig = jnp.sum(eligible.astype(jnp.int32))
        k = jnp.minimum(jnp.asarray(d.vaccination_rate, jnp.int32), n_elig)

        def fresh_threshold(seed_vax):
            # default selector: exact-k via the k-th smallest fresh hash
            # score over the pool (seed derived OUTSIDE the cond — see the
            # scalar-chain note at the top of fast_step)
            scores = hash_bits(seed_vax, jnp.arange(n, dtype=jnp.uint32))
            tau = kth_threshold(
                seed_vax, eligible, k, n_elig
            )
            below = eligible & (scores < tau)
            at = eligible & (scores == tau)
            allowed = k - jnp.sum(below.astype(jnp.int32))

            def tiebreak(at_lane):
                # multiple eligible scores equal tau (p ~ pool/2^32 per
                # step): exact-k needs their cumulative ranks
                at_rank = jnp.cumsum(at_lane.astype(jnp.int32))
                return at_lane & (at_rank <= allowed)

            take_at = jax.lax.cond(
                jnp.sum(at.astype(jnp.int32)) > allowed,
                tiebreak,
                lambda at_lane: at_lane,
                at,
            )
            return below | take_at

        # negative = all pieces real (-1 conditional, -2 unconditional)
        parts = -1 if cfg.debug_vax_parts < 0 else cfg.debug_vax_parts
        if not parts & 1:
            # debug only: fake selector, one fixed-threshold compare
            from ..ops.hashrng import hash_bits as _hb

            chosen = eligible & (
                _hb(seed_vax0, jnp.arange(n, dtype=jnp.uint32))
                < jnp.uint32(0x00200000)
            )
        elif fixed_pri:
            # rejection-sampled uniform k-subset: draw D candidate slots,
            # reject stale pool entries against the live eligible lane,
            # keep the first k distinct (in draw order — a uniform
            # k-subset); fall back to the threshold selector if the draws
            # come up short (also uniform, so the law is unchanged)
            from ..ops.sparse import scatter_bits as _sbits

            D = 8192
            u = jax.random.bits(k_vax, (D,), jnp.uint32)
            size_u = jnp.maximum(vax_pool_size, 1).astype(jnp.uint32)
            rem = (jnp.uint32(0) - size_u) % size_u  # 2^32 mod size
            accept = u >= rem  # Lemire rejection: slots exactly uniform
            slot = (u % size_u).astype(jnp.int32)
            members = jnp.take(
                vax_pool, jnp.minimum(slot, n - 1), mode="clip"
            )
            alive = (
                accept
                & (slot < vax_pool_size)
                & jnp.take(eligible, members)
            )
            seq = jnp.arange(D, dtype=jnp.int32)
            mkey = jnp.where(alive, members, n)
            sk, ss = jax.lax.sort((mkey, seq), num_keys=2)
            first = (sk < n) & (
                (seq == 0) | (sk != jnp.roll(sk, 1))
            )
            n_distinct = jnp.sum(first.astype(jnp.int32))
            cand_seq = jnp.where(first, ss, jnp.int32(2**30))
            order = jnp.sort(cand_seq)
            kth_seq = order[jnp.clip(k - 1, 0, D - 1)]
            sel = first & (ss <= kth_seq) & (k >= 1)
            sampled = _sbits(n, jnp.where(sel, sk, n), sel)
            chosen = jax.lax.cond(
                n_distinct >= k,
                lambda _: sampled,
                lambda _: fresh_threshold(seed_vax1),
                None,
            )
        else:
            chosen = fresh_threshold(seed_vax0)

        def apply(chosen_lane, status_lane):
            new = jnp.where(
                chosen_lane, jnp.int8(STATUS_VACCINATED), status_lane
            )
            if not cfg.faithful_vaccine_bugs:
                new = jnp.where(
                    chosen_lane & (status_lane != STATUS_SUSCEPTIBLE),
                    status_lane, new,
                )
            return new

        if parts & 2:
            new_status = apply(chosen, status)
            if not cfg.faithful_vaccine_bugs:
                eligible = eligible & ~chosen
        else:
            new_status = status
        n_vax_now = jnp.sum(chosen.astype(jnp.int32))
        if not rep:
            return new_status, eligible, n_vax_now

        if not parts & 4:
            return new_status, eligible, args[2], args[3], n_vax_now

        from ..ops.sparse import compact_positions, scatter_bits

        pos, live, cnt = compact_positions(chosen, KS)
        safe = jnp.minimum(pos, n - 1)
        sp_ws = scatter_bits(n, jnp.take(world.wpos, safe), live)
        sp_r = scatter_bits(R, jnp.take(world.rpos, safe), live)

        def dense(x):
            ws = permute_by_sort(
                world.wpos, x.astype(jnp.int8), bits=1
            ).astype(bool)
            return ws, jnp.take(x, world.rider_perm)

        chosen_ws, chosen_r = jax.lax.cond(
            cnt > KS, dense, lambda x: (sp_ws, sp_r), chosen
        )
        st_ws = apply(chosen_ws, args[2])
        st_r = apply(chosen_r, args[3])
        return new_status, eligible, st_ws, st_r, n_vax_now

    if cfg.debug_vax_parts == -2:
        # debug only: unconditional vaccinate (no lax.cond).  Semantics are
        # preserved because pre-activation the eligible lane is all-false,
        # so k = min(rate, 0) = 0 selects nobody.
        if rep:
            status, eligible, status_ws1, status_r1, n_vax = vaccinate(
                (status, eligible, status_ws1, status_r1)
            )
        else:
            status, eligible, n_vax = vaccinate((status, eligible))
    elif rep:
        status, eligible, status_ws1, status_r1, n_vax = jax.lax.cond(
            vaccination_started,
            vaccinate,
            lambda args: (
                args[0], args[1], args[2], args[3], jnp.int32(0),
            ),
            (status, eligible, status_ws1, status_r1),
        )
    else:
        status, eligible, n_vax = jax.lax.cond(
            vaccination_started,
            vaccinate,
            lambda args: (args[0], args[1], jnp.int32(0)),
            (status, eligible),
        )

    if use_fused and packed_carry:
        _e = jnp.zeros((0,), jnp.bool_)
        sched_lanes = dict(
            at_work=_e, on_bus=_e, bus_to_work=_e,
            at_work_ws=_e, on_bus_ws=_e, sched=sched1,
        )
    else:
        sched_lanes = dict(
            at_work=at_work, on_bus=on_bus, bus_to_work=bus_to_work,
            at_work_ws=at_work_ws, on_bus_ws=on_bus_ws,
            sched=jnp.zeros((0,), jnp.int8),
        )
    new_state = SimState(
        status=status,
        timer=timer.astype(TIMER_DTYPE),
        eligible=eligible,
        **sched_lanes,
        status_ws=status_ws1 if rep else state.status_ws,
        timer_ws=timer_ws1.astype(TIMER_TWIN_DTYPE) if rep else state.timer_ws,
        status_r=status_r1 if rep else state.status_r,
        timer_r=timer_r1.astype(TIMER_TWIN_DTYPE) if rep else state.timer_r,
        on_bus_r=on_bus_r1 if rep else state.on_bus_r,
        vax_pool=vax_pool if fixed_pri else state.vax_pool,
        vax_pool_size=vax_pool_size if fixed_pri else state.vax_pool_size,
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
