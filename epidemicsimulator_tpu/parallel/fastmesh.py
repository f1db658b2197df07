"""Sharded fast path: the gather-free step formulation over a device mesh.

Pairs with :mod:`.partition` (household-aligned shards + static ghost work
slots).  Communication per step, over the devices' interconnect:

* one ``all_to_all`` of packed int8 ghost bits out (6 bits per cross-shard
  worker) and one back (1 hit bit) — the only agent-level exchange;
* ``psum`` of the SEIRV census, exposure counters and per-OA tables;
* ``all_gather`` of per-shard scalar counts for exact global-k vaccination.

Home (household window) and bus mixing are fully shard-local by
construction.  This is the mesh analog of the reference's cross-OA
migration merge (simulator.rs:218-257), reduced to a few static bits.

The per-shard step runs the SAME engine as the single-device fast path
(the reference's parallel path runs its fastest engine too,
simulator.rs:94-96): the fused citizen phase per shard (timers,
movement, census counts, household window, home draw in one pass —
ops/citizen.py, hashing global citizen ids via the gid0 offset so
streams stay bitwise-identical to single-device), run totals on the work
slots, lax.cond gating of the work/bus sides on psum'd pressure
predicates (value-identical no-ops when zero), and the K-bounded sparse
hit return (slot -> local citizen via the static unsort table) instead
of a second full-length permutation sort.  The unfused branch
(use_fused_citizen=False) is bitwise-identical (tests/test_fastmesh.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import use_fused_citizen
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
from ..engine.fastpath import _exposure_p, _movement
from ..engine.state import SimState, init_state
from ..engine.step import StepOutput
from ..ops.maths import binomial_at_least_one, truncate_u8
from ..ops.runsums import permute_by_sort, range_totals, run_totals
from ..ops.segments import bus_hits
from .mesh import AXIS, make_mesh
from .partition import PAD_STATUS, ShardedWorld, partition_world, shard_state_arrays


def _ext(lane, pad_value):
    """Append one pad element so index tables can use `size` as a dump."""
    return jnp.concatenate(
        [lane, jnp.full((1,), pad_value, lane.dtype)]
    )


def _shard_citizen_statics(sw: ShardedWorld, sq):
    """Per-shard CitizenStatics (ops/citizen.py bit layout) from the
    partitioned lanes.  The sharded formulation has no work-order twin, so
    the twin schedule fields are zero — the phase's ws-movement sched bits
    (3/4) are carried but never read here.  Built once per chunk, outside
    the scan (loop-invariant)."""
    from ..ops.citizen import pack_citizen_statics

    return pack_citizen_statics(
        work_start=sq(sw.work_start),
        work_end=sq(sw.work_end),
        uses_transport=sq(sw.uses_transport),
        work_neq_home=sq(sw.work_neq_home),
        hh_pos=sq(sw.hh_pos),
        hh_size=sq(sw.hh_size),
        mask_compliant=sq(sw.mask_compliant),
        same_oa=sq(sw.same_oa),
    )


def fast_shard_step(sw: ShardedWorld, params: Params, cfg: SimConfig,
                    state: SimState, fused_statics=None,
                    rider_statics=None):
    """One hour on one shard (inside shard_map).  Per-citizen lanes are
    local (S,); scalars and outputs are replicated via psum.

    Two formulations, bitwise-identical (tests/test_fastmesh.py):

    * fused: stages 1-4 run the fused citizen phase per shard — the same
      engine as the single-device fast path — with the shard's global-id
      offset keying the home draw, so streams equal single-device; the
      schedule bools ride the packed int8 ``sched`` lane.
    * unfused: the elementwise formulation with bool schedule lanes.

    The work and bus sides are gated ``lax.cond``s on psum'd pressure
    predicates (replicated, so every shard takes the same branch and the
    collectives inside stay legal); the gated blocks are value-identical
    no-ops when their pressure is zero.
    """
    d = params.disease
    th = params.thresholds
    S = sw.shard_size
    W = sw.n_slots
    L = sw.sort_len
    G = sw.n_ghost
    n_dev = sw.n_dev
    use_fused = use_fused_citizen(cfg, sw.max_household_size)

    # Debug-only subtraction bits for a per-collective cost table
    # (SimConfig.debug_shard_parts).  0 = everything real.
    _parts = 0 if cfg.debug_shard_parts == -1 else cfg.debug_shard_parts
    _skip_collectives = bool(_parts & 1)
    _skip_ghost = bool(_parts & 2)
    _skip_reapply = bool(_parts & 4)

    def gsum(x):
        if _skip_collectives:
            return x
        return jax.lax.psum(x, AXIS)

    sq = lambda x: x.reshape(x.shape[1:])  # drop the shard_map unit axis
    hour = state.hour + 1
    key = jax.random.fold_in(state.rng_key, hour)
    k_bus, k_h, k_w, k_b, k_vax = jax.random.split(key, 5)
    # Citizen-keyed draws hash (per-step seed, GLOBAL citizen / work-order
    # id) — the same streams the single-device fast path draws
    # (fastpath.py), so the sharded trajectory is bitwise-identical in
    # fully stochastic regimes.  Only the bus machinery keeps per-shard
    # keys: buses assemble shard-locally (the one documented divergence,
    # FIDELITY.md).
    seed_h = jax.random.bits(k_h, (), jnp.uint32)
    seed_w = jax.random.bits(k_w, (), jnp.uint32)
    seed_vax0 = jax.random.bits(k_vax, (), jnp.uint32)
    me = jax.lax.axis_index(AXIS)
    k_bus = jax.random.fold_in(k_bus, me)
    k_b = jax.random.fold_in(k_b, me)
    from ..ops.hashrng import hash_bits, hash_uniform

    gid_u32 = sq(sw.global_id).astype(jnp.uint32)
    h24 = (hour % 24).astype(jnp.int8)
    move = ~state.lockdown
    K = sw.max_household_size

    def trunc(x):
        return truncate_u8(x) if cfg.reference_u8_truncation else x

    if use_fused:
        # Stages 1-4 + the cond-operand packing in one fused pass
        # (ops/citizen.py): timers, movement, census counts, household
        # window, home draw — the home-draw hash is keyed on gid0 + lane
        # (= global citizen id), so the stream equals single-device bitwise.
        from ..ops.citizen import citizen_phase

        statics = (
            fused_statics if fused_statics is not None
            else _shard_citizen_statics(sw, sq)
        )
        gid0 = sq(sw.global_id)[0]  # shards are contiguous global ranges
        (status, timer, sched1, gates, partials) = citizen_phase(
            statics,
            state.status, state.timer, state.sched,
            h24=h24, move=move, mask_status=state.mask_status, seed=seed_h,
            exposed_time=d.exposed_time, infected_time=d.infected_time,
            exposure_chance=d.exposure_chance,
            mask_effectiveness=d.mask_effectiveness,
            gid0=gid0.astype(jnp.uint32),
            K=K,
            ref_mask_sem=cfg.reference_mask_semantics,
            u8_trunc=cfg.reference_u8_truncation,
        )
        timer = jnp.asarray(timer, jnp.int32)
        # phase gates: contrib_work | susceptible<<1 | hit_home<<2 |
        # on_bus<<3 | infected<<4; add at_work (sched bit 0) as bit 5 for
        # the slot machinery.
        hit_home = (gates & 4) != 0
        fwd6 = gates | ((sched1 & 1) << 5)
        seirv0 = gsum(jnp.sum(partials[:, :5], axis=0))
        tot_ib_sh = gsum(jnp.sum(partials[:, 6]))
        tot_c_sh = gsum(jnp.sum(partials[:, 5]))
        work_pred = tot_c_sh > 0
        bus_pred = tot_ib_sh > 0
        sched_lanes = dict(
            sched=sched1,
            at_work=jnp.zeros((0,), jnp.bool_),
            on_bus=jnp.zeros((0,), jnp.bool_),
            bus_to_work=jnp.zeros((0,), jnp.bool_),
        )
    else:
        tot_ib_sh = None
        tot_c_sh = None
        # 1. timers (disease.rs:47-71); PAD_STATUS citizens never transition
        status, timer = state.status, jnp.asarray(state.timer, jnp.int32)
        is_e = status == STATUS_EXPOSED
        is_i = status == STATUS_INFECTED
        e_to_i = is_e & (timer >= d.exposed_time)
        i_to_r = is_i & (timer >= d.infected_time)
        status = jnp.where(e_to_i, STATUS_INFECTED, status)
        status = jnp.where(i_to_r, jnp.int8(3), status).astype(jnp.int8)
        timer = jnp.where(
            e_to_i | i_to_r, 0, jnp.where(is_e | is_i, timer + 1, timer)
        )

        # 2. movement (citizen.rs:168-216)
        at_work, on_bus, bus_to_work = _movement(
            h24, sq(sw.work_start), sq(sw.work_end), sq(sw.uses_transport),
            move, state.at_work, state.on_bus, state.bus_to_work,
        )

        # 3. census post-advance (simulator.rs:178); pads are status 5
        seirv0 = gsum(
            jnp.stack(
                [jnp.sum((status == s).astype(jnp.int32)) for s in range(5)]
            )
        )

        # 4. home side: households never straddle shards, so the
        #    shift-window sum is fully local
        inf_active = (status == STATUS_INFECTED) & ~on_bus
        wneq = sq(sw.work_neq_home)
        contrib_home = inf_active & (~at_work | ~wneq)
        pos, size = sq(sw.hh_pos), sq(sw.hh_size)
        if 0 < K <= 24:
            c8 = contrib_home.astype(jnp.int8)
            acc = contrib_home.astype(jnp.int32)
            for dd in range(1, K):
                acc = acc + jnp.where(pos + dd < size, jnp.roll(c8, -dd), 0)
                acc = acc + jnp.where(pos - dd >= 0, jnp.roll(c8, dd), 0)
            n_h = acc
        else:
            hh_start = pos == 0
            hh_end = pos == size - 1
            n_h = run_totals(contrib_home, hh_start, hh_end)

        p_cit = _exposure_p(
            d.exposure_chance, d.mask_effectiveness, state.mask_status,
            sq(sw.mask_compliant), on_bus, cfg.reference_mask_semantics,
        )
        same_oa = sq(sw.same_oa)
        q_home = jnp.where(
            ~at_work | same_oa, binomial_at_least_one(p_cit, trunc(n_h)), 0.0
        )
        susceptible = status == STATUS_SUSCEPTIBLE
        hit_home = susceptible & (hash_uniform(seed_h, gid_u32) < q_home)

        contrib_work = inf_active & at_work & wneq
        fwd6 = (
            contrib_work.astype(jnp.int8)
            | (susceptible.astype(jnp.int8) << 1)
            | (hit_home.astype(jnp.int8) << 2)
            | (on_bus.astype(jnp.int8) << 3)
            | ((status == STATUS_INFECTED).astype(jnp.int8) << 4)
            | (at_work.astype(jnp.int8) << 5)
        )
        work_pred = gsum(jnp.sum(contrib_work.astype(jnp.int32))) > 0
        bus_pred = gsum(jnp.sum(
            (on_bus & (status == STATUS_INFECTED)).astype(jnp.int32)
        )) > 0
        sched_lanes = dict(
            at_work=at_work, on_bus=on_bus, bus_to_work=bus_to_work,
            sched=jnp.zeros((0,), jnp.int8),
        )

    # --- slot-space schedule lanes (sortless work branch) -----------------
    # The slot's occupant is static, so the slot's at_work/on_bus follow
    # the occupant's _movement recurrence exactly — carried in slot space
    # (SimState.at_work_ws/on_bus_ws are repurposed as (W,) lanes in the
    # sharded engine) and updated every hour, so the sortless work branch
    # never needs the occupant bits transported through the slot sort.
    slot_sched_live = (
        sw.slot_ws is not None
        and state.at_work_ws is not None
        and state.at_work_ws.shape[0] == W
    )
    if slot_sched_live:
        s_ws_l = jnp.asarray(sq(sw.slot_ws), jnp.int8)
        s_we_l = jnp.asarray(sq(sw.slot_we), jnp.int8)
        s_uses_l = sq(sw.slot_uses)
        arm_bo_s = (h24 == s_ws_l - 1) & s_uses_l
        arm_bh_s = (h24 == s_we_l - 1) & s_uses_l
        on_bus_s1 = jnp.where(move, arm_bo_s | arm_bh_s, state.on_bus_ws)
        at_work_s1 = jnp.where(
            move,
            jnp.where(
                h24 == s_ws_l, True,
                jnp.where(h24 == s_we_l, False, state.at_work_ws),
            ),
            state.at_work_ws,
        )
    else:
        at_work_s1, on_bus_s1 = state.at_work_ws, state.on_bus_ws

    # 5-7. work side with ghost slots, gated: no infected worker anywhere
    #    -> every q is 0, the zero branch is value-identical and skips the
    #    sorts, run totals and the ghost all_to_alls.  6 packed bits per
    #    participant (fwd6 layout above).
    record_oa = cfg.record_exposures_per_oa
    n_oa_out = sw.n_output_areas if record_oa else 0
    from ..ops.sparse import compact_positions, scatter_bits

    KS = cfg.sparse_transport_slots

    def work_side(fwd):
        lane_L = jnp.concatenate([fwd, jnp.zeros((L - S,), jnp.int8)])
        slots = permute_by_sort(sq(sw.sort_rank), lane_L, bits=6)[:W]

        # ghost bits out: gather my cross-shard workers' bits, exchange,
        # and overwrite the (garbage) ghost slot positions at the owner
        if not _skip_ghost:
            fwd_ext = _ext(fwd, 0)
            send = jnp.take(
                fwd_ext, sq(sw.out_ghost_src).reshape(-1)
            ).reshape(n_dev, G)
            recv = jax.lax.all_to_all(
                send, AXIS, split_axis=0, concat_axis=0
            )
            slots = slots.at[sq(sw.recv_slot_pos).reshape(-1)].set(
                recv.reshape(-1), mode="drop"
            )

        active = sq(sw.slot_active)
        contrib_s = ((slots & 1) != 0) & active
        susc_s = ((slots & 2) != 0) & active
        hit_home_s = (slots & 4) != 0
        on_bus_s = (slots & 8) != 0
        at_work_s = (slots & 32) != 0

        # global per-building pressure = local run totals: every worker of
        # a building occupies a slot on its owner shard, local or ghost.
        n_w = run_totals(contrib_s, sq(sw.wb_start), sq(sw.wb_end))
        room = run_totals(contrib_s, sq(sw.room_start), sq(sw.room_end))
        draws = jnp.where(
            sq(sw.slot_is_school), room, (n_w > 0).astype(jnp.int32)
        )
        p_s = _exposure_p(
            d.exposure_chance, d.mask_effectiveness, state.mask_status,
            sq(sw.slot_mask_compliant), on_bus_s, cfg.reference_mask_semantics,
        )
        q_single = binomial_at_least_one(p_s, trunc(n_w))
        gate = active & (at_work_s | sq(sw.slot_same_oa))
        q_work = jnp.where(
            gate,
            -jnp.expm1(draws.astype(jnp.float32) * jnp.log1p(-q_single)),
            0.0,
        )
        hit_s = susc_s & (
            hash_uniform(seed_w, sq(sw.slot_ws_index).astype(jnp.uint32))
            < q_work
        )
        from_work_s = hit_s & ~hit_home_s
        if record_oa:
            oa_work = range_totals(
                from_work_s, sq(sw.ws_oa_lo), sq(sw.ws_oa_hi)
            )
        else:
            oa_work = jnp.zeros((0,), jnp.int32)

        # hits back: local participants via the static unsort table —
        # hits are few on almost every hour, so a K-bounded compaction +
        # scatter replaces the second full-length permutation sort (dense
        # fallback past KS keeps the lane bitwise-identical at any hit
        # count).  Ghost-slot hits MUST be excluded: non-participant local
        # citizens absorb the ghost-slot ranks (the sort rank is a complete
        # permutation) and would otherwise receive a ghost's hit; ghosts
        # get theirs via the reverse all_to_all.
        hit_local_only = jnp.where(sq(sw.slot_local), hit_s, False)
        unsort = sq(sw.unsort_rank)
        pos_h, live, cnt = compact_positions(hit_local_only, KS)
        cit_idx = jnp.take(unsort, jnp.minimum(pos_h, W - 1))
        sp = scatter_bits(
            S, jnp.minimum(cit_idx, S - 1), live & (cit_idx < S)
        )

        def dense(hlo):
            hit_L = jnp.concatenate(
                [hlo.astype(jnp.int8), jnp.zeros((L - W,), jnp.int8)]
            )
            return permute_by_sort(unsort, hit_L, bits=1)[:S].astype(bool)

        hit_work0 = jax.lax.cond(
            cnt > KS, dense, lambda _: sp, hit_local_only
        )
        if _skip_ghost:
            return hit_work0, oa_work
        hit_s_ext = _ext(hit_s.astype(jnp.int8), 0)
        ghost_hits = jnp.take(
            hit_s_ext, sq(sw.recv_slot_pos).reshape(-1)
        ).reshape(n_dev, G)
        back = jax.lax.all_to_all(ghost_hits, AXIS, split_axis=0, concat_axis=0)
        hit_work = (
            hit_work0.astype(jnp.int8)
            .at[sq(sw.out_ghost_src).reshape(-1)]
            .max(back.reshape(-1), mode="drop")
        ) != 0
        return hit_work, oa_work

    # debug gate forcings (SimConfig.debug_force_gates) — same
    # subtractive-measurement hook as engine/fastpath.py; NOT
    # semantics-preserving when forcing a live side off.
    if cfg.debug_force_gates is not None:
        gw, gb = cfg.debug_force_gates
        if gw is not None:
            work_pred = jnp.asarray(bool(gw))
        if gb is not None:
            bus_pred = jnp.asarray(bool(gb))

    sd_work = cfg.use_sortless_sharded
    if sd_work is None:
        sd_work = False
    sortless_work_sh = (
        bool(sd_work)
        and use_fused
        and tot_c_sh is not None
        and slot_sched_live
        and sw.slot_oa is not None
        and sw.slot_ws is not None
    )

    def _work_zeros_sh(_):
        return (
            jnp.zeros((S,), bool),
            jnp.zeros((n_oa_out,), jnp.int32),
        )

    if sortless_work_sh:

        def work_side_sl(fwd):
            # Sortless sharded work branch (the dense fastpath lever with
            # ghost handling): local contributor bits drain into slot
            # space through the static sort_rank (contributors are
            # participants, so their rank IS their slot); ghost bits
            # arrive by the SAME all_to_all as the sorted branch and
            # scatter sparsely; pressure/draws run in slot space off the
            # carried slot schedule lanes; the few post-draw candidates
            # compact back — susceptibility/hit-home read from the local
            # citizen bits or the received ghost bits; ghost hits return
            # by the same reverse all_to_all.  Bitwise the sorted
            # branch's hit set (same pressure tables, same
            # hash(slot_ws_index) stream).
            from ..ops.sparse import block_hierarchy, compact_from_hierarchy

            K_SL = max(1, min(cfg.sortless_slots, S))
            contrib_c = (fwd & 1) != 0
            h_c = block_hierarchy(contrib_c, block=128)

            # ghost exchange (identical to the sorted branch)
            fwd_ext = _ext(fwd, 0)
            send = jnp.take(
                fwd_ext, sq(sw.out_ghost_src).reshape(-1)
            ).reshape(n_dev, G)
            recv = jax.lax.all_to_all(
                send, AXIS, split_axis=0, concat_axis=0
            )
            rsp = sq(sw.recv_slot_pos).reshape(-1)
            gbits = (
                jnp.zeros((W + 1,), jnp.int8)
                .at[rsp]
                .set(recv.reshape(-1), mode="drop")[:W]
            )

            rank_l = sq(sw.sort_rank)
            L_l = rank_l.shape[0]

            def c_round(c):
                done, lane = c
                pos, live, _ = compact_from_hierarchy(
                    h_c, K_SL, offset=done, n=S, sb=128
                )
                slot = jnp.take(rank_l, jnp.minimum(pos, L_l - 1))
                lane = lane.at[
                    jnp.where(live & (slot < W), slot, W)
                ].set(jnp.int8(1), mode="drop")
                return done + jnp.sum(live.astype(jnp.int32)), lane

            _, contrib_loc8 = jax.lax.while_loop(
                lambda c: c[0] < h_c[2],
                c_round,
                (jnp.int32(0), jnp.zeros((W,), jnp.int8)),
            )
            # A cross-shard worker's LOCAL rank is a filler (its real slot
            # lives on the owner shard), so the drains can deposit
            # phantom bits on ghost/pad slot positions — the sorted
            # branch's recv scatter OVERWRITES those, so mask to
            # local-active slots and read ghost slots from the received
            # bits instead of max-combining.
            active_l = sq(sw.slot_active)
            loc_slots = sq(sw.slot_local) & active_l
            contrib_s8 = jnp.where(loc_slots, contrib_loc8, gbits & 1)

            n_w = run_totals(
                contrib_s8 != 0, sq(sw.wb_start), sq(sw.wb_end)
            )
            room = run_totals(
                contrib_s8 != 0, sq(sw.room_start), sq(sw.room_end)
            )
            draws = jnp.where(
                sq(sw.slot_is_school), room, (n_w > 0).astype(jnp.int32)
            )
            active = sq(sw.slot_active)
            p_s = _exposure_p(
                d.exposure_chance, d.mask_effectiveness, state.mask_status,
                sq(sw.slot_mask_compliant), on_bus_s1,
                cfg.reference_mask_semantics,
            )
            q_single = binomial_at_least_one(p_s, trunc(n_w))
            gate = active & (at_work_s1 | sq(sw.slot_same_oa))
            q_work = jnp.where(
                gate,
                -jnp.expm1(
                    draws.astype(jnp.float32) * jnp.log1p(-q_single)
                ),
                0.0,
            )
            u_s = hash_uniform(
                seed_w, sq(sw.slot_ws_index).astype(jnp.uint32)
            )
            cand = u_s < q_work
            h_cand = block_hierarchy(cand, block=128)
            unsort = sq(sw.unsort_rank)
            slot_local_l = sq(sw.slot_local)
            slot_oa_l = sq(sw.slot_oa)

            def h_round(c):
                done, lane_cit, gh_lane, oa = c
                pos, live, _ = compact_from_hierarchy(
                    h_cand, K_SL, offset=done, n=W, sb=128
                )
                posw = jnp.minimum(pos, W - 1)
                is_loc = jnp.take(slot_local_l, posw) & live
                cit = jnp.take(unsort, posw)
                fb_local = jnp.take(fwd_ext, jnp.minimum(cit, S))
                fb = jnp.where(is_loc, fb_local, jnp.take(gbits, posw))
                hitk = ((fb & 2) != 0) & live
                fw = hitk & ((fb & 4) == 0)
                lane_cit = lane_cit.at[
                    jnp.where(hitk & is_loc & (cit < S), cit, S)
                ].set(True, mode="drop")
                gh_lane = gh_lane.at[
                    jnp.where(hitk & ~is_loc, posw, W)
                ].set(jnp.int8(1), mode="drop")
                if record_oa:
                    ids = jnp.take(slot_oa_l, posw, mode="clip")
                    oa = oa.at[jnp.where(fw, ids, n_oa_out)].add(
                        1, mode="drop"
                    )
                return (
                    done + jnp.sum(live.astype(jnp.int32)),
                    lane_cit, gh_lane, oa,
                )

            _, hit_cit, gh_lane, oa_work = jax.lax.while_loop(
                lambda c: c[0] < h_cand[2],
                h_round,
                (
                    jnp.int32(0),
                    jnp.zeros((S,), bool),
                    jnp.zeros((W,), jnp.int8),
                    jnp.zeros((n_oa_out,), jnp.int32),
                ),
            )
            # ghost hits back (identical reverse a2a to the sorted branch)
            gh_ext = jnp.concatenate(
                [gh_lane, jnp.zeros((1,), jnp.int8)]
            )
            back = jax.lax.all_to_all(
                jnp.take(gh_ext, rsp).reshape(n_dev, G),
                AXIS, split_axis=0, concat_axis=0,
            )
            hit_work = (
                hit_cit.astype(jnp.int8)
                .at[sq(sw.out_ghost_src).reshape(-1)]
                .max(back.reshape(-1), mode="drop")
            ) != 0
            return hit_work, oa_work

        from ..engine.fastpath import sortless_rounds

        bound_w_sh = max(1, min(cfg.sortless_slots, S)) * sortless_rounds(
            S, cfg
        )
        sel_w_sh = jnp.where(
            work_pred,
            jnp.where(tot_c_sh > bound_w_sh, 1, 2),
            0,
        ).astype(jnp.int32)
        hit_work, oa_work = jax.lax.switch(
            sel_w_sh,
            [_work_zeros_sh, work_side, work_side_sl],
            fwd6,
        )
    else:
        hit_work, oa_work = jax.lax.cond(
            work_pred,
            work_side,
            _work_zeros_sh,
            fwd6,
        )

    # 8. bus side: riders live on their home shard; the whole shuffle +
    #    chunk + draw machinery is local (ops/segments.py::bus_hits).
    #    Gated: no infected rider anywhere -> n_bus = 0 -> q = 0, the zero
    #    branch is value-identical.
    rl = sq(sw.rider_local)

    def p_fn(compliant, on_bus_lane):
        return _exposure_p(
            d.exposure_chance, d.mask_effectiveness, state.mask_status,
            compliant, on_bus_lane, cfg.reference_mask_semantics,
        )

    def bus_side(fwd):
        # Rider-order input bits via ONE shard-local key-sort on the
        # static rpos_local rank (the fastpath rpos trick) — pad rider
        # slots receive non-rider citizens
        # whose on_bus bit is 0, so they sort to the invalid tail and the
        # hit set is bitwise the gather formulation's.  Gather fallback
        # for partitions cached before the lane existed.
        R_s = rl.shape[0]
        if sw.rpos_local is not None:
            pk = permute_by_sort(sq(sw.rpos_local), fwd, bits=6)[:R_s]
        else:
            ext = _ext(fwd, 0)
            pk = jnp.take(ext, rl)
        return bus_hits(
            k_bus, k_b,
            (pk & 8) != 0, (pk & 16) != 0, (pk & 2) != 0,
            sq(sw.rider_compliant),
            sq(sw.rider_route), rl, cfg.bus_capacity, p_fn, S,
        )[0]

    sd_sh = cfg.use_sortless_sharded
    if sd_sh is None:
        sd_sh = False
    sortless_bus_sh = (
        bool(sd_sh)
        and use_fused
        and tot_ib_sh is not None
        and rider_statics is not None
        and sw.rpos_local is not None
        and sw.n_riders > 0
    )
    if sortless_bus_sh:
        # Sortless sharded bus (riders are fully shard-local, so this is
        # the dense fastpath lever verbatim): on moving rider-light hours
        # skip the citizen->rider permutation sort — on_bus from the
        # static per-shard rider schedule, the few infected riders
        # scatter through rpos_local, susceptibility gates the compacted
        # post-draw candidates, hits scatter straight into the (S,) lane.
        # Bitwise the sorted branch's hit set (pad slots masked by
        # rider_valid so the shuffle-sort layout is identical); candidate
        # overflow falls back to the sorted branch.
        ws_r_sh, we_r_sh, rider_valid = rider_statics
        R_sl = rl.shape[0]
        k_bt_sh = (
            min(16384, R_sl)
            if cfg.debug_bus_hit_slots is None
            else max(1, min(cfg.debug_bus_hit_slots, R_sl))
        )

        def bus_side_sl(fwd):
            from ..ops.segments import bus_hits_sortless
            from ..ops.sparse import block_hierarchy, compact_from_hierarchy

            K_SL = max(1, min(cfg.sortless_slots, S))
            inf_onbus = (fwd & 24) == 24
            h_ib = block_hierarchy(inf_onbus, block=128)

            def i_round(c):
                done, lane = c
                pos, live, _ = compact_from_hierarchy(
                    h_ib, K_SL, offset=done, n=S, sb=128
                )
                r_idx = jnp.take(
                    sq(sw.rpos_local), jnp.minimum(pos, S - 1)
                )
                lane = lane.at[jnp.where(live, r_idx, R_sl)].set(
                    True, mode="drop"
                )
                return done + jnp.sum(live.astype(jnp.int32)), lane

            _, rb_inf = jax.lax.while_loop(
                lambda c: c[0] < h_ib[2],
                i_round,
                (jnp.int32(0), jnp.zeros((R_sl,), bool)),
            )
            arm_r = rider_valid & (
                (h24 == ws_r_sh - 1) | (h24 == we_r_sh - 1)
            )

            def susc_of_rider(rider_ids):
                cit = jnp.take(
                    rl, jnp.minimum(rider_ids, max(R_sl - 1, 0)),
                    mode="clip",
                )
                return (
                    jnp.take(fwd, jnp.minimum(cit, S - 1), mode="clip") & 2
                ) != 0

            _, _, live, _, cit_ids, cand_total = bus_hits_sortless(
                k_bus, k_b, arm_r, rb_inf,
                sq(sw.rider_compliant),
                sq(sw.rider_route), rl, cfg.bus_capacity, p_fn,
                susc_of_rider, max_hits=k_bt_sh,
            )
            lane = (
                jnp.zeros((S,), bool)
                .at[jnp.where(live & (cit_ids < S), cit_ids, S)]
                .set(True, mode="drop")
            )
            return jax.lax.cond(
                cand_total <= k_bt_sh,
                lambda _: lane,
                bus_side,
                fwd,
            )

        from ..engine.fastpath import sortless_rounds as _slr

        bound_b_sh = max(1, min(cfg.sortless_slots, S)) * _slr(S, cfg)
        sel_b_sh = jnp.where(
            bus_pred,
            jnp.where(move & (tot_ib_sh <= bound_b_sh), 2, 1),
            0,
        ).astype(jnp.int32)
        hit_bus = jax.lax.switch(
            sel_b_sh,
            [lambda _: jnp.zeros((S,), bool), bus_side, bus_side_sl],
            fwd6,
        )
    else:
        hit_bus = jax.lax.cond(
            bus_pred, bus_side, lambda _: jnp.zeros((S,), bool), fwd6
        )

    # 9. combine + bookkeeping (the fused phase already applied hit_home;
    #    the dense re-apply is idempotent, so both branches stay bitwise-
    #    identical)
    newly_exposed = hit_home | hit_work | hit_bus
    if _skip_reapply:
        # debug bit2: value-identical ONLY with both sides forced off in
        # the fused regime (hit_work/hit_bus all-zero => the re-apply
        # rewrites the phase's own values) and vaccination disabled
        # (eligible never read)
        from_bus = hit_bus & ~hit_home & ~hit_work
        eligible = state.eligible
    else:
        status = jnp.where(newly_exposed, jnp.int8(STATUS_EXPOSED), status)
        timer = jnp.where(newly_exposed, 0, timer)
        from_bus = hit_bus & ~hit_home & ~hit_work
        if cfg.faithful_vaccine_bugs:
            eligible = state.eligible & ~from_bus
        else:
            eligible = state.eligible & ~newly_exposed

    n_new = gsum(jnp.sum(newly_exposed.astype(jnp.int32)))
    n_bus_exp = gsum(jnp.sum(from_bus.astype(jnp.int32)))
    if record_oa:
        oa_home = range_totals(hit_home, sq(sw.oa_lo), sq(sw.oa_hi))
        exposures_per_oa = gsum(oa_home + oa_work)
    else:
        exposures_per_oa = jnp.zeros((0,), jnp.int32)

    seirv = seirv0.at[STATUS_SUSCEPTIBLE].add(-n_new).at[STATUS_EXPOSED].add(n_new)

    # 10. interventions (interventions.rs:110-184) on replicated scalars
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

    # 11. vaccination: exact global-k selection.  Sampled-band threshold
    #     (3 collective rounds; ops/select.py::kth_threshold_sharded) with
    #     the 32-round psum bisection as exact fallback / small-shard path;
    #     shard-prefix tie allocation via all_gather.
    def vaccinate(args):
        status, eligible = args
        # same scores as fastpath's fresh_threshold selector (global-id
        # keyed); both selector branches find the identical k-th threshold
        # and the shard-prefix tie split equals the global cumsum rank
        # order (shards are contiguous citizen ranges)
        from ..ops.select import kth_threshold_sharded

        scores = hash_bits(seed_vax0, gid_u32)
        n_elig = gsum(jnp.sum(eligible.astype(jnp.int32)))
        kk = jnp.minimum(jnp.asarray(d.vaccination_rate, jnp.int32), n_elig)
        tau = kth_threshold_sharded(
            scores, eligible, kk, n_elig, axis=AXIS,
            force_sampled=cfg.use_sampled_vax_sharded,
            sample_log2=cfg.vax_sharded_sample_log2,
        )
        below = eligible & (scores < tau)
        at = eligible & (scores == tau)
        allowed = kk - gsum(jnp.sum(below.astype(jnp.int32)))
        at_counts = jax.lax.all_gather(jnp.sum(at.astype(jnp.int32)), AXIS)
        me = jax.lax.axis_index(AXIS)
        prefix = jnp.sum(
            jnp.where(jnp.arange(n_dev) < me, at_counts, 0)
        )
        my_quota = jnp.clip(allowed - prefix, 0, None)
        chosen = below | (at & (jnp.cumsum(at.astype(jnp.int32)) <= my_quota))
        new_status = jnp.where(chosen, jnp.int8(STATUS_VACCINATED), status)
        if not cfg.faithful_vaccine_bugs:
            eligible = eligible & ~chosen
            new_status = jnp.where(
                chosen & (status != STATUS_SUSCEPTIBLE), status, new_status
            )
        return new_status, eligible, gsum(jnp.sum(chosen.astype(jnp.int32)))

    status, eligible, n_vax = jax.lax.cond(
        vaccination_started,
        vaccinate,
        lambda args: (args[0], args[1], jnp.int32(0)),
        (status, eligible),
    )

    new_state = SimState(
        status=status,
        timer=timer.astype(TIMER_DTYPE),
        **sched_lanes,
        eligible=eligible,
        at_work_ws=at_work_s1,
        on_bus_ws=on_bus_s1,
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


def init_sharded_state(world, sw: ShardedWorld, *, seed=0,
                       starting_infected=10, cfg: SimConfig | None = None):
    """Global init_state scattered into (n_dev, S) stacked lanes.

    ``cfg``: when given and ``use_sortless_sharded`` is on, allocates the
    slot-space schedule lanes the sortless sharded branches carry."""
    gs = init_state(world, seed=seed, starting_infected=starting_infected)
    lanes = shard_state_arrays(sw, {
        "status": (np.asarray(gs.status), PAD_STATUS),
        "timer": (np.asarray(gs.timer), 0),
        "at_work": (np.asarray(gs.at_work), False),
        "on_bus": (np.asarray(gs.on_bus), False),
        "bus_to_work": (np.asarray(gs.bus_to_work), False),
        "eligible": (np.asarray(gs.eligible), False),
    })
    # lanes ride flat (n_dev*S,): shard_map splits them into per-shard (S,)
    # blocks and concatenates outputs back symmetrically
    # Slot-space schedule lanes for the sortless work branch: the slot's
    # occupant is static, so its at_work/on_bus follow the occupant's
    # _movement recurrence — carried here in slot space, initialised to
    # the occupants' initial state (all False at hour 0, matching
    # init_state).  Empty when the partition predates the slot statics.
    slot_sched = (
        sw.slot_ws is not None
        and cfg is not None
        and cfg.use_sortless_sharded is not None
        and bool(cfg.use_sortless_sharded)
    )
    n_slot = sw.n_dev * sw.n_slots if slot_sched else 0
    return dataclasses.replace(
        gs,
        **{k: jnp.asarray(v).reshape(-1) for k, v in lanes.items()},
        at_work_ws=jnp.zeros((n_slot,), bool),
        on_bus_ws=jnp.zeros((n_slot,), bool),
        # replicated-order twins don't exist in the sharded formulation
        status_ws=jnp.zeros((0,), jnp.int8),
        timer_ws=jnp.zeros((0,), TIMER_TWIN_DTYPE),
        status_r=jnp.zeros((0,), jnp.int8),
        timer_r=jnp.zeros((0,), TIMER_TWIN_DTYPE),
        on_bus_r=jnp.zeros((0,), bool),
        vax_pool=jnp.zeros((0,), jnp.int32),
        vax_pool_size=jnp.zeros((), jnp.int32),
    )


def make_fast_sharded_runner(sw: ShardedWorld, cfg: SimConfig, mesh: Mesh):
    """jitted chunk(sw, params, state) over the partitioned world."""
    lane_fields = {
        "status", "timer", "at_work", "on_bus", "bus_to_work", "eligible",
    }
    if (
        sw.slot_ws is not None
        and cfg.use_sortless_sharded is not None
        and bool(cfg.use_sortless_sharded)
    ):
        # (n_dev*W,) slot-space schedule lanes for the sortless sharded
        # branches (fast_shard_step carries them; repurposed ws-twin
        # fields).  Off by default.
        lane_fields = lane_fields | {"at_work_ws", "on_bus_ws"}
    # The remaining twins and the packed sched lane are always empty (0,)
    # at chunk boundaries in the sharded formulation (init_sharded_state;
    # chunk packs/unpacks sched internally), so they cross the boundary
    # replicated — a P(AXIS) spec here would make the output state's
    # empties arrive sharded and clash with the pinned jit in_shardings
    # below on the next chunk.
    s_specs = SimState(
        **{
            f: P(AXIS) if f in lane_fields else P()
            for f in SimState.__dataclass_fields__
        }
    )
    w_specs = jax.tree.map(lambda _: P(AXIS), sw)
    out_specs = (s_specs, jax.tree.map(lambda _: P(), _out_proto()))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(w_specs, jax.tree.map(lambda _: P(), Params.covid()), s_specs),
        out_specs=out_specs,
        check_vma=False,
    )
    def chunk(sw_l, params, state_l):
        use_fused = use_fused_citizen(cfg, sw.max_household_size)
        sq = lambda x: x.reshape(x.shape[1:])
        statics = _shard_citizen_statics(sw_l, sq) if use_fused else None
        # per-shard rider-order schedule lanes for the sortless bus branch
        # (loop-invariant: built once per chunk, outside the scan).  Pad
        # slots carry valid=False so the shuffle-sort layout matches the
        # sorted branch bitwise.
        rider_statics = None
        sd = cfg.use_sortless_sharded
        if (
            use_fused
            and (sd is not None and sd)
            and sw.rpos_local is not None
            and sw.n_riders > 0
        ):
            rl_c = sq(sw_l.rider_local)
            S_c = sw.shard_size
            valid = rl_c < S_c
            safe = jnp.minimum(rl_c, S_c - 1)
            rider_statics = (
                jnp.take(jnp.asarray(sq(sw_l.work_start), jnp.int32), safe),
                jnp.take(jnp.asarray(sq(sw_l.work_end), jnp.int32), safe),
                valid,
            )
        empty_b = jnp.zeros((0,), jnp.bool_)
        if use_fused:
            # scan-internal packed carry: the three schedule bools ride the
            # citizen phase's int8 sched lane (pack/unpack once per CHUNK)
            sched = (
                state_l.at_work.astype(jnp.int8)
                | (state_l.on_bus.astype(jnp.int8) << 1)
                | (state_l.bus_to_work.astype(jnp.int8) << 2)
            )
            state_l = dataclasses.replace(
                state_l, sched=sched,
                at_work=empty_b, on_bus=empty_b, bus_to_work=empty_b,
            )

        # Same two scan-plumbing choices as engine/scan.py's
        # make_chunk_runner: (1) the PRNG key is loop-invariant (every step
        # folds the hour in afresh) — carrying it costs copies each
        # iteration, so close over it; (2) one (10,) stacked output vector
        # instead of
        # six tiny per-step leaves, each of which pays its own
        # per-iteration store/copy.
        base_key = state_l.rng_key
        state_l = dataclasses.replace(state_l, rng_key=None)

        def body(carry, _):
            ns, out = fast_shard_step(
                sw_l, params, cfg,
                dataclasses.replace(carry, rng_key=base_key),
                fused_statics=statics,
                rider_statics=rider_statics,
            )
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
                dataclasses.replace(ns, rng_key=None),
                (small, out.exposures_per_oa),
            )

        state_l, (small_t, oa_t) = jax.lax.scan(
            body, state_l, None, length=cfg.chunk_size
        )
        state_l = dataclasses.replace(state_l, rng_key=base_key)
        outs = StepOutput(
            seirv=small_t[:, :5],
            exposures_per_oa=oa_t,
            n_bus_exposures=small_t[:, 5],
            n_exposures=small_t[:, 6],
            lockdown=small_t[:, 7].astype(jnp.bool_),
            mask_status=small_t[:, 8].astype(jnp.int8),
            n_vaccinated_now=small_t[:, 9],
        )
        if use_fused:
            s = state_l.sched
            state_l = dataclasses.replace(
                state_l,
                at_work=(s & 1) != 0,
                on_bus=(s & 2) != 0,
                bus_to_work=(s & 4) != 0,
                sched=jnp.zeros((0,), jnp.int8),
            )
        return state_l, outs

    # Explicit in_shardings: same provenance rule as engine/scan.py's
    # make_chunk_runner — without them jit specializes a second program
    # for committed inputs.  The shardings mirror the shard_map in_specs:
    # world lanes and
    # state lanes split on AXIS, params and intervention scalars
    # replicated.
    shard = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    s_in = SimState(
        **{
            f: shard if f in lane_fields else rep
            for f in SimState.__dataclass_fields__
        }
    )
    return jax.jit(chunk, donate_argnums=(2,), in_shardings=(shard, rep, s_in))


def _out_proto():
    z = jnp.zeros(())
    return StepOutput(z, z, z, z, z, z, z)


def run_fast_sharded(world, params, cfg: SimConfig, mesh: Mesh, *,
                     seed=0, starting_infected=10, callback=None):
    """Partition + run until the epidemic dies or cfg.max_steps."""
    n_dev = mesh.devices.size
    sw = partition_world(world, n_dev)
    state = init_sharded_state(
        world, sw, seed=seed, starting_infected=starting_infected, cfg=cfg
    )
    w_sh = jax.tree.map(
        lambda x: jax.device_put(
            jnp.asarray(x), NamedSharding(mesh, P(AXIS))
        ) if hasattr(x, "shape") else x,
        sw,
    )
    lane_fields = {
        "status", "timer", "at_work", "on_bus", "bus_to_work", "eligible",
    }
    if (
        sw.slot_ws is not None
        and cfg.use_sortless_sharded is not None
        and bool(cfg.use_sortless_sharded)
    ):
        lane_fields = lane_fields | {"at_work_ws", "on_bus_ws"}
    state = jax.tree.map(jnp.asarray, state)
    state = dataclasses.replace(
        state,
        **{
            f: jax.device_put(
                getattr(state, f), NamedSharding(mesh, P(AXIS))
            )
            for f in lane_fields
        },
    )
    runner = make_fast_sharded_runner(sw, cfg, mesh)
    params = params.as_arrays()

    chunks = []
    steps = 0
    while steps < cfg.max_steps:
        state, out = runner(w_sh, params, state)
        out = jax.tree.map(np.asarray, out)
        chunks.append(out)
        steps += cfg.chunk_size
        if callback is not None:
            callback(steps, out, state)
        seirv = out.seirv
        if not (seirv[-1, 0] + seirv[-1, 1] + seirv[-1, 2] > 0):
            break

    outputs = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *chunks)
    outputs = jax.tree.map(lambda x: x[: cfg.max_steps], outputs)
    seirv = outputs.seirv
    alive = seirv[:, 0] + seirv[:, 1] + seirv[:, 2] > 0
    if not alive.all():
        end = int(np.argmin(alive)) + 1
        outputs = jax.tree.map(lambda x: x[:end], outputs)
    return state, sw, outputs
