"""Packed-replica ensembles: R parameter replicates as ONE world.

The vmapped ensemble (engine/ensemble.py) pays for batched sorts, flattened
control flow and per-replicate small-op overhead over a single world of the
same total lane count.  This module removes the vmap
entirely — R disjoint copies of the base world are packed into one World
(buildings / OAs / rooms / routes offset per replica, so no mixing group
ever crosses replicas) and ONE pass of the regular fast-path formulation
steps all replicates:

* each replica is padded to a whole number of ``block_rows * 128``-lane
  blocks (pad citizens are inert singleton households with status 5,
  outside every census, draw and mask), so replicas are equal contiguous
  spans;
* the swept disease parameters (every DiseaseParams field: exposure_chance,
  exposed_time, infected_time, mask_effectiveness, vaccination_rate) and
  the per-replica intervention state (lockdown, mask status) reach the
  fused citizen phase as (R,) rows, one per replica span (ops/citizen.py
  ``n_groups``) — no per-citizen parameter lanes in device memory;
  intervention thresholds are (R,) rows compared against the (R,)
  per-replica census;
* the per-replica SEIRV census is the citizen phase's per-group counts;
* work / bus / vaccination run the regular fast-path formulations over the
  packed lanes, with per-citizen views of (R,) state as broadcast+reshape —
  replicas are contiguous, equal-stride blocks in every engine order
  (citizen, work, rider), so no gather;
* exact-k vaccination runs the usual kth-score-threshold search vmapped
  over the (R, stride) reshape.

Replicates are independent simulations: the packed trajectory of replica r
is distributionally identical to a solo run (draws hash global indices, so
streams differ from solo runs, like any reseeding).

Same sweep surface as engine/ensemble.py::run_ensemble; returns (R, T, 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import use_fused_citizen
from ..config import (
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
from ..ops.hashrng import hash_bits, hash_uniform
from ..ops.maths import binomial_at_least_one, truncate_u8
from ..ops.runsums import permute_by_sort, permute_by_sort_rows, run_totals
from ..ops.segments import bus_hits
from ..world.schema import World, make_world
from .fastpath import (
    _advance_disease, _exposure_p, _kth_score_threshold, _movement,
)

LANES = 128


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedEnsemble:
    """One world holding R block-aligned replicas + (R,) parameter rows."""

    world: World
    # swept per-replica disease parameters — EVERY DiseaseParams field is a
    # per-replica row, so the sweep surface equals the vmapped engine's
    chance: Any          # f32 (R,)
    exposed_time: Any    # i32 (R,)
    infected_time: Any   # i32 (R,)
    mask_effectiveness: Any  # f32 (R,)
    vaccination_rate: Any    # i32 (R,)
    n_replicas: int = dataclasses.field(metadata=dict(static=True))
    rep_size: int = dataclasses.field(metadata=dict(static=True))
    #: padded per-replica lane count (multiple of block_rows * 128)
    rep_stride: int = dataclasses.field(default=0, metadata=dict(static=True))
    #: alignment unit, in rows of 128 lanes, of each replica's span
    block_rows: int = dataclasses.field(default=128, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedState:
    status: Any          # i8 (N,); pad lanes hold 5 (outside every census)
    timer: Any           # i32 (N,)
    sched: Any           # i8 (N,): at_work | on_bus<<1 | bus_to_work<<2
                         #          | at_work_ws<<3 | on_bus_ws<<4
    eligible: Any        # bool (N,)
    hour: Any            # i32
    lockdown: Any        # bool (R,)
    mask_status: Any     # i8 (R,)
    vaccination_started: Any  # bool (R,)
    rng_key: Any


def pack_replicas(base: World, param_list: list[Params], *,
                  block_rows: int = 128) -> PackedEnsemble:
    """Tile ``base`` into R replicas padded to ``block_rows * 128``-lane
    boundaries and collect the swept parameters as (R,) rows.

    Pad citizens are inert: singleton households in a per-replica pad OA
    (so they sort to the replica's tail), work == home, no transport, not
    mask-compliant; init_packed_state seeds them status 5, which every
    census / susceptibility / eligibility test excludes.  Replicas stay
    contiguous equal-stride blocks in citizen, work and rider order
    (buildings/OAs/rooms are replica-major and make_world's
    canonicalisation preserves replica-major keys)."""
    R = len(param_list)
    n = base.n_citizens
    B, M, O = base.n_buildings, base.n_rooms, base.n_output_areas
    block_elems = block_rows * LANES
    stride = -(-max(n, 1) // block_elems) * block_elems
    n_pad = stride - n
    Bp, Op = B + n_pad, O + 1

    def padded(x, padval):
        x = np.asarray(x)
        return np.concatenate([x, np.full(n_pad, padval, x.dtype)])

    def tiled(x, padval):
        return np.tile(padded(x, padval), R)

    rep = np.repeat(np.arange(R, dtype=np.int64), stride)
    pad_b = B + np.arange(n_pad, dtype=np.int64)
    hb = np.concatenate([np.asarray(base.home_building, np.int64), pad_b])
    wb = np.concatenate([np.asarray(base.work_building, np.int64), pad_b])
    ho = padded(np.asarray(base.home_oa, np.int64), O)
    wo = padded(np.asarray(base.work_oa, np.int64), O)
    # room sentinel: base M -> packed R*M (pads have no room either)
    rm = np.where(np.asarray(base.room, np.int64) == M, -1,
                  np.asarray(base.room, np.int64))
    rm = padded(rm, -1)
    rm_t = np.tile(rm, R)
    room_packed = np.where(rm_t < 0, R * M, rep * M + rm_t)
    world = make_world(
        age=tiled(base.age, 0),
        occupation=tiled(base.occupation, 0),
        home_building=rep * Bp + np.tile(hb, R),
        work_building=rep * Bp + np.tile(wb, R),
        home_oa=rep * Op + np.tile(ho, R),
        work_oa=rep * Op + np.tile(wo, R),
        room=room_packed,
        is_school_work=tiled(base.is_school_work, False),
        uses_transport=tiled(base.uses_transport, False),
        mask_compliant=tiled(base.mask_compliant, False),
        work_start=tiled(base.work_start, 9),
        work_end=tiled(base.work_end, 17),
        n_buildings=R * Bp,
        n_rooms=R * M,
        n_output_areas=R * Op,
    )
    # make_world must not have reordered citizens across replica blocks or
    # moved pads off the tail: the packed keys are already sorted
    # replica-major with the pad OA last inside each replica.
    assert world.n_citizens == R * stride
    assert np.array_equal(
        np.asarray(world.home_oa, np.int64), rep * Op + np.tile(ho, R)
    ), "pack_replicas: canonicalisation broke the replica-major layout"

    ds = [p.as_arrays().disease for p in param_list]
    chance = np.array(
        [float(jax.device_get(d.exposure_chance)) for d in ds], np.float32
    )
    et = np.array(
        [int(jax.device_get(d.exposed_time)) for d in ds], np.int32
    )
    it = np.array(
        [int(jax.device_get(d.infected_time)) for d in ds], np.int32
    )
    me = np.array(
        [float(jax.device_get(d.mask_effectiveness)) for d in ds], np.float32
    )
    vr = np.array(
        [int(jax.device_get(d.vaccination_rate)) for d in ds], np.int32
    )
    return PackedEnsemble(
        world=world,
        chance=chance,
        exposed_time=et,
        infected_time=it,
        mask_effectiveness=me,
        vaccination_rate=vr,
        n_replicas=R,
        rep_size=n,
        rep_stride=stride,
        block_rows=block_rows,
    )


def init_packed_state(pe: PackedEnsemble, *, seed: int = 0,
                      starting_infected: int = 10) -> PackedState:
    """Seed ``starting_infected`` infections independently per replica."""
    R, n, stride = pe.n_replicas, pe.rep_size, pe.rep_stride
    rng = np.random.default_rng(seed)
    status = np.zeros(R * stride, np.int8)
    for r in range(R):
        status[r * stride + n : (r + 1) * stride] = 5  # inert pad lanes
        idx = rng.choice(n, size=starting_infected, replace=False)
        status[r * stride + idx] = STATUS_INFECTED
    return PackedState(
        status=jnp.asarray(status),
        timer=jnp.zeros(R * stride, jnp.int32),
        sched=jnp.zeros(R * stride, jnp.int8),
        eligible=jnp.zeros(R * stride, bool),
        hour=jnp.int32(0),
        lockdown=jnp.zeros(R, bool),
        mask_status=jnp.full(R, MASK_NONE, jnp.int8),
        vaccination_started=jnp.zeros(R, bool),
        rng_key=jax.random.PRNGKey(seed),
    )


def _rep_lane(vec_r, R, stride):
    """(R,) per-replica vector -> (R*stride,) per-citizen lane (no gather:
    replicas are contiguous equal blocks in every replica-major order)."""
    return jnp.broadcast_to(vec_r[:, None], (R, stride)).reshape(-1)


def derive_step_rng(base_key, hours):
    """Per-step RNG material for a chunk, batched: one vectorised threefry
    pass over the (chunk,) hours instead of a scalar fold_in/split/bits
    chain per scan iteration, so the scan body holds no scalar key
    arithmetic; the chunk runner precomputes these and feeds them through
    scan xs.
    Streams are bitwise-identical to the inline derivation."""

    def one(h):
        key = jax.random.fold_in(base_key, h)
        k_bus, k_h, k_w, k_b, k_vax = jax.random.split(key, 5)
        return (
            k_bus, k_b,
            jax.random.bits(k_h, (), jnp.uint32),
            jax.random.bits(k_w, (), jnp.uint32),
            jax.random.bits(k_vax, (), jnp.uint32),
        )

    return jax.vmap(one)(hours)


def make_perm_rels(world, R, stride):
    """Row-relative ranks of the replica-block-diagonal static permutations
    (pack_replicas keeps citizen/work/rider orders replica-major, so wpos /
    work_perm map block r onto block r, and replica r's riders occupy
    rider slots [r*r_base, (r+1)*r_base)).  Enables row-blocked sorts
    (ops/runsums.py::permute_by_sort_rows) in the work/bus stages — same
    orders bitwise, sort work scales n*log(stride) instead of n*log(N).
    Loop-invariant: chunk runners compute this once, outside the scan."""
    R_riders = world.rider_perm.shape[0]
    r_base = R_riders // max(R, 1)
    base = (jnp.arange(R, dtype=jnp.uint32) * jnp.uint32(stride))[:, None]
    wpos_rel = (
        world.wpos.astype(jnp.uint32).reshape(R, stride) - base
    ).reshape(-1)
    wperm_rel = (
        world.work_perm.astype(jnp.uint32).reshape(R, stride) - base
    ).reshape(-1)
    # rider-order local rank: riders keep their in-replica rider position,
    # non-riders fill [r_base, stride) in lane order — sorting each row and
    # slicing [:, :r_base] reproduces the global rider order exactly.
    rpos2 = world.rpos.astype(jnp.int32).reshape(R, stride)
    rider = rpos2 < R_riders
    nr_rank = jnp.cumsum((~rider).astype(jnp.int32), axis=1) - 1
    rb = (jnp.arange(R, dtype=jnp.int32) * jnp.int32(r_base))[:, None]
    rpos_rel = jnp.where(
        rider, rpos2 - rb, r_base + nr_rank
    ).astype(jnp.uint32).reshape(-1)
    return wpos_rel, wperm_rel, rpos_rel


def packed_step(pe: PackedEnsemble, th, cfg: SimConfig, state: PackedState,
                fused_statics=None, rng=None, perm_rels=None,
                gid0=None, rider_gid0=None):
    """One hour for all R replicas.  Reference semantics per replica
    (simulator.rs:131-152); th = InterventionThresholds (shared).

    Mirrors engine/fastpath.py::fast_step stage for stage; per-replica
    parameters enter the fused citizen phase as (R,) rows (one group per
    replica) and the work/bus/vaccination stages as broadcast lanes over
    the (R, stride) block structure.

    ``rng``: optional pre-derived (k_bus, k_b, seed_h, seed_w, seed_vax)
    for this step (derive_step_rng row); derived inline from
    ``state.rng_key`` when absent — identical streams either way.

    ``gid0`` / ``rider_gid0``: global lane offsets for the replicate-
    sharded runner (parallel/ensemble_mesh.py) — a device holding
    replicas [d*R_l, (d+1)*R_l) passes its first lane's index in the
    full-R packing so every index-keyed draw (home, work, vaccination
    scores — and, under ``cfg.id_keyed_ensemble_rng``, the bus tie/draw
    streams) hashes GLOBAL ids and the sharded trajectory is bitwise the
    single-device full-R packing's.  ``None`` (single-device callers)
    means offset 0.
    """
    world = pe.world
    R, n, stride = pe.n_replicas, pe.rep_size, pe.rep_stride
    N = R * stride
    if perm_rels is None:
        perm_rels = make_perm_rels(world, R, stride)
    wpos_rel, wperm_rel, rpos_rel = perm_rels
    off_u32 = (
        jnp.uint32(0) if gid0 is None else jnp.asarray(gid0, jnp.uint32)
    )

    def lane_u32():
        ids = jnp.arange(N, dtype=jnp.uint32)
        return ids if gid0 is None else ids + off_u32

    id_keyed_bus = (
        bool(cfg.id_keyed_ensemble_rng)
        if cfg.id_keyed_ensemble_rng is not None else False
    )

    hour = state.hour + 1
    if rng is None:
        key = jax.random.fold_in(state.rng_key, hour)
        k_bus, k_h, k_w, k_b, k_vax = jax.random.split(key, 5)
        seed_h = jax.random.bits(k_h, (), jnp.uint32)
        seed_w = jax.random.bits(k_w, (), jnp.uint32)
        seed_vax = jax.random.bits(k_vax, (), jnp.uint32)
    else:
        k_bus, k_b, seed_h, seed_w, seed_vax = rng
    h24 = (hour % 24).astype(jnp.int8)
    move_r = ~state.lockdown  # (R,)

    K = world.max_household_size
    use_fused = use_fused_citizen(cfg, K)

    def trunc(x):
        return truncate_u8(x) if cfg.reference_u8_truncation else x

    def param_lanes():
        """(N,) per-citizen views of the (R,) parameter/state rows — built
        at each use site (inside the gated cond branches) so the conds
        carry (R,) operands instead of materialised N-sized lanes."""
        return (
            _rep_lane(state.mask_status, R, stride),
            _rep_lane(jnp.asarray(pe.chance, jnp.float32), R, stride),
            _rep_lane(
                jnp.asarray(pe.mask_effectiveness, jnp.float32), R, stride
            ),
        )

    if use_fused:
        # Stages 1-4 fused (ops/citizen.py, one group per replica): timers,
        # per-replica movement, per-replica census, household pressure,
        # home draw and the packed cond operand in one pass.
        from ..ops.citizen import citizen_phase, make_citizen_statics

        statics = (
            fused_statics if fused_statics is not None
            else make_citizen_statics(world)
        )
        (status, timer, sched1, fwd_packed, part_r) = citizen_phase(
            statics,
            state.status, state.timer, state.sched,
            h24=h24, move=move_r, mask_status=state.mask_status,
            seed=seed_h,
            exposed_time=pe.exposed_time, infected_time=pe.infected_time,
            exposure_chance=pe.chance,
            mask_effectiveness=pe.mask_effectiveness,
            gid0=off_u32,
            K=K,
            ref_mask_sem=cfg.reference_mask_semantics,
            u8_trunc=cfg.reference_u8_truncation,
            n_groups=R,
        )
        timer = jnp.asarray(timer, jnp.int32)
        hit_home = (fwd_packed & 4) != 0
        seirv0 = part_r[:, :5]
        work_pred = jnp.sum(part_r[:, 5]) > 0
        bus_pred = jnp.sum(part_r[:, 6]) > 0
    else:
        # Unfused formulation — same streams, same values as the fused
        # phase (tests/test_packed.py pins this bitwise).
        s0 = state.sched
        at_work0 = (s0 & 1) != 0
        on_bus0 = (s0 & 2) != 0
        btw0 = (s0 & 4) != 0
        at_work_ws0 = (s0 & 8) != 0
        on_bus_ws0 = (s0 & 16) != 0

        ms_cit, chance_cit, eff_cit = param_lanes()

        class _D:
            exposed_time = _rep_lane(
                jnp.asarray(pe.exposed_time, jnp.int32), R, stride
            )
            infected_time = _rep_lane(
                jnp.asarray(pe.infected_time, jnp.int32), R, stride
            )

        status, timer = _advance_disease(
            state.status, jnp.asarray(state.timer, jnp.int32), _D
        )
        move = _rep_lane(move_r, R, stride)
        at_work, on_bus, btw = _movement(
            h24, world.work_start, world.work_end, world.uses_transport,
            move, at_work0, on_bus0, btw0,
        )
        at_work_ws, on_bus_ws, _ = _movement(
            h24, world.ws_work_start, world.ws_work_end,
            world.ws_uses_transport, move, at_work_ws0, on_bus_ws0, None,
        )

        # per-replica census, post-advance (simulator.rs:178); pads are
        # status 5 and never counted
        st2 = status.reshape(R, stride)
        seirv0 = jnp.stack(
            [jnp.sum((st2 == s).astype(jnp.int32), axis=1) for s in range(5)],
            axis=1,
        )  # (R, 5)

        inf_active = (status == STATUS_INFECTED) & ~on_bus
        wneq = world.work_building != world.home_building
        contrib_home = inf_active & (~at_work | ~wneq)
        if 0 < K <= 24:
            c8 = contrib_home.astype(jnp.int8)
            pos, size = world.hh_pos, world.hh_size
            acc = contrib_home.astype(jnp.int32)
            for dd in range(1, K):
                acc = acc + jnp.where(pos + dd < size, jnp.roll(c8, -dd), 0)
                acc = acc + jnp.where(pos - dd >= 0, jnp.roll(c8, dd), 0)
            n_h = acc
        else:
            n_h = run_totals(
                contrib_home, world.home_start_mask, world.home_end_mask
            )
        p_cit = _exposure_p(
            chance_cit, eff_cit, ms_cit,
            world.mask_compliant, on_bus, cfg.reference_mask_semantics,
        )
        cur_oa = jnp.where(at_work, world.work_oa, world.home_oa)
        q_home = jnp.where(
            cur_oa == world.home_oa,
            binomial_at_least_one(p_cit, trunc(n_h)),
            0.0,
        )
        susceptible = status == STATUS_SUSCEPTIBLE
        hit_home = susceptible & (
            hash_uniform(seed_h, lane_u32()) < q_home
        )
        contrib_work = inf_active & at_work & wneq
        fwd_packed = (
            contrib_work.astype(jnp.int8)
            | (susceptible.astype(jnp.int8) << 1)
            | (hit_home.astype(jnp.int8) << 2)
            | (on_bus.astype(jnp.int8) << 3)
            | ((status == STATUS_INFECTED).astype(jnp.int8) << 4)
        )
        sched1 = (
            at_work.astype(jnp.int8)
            | (on_bus.astype(jnp.int8) << 1)
            | (btw.astype(jnp.int8) << 2)
            | (at_work_ws.astype(jnp.int8) << 3)
            | (on_bus_ws.astype(jnp.int8) << 4)
        )
        work_pred = jnp.any(contrib_work)
        bus_pred = jnp.any(on_bus & (status == STATUS_INFECTED))

    # 5-7. work side, gated like the fast path (fastpath.py work_side): no
    # infected worker at any workplace -> every q is 0, the zero branch is
    # value-identical and skips the two N-sized permutation sorts + scans.
    def work_side(fwd):
        fwd_ws = permute_by_sort_rows(wpos_rel, fwd, R, bits=5)
        contrib_w_ws = (fwd_ws & 1).astype(jnp.int32)
        susc_ws = (fwd_ws & 2) != 0
        hit_home_ws = (fwd_ws & 4) != 0
        n_w_ws = run_totals(
            contrib_w_ws, world.ws_wb_start_mask, world.ws_wb_end_mask
        )
        room_ws = run_totals(
            contrib_w_ws, world.ws_room_start_mask, world.ws_room_end_mask
        )
        draws_ws = jnp.where(
            world.ws_is_school, room_ws, (n_w_ws > 0).astype(jnp.int32)
        )
        at_work_ws_l = (sched1 & 8) != 0
        on_bus_ws_l = (sched1 & 16) != 0
        # ws order is replica-major equal blocks, so the citizen-order
        # broadcast lanes (chance, mask status, effectiveness) are also the
        # ws-order ones; built INSIDE the branch from (R,) rows
        ms_ws, chance_ws, eff_ws = param_lanes()
        p_ws = _exposure_p(
            chance_ws, eff_ws, ms_ws,
            world.ws_mask_compliant, on_bus_ws_l,
            cfg.reference_mask_semantics,
        )
        cur_oa_ws = jnp.where(at_work_ws_l, world.ws_work_oa, world.ws_home_oa)
        q_single = binomial_at_least_one(p_ws, trunc(n_w_ws))
        q_work_ws = jnp.where(
            (cur_oa_ws == world.ws_work_oa) & world.ws_work_neq_home,
            -jnp.expm1(draws_ws.astype(jnp.float32) * jnp.log1p(-q_single)),
            0.0,
        )
        u_w = hash_uniform(seed_w, lane_u32())
        hit_work_ws = susc_ws & ~hit_home_ws & (u_w < q_work_ws)
        # hits are few on most hours: ship them back to citizen order as a
        # K-bounded compaction + scatter instead of a second N-sized
        # permutation sort; dense (row-sorted) fallback past K keeps the
        # lane bitwise-identical at any hit count.  BOTH strategies live
        # inside the cond so mid-epidemic hours (ensembles: hits >> K on
        # every work hour near the peaks) don't also pay the compaction +
        # full-lane scatter.
        from ..ops.sparse import compact_positions, scatter_bits

        KS = cfg.sparse_transport_slots
        cnt = jnp.sum(hit_work_ws.astype(jnp.int32))

        def sparse_ret(lane):
            pos, live, _ = compact_positions(lane, KS)
            cit_idx = jnp.take(world.work_perm, jnp.minimum(pos, N - 1))
            return scatter_bits(N, cit_idx, live)

        def dense_ret(lane):
            return permute_by_sort_rows(
                wperm_rel, lane.astype(jnp.int8), R, bits=1
            ).astype(bool)

        return jax.lax.cond(cnt > KS, dense_ret, sparse_ret, hit_work_ws)

    hit_work = jax.lax.cond(
        work_pred,
        work_side,
        lambda _: jnp.zeros((N,), bool),
        fwd_packed,
    )

    # 8. bus side: rider-order bits via the rpos packed sort (no gather);
    #    per-rider mask-adjusted chance rides the shuffle sort.  Gated like
    #    the fast path (bus_pred): no infected rider -> n_bus=0 -> q=0
    #    everywhere, so the zero branch is value-identical.
    rp = world.rider_perm
    R_riders = rp.shape[0]
    r_base = R_riders // max(R, 1)
    # pack_replicas guarantees equal rider blocks per replica; any other
    # World handed in must fail loudly, not mis-align every rider lane
    assert R_riders == R * r_base, (
        f"packed rider count {R_riders} is not a multiple of "
        f"n_replicas={R}; per-replica rider lanes would mis-align"
    )

    def bus_side(gates):
        # row-blocked variant of permute_by_sort(world.rpos, gates)[:R_riders]
        # — riders sort to the head of each replica row (make_perm_rels),
        # so the per-row slice IS the global rider order, without sorting
        # the non-rider 80% at global log(N) cost.
        packed_keys = (rpos_rel << 5) | gates.astype(jnp.uint32)
        out2d = jax.lax.sort(
            packed_keys.reshape(R, stride), dimension=1, is_stable=False
        )
        pk = (
            out2d[:, :r_base].reshape(-1) & jnp.uint32(31)
        ).astype(jnp.int8)
        rb_on = (pk & 8) != 0
        rb_inf = (pk & 16) != 0
        rb_susc = (pk & 2) != 0
        # rider order is replica-major with equal blocks (same base riders;
        # pads never ride)
        def rep_rider(vec_r, dtype):
            return jnp.broadcast_to(
                jnp.asarray(vec_r, dtype)[:, None], (R, r_base)
            ).reshape(-1)

        ms_r = rep_rider(state.mask_status, state.mask_status.dtype)
        ch_r = rep_rider(pe.chance, jnp.float32)
        eff_r = rep_rider(pe.mask_effectiveness, jnp.float32)
        compliant_r = world.rider_mask_compliant
        if cfg.reference_mask_semantics:
            active_r = (ms_r == MASK_EVERYWHERE) & ~compliant_r
        else:
            active_r = compliant_r & (
                (ms_r == MASK_EVERYWHERE)
                | ((ms_r == MASK_PUBLIC_TRANSPORT) & rb_on)
            )
        rb_chance = jnp.asarray(
            ch_r * jnp.where(active_r, 1.0 - eff_r, 1.0),
            jnp.float32,
        )
        if id_keyed_bus:
            # Shard-invariant bus streams: ties and exposure draws hash
            # GLOBAL rider ids instead of riding counter-based
            # key-generation over the local lane length (segments.py
            # bus_hits docstring) — a replicate shard reproduces its
            # slice of the full-R streams exactly.
            roff = (
                jnp.uint32(0) if rider_gid0 is None
                else jnp.asarray(rider_gid0, jnp.uint32)
            )
            seed_tie = jax.random.bits(k_bus, (), jnp.uint32)
            seed_draw = jax.random.bits(k_b, (), jnp.uint32)
            tie_bits = hash_bits(
                seed_tie, roff + jnp.arange(R_riders, dtype=jnp.uint32)
            )
            return bus_hits(
                k_bus, k_b, rb_on, rb_inf, rb_susc, compliant_r,
                world.rider_route, rp, cfg.bus_capacity,
                lambda c, v, chance: chance, N,
                rb_chance=rb_chance,
                tie_bits=tie_bits, draw_seed=seed_draw, rider_gid0=roff,
            )[0]
        return bus_hits(
            k_bus, k_b, rb_on, rb_inf, rb_susc, compliant_r,
            world.rider_route, rp, cfg.bus_capacity,
            lambda c, v, chance: chance, N,
            rb_chance=rb_chance,
        )[0]

    hit_bus = jax.lax.cond(
        bus_pred,
        bus_side,
        lambda _: jnp.zeros((N,), bool),
        fwd_packed,
    )

    # 9. combine (the fused phase already applied hit_home; the dense
    # re-apply is idempotent, so both paths stay bitwise-identical)
    newly_exposed = hit_home | hit_work | hit_bus
    status = jnp.where(newly_exposed, jnp.int8(STATUS_EXPOSED), status)
    timer = jnp.where(newly_exposed, 0, timer)
    from_bus = hit_bus & ~hit_home & ~hit_work
    if cfg.faithful_vaccine_bugs:
        eligible = state.eligible & ~from_bus
    else:
        eligible = state.eligible & ~newly_exposed

    n_new_r = jnp.sum(
        newly_exposed.reshape(R, stride).astype(jnp.int32), axis=1
    )
    seirv = (
        seirv0.at[:, STATUS_SUSCEPTIBLE].add(-n_new_r)
        .at[:, STATUS_EXPOSED].add(n_new_r)
    )

    # 10. interventions per replica (interventions.rs:110-184); the infected
    #     fraction divides by the REAL replica population, not the stride
    pct = seirv[:, STATUS_INFECTED].astype(jnp.float32) / jnp.float32(n)
    lockdown = (th.lockdown >= 0) & (th.lockdown < pct)
    newly_started = (
        ~state.vaccination_started
        & (th.vaccination >= 0) & (th.vaccination < pct)
    )
    vaccination_started = state.vaccination_started | newly_started
    eligible = jnp.where(
        _rep_lane(newly_started, R, stride),
        status == STATUS_SUSCEPTIBLE, eligible,
    )
    ms = state.mask_status
    ms_next = jnp.where(
        ms == MASK_NONE,
        jnp.where(pct > th.mask_public_transport, MASK_PUBLIC_TRANSPORT,
                  MASK_NONE),
        jnp.where(
            ms == MASK_PUBLIC_TRANSPORT,
            jnp.where(
                pct < th.mask_public_transport, MASK_NONE,
                jnp.where(pct > th.mask_everywhere, MASK_EVERYWHERE,
                          MASK_PUBLIC_TRANSPORT),
            ),
            jnp.where(pct < th.mask_everywhere, MASK_PUBLIC_TRANSPORT,
                      MASK_EVERYWHERE),
        ),
    ).astype(jnp.int8)

    # 11. vaccination: exact-k per replica (simulator.rs:524-553), gated on
    #     any replica having started
    def vaccinate(args):
        status, eligible = args
        scores = hash_bits(seed_vax, lane_u32()).reshape(R, stride)
        elig2 = eligible.reshape(R, stride)
        started = vaccination_started
        k_r = jnp.where(
            started,
            jnp.minimum(
                jnp.asarray(pe.vaccination_rate, jnp.int32),
                jnp.sum(elig2.astype(jnp.int32), axis=1),
            ),
            0,
        )
        tau = jax.vmap(_kth_score_threshold)(scores, elig2, k_r)
        below = elig2 & (scores < tau[:, None])
        at = elig2 & (scores == tau[:, None])
        allowed = k_r - jnp.sum(below.astype(jnp.int32), axis=1)
        at_rank = jnp.cumsum(at.astype(jnp.int32), axis=1)
        chosen = (below | (at & (at_rank <= allowed[:, None])))
        chosen = (chosen & started[:, None] & (k_r > 0)[:, None]).reshape(-1)
        new_status = jnp.where(chosen, jnp.int8(STATUS_VACCINATED), status)
        new_elig = eligible
        if not cfg.faithful_vaccine_bugs:
            new_elig = eligible & ~chosen
            new_status = jnp.where(
                chosen & (status != STATUS_SUSCEPTIBLE), status, new_status
            )
        return new_status, new_elig

    # Gate on any ELIGIBLE citizen, not any started replica: eligible lanes
    # are only true between a replica's activation and its pool draining
    # (~pool/rate steps), so the cond stops firing for the rest of the run
    # — with 64 replicas SOME replica latches early and would otherwise
    # pin the cond on for every remaining step.  Value-identical: no
    # eligible => every k_r
    # is min(rate, 0) = 0 => nobody chosen.
    status, eligible = jax.lax.cond(
        jnp.any(eligible),
        vaccinate,
        lambda args: args,
        (status, eligible),
    )

    new_state = PackedState(
        status=status, timer=timer, sched=sched1,
        eligible=eligible, hour=hour, lockdown=lockdown,
        mask_status=ms_next, vaccination_started=vaccination_started,
        rng_key=state.rng_key,
    )
    return new_state, seirv


def make_packed_runner(pe: PackedEnsemble, cfg: SimConfig):
    """jitted chunk(thresholds, state) -> (state, (chunk, R, 5))."""
    s = jax.sharding.SingleDeviceSharding(jax.devices()[0])

    use_fused = use_fused_citizen(cfg, pe.world.max_household_size)

    def chunk(pe_d, th, state):
        if use_fused:
            from ..ops.citizen import make_citizen_statics

            statics = make_citizen_statics(pe_d.world)  # loop-invariant
        else:
            statics = None
        rels = make_perm_rels(
            pe_d.world, pe_d.n_replicas, pe_d.rep_stride
        )  # loop-invariant

        # Per-step RNG material precomputed OUTSIDE the scan in one batched
        # threefry pass and fed through scan xs (see derive_step_rng).  The
        # key itself leaves the carry entirely.
        base_key = state.rng_key
        state = dataclasses.replace(state, rng_key=None)
        hours = state.hour + 1 + jnp.arange(cfg.chunk_size, dtype=jnp.int32)
        xs = derive_step_rng(base_key, hours)

        def body(carry, x):
            ns, seirv = packed_step(
                pe_d, th, cfg, carry, fused_statics=statics, rng=x,
                perm_rels=rels,
            )
            return ns, seirv

        state, seirv_t = jax.lax.scan(body, state, xs,
                                      length=cfg.chunk_size)
        return dataclasses.replace(state, rng_key=base_key), seirv_t

    jitted = jax.jit(chunk, donate_argnums=(2,), in_shardings=(s, s, s))
    pe_d = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x), s)
        if hasattr(x, "shape") else x,
        pe,
    )

    def run_chunk(th, state):
        return jitted(pe_d, th, state)

    return run_chunk


def ensemble_done(seirv_row, early_exit: str = "sei"):
    """Whether every replica's run is over, from one (R, 5) census row.

    ``early_exit="sei"`` (default) is the faithful reference semantics:
    ``disease_exists = S+E+I > 0`` (statistics.rs:289-291) — a run ends
    only when vaccination + recovery have emptied all three pools, so a
    dead epidemic keeps stepping while the vaccination campaign drains S.
    ``early_exit="ei"`` stops as soon as no exposure can ever happen again
    (E+I == 0) — a benchmarking shortcut that skips the epidemiologically
    inert tail; documented as a divergence in docs/FIDELITY.md.
    """
    if early_exit == "sei":
        return not bool((seirv_row[:, :3].sum(axis=1) > 0).any())
    if early_exit == "ei":
        return not bool((seirv_row[:, 1:3].sum(axis=1) > 0).any())
    raise ValueError(f"early_exit must be 'sei' or 'ei', got {early_exit!r}")


def run_packed_ensemble(base: World, param_list: list[Params],
                        cfg: SimConfig, *, seed: int = 0,
                        block_rows: int = 128, early_exit: str = "sei"):
    """Pack, run to cfg.max_steps (early exit per :func:`ensemble_done` —
    default faithful S+E+I semantics, statistics.rs:289-291); returns
    (R, T, 5) SEIRV series.  Thresholds are swept per replica ((R,) rows —
    the intervention comparisons broadcast against the (R,) census)."""
    pe = pack_replicas(base, param_list, block_rows=block_rows)
    state = init_packed_state(
        pe, seed=seed, starting_infected=cfg.starting_infected
    )
    th = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[p.as_arrays().thresholds for p in param_list],
    )
    runner = make_packed_runner(pe, cfg)
    chunks = []
    steps = 0
    while steps < cfg.max_steps:
        state, seirv = runner(th, state)
        seirv = np.asarray(seirv)  # (chunk, R, 5)
        chunks.append(seirv)
        steps += cfg.chunk_size
        if ensemble_done(seirv[-1], early_exit):
            break
    out = np.concatenate(chunks, axis=0)[: cfg.max_steps]
    return np.transpose(out, (1, 0, 2))
