"""Segment reductions and the per-step bus grouping kernel.

The reference's exposure machinery walks per-building occupant lists behind
mutexes (simulator.rs:262-405).  Here the same semantics are one
``segment_sum`` per mixing-group namespace plus gathers — shape-stable,
fully vectorised, and fusable by XLA.

The hard case is public transport: the reference *shuffles* each route's
riders and chunks them into capacity-20 buses every step
(simulator.rs:360-401, public_transport_route.rs:78-87).  We express that as
a key-sort: sort riders by (route, random tiebreak); a random tiebreak within
equal route keys IS a uniform shuffle of that route's riders; contiguous
chunks of 20 in sorted order are then exactly the reference's buses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .maths import binomial_at_least_one

# NOTE: keep this a Python int, NOT a jnp scalar: module-level device
# constants get hoisted as hidden executable inputs by jax's constant
# handling.
_INT32_MAX = 2**31 - 1


def count_per_segment(values, segment_ids, num_segments: int):
    """segment_sum with int32 accumulation."""
    return jax.ops.segment_sum(
        jnp.asarray(values, jnp.int32), segment_ids, num_segments=num_segments
    )


def bus_infection_counts(key, on_bus, route_key, infected, capacity: int):
    """Assign riders to buses and return per-citizen infected-on-my-bus counts.

    Parameters
    ----------
    key: PRNG key for this step's shuffle.
    on_bus: (N,) bool — riding this step.
    route_key: (N,) int32 — dense (src_oa, dst_oa) route id; ignored for
        non-riders.
    infected: (N,) bool — rider is infected (contributes exposure on the bus).
    capacity: bus capacity (static; config.rs:37 = 20).

    Returns
    -------
    n_inf_my_bus: (N,) int32 — number of infected riders sharing the citizen's
        bus this step (0 for non-riders).

    Semantics matched to the reference: riders of one (src, dst) route are
    shuffled uniformly (simulator.rs:362) and packed into buses of exactly
    ``capacity`` with one trailing partial bus (public_transport_route.rs:79).
    Exposure strength on a bus is its total infected count
    (simulator.rs:385-387), evaluated per rider later.
    """
    n = on_bus.shape[0]
    rk = jnp.where(on_bus, route_key, _INT32_MAX)
    # Random minor key: equal-route riders land in uniformly random relative
    # order == the reference's Vec::shuffle.
    tiebreak = jax.random.bits(key, (n,), dtype=jnp.uint32).astype(jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    rk_s, _, idx_s = jax.lax.sort((rk, tiebreak, idx), num_keys=2)

    inf_s = jnp.take(infected, idx_s).astype(jnp.int32)

    # Route-run starts in sorted order -> position within route -> bus id.
    boundary = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), rk_s[1:] != rk_s[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(boundary, idx, 0))
    pos_in_route = idx - seg_start
    # Each bus is identified by the sorted index of its first rider.
    bus_first = seg_start + (pos_in_route // capacity) * capacity

    n_inf_bus = jax.ops.segment_sum(inf_s, bus_first, num_segments=n)
    n_my_bus = jnp.take(n_inf_bus, bus_first)
    valid = rk_s != _INT32_MAX
    n_my_bus = jnp.where(valid, n_my_bus, 0)

    # Scatter back to citizen order.
    out = jnp.zeros((n,), jnp.int32).at[idx_s].set(n_my_bus, mode="drop")
    return out


def bus_exposure_probability(p_exposure, n_inf_my_bus):
    """Per-rider probability of exposure on their bus.

    ``Citizen::expose`` with ``exposure_total = bus.exposure_count``
    (simulator.rs:385-400): binomial(p, n) with at-least-one-success form.
    n <= capacity = 20, so the u8 truncation (citizen.rs:239) cannot trigger.
    """
    return jnp.where(
        n_inf_my_bus > 0,
        binomial_at_least_one(p_exposure, n_inf_my_bus),
        0.0,
    )


def bus_hits_sortless(
    key_shuffle,
    key_draw,
    rb_on,
    rb_inf,
    rb_compliant,
    rider_route,
    rider_citizen_id,
    capacity: int,
    exposure_p_fn,
    susc_of_rider,
    max_hits: int = 16384,
):
    """:func:`bus_hits` with the rider-order *input* lanes built without
    the N-sized citizen->rider permutation sort, and the susceptibility
    filter deferred to the compacted hit candidates.

    Callers supply ``rb_on`` computed from static rider schedule lanes
    (valid on moving steps only — frozen lockdown hours must take the
    sorted path), ``rb_inf`` as a K-bounded sparse scatter of the few
    infected riders, and ``susc_of_rider(rider_ids) -> bool`` reading the
    susceptible bit back in citizen order.  The hit set is then
    bitwise-identical to :func:`bus_hits`: the shuffle sort's ORDER
    depends only on (route, tiebreak) — the payload's missing
    susceptible bit and the tail-region infected bits of non-riding
    infected citizens never influence a key, a valid-region count, or a
    draw; the post-draw candidate set (``u < q`` — already the tiny
    post-RNG set) is compacted with the block hierarchy instead of a
    second full sort, and susceptibility gates the compacted slots.

    Returns ``(rider_lane, rider_ids, live, n_hits, cit_ids, cand_total)``
    — the first five exactly as :func:`bus_hits`'s sparse outputs, valid
    only while ``cand_total <= max_hits``; callers must branch to
    :func:`bus_hits` past that (simulator.rs:360-401 peak hours).
    """
    from .runsums import run_totals
    from .sparse import block_hierarchy, compact_from_hierarchy

    r = rb_on.shape[0]
    if r == 0:
        return (
            jnp.zeros((0,), bool),
            jnp.zeros((0,), jnp.int32),
            jnp.zeros((0,), bool),
            jnp.int32(0),
            jnp.zeros((0,), jnp.int32),
            jnp.int32(0),
        )
    rk = jnp.where(rb_on, rider_route, _INT32_MAX)
    tie = jax.random.bits(key_shuffle, (r,), dtype=jnp.uint32).astype(jnp.int32)
    idx = jnp.arange(r, dtype=jnp.uint32)
    payload = (
        (idx << 3)
        | (rb_inf.astype(jnp.uint32) << 2)
        | rb_compliant.astype(jnp.uint32)
    )
    rk_s, _, pay_s = jax.lax.sort((rk, tie, payload), num_keys=2)

    pos_i = jnp.arange(r, dtype=jnp.int32)
    boundary = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), rk_s[1:] != rk_s[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(boundary, pos_i, 0))
    pos_in_route = pos_i - seg_start
    bus_start = boundary | (pos_in_route % capacity == 0)
    bus_end = jnp.concatenate([bus_start[1:], jnp.ones((1,), jnp.bool_)])

    inf_s = ((pay_s >> 2) & 1).astype(jnp.int32)
    n_bus = run_totals(inf_s, bus_start, bus_end)

    valid = rk_s != _INT32_MAX
    compliant_s = (pay_s & 1) != 0
    p = exposure_p_fn(compliant_s, valid)
    q = jnp.where(valid & (n_bus > 0), binomial_at_least_one(p, n_bus), 0.0)
    cand = valid & (jax.random.uniform(key_draw, (r,)) < q)

    k_top = min(max_hits, r)
    pos, live_c, cand_total = compact_from_hierarchy(
        block_hierarchy(cand, block=128), k_top, n=r, sb=128
    )
    rider_ids = jnp.asarray(
        jnp.take(pay_s, jnp.minimum(pos, r - 1)) >> 3, jnp.int32
    )
    live = live_c & susc_of_rider(rider_ids)
    cit_ids = jnp.take(
        rider_citizen_id, jnp.minimum(rider_ids, r - 1), mode="clip"
    )
    n_hits = jnp.sum(live.astype(jnp.int32))
    rider_lane = (
        jnp.zeros((r,), bool)
        .at[jnp.where(live, rider_ids, r)]
        .set(True, mode="drop")
    )
    return rider_lane, rider_ids, live, n_hits, cit_ids, cand_total


def bus_hits(
    key_shuffle,
    key_draw,
    rb_on,
    rb_inf,
    rb_susc,
    rb_compliant,
    rider_route,
    rider_citizen_id,
    capacity: int,
    exposure_p_fn,
    n_citizens: int,
    max_hits: int = 16384,
    want_cit_lane: bool = True,
    rb_chance=None,
    tie_bits=None,
    draw_seed=None,
    rider_gid0=None,
):
    """Gather-free bus exposure.

    Returns ``(cit_lane, rider_lane, rider_ids, live, n_hits, cit_ids)``:
    the (n_citizens,) bool hit lane ((0,) when ``want_cit_lane`` is False —
    the sparse-apply caller scatters ``cit_ids`` itself), the (R,)
    rider-order hit lane (exact in BOTH compaction regimes), the
    compacted rider-order hit slots (max_hits,) with their live mask, and
    the exact hit count (compaction is exact only while
    ``n_hits <= max_hits`` — both lanes fall back to dense scatters past
    that).

    Same semantics as :func:`bus_infection_counts` + the per-rider draw
    (simulator.rs:360-401): shuffle each route's riders, chunk into
    capacity-sized buses, expose susceptible riders with binomial(p, infected
    on my bus).  The per-index-serial ops of the v1 formulation (one r-sized
    gather for infected bits, a segment_sum, two r-sized gathers for bus
    counts, one r-sized scatter back) are
    replaced by sort payloads, contiguous-run sums and a sparse hit return:

    * inf/susc/compliant bits and the rider index ride the shuffle sort as a
      packed u32 payload (`idx<<3 | inf<<2 | susc<<1 | compliant`);
    * buses are contiguous runs in sorted order, so per-bus infected counts
      are boundary-masked run totals (ops/runsums.py), no segment_sum;
    * exposure draws run in sorted order; successful hits are compacted by
      one u32 sort and scattered sparsely (hits per step are few; a dense
      scatter fallback guards the >max_hits case).

    ``exposure_p_fn(compliant_bool, on_bus_bool) -> f32`` supplies the
    mask-adjusted exposure chance.

    ``rb_chance``: optional (R,) f32 per-rider mask-adjusted exposure
    chance (packed-replica ensembles sweep exposure_chance per replica).
    It rides the shuffle sort as an extra operand and exposure_p_fn is
    then called as ``exposure_p_fn(compliant, on_bus, chance_sorted)``.

    ``tie_bits`` / ``draw_seed`` + ``rider_gid0``: shard-offsetable RNG
    (sharded packed ensembles, engine/packed.py).  The default streams
    are COUNTER-based (``random.bits(key,(r,))`` ties in lane order;
    ``random.uniform(key,(r,))`` draws in SORTED order) and therefore
    depend on the lane length and on other replicas' rider counts — a
    shard slab cannot reproduce its slice of them.  Passing a
    precomputed (r,) ``tie_bits`` lane and a scalar ``draw_seed`` keys
    the exposure draw by RIDER ID (``hash_uniform(draw_seed,
    rider_gid0 + rider_id)`` — order-independent), so per-replica
    streams are identical at any sharding.  Law-identical either way
    (iid ties / iid uniforms); default callers (fastpath, fastmesh) are
    untouched bitwise.
    """
    from .runsums import run_totals

    r = rb_on.shape[0]
    if r == 0:
        return (
            jnp.zeros((n_citizens if want_cit_lane else 0,), bool),
            jnp.zeros((0,), bool),
            jnp.zeros((0,), jnp.int32),
            jnp.zeros((0,), bool),
            jnp.int32(0),
            jnp.zeros((0,), jnp.int32),
        )
    rk = jnp.where(rb_on, rider_route, _INT32_MAX)
    if tie_bits is not None:
        tie = jnp.asarray(tie_bits, jnp.uint32).astype(jnp.int32)
    else:
        tie = jax.random.bits(
            key_shuffle, (r,), dtype=jnp.uint32
        ).astype(jnp.int32)
    idx = jnp.arange(r, dtype=jnp.uint32)
    payload = (
        (idx << 3)
        | (rb_inf.astype(jnp.uint32) << 2)
        | (rb_susc.astype(jnp.uint32) << 1)
        | rb_compliant.astype(jnp.uint32)
    )
    if rb_chance is not None:
        rk_s, _, pay_s, chance_s = jax.lax.sort(
            (rk, tie, payload, jnp.asarray(rb_chance, jnp.float32)),
            num_keys=2,
        )
    else:
        rk_s, _, pay_s = jax.lax.sort((rk, tie, payload), num_keys=2)
        chance_s = None

    pos_i = jnp.arange(r, dtype=jnp.int32)
    boundary = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), rk_s[1:] != rk_s[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(boundary, pos_i, 0))
    pos_in_route = pos_i - seg_start
    bus_start = boundary | (pos_in_route % capacity == 0)
    bus_end = jnp.concatenate([bus_start[1:], jnp.ones((1,), jnp.bool_)])

    inf_s = ((pay_s >> 2) & 1).astype(jnp.int32)
    n_bus = run_totals(inf_s, bus_start, bus_end)

    valid = rk_s != _INT32_MAX
    susc_s = (pay_s & 2) != 0
    compliant_s = (pay_s & 1) != 0
    if chance_s is not None:
        p = exposure_p_fn(compliant_s, valid, chance_s)
    else:
        p = exposure_p_fn(compliant_s, valid)
    q = jnp.where(valid & (n_bus > 0), binomial_at_least_one(p, n_bus), 0.0)
    if draw_seed is not None:
        from .hashrng import hash_uniform

        g0 = jnp.uint32(0) if rider_gid0 is None else jnp.asarray(
            rider_gid0, jnp.uint32
        )
        u = hash_uniform(draw_seed, (pay_s >> 3) + g0)
    else:
        u = jax.random.uniform(key_draw, (r,))
    hit = susc_s & valid & (u < q)

    # Sparse return: compact hit payloads to the front with one u32 sort,
    # then scatter only those (few) citizen ids.
    hit_key = jnp.where(hit, pay_s, jnp.uint32(0xFFFFFFFF))
    k_top = min(max_hits, r)
    compact = jax.lax.sort(hit_key)[:k_top]
    live = compact != jnp.uint32(0xFFFFFFFF)
    rider_ids = jnp.asarray(compact >> 3, jnp.int32)
    cit_ids = jnp.take(
        rider_citizen_id, jnp.minimum(rider_ids, r - 1), mode="clip"
    )
    n_hits = jnp.sum(hit.astype(jnp.int32))
    if want_cit_lane:
        sparse = (
            jnp.zeros((n_citizens,), bool)
            .at[jnp.where(live, cit_ids, n_citizens)]
            .set(True, mode="drop")
        )

        def dense(_):
            cit_all = jnp.take(
                rider_citizen_id, jnp.asarray(pay_s >> 3, jnp.int32)
            )
            return (
                jnp.zeros((n_citizens,), bool)
                .at[jnp.where(hit, cit_all, n_citizens)]
                .set(True, mode="drop")
            )

        cit_lane = jax.lax.cond(
            n_hits > k_top, dense, lambda _: sparse, None
        )
    else:
        cit_lane = jnp.zeros((0,), bool)
    # Rider-order hit lane for the replicated-order engine: the compact
    # payload indices ARE rider-order slots; the dense branch scatters the
    # sorted lane back through the shuffle payload.
    def rider_dense(_):
        return (
            jnp.zeros((r,), bool)
            .at[jnp.where(hit, jnp.asarray(pay_s >> 3, jnp.int32), r)]
            .set(True, mode="drop")
        )

    rider_lane = jax.lax.cond(
        n_hits > k_top,
        rider_dense,
        lambda _: (
            jnp.zeros((r,), bool)
            .at[jnp.where(live, rider_ids, r)]
            .set(True, mode="drop")
        ),
        None,
    )
    return cit_lane, rider_lane, rider_ids, live, n_hits, cit_ids
