"""Fused citizen phase: fast-path stages 1-4 as one plain-XLA function.

Covers disease-timer advance (disease.rs:47-71), schedule movement for both
the citizen-order state and its work-order twin (citizen.rs:168-216), the
post-advance SEIRV census (simulator.rs:178), household infection pressure
as a shift-window sum over the static household layout (building.rs:
202-204), the per-citizen exposure chance (disease.rs:131-154), the
home-exposure Bernoulli draw (citizen.rs:221-248), and the packed int8
operand for the work-side / bus-side ``lax.cond`` branches.

Everything is elementwise over flat (N,) lanes plus a K <= 24 shift window,
which XLA fuses on its own; the only reductions are the eight per-group
counts.  The statics are bit-packed (11 int8 lanes become 5) and the five
schedule bools ride one packed int8 ``sched`` lane, so the phase reads
about 8 lanes and writes 4.

The draws are the unfused fast path's (engine/fastpath.py): the same
``binomial_at_least_one`` chance and the same counter-hash uniforms
(ops/hashrng.py) keyed on the global citizen id, so both formulations
produce bitwise-identical trajectories.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import (
    MASK_EVERYWHERE,
    MASK_PUBLIC_TRANSPORT,
    STATUS_EXPOSED,
    STATUS_INFECTED,
    STATUS_RECOVERED,
    STATUS_SUSCEPTIBLE,
    TIMER_DTYPE,
)
from .hashrng import hash_uniform
from .maths import binomial_at_least_one, truncate_u8

# sched bit assignments (must match engine/state.py::pack_sched)
SCHED_AT_WORK = 1
SCHED_ON_BUS = 2
SCHED_BUS_TO_WORK = 4
SCHED_AT_WORK_WS = 8
SCHED_ON_BUS_WS = 16

#: Columns of the per-group counts returned by :func:`citizen_phase`.
COUNT_CONTRIB_WORK = 5
COUNT_INFECTED_ON_BUS = 6
COUNT_HOME_HITS = 7


class CitizenStatics(NamedTuple):
    """Static world lanes of the citizen phase, bit-packed into five (N,)
    int8 lanes (work hours 0-24 and household fields < 32 fit 5 bits; the
    phase requires max_household_size <= 24):

    * ``a``: work_start | uses_transport<<5 | work_neq_home<<6
    * ``b``: work_end | (hh_pos & 7)<<5
    * ``c``: (hh_pos >> 3) | hh_size<<2
    * ``d``: ws_work_start | mask_compliant<<5 | same_oa<<6
    * ``e``: ws_work_end | ws_uses_transport<<5
    """

    a: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray
    d: jnp.ndarray
    e: jnp.ndarray


def pack_citizen_statics(*, work_start, work_end, uses_transport,
                         work_neq_home, hh_pos, hh_size, mask_compliant,
                         same_oa, ws_work_start=None, ws_work_end=None,
                         ws_uses_transport=None) -> CitizenStatics:
    """Bit-pack per-citizen static lanes.  The work-order twin lanes may be
    omitted (the sharded engine carries no twin); their bits are then 0."""
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    zero = jnp.zeros_like(i32(work_start))
    ws_ws = zero if ws_work_start is None else i32(ws_work_start)
    ws_we = zero if ws_work_end is None else i32(ws_work_end)
    ws_uses = zero if ws_uses_transport is None else i32(ws_uses_transport)
    pos = i32(hh_pos)
    i8 = lambda x: x.astype(jnp.int8)
    return CitizenStatics(
        a=i8(i32(work_start) | (i32(uses_transport) << 5)
             | (i32(work_neq_home) << 6)),
        b=i8(i32(work_end) | ((pos & 7) << 5)),
        c=i8((pos >> 3) | (i32(hh_size) << 2)),
        d=i8(ws_ws | (i32(mask_compliant) << 5) | (i32(same_oa) << 6)),
        e=i8(ws_we | (ws_uses << 5)),
    )


def make_citizen_statics(world) -> CitizenStatics:
    """Statics of a fast-table World; call once per chunk (outside the
    scan) so the packing is loop-invariant."""
    return pack_citizen_statics(
        work_start=world.work_start,
        work_end=world.work_end,
        uses_transport=world.uses_transport,
        work_neq_home=world.work_building != world.home_building,
        hh_pos=world.hh_pos,
        hh_size=world.hh_size,
        mask_compliant=world.mask_compliant,
        same_oa=world.work_oa == world.home_oa,
        ws_work_start=world.ws_work_start,
        ws_work_end=world.ws_work_end,
        ws_uses_transport=world.ws_uses_transport,
    )


def _movement(h24, move, ws, we, uses, at_work, on_bus):
    """citizen.rs:168-216 schedule match, frozen under lockdown."""
    arm_bus_out = (h24 == ws - 1) & uses
    arm_to_work = h24 == ws
    arm_bus_home = (h24 == we - 1) & uses
    arm_to_home = h24 == we
    on_bus1 = jnp.where(move, arm_bus_out | arm_bus_home, on_bus)
    at_work1 = jnp.where(
        move,
        jnp.where(arm_to_work, True, jnp.where(arm_to_home, False, at_work)),
        at_work,
    )
    return at_work1, on_bus1, arm_bus_out


@functools.partial(
    jax.jit, static_argnames=("K", "ref_mask_sem", "u8_trunc", "n_groups")
)
def citizen_phase(
    statics: CitizenStatics,
    status, timer, sched,
    *, h24, move, mask_status, seed, exposed_time, infected_time,
    exposure_chance, mask_effectiveness, gid0=0,
    K, ref_mask_sem, u8_trunc, n_groups=1,
):
    """Run the fused citizen phase over flat (N,) lanes.

    ``sched`` carries the five schedule bools packed int8 (bits 0-4:
    at_work, on_bus, bus_to_work, at_work_ws, on_bus_ws; see
    engine/state.py::pack_sched).  ``seed`` is the step's home-draw seed
    (uint32) and ``gid0`` the global citizen id of lane 0: nonzero only for
    shards of a partitioned world (parallel/fastmesh.py) or replicate
    shards of a packed ensemble, so their streams equal the single-device
    ones.

    ``n_groups`` splits the lanes into that many equal contiguous spans
    (the replicas of a packed ensemble, engine/packed.py).  ``move``,
    ``mask_status``, ``exposed_time``, ``infected_time``,
    ``exposure_chance`` and ``mask_effectiveness`` are then (n_groups,)
    rows, one per span; with one group they are scalars.

    Returns ``(status1, timer1, sched1, gates, counts)``: (N,) lanes plus
    ``counts`` (n_groups, 8) int32 = [S, E, I, R, V, n_contrib_work,
    n_infected_on_bus, n_home_hits] per group.  ``gates`` packs the work
    AND bus cond operands into one int8 lane: contrib_work |
    susceptible<<1 | hit_home<<2 | on_bus<<3 | infected<<4.  The census
    columns are PRE-exposure (simulator.rs:178); status/timer already have
    this step's home hits applied (hit_home itself is bit 2 of gates).
    """
    n = status.shape[0]
    if n % n_groups:
        raise ValueError(f"{n} lanes do not split into {n_groups} groups")

    def lane(x, dtype):
        """Per-lane view of a scalar or an (n_groups,) row."""
        x = jnp.asarray(x, dtype)
        if x.ndim == 0:
            return x
        return jnp.broadcast_to(x[:, None], (n_groups, n // n_groups)).reshape(-1)

    move = lane(move, bool)
    mask_status = lane(mask_status, jnp.int8)
    e_time = lane(exposed_time, jnp.int32)
    i_time = lane(infected_time, jnp.int32)
    chance = lane(exposure_chance, jnp.float32)
    mask_eff = lane(mask_effectiveness, jnp.float32)

    pa = statics.a.astype(jnp.int32)
    pb = statics.b.astype(jnp.int32)
    pc = statics.c.astype(jnp.int32)
    pd = statics.d.astype(jnp.int32)
    pe = statics.e.astype(jnp.int32)
    ws = pa & 31
    uses = ((pa >> 5) & 1) != 0
    wneq = ((pa >> 6) & 1) != 0
    we = pb & 31
    pos = ((pb >> 5) & 7) | ((pc & 3) << 3)
    size = (pc >> 2) & 31
    ws_ws = pd & 31
    compliant = ((pd >> 5) & 1) != 0
    same_oa = ((pd >> 6) & 1) != 0
    ws_we = pe & 31
    ws_uses = ((pe >> 5) & 1) != 0

    s = sched.astype(jnp.int32)
    at_work0 = (s & SCHED_AT_WORK) != 0
    on_bus0 = (s & SCHED_ON_BUS) != 0
    btw0 = (s & SCHED_BUS_TO_WORK) != 0
    at_work_ws0 = (s & SCHED_AT_WORK_WS) != 0
    on_bus_ws0 = (s & SCHED_ON_BUS_WS) != 0
    h24 = jnp.asarray(h24, jnp.int32)

    # 1. disease timers (disease.rs:47-71)
    timer = jnp.asarray(timer, jnp.int32)
    is_e = status == STATUS_EXPOSED
    is_i = status == STATUS_INFECTED
    e_to_i = is_e & (timer >= e_time)
    i_to_r = is_i & (timer >= i_time)
    status1 = jnp.where(e_to_i, jnp.int8(STATUS_INFECTED), status)
    status1 = jnp.where(i_to_r, jnp.int8(STATUS_RECOVERED), status1)
    timer1 = jnp.where(
        e_to_i | i_to_r, 0, jnp.where(is_e | is_i, timer + 1, timer)
    )

    # 2. movement (citizen.rs:168-216) in citizen order and, independently
    #    with the same rules, in work order; frozen under lockdown
    at_work1, on_bus1, arm_bus_out = _movement(
        h24, move, ws, we, uses, at_work0, on_bus0
    )
    btw1 = jnp.where(move, arm_bus_out, btw0)
    at_work_ws1, on_bus_ws1, _ = _movement(
        h24, move, ws_ws, ws_we, ws_uses, at_work_ws0, on_bus_ws0
    )

    # 4a. household pressure: infected positioned at home contribute; the
    #     window's pos/size gates never select across a household boundary
    infected = status1 == STATUS_INFECTED
    inf_active = infected & ~on_bus1
    contrib = inf_active & (~at_work1 | ~wneq)
    c8 = contrib.astype(jnp.int8)
    n_h = contrib.astype(jnp.int32)
    for dd in range(1, K):
        n_h = n_h + jnp.where(pos + dd < size, jnp.roll(c8, -dd), 0)
        n_h = n_h + jnp.where(pos - dd >= 0, jnp.roll(c8, dd), 0)

    # 5. exposure chance (disease.rs:131-154; reference mask inversion per
    #    SimConfig.reference_mask_semantics)
    if ref_mask_sem:
        active = (mask_status == MASK_EVERYWHERE) & ~compliant
    else:
        active = compliant & (
            (mask_status == MASK_EVERYWHERE)
            | ((mask_status == MASK_PUBLIC_TRANSPORT) & on_bus1)
        )
    p_cit = chance * jnp.where(active, 1.0 - mask_eff, 1.0)
    n_eff = truncate_u8(n_h) if u8_trunc else n_h
    q_home = jnp.where(
        ~at_work1 | same_oa, binomial_at_least_one(p_cit, n_eff), 0.0
    )

    # 6. home draw: counter-hash uniforms keyed on the GLOBAL citizen id
    gid = jnp.arange(n, dtype=jnp.uint32) + jnp.asarray(gid0, jnp.uint32)
    u = hash_uniform(jnp.asarray(seed, jnp.uint32), gid)
    susceptible = status1 == STATUS_SUSCEPTIBLE
    hit_home = susceptible & (u < q_home)

    # 7. one packed cond operand for both the work and the bus conds
    contrib_work = inf_active & at_work1 & wneq
    i8 = lambda x: x.astype(jnp.int8)
    gates = (
        i8(contrib_work) | (i8(susceptible) << 1) | (i8(hit_home) << 2)
        | (i8(on_bus1) << 3) | (i8(infected) << 4)
    )

    # 3/8. per-group census (pre-exposure) + gate counts
    cols = [status1 == st for st in range(5)] + [
        contrib_work, on_bus1 & infected, hit_home,
    ]
    counts = jnp.stack(
        [jnp.sum(c.reshape(n_groups, -1), axis=1, dtype=jnp.int32)
         for c in cols],
        axis=1,
    )

    status_out = jnp.where(hit_home, jnp.int8(STATUS_EXPOSED), status1)
    timer_out = jnp.where(hit_home, 0, timer1).astype(TIMER_DTYPE)
    sched_out = (
        i8(at_work1) | (i8(on_bus1) << 1) | (i8(btw1) << 2)
        | (i8(at_work_ws1) << 3) | (i8(on_bus_ws1) << 4)
    )
    return status_out, timer_out, sched_out, gates, counts
