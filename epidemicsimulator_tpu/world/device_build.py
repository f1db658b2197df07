"""On-device world construction: generation + index tables as jitted XLA.

The host numpy pipeline (synthetic.py + schema.build_index_tables) costs
host seconds to minutes at region and UK scale, then uploads ~90
bytes/citizen of tables.  Everything in it is sorts, prefix scans, boundary
masks and scatters — work an accelerator does in milliseconds.  This module
rebuilds the same pipeline as two jitted stages:

* :func:`synthetic_core_device` — the distribution-faithful synthetic
  citizen/household/workplace/school sampling (mirrors
  ``generate_synthetic_world`` stage for stage; reference semantics per
  simulator_builder.rs:1144-1292, building.rs:244-443, output_area.rs:128-197).
  RNG is threefry, so lanes are *statistically* equivalent to the numpy
  generator, not bitwise-equal.
* :func:`build_tables_device` — the canonical building relabel + citizen
  ordering of ``make_world`` and the full index/fast-table build of
  ``World.build_index_tables``/``build_fast_tables``, bit-for-bit identical
  to the numpy path for the same core lanes (tested).

Data-dependent sizes (n_buildings, n_rooms, rider count R) cross the host
boundary as a handful of scalars between the stages; each distinct size
tuple compiles once and hits the persistent cache afterwards.

Everything stays in int32 — citizen counts, building ids and composite sort
keys are all < 2^31 even at 63M citizens; wide keys are avoided by replacing
``key = a * K + b`` constructions with boundary detection on (a, b) lane
pairs and by LSD multi-pass stable sorts for (major, minor) orderings.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    AVERAGE_CLASS_SIZE,
    AVERAGE_OFFICE_SIZE,
    EMPLOYMENT_DENSITY_BY_OCCUPATION,
    HOUSEHOLD_SIZE,
    MAX_STUDENT_AGE,
    MIN_WORKPLACE_OCCUPANT_COUNT,
    MINIMUM_FLOOR_SPACE_SIZE,
    OCC_STUDENT,
    OCC_TEACHING,
    OCC_UNEMPLOYED,
    PUBLIC_TRANSPORT_PERCENTAGE,
)
from .schema import World

_I32_MAX = jnp.int32(2**31 - 1)


# ---------------------------------------------------------------------------
# StableHLO export cache: skip per-process trace + MLIR lowering
# ---------------------------------------------------------------------------
# Lowering the synthetic program's jaxpr to MLIR costs seconds of host
# Python at Y&H scale, every process (the XLA *compile* cache only kicks in
# after).
# jax.export lets us serialize the lowered module once and replay it; the
# cache key hashes this module's + hashrng's source so edits invalidate it.

def _export_cache_key(name: str, statics: tuple) -> str:
    import hashlib
    import os.path as osp

    h = hashlib.sha256()
    h.update(jax.__version__.encode())
    # exports lower for one platform; a module exported on one backend
    # cannot replay on another
    h.update(jax.default_backend().encode())
    for mod in (__file__, osp.join(osp.dirname(osp.dirname(__file__)),
                                   "ops", "hashrng.py")):
        try:
            with open(mod, "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(b"?")
    h.update(repr(statics).encode())
    return f"{name}-{h.hexdigest()[:32]}"


def _call_exported_cached(name: str, statics: tuple, make_jitted, args):
    """Call ``make_jitted()`` (a 0-arg fn returning a jitted callable) on
    ``args``, replaying a serialized StableHLO module when one exists for
    (source hash, statics, arg shapes/dtypes).  Logs any export machinery
    failure and falls back to a plain call.  The cache lives under
    ``utils.cache_root()``."""
    import os

    if os.environ.get("ESUCD_NO_EXPORT_CACHE", "") == "1":
        return make_jitted()(*args)
    from jax import export as jax_export

    shapes = tuple(
        (jnp.shape(a), jnp.result_type(a).name) for a in args
    )
    key = _export_cache_key(name, statics + shapes)
    from ..utils import cache_root

    cache_dir = os.path.join(cache_root(), "esucd_export")
    path = os.path.join(cache_dir, key + ".bin")
    try:
        if os.path.exists(path):
            with open(path, "rb") as f:
                exp = jax_export.deserialize(bytearray(f.read()))
            return exp.call(*args)
        jitted = make_jitted()
        exp = jax_export.export(jitted)(
            *(jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a))
              for a in args)
        )
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(exp.serialize())
        os.replace(tmp, path)
        return exp.call(*args)
    except Exception:  # any export quirk: log it, then take the plain path
        import logging

        logging.getLogger(__name__).warning(
            "StableHLO export cache failed for %s; calling the jitted "
            "function directly", name, exc_info=True,
        )
        return make_jitted()(*args)

_OCCUPATION_WEIGHTS = np.array(
    [0.11, 0.20, 0.13, 0.11, 0.11, 0.09, 0.08, 0.07, 0.05], np.float64
)
_UNEMPLOYED_FRACTION = 0.06
_WORKPLACE_CAPACITY = np.array(
    [
        max(MINIMUM_FLOOR_SPACE_SIZE // d, MIN_WORKPLACE_OCCUPANT_COUNT)
        for d in EMPLOYMENT_DENSITY_BY_OCCUPATION
    ],
    np.int32,
)


# ---------------------------------------------------------------------------
# (N,) lane helpers — boundary masks, run ranges, cumulative counts
# ---------------------------------------------------------------------------

def _i32(x):
    return jnp.asarray(x, jnp.int32)


def _start_mask(*lanes):
    """True at the first element of each run of equal (lane0, lane1, ...)."""
    n = lanes[0].shape[0]
    neq = jnp.zeros(n - 1, bool)
    for lane in lanes:
        neq = neq | (lane[1:] != lane[:-1])
    return jnp.concatenate([jnp.ones(1, bool), neq])


def _end_from_start(start):
    return jnp.concatenate([start[1:], jnp.ones(1, bool)])


def _run_ranges(start):
    """(lo, hi) positions of each element's run, given its start mask."""
    n = start.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    lo = jax.lax.cummax(jnp.where(start, idx, 0), axis=0)
    end = _end_from_start(start)
    hi = jax.lax.cummin(jnp.where(end, idx + 1, n), axis=0, reverse=True)
    return lo, hi


def _cumcount(start):
    """Position of each element within its run."""
    idx = jnp.arange(start.shape[0], dtype=jnp.int32)
    return idx - jax.lax.cummax(jnp.where(start, idx, 0), axis=0)


def _dense_ids(start):
    """0-based run index per element (cumsum of boundaries - 1)."""
    return jnp.cumsum(start.astype(jnp.int32)) - 1


def _inverse_perm(perm):
    n = perm.shape[0]
    return jnp.zeros(n, jnp.int32).at[perm].set(jnp.arange(n, dtype=jnp.int32))


def _sort_pairs_with_mask(major, minor, member):
    """Stable argsort by (major, minor, index) with non-members last.

    LSD two-pass: stable sort by the minor key, then by the major key with
    non-members sent to the sentinel.  Avoids 64-bit composite keys.
    """
    p1 = jnp.argsort(_i32(minor), stable=True)
    key2 = jnp.where(member, _i32(major), _I32_MAX)[p1]
    return p1[jnp.argsort(key2, stable=True)]


# ---------------------------------------------------------------------------
# Stage 2: canonicalisation + index/fast tables (generic, bit-exact vs numpy)
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("n_buildings", "n_rooms", "n_oa", "n_riders"),
)
def _tables_kernel(
    lanes: dict,
    *,
    n_buildings: int,
    n_rooms: int,
    n_oa: int,
    n_riders: int,
):
    n = lanes["age"].shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)

    # --- canonical building numbering (make_world, schema.py:425-436):
    # buildings relabelled OA-major (stable by old id within an OA).
    hb0 = _i32(lanes["home_building"])
    wb0 = _i32(lanes["work_building"])
    b_oa = (
        jnp.zeros(n_buildings, jnp.int32)
        .at[wb0].set(_i32(lanes["work_oa"]))
        .at[hb0].set(_i32(lanes["home_oa"]))
    )
    order_b = jnp.argsort(b_oa, stable=True)
    new_id = _inverse_perm(order_b)
    hb1 = new_id[hb0]
    wb1 = new_id[wb0]

    # --- canonical citizen order: stable sort by new home_building
    # (schema.py:441-453; stable argsort of an already-sorted lane is the
    # identity, matching the numpy path's sort-only-if-needed).
    order = jnp.argsort(hb1, stable=True)

    def take(name, dtype=None):
        lane = jnp.asarray(lanes[name])[order]
        return lane if dtype is None else lane.astype(dtype)

    age = take("age", jnp.int16)
    occupation = take("occupation", jnp.int8)
    home_building = hb1[order]
    work_building = wb1[order]
    home_oa = take("home_oa", jnp.int32)
    work_oa = take("work_oa", jnp.int32)
    room = take("room", jnp.int32)
    is_school_work = take("is_school_work", bool)
    uses_transport = take("uses_transport", bool)
    mask_compliant = take("mask_compliant", bool)
    work_start = take("work_start", jnp.int8)
    work_end = take("work_end", jnp.int8)

    # --- household ranges in citizen order (schema.py:186-189)
    h_start = _start_mask(home_building)
    home_lo, home_hi = _run_ranges(h_start)

    # --- work order: stable by (work_building, room, index) (schema.py:195-196)
    p1 = jnp.argsort(room, stable=True)
    work_perm = p1[jnp.argsort(work_building[p1], stable=True)]
    wpos = _inverse_perm(work_perm)
    wb_ws = work_building[work_perm]
    rm_ws = room[work_perm]

    wb_start_ws = _start_mask(wb_ws)
    wb_lo_ws, wb_hi_ws = _run_ranges(wb_start_ws)
    rm_start_ws = _start_mask(wb_ws, rm_ws)
    rm_lo_ws, rm_hi_ws = _run_ranges(rm_start_ws)

    # citizen-order views of the ws-order ranges (schema.py:201-221)
    wb_lo = wb_lo_ws[wpos]
    wb_hi = wb_hi_ws[wpos]
    room_lo = rm_lo_ws[wpos]
    room_hi = rm_hi_ws[wpos]

    # --- riders sorted by (home_oa, work_oa, index) (schema.py:225-250)
    rsort = _sort_pairs_with_mask(home_oa, work_oa, uses_transport)
    rider_perm = rsort[:n_riders]
    r_ho = home_oa[rider_perm]
    r_wo = work_oa[rider_perm]
    if n_riders:
        rider_route = _dense_ids(_start_mask(r_ho, r_wo))
    else:
        rider_route = jnp.zeros(0, jnp.int32)
    rider_mask_compliant = mask_compliant[rider_perm]

    # rpos: riders get their rider-order slot; non-riders unique fillers
    # >= R in citizen order (schema.py:246-250).
    rpos = jnp.zeros(n, jnp.int32).at[rider_perm].set(
        jnp.arange(n_riders, dtype=jnp.int32)
    )
    non_rider = ~uses_transport
    nr_rank = jnp.cumsum(non_rider.astype(jnp.int32)) - 1
    rpos = jnp.where(non_rider, n_riders + nr_rank, rpos)

    # --- fast tables (schema.build_fast_tables) ---------------------------
    h_end = _end_from_start(h_start)
    wb_end_ws = _end_from_start(wb_start_ws)
    rm_end_ws = _end_from_start(rm_start_ws)

    ho_counts = jnp.zeros(n_oa, jnp.int32).at[home_oa].add(1)
    oa_hi = jnp.cumsum(ho_counts)
    oa_lo = oa_hi - ho_counts
    wo_ws = work_oa[work_perm]
    wo_counts = jnp.zeros(n_oa, jnp.int32).at[wo_ws].add(1)
    ws_oa_hi = jnp.cumsum(wo_counts)
    ws_oa_lo = ws_oa_hi - wo_counts
    # canonical ordering makes OA runs contiguous in both orders; the
    # wrapper asserts this flag (the numpy path falls back to segment_sum).
    oa_contig = (
        jnp.all(home_oa[1:] >= home_oa[:-1]) & jnp.all(wo_ws[1:] >= wo_ws[:-1])
        if n > 1 else jnp.bool_(True)
    )

    hh_pos = idx - home_lo
    hh_size = home_hi - home_lo
    max_hh = jnp.max(hh_size) if n else jnp.int32(0)

    wp = work_perm
    return dict(
        age=age,
        occupation=occupation,
        home_building=home_building,
        work_building=work_building,
        home_oa=home_oa,
        work_oa=work_oa,
        room=room,
        is_school_work=is_school_work,
        uses_transport=uses_transport,
        mask_compliant=mask_compliant,
        work_start=work_start,
        work_end=work_end,
        home_lo=home_lo,
        home_hi=home_hi,
        work_perm=work_perm,
        wb_lo=wb_lo,
        wb_hi=wb_hi,
        room_lo=room_lo,
        room_hi=room_hi,
        rider_perm=rider_perm,
        rider_route=rider_route,
        rider_mask_compliant=rider_mask_compliant,
        rpos=rpos,
        wpos=wpos,
        home_start_mask=h_start,
        home_end_mask=h_end,
        ws_wb_start_mask=wb_start_ws,
        ws_wb_end_mask=wb_end_ws,
        ws_room_start_mask=rm_start_ws,
        ws_room_end_mask=rm_end_ws,
        ws_home_oa=home_oa[wp],
        ws_work_oa=wo_ws,
        ws_mask_compliant=mask_compliant[wp],
        ws_is_school=is_school_work[wp],
        ws_work_neq_home=(work_building != home_building)[wp],
        ws_uses_transport=uses_transport[wp],
        ws_work_start=work_start[wp],
        ws_work_end=work_end[wp],
        oa_lo=oa_lo,
        oa_hi=oa_hi,
        ws_oa_lo=ws_oa_lo,
        ws_oa_hi=ws_oa_hi,
        hh_pos=hh_pos.astype(jnp.int16),
        hh_size=hh_size.astype(jnp.int16),
    ), (max_hh, oa_contig)


def build_tables_device(core: World, *, n_riders: int | None = None) -> World:
    """Device-side equivalent of ``make_world`` canonicalisation +
    ``build_index_tables`` + ``build_fast_tables`` for a ``World`` carrying
    only core lanes.  Returns a fully-tabled ``World`` of device arrays,
    bit-identical to the numpy pipeline for the same inputs.

    ``n_riders`` (static) can be passed by callers that already know it,
    saving an eager device reduction + host fetch here.
    """
    lanes = {name: jnp.asarray(getattr(core, name)) for name in World.CORE_LANES}
    if n_riders is None:
        ut = getattr(core, "uses_transport")
        if isinstance(ut, np.ndarray):
            n_riders = int(np.sum(ut.astype(np.int32)))
        else:
            n_riders = int(jnp.sum(lanes["uses_transport"].astype(jnp.int32)))
    out, (max_hh, oa_contig) = _tables_kernel(
        lanes,
        n_buildings=int(core.n_buildings),
        n_rooms=int(core.n_rooms),
        n_oa=int(core.n_output_areas),
        n_riders=n_riders,
    )
    assert bool(oa_contig), "device table build requires OA-contiguous worlds"
    return World(
        n_buildings=int(core.n_buildings),
        n_rooms=int(core.n_rooms),
        n_output_areas=int(core.n_output_areas),
        max_household_size=int(max_hh),
        **out,
    )


# ---------------------------------------------------------------------------
# Stage 1: synthetic core generation (device analog of synthetic.py)
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("n", "n_oa", "n_schools")
)
def _synthetic_core_kernel(
    seed,
    *,
    n: int,
    n_oa: int,
    n_schools: int,
    oas_per_school: int,
    commute_spread: float,
    mask_percentage: float,
):
    # Counter-hash RNG (ops/hashrng.py, murmur3-fmix32 quality) instead of
    # threefry: the hash draws keep the compiled program small.
    from ..ops.hashrng import hash_bits, hash_uniform

    seed32 = jnp.asarray(seed, jnp.uint32)

    def subkey(i):
        return hash_bits(
            jnp.uint32(0xA5A5A5A5) + jnp.uint32(i) * jnp.uint32(0x9E3779B9),
            seed32,
        )

    idx = jnp.arange(n, dtype=jnp.uint32)

    # --- citizens (synthetic.py:98-115) ----------------------------------
    age = (hash_bits(subkey(0), idx) % jnp.uint32(90)).astype(jnp.int16)
    is_student = age < MAX_STUDENT_AGE

    # NB: keep trace-time lookup tables as *numpy* — an eager jnp.asarray
    # here becomes a device-resident closure constant, and MLIR lowering
    # fetches its value back to the host.
    cumw = np.cumsum(_OCCUPATION_WEIGHTS / _OCCUPATION_WEIGHTS.sum()).astype(
        np.float32
    )
    occ = jnp.searchsorted(
        cumw, hash_uniform(subkey(1), idx), side="right"
    ).astype(jnp.int8)
    occ = jnp.minimum(occ, jnp.int8(8))
    unemployed = hash_uniform(subkey(2), idx) < _UNEMPLOYED_FRACTION
    occ = jnp.where(unemployed, jnp.int8(OCC_UNEMPLOYED), occ)
    occ = jnp.where(is_student, jnp.int8(OCC_STUDENT), occ)

    mask_compliant = hash_uniform(subkey(3), idx) < mask_percentage
    uses_transport = hash_uniform(subkey(4), idx) < PUBLIC_TRANSPORT_PERCENTAGE

    # --- households and home OAs (synthetic.py:117-129) -------------------
    home_oa = jnp.sort(
        (hash_bits(subkey(5), idx) % jnp.uint32(n_oa)).astype(jnp.int32)
    )
    oa_start = _start_mask(home_oa)
    pos_in_oa = _cumcount(oa_start)
    hh_in_oa = pos_in_oa // HOUSEHOLD_SIZE
    hh_start = _start_mask(home_oa, hh_in_oa)
    household = _dense_ids(hh_start)
    n_households = household[n - 1] + 1

    # --- commuting (synthetic.py:131-135): Laplace via inverse CDF --------
    u = hash_uniform(subkey(6), idx) - 0.5
    lap = -jnp.sign(u) * jnp.log1p(-2.0 * jnp.abs(u))
    # float-clip before the int cast: u == -0.5 gives -inf (p ~ 2^-24/draw)
    shift = jnp.rint(
        jnp.clip(lap * commute_spread, -float(n_oa), float(n_oa))
    ).astype(jnp.int32)
    work_oa = jnp.clip(home_oa + shift, 0, n_oa - 1)

    # --- workplaces (synthetic.py:137-150): workers sorted by
    # (work_oa, occupation), packed to capacity ----------------------------
    is_worker = (~is_student) & (occ != OCC_UNEMPLOYED)
    w_bucket = work_oa * 16 + occ.astype(jnp.int32)
    w_key = jnp.where(is_worker, w_bucket, _I32_MAX)
    w_perm = jnp.argsort(w_key, stable=True)
    worker_sorted = is_worker[w_perm]
    bucket_sorted = w_bucket[w_perm]
    b_start = _start_mask(bucket_sorted)
    pos = _cumcount(b_start)
    caps = jnp.take(
        np.asarray(_WORKPLACE_CAPACITY),
        jnp.clip(occ[w_perm], 0, 8).astype(jnp.int32),
    )
    slot = pos // caps
    wp_start = (b_start | _start_mask(slot)) & worker_sorted
    # dense workplace id among workers (workers form the sorted prefix)
    wp_id = jnp.cumsum(wp_start.astype(jnp.int32)) - 1
    n_workplaces = jnp.sum(wp_start.astype(jnp.int32))

    # --- schools (synthetic.py:152-178): students chunked into classes of
    # ~AVERAGE_CLASS_SIZE per (school, age) group --------------------------
    school_of_oa = jnp.minimum(
        jnp.arange(n_oa, dtype=jnp.int32) // oas_per_school, n_schools - 1
    )
    school_oa = jnp.clip(
        jnp.arange(n_schools, dtype=jnp.int32) * oas_per_school, 0, n_oa - 1
    )

    s_school = school_of_oa[home_oa]
    s_key = jnp.where(
        is_student, s_school * 256 + age.astype(jnp.int32), _I32_MAX
    )
    s_perm = jnp.argsort(s_key, stable=True)
    student_sorted = is_student[s_perm]
    # Run structure must come from the UNMASKED key lane so the sentinel
    # (non-student) tail forms its own run and the last real group's range
    # ends at the student/non-student boundary.
    g_run_start = _start_mask(s_key[s_perm])
    g_start = g_run_start & student_sorted
    g_lo, g_hi = _run_ranges(g_run_start)
    g_count = (g_hi - g_lo).astype(jnp.float32)
    class_counts = jnp.maximum(jnp.ceil(g_count / AVERAGE_CLASS_SIZE), 1.0)
    class_sizes = jnp.ceil(g_count / class_counts).astype(jnp.int32)
    class_counts = class_counts.astype(jnp.int32)
    pos_in_group = _cumcount(g_run_start)
    class_in_group = pos_in_group // class_sizes
    cc_at_start = jnp.where(g_start, class_counts, 0)
    class_base = jnp.cumsum(cc_at_start) - class_counts
    class_id = class_base + class_in_group  # valid on student slots
    n_classes = jnp.sum(cc_at_start)

    s_school_sorted = s_school[s_perm]
    classes_per_school = jnp.zeros(n_schools, jnp.int32).at[
        jnp.where(g_start, s_school_sorted, 0)
    ].add(jnp.where(g_start, class_counts, 0))
    sch_class_base = jnp.cumsum(classes_per_school) - classes_per_school

    # --- teachers (synthetic.py:180-228): teaching-occupation workers by
    # work-OA school group, shortfall conscripted from other workers -------
    is_teacher_pool = is_worker & (occ == OCC_TEACHING)
    pool_school = school_of_oa[work_oa]
    t_key = jnp.where(is_teacher_pool, pool_school, _I32_MAX)
    t_perm = jnp.argsort(t_key, stable=True)
    t_in_pool = is_teacher_pool[t_perm]
    t_school = pool_school[t_perm]
    tr_start = _start_mask(t_key[t_perm])  # unmasked: sentinel run separate
    t_rank = _cumcount(tr_start)
    t_needed = classes_per_school[t_school]
    t_take = t_in_pool & (t_rank < t_needed)
    t_class = sch_class_base[t_school] + t_rank

    # per-school taken count = min(pool size, needed)
    tp_start = tr_start & t_in_pool
    tp_lo, tp_hi = _run_ranges(tr_start)
    pool_count = tp_hi - tp_lo
    already = jnp.zeros(n_schools, jnp.int32).at[
        jnp.where(tp_start, t_school, 0)
    ].add(jnp.where(tp_start, jnp.minimum(pool_count, t_needed), 0))
    deficit = classes_per_school - already

    is_other = is_worker & (occ != OCC_TEACHING)
    o_key = jnp.where(is_other, pool_school, _I32_MAX)
    o_perm = jnp.argsort(o_key, stable=True)
    o_in_pool = is_other[o_perm]
    o_school = pool_school[o_perm]
    o_rank = _cumcount(_start_mask(o_key[o_perm]))
    o_take = o_in_pool & (o_rank < deficit[o_school])
    o_class = sch_class_base[o_school] + already[o_school] + o_rank

    n_staffed = jnp.sum(t_take.astype(jnp.int32)) + jnp.sum(
        o_take.astype(jnp.int32)
    )

    # leftover teachers -> offices of AVERAGE_OFFICE_SIZE (synthetic.py:230-243)
    t_left = t_in_pool & ~t_take
    lo_rank = t_rank - t_needed  # rank among leftovers of the school
    office_in_school = jnp.where(t_left, lo_rank // AVERAGE_OFFICE_SIZE, 0)
    offices_per_school = jnp.zeros(n_schools, jnp.int32).at[
        jnp.where(t_left, t_school, 0)
    ].max(jnp.where(t_left, office_in_school + 1, 0))
    office_base = (
        n_classes + jnp.cumsum(offices_per_school) - offices_per_school
    )
    left_room = office_base[t_school] + office_in_school
    n_offices = jnp.sum(offices_per_school)
    n_rooms = n_classes + n_offices

    # --- assemble citizen-order lanes (synthetic.py:245-279) --------------
    workplace_base = n_households
    school_base = workplace_base + n_workplaces

    home_building = household
    work_building = household
    work_oa_final = home_oa
    room = jnp.full(n, 0, jnp.int32)  # placeholder; sentinel applied below
    room_is_set = jnp.zeros(n, bool)
    is_school_work = jnp.zeros(n, bool)

    # workers -> workplaces (scatter lanes from worker-sorted order)
    wb_w = jnp.zeros(n, jnp.int32).at[w_perm].set(workplace_base + wp_id)
    work_building = jnp.where(is_worker, wb_w, work_building)
    work_oa_final = jnp.where(is_worker, work_oa, work_oa_final)

    # students -> their school/class
    cls = jnp.zeros(n, jnp.int32).at[s_perm].set(class_id)
    work_building = jnp.where(is_student, school_base + s_school, work_building)
    work_oa_final = jnp.where(is_student, school_oa[s_school], work_oa_final)
    room = jnp.where(is_student, cls, room)
    room_is_set = room_is_set | is_student
    is_school_work = is_school_work | is_student

    # class teachers + conscripts
    take_lane = jnp.zeros(n, bool).at[t_perm].set(t_take)
    tclass_lane = jnp.zeros(n, jnp.int32).at[t_perm].set(t_class)
    otake_lane = jnp.zeros(n, bool).at[o_perm].set(o_take)
    oclass_lane = jnp.zeros(n, jnp.int32).at[o_perm].set(o_class)
    teach = take_lane | otake_lane
    tcls = jnp.where(take_lane, tclass_lane, oclass_lane)
    work_building = jnp.where(teach, school_base + pool_school, work_building)
    work_oa_final = jnp.where(teach, school_oa[pool_school], work_oa_final)
    room = jnp.where(teach, tcls, room)
    room_is_set = room_is_set | teach
    is_school_work = is_school_work | teach

    # leftover teachers -> offices
    left_lane = jnp.zeros(n, bool).at[t_perm].set(t_left)
    lroom_lane = jnp.zeros(n, jnp.int32).at[t_perm].set(left_room)
    work_building = jnp.where(left_lane, school_base + pool_school, work_building)
    work_oa_final = jnp.where(left_lane, school_oa[pool_school], work_oa_final)
    room = jnp.where(left_lane, lroom_lane, room)
    room_is_set = room_is_set | left_lane
    is_school_work = is_school_work | left_lane

    room = jnp.where(room_is_set, room, n_rooms)

    lanes = dict(
        age=age,
        occupation=occ,
        home_building=home_building,
        work_building=work_building,
        home_oa=home_oa,
        work_oa=work_oa_final,
        room=room,
        is_school_work=is_school_work,
        uses_transport=uses_transport,
        mask_compliant=mask_compliant,
        work_start=jnp.full(n, 9, jnp.int8),
        work_end=jnp.full(n, 17, jnp.int8),
    )
    scalars = jnp.stack([
        n_households,
        n_workplaces,
        n_classes,
        n_rooms,
        n_staffed,
        jnp.sum(uses_transport.astype(jnp.int32)),
    ])
    return lanes, scalars


def generate_synthetic_world_device(
    n_citizens: int,
    n_output_areas: int = 64,
    *,
    seed: int = 42,
    oas_per_school: int = 4,
    commute_spread: float = 3.0,
    mask_percentage: float = 0.8,
) -> World:
    """Device-resident synthetic world: same structure as
    :func:`..world.synthetic.generate_synthetic_world`, built entirely on
    the accelerator (counter-hash RNG, so lanes are distribution-equal,
    not bitwise-equal, to the numpy generator).
    """
    import os
    import time

    n = int(n_citizens)
    n_oa = int(n_output_areas)
    if n <= 0:
        raise ValueError("n_citizens must be positive")
    n_schools = max(1, (n_oa + oas_per_school - 1) // oas_per_school)

    timing = os.environ.get("ESUCD_TIMING", "") == "1"
    t0 = time.perf_counter()

    def tick(label):
        nonlocal t0
        if timing:
            now = time.perf_counter()
            print(f"  [world-build] {label}: {now - t0:.1f}s", flush=True)
            t0 = now

    def make_jitted():
        def wrapper(seed_, oas_per_school_, commute_spread_, mask_pct_):
            return _synthetic_core_kernel(
                seed_,
                n=n,
                n_oa=n_oa,
                n_schools=n_schools,
                oas_per_school=oas_per_school_,
                commute_spread=commute_spread_,
                mask_percentage=mask_pct_,
            )

        return jax.jit(wrapper)

    lanes, scalars = _call_exported_cached(
        "synthetic_core",
        (n, n_oa, n_schools),
        make_jitted,
        (
            np.int32(seed),
            np.int32(oas_per_school),
            np.float32(commute_spread),
            np.float32(mask_percentage),
        ),
    )
    tick("stage1 dispatch")
    (n_households, n_workplaces, n_classes, n_rooms, n_staffed, n_riders) = (
        int(x) for x in np.asarray(scalars)
    )
    tick("stage1 sync")
    if n_staffed < n_classes:
        raise ValueError(
            f"synthetic world cannot staff {n_classes} classes with "
            f"{n_staffed} teachers"
        )
    n_buildings = n_households + n_workplaces + n_schools

    core = World(
        n_buildings=n_buildings,
        n_rooms=n_rooms,
        n_output_areas=n_oa,
        **{name: lanes[name] for name in World.CORE_LANES},
    )
    out = build_tables_device(core, n_riders=n_riders)
    tick("stage2 dispatch+sync")
    return out
