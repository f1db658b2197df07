"""Static world representation: struct-of-arrays over N citizens.

The reference holds an object graph — ``Vec<Mutex<OutputArea>>`` each owning
``Vec<Citizen>`` and ``Vec<Box<dyn Building>>`` (simulator.rs:94-96).  The
TPU-native design inverts this: the world is a handful of parallel device
arrays indexed by citizen id, plus integer index tables.  Citizen identity is
the array index (the reference already carries a dense ``global_index``,
citizen.rs:53-54; the UUIDs exist only to make hashes unique and are dropped).

Mixing-group design (replaces the Building trait, building.rs:125-140):

* ``home_building`` — global building id of the household.  Household
  exposure exposes all residents (building.rs:202-204), which is exactly a
  segment reduction over this lane.
* ``work_building`` — global building id of the daytime location: the
  workplace for workers, the school for students/teachers, and the *home*
  building for the unemployed (the reference initialises workplace_code to
  the household and never reassigns it for Unemployed, output_area.rs:163-167).
* ``room`` — for school occupants, the class/office mixing group
  (building.rs:494-522 confines school exposure to the infected's class or
  office).  Non-school citizens carry the sentinel ``n_rooms`` so their
  segment is dropped.

Positions are never stored per-citizen; the current building is
``where(at_work, work_building, home_building)`` with the at-work bit carried
through the scan (needed because lockdown freezes transitions,
citizen.rs:176-206).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class World:
    """Immutable world tables.  All per-citizen arrays have shape (N,).

    ``n_buildings``/``n_rooms``/``n_output_areas`` are static python ints
    (they shape segment reductions), marked as pytree metadata.
    """

    # --- per-citizen lanes ---
    age: Any                    # int16, years
    occupation: Any             # int8, OCC_* encoding
    home_building: Any          # int32 in [0, n_buildings)
    work_building: Any          # int32 in [0, n_buildings)
    home_oa: Any                # int32 in [0, n_output_areas)
    work_oa: Any                # int32 in [0, n_output_areas)
    room: Any                   # int32 in [0, n_rooms], n_rooms = "no room"
    is_school_work: Any         # bool: work_building is a school
    uses_transport: Any         # bool (citizen.rs:159, 20% Bernoulli)
    mask_compliant: Any         # bool (output_area.rs:119 Bernoulli(0.8))
    work_start: Any             # int8, hour work begins (citizen.rs:154, 9)
    work_end: Any               # int8, hour work ends (citizen.rs:155, 17)

    # --- static sizes (pytree aux data) ---
    n_buildings: int = dataclasses.field(metadata=dict(static=True))
    n_rooms: int = dataclasses.field(metadata=dict(static=True))
    n_output_areas: int = dataclasses.field(metadata=dict(static=True))

    # --- derived index tables (built by build_index_tables) ---------------
    # Mixing-group membership is static, so infection pressure needs no
    # scatter: citizens are kept sorted by home_building, a static
    # permutation sorts them by (work_building, room), and per-citizen
    # [start, end) ranges into prefix sums replace segment_sum on the hot
    # path.
    home_lo: Any = None        # int32 (N,), household range start (citizen order)
    home_hi: Any = None        # int32 (N,), household range end (exclusive)
    work_perm: Any = None      # int32 (N,), citizen ids sorted by (work_building, room)
    wb_lo: Any = None          # int32 (N,), work-building range start in work_perm order
    wb_hi: Any = None          # int32 (N,)
    room_lo: Any = None        # int32 (N,), room range (school citizens; == work range otherwise)
    room_hi: Any = None        # int32 (N,)
    rider_perm: Any = None     # int32 (R,), transport users sorted by (home_oa, work_oa)
    rider_route: Any = None    # int32 (R,), dense route id per rider (undirected pairing
                               # of the static home->work commute; same grouping serves
                               # both travel directions)
    rider_mask_compliant: Any = None  # bool (R,), static lane in rider order
    rpos: Any = None           # int32 (N,), rider-compaction rank: riders get
                               # their rider-order slot, non-riders unique
                               # fillers >= R, so one packed key-sort moves
                               # citizen-order bits into rider order (take
                               # [:R]) without an r-sized gather

    # --- fast-path tables (build_fast_tables) -----------------------------
    # The hot loop avoids N-sized random access: run sums via boundary-masked
    # scans,
    # citizen<->work-order movement via two static-key sorts, per-OA stats
    # via cumsum + tiny static gathers at OA boundaries.
    wpos: Any = None           # int32 (N,), rank of citizen in work order
    home_start_mask: Any = None   # bool (N,), first citizen of each household run
    home_end_mask: Any = None     # bool (N,), last citizen of each household run
    ws_wb_start_mask: Any = None  # bool (N,), ws order: first of work-building run
    ws_wb_end_mask: Any = None    # bool (N,), ws order: last of work-building run
    ws_room_start_mask: Any = None  # bool (N,), ws order: first of room run
    ws_room_end_mask: Any = None    # bool (N,), ws order: last of room run
    # ws-order copies of static per-citizen lanes
    ws_home_oa: Any = None
    ws_work_oa: Any = None
    ws_mask_compliant: Any = None
    ws_is_school: Any = None
    ws_work_neq_home: Any = None
    ws_uses_transport: Any = None
    ws_work_start: Any = None
    ws_work_end: Any = None
    # per-OA cumulative-range positions: counts for OA o are cs[hi[o]]-cs[lo[o]]
    oa_lo: Any = None          # int32 (n_oa,), citizen order (home OA runs)
    oa_hi: Any = None
    ws_oa_lo: Any = None       # int32 (n_oa,), ws order (work-building OA runs)
    ws_oa_hi: Any = None
    # household shift-window lanes: households are tiny (~HOUSEHOLD_SIZE),
    # so per-household sums are cheaper as max_household_size shifted adds
    # than as scans.  pos_in_household/household_size are static int16.
    hh_pos: Any = None
    hh_size: Any = None
    max_household_size: int = dataclasses.field(
        default=0, metadata=dict(static=True)
    )

    @property
    def n_citizens(self) -> int:
        return self.age.shape[-1]

    CORE_LANES = (
        "age", "occupation", "home_building", "work_building", "home_oa",
        "work_oa", "room", "is_school_work", "uses_transport",
        "mask_compliant", "work_start", "work_end",
    )

    def validate(self) -> None:
        n = self.n_citizens
        for name in self.CORE_LANES:
            arr = getattr(self, name)
            assert arr.shape[-1] == n, f"{name}: {arr.shape} != ({n},)"
        hb = np.asarray(self.home_building)
        wb = np.asarray(self.work_building)
        assert hb.min() >= 0 and hb.max() < self.n_buildings
        assert wb.min() >= 0 and wb.max() < self.n_buildings
        rm = np.asarray(self.room)
        assert rm.min() >= 0 and rm.max() <= self.n_rooms
        ho = np.asarray(self.home_oa)
        wo = np.asarray(self.work_oa)
        assert ho.min() >= 0 and ho.max() < self.n_output_areas
        assert wo.min() >= 0 and wo.max() < self.n_output_areas

    def device_put(self) -> "World":
        return jax.tree.map(jnp.asarray, self)

    @property
    def has_index_tables(self) -> bool:
        return self.home_lo is not None and np.size(self.home_lo) > 0

    def without_index_tables(self) -> "World":
        """Drop the derived tables (used by the sharded path, which slices
        per-citizen lanes across devices — global index tables don't shard)."""
        # Size-0 placeholders, not None: mixing None and array leaves for
        # the same field across jit calls trips a pytree cache collision in
        # the dispatch fast path ("supplied N buffers but compiled program
        # expected M").
        derived = {
            f.name: np.zeros(0, np.int32)
            for f in dataclasses.fields(self)
            if f.name not in self.CORE_LANES and not f.metadata.get("static")
        }
        return dataclasses.replace(self, **derived)

    def build_index_tables(self) -> "World":
        """Host-side construction of the static prefix-sum index tables.

        Requires citizens sorted by home_building (make_world canonicalises).
        """
        hb = np.asarray(self.home_building, np.int64)
        wb = np.asarray(self.work_building, np.int64)
        rm = np.asarray(self.room, np.int64)
        n = len(hb)
        assert (np.diff(hb) >= 0).all(), "citizens must be sorted by home_building"

        # Household ranges in citizen order.
        counts = np.bincount(hb, minlength=self.n_buildings)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        home_lo = starts[hb]
        home_hi = home_lo + counts[hb]

        # Work order: stable sort by (work_building, room); rooms are
        # globally unique within a school so room ranges nest inside the
        # school's building range.  One composite-key argsort (the key is
        # reused below as `pair`) instead of a two-pass lexsort.
        pair0 = wb * (self.n_rooms + 2) + rm
        work_perm = np.argsort(pair0, kind="stable")
        wb_sorted = wb[work_perm]
        rm_sorted = rm[work_perm]
        wcounts = np.bincount(wb_sorted, minlength=self.n_buildings)
        wstarts = np.concatenate([[0], np.cumsum(wcounts)[:-1]])
        wb_lo = wstarts[wb]
        wb_hi = wb_lo + wcounts[wb]

        # Room ranges (positions in work_perm order).  Key rooms by
        # (building, room) to keep the sentinel room distinct per workplace.
        pair = pair0[work_perm]
        boundary = np.empty(n, np.bool_)
        if n:
            boundary[0] = True
            boundary[1:] = pair[1:] != pair[:-1]
        idx = np.arange(n, dtype=np.int64)
        seg_start = np.maximum.accumulate(np.where(boundary, idx, 0))
        # run length per position, then scatter to citizen order
        run_id = np.cumsum(boundary) - 1
        run_len = np.bincount(run_id)
        room_lo_sorted = seg_start
        room_hi_sorted = seg_start + run_len[run_id]
        room_lo = np.empty(n, np.int64)
        room_hi = np.empty(n, np.int64)
        room_lo[work_perm] = room_lo_sorted
        room_hi[work_perm] = room_hi_sorted

        # Riders: transport users sorted by their static (home_oa, work_oa)
        # commute pair; the same grouping serves both directions.
        ut = np.asarray(self.uses_transport)
        riders = np.flatnonzero(ut)
        route_key = (
            np.asarray(self.home_oa, np.int64)[riders] * self.n_output_areas
            + np.asarray(self.work_oa, np.int64)[riders]
        )
        order = np.argsort(route_key, kind="stable")
        rider_perm = riders[order]
        rk_sorted = route_key[order]
        # rk_sorted is sorted: dense route ids are one boundary cumsum.
        if len(rk_sorted):
            rb = np.empty(len(rk_sorted), np.bool_)
            rb[0] = True
            np.not_equal(rk_sorted[1:], rk_sorted[:-1], out=rb[1:])
            rider_route = np.cumsum(rb) - 1
        else:
            rider_route = np.zeros(0, np.int64)
        rider_mask_compliant = np.asarray(self.mask_compliant)[rider_perm]

        # Rider-compaction rank (see field comment).
        r = len(rider_perm)
        rpos = np.empty(n, np.int64)
        rpos[rider_perm] = np.arange(r)
        non_rider = np.ones(n, np.bool_)
        non_rider[rider_perm] = False
        rpos[non_rider] = r + np.arange(n - r)

        out = dataclasses.replace(
            self,
            home_lo=home_lo.astype(np.int32),
            home_hi=home_hi.astype(np.int32),
            work_perm=work_perm.astype(np.int32),
            wb_lo=wb_lo.astype(np.int32),
            wb_hi=wb_hi.astype(np.int32),
            room_lo=room_lo.astype(np.int32),
            room_hi=room_hi.astype(np.int32),
            rider_perm=rider_perm.astype(np.int32),
            rider_route=rider_route.astype(np.int32),
            rider_mask_compliant=rider_mask_compliant,
            rpos=rpos.astype(np.int32),
        )
        return out.build_fast_tables()

    @property
    def has_fast_tables(self) -> bool:
        return self.wpos is not None and np.size(self.wpos) > 0

    def build_fast_tables(self) -> "World":
        """Boundary masks, ws-order static lanes and per-OA range positions
        for the scan-based hot loop (no large gathers/scatters at runtime)."""
        n = self.n_citizens
        hb = np.asarray(self.home_building, np.int64)
        wp = np.asarray(self.work_perm, np.int64)
        wb_ws = np.asarray(self.work_building, np.int64)[wp]
        rm_ws = np.asarray(self.room, np.int64)[wp]

        wpos = np.empty(n, np.int64)
        wpos[wp] = np.arange(n)

        def run_masks(keys):
            start = np.empty(len(keys), np.bool_)
            end = np.empty(len(keys), np.bool_)
            if len(keys):
                start[0] = True
                start[1:] = keys[1:] != keys[:-1]
                end[-1] = True
                end[:-1] = keys[1:] != keys[:-1]
            return start, end

        h_s, h_e = run_masks(hb)
        wb_s, wb_e = run_masks(wb_ws)
        pair_ws = wb_ws * (self.n_rooms + 2) + rm_ws
        rm_s, rm_e = run_masks(pair_ws)

        # Per-OA cumulative ranges.  Requires home_oa runs contiguous in
        # citizen order and work-building OAs contiguous in ws order —
        # guaranteed by the canonical ordering (buildings numbered by OA).
        ho = np.asarray(self.home_oa, np.int64)
        wo_ws = np.asarray(self.work_oa, np.int64)[wp]

        def oa_ranges(oas, order_name):
            counts = np.bincount(oas, minlength=self.n_output_areas)
            hi = np.cumsum(counts)
            lo = hi - counts
            # contiguity check: sorted ids must reproduce the lane
            if not (np.diff(oas) >= 0).all():
                return None, None
            return lo, hi

        oa_lo, oa_hi = oa_ranges(ho, "citizen")
        ws_oa_lo, ws_oa_hi = oa_ranges(wo_ws, "ws")
        if oa_lo is None or ws_oa_lo is None:
            # Non-canonical ordering: fast per-OA stats unavailable; the
            # engine falls back to segment_sum for exposures_per_oa.
            empty = np.zeros(0, np.int64)
            oa_lo = oa_hi = ws_oa_lo = ws_oa_hi = empty

        # household window lanes — derived from the home ranges already
        # built in build_index_tables (home_lo/home_hi are citizen-order
        # prefix positions of the household run).
        home_lo = np.asarray(self.home_lo, np.int64)
        home_hi = np.asarray(self.home_hi, np.int64)
        hh_pos = np.arange(n) - home_lo
        hh_size = home_hi - home_lo
        max_hh = int(hh_size.max()) if n else 0

        i32 = lambda x: x.astype(np.int32)
        return dataclasses.replace(
            self,
            hh_pos=hh_pos.astype(np.int16),
            hh_size=hh_size.astype(np.int16),
            max_household_size=max_hh,
            wpos=wpos.astype(np.int32),
            home_start_mask=h_s,
            home_end_mask=h_e,
            ws_wb_start_mask=wb_s,
            ws_wb_end_mask=wb_e,
            ws_room_start_mask=rm_s,
            ws_room_end_mask=rm_e,
            ws_home_oa=np.asarray(self.home_oa)[wp],
            ws_work_oa=np.asarray(self.work_oa)[wp],
            ws_mask_compliant=np.asarray(self.mask_compliant)[wp],
            ws_is_school=np.asarray(self.is_school_work)[wp],
            ws_work_neq_home=(
                np.asarray(self.work_building) != np.asarray(self.home_building)
            )[wp],
            ws_uses_transport=np.asarray(self.uses_transport)[wp],
            ws_work_start=np.asarray(self.work_start)[wp],
            ws_work_end=np.asarray(self.work_end)[wp],
            oa_lo=i32(oa_lo),
            oa_hi=i32(oa_hi),
            ws_oa_lo=i32(ws_oa_lo),
            ws_oa_hi=i32(ws_oa_hi),
        )

    # ------------------------------------------------------------------
    # (De)serialisation — the preprocessing cache, the analog of the
    # reference's bincode OSM cache (osm_data/src/lib.rs:395-474).
    # ------------------------------------------------------------------
    def save_npz(self, path: str) -> None:
        arrays = {
            f.name: np.asarray(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if not f.metadata.get("static") and getattr(self, f.name) is not None
        }
        np.savez_compressed(
            path,
            __meta__=np.array(
                [self.n_buildings, self.n_rooms, self.n_output_areas,
                 self.max_household_size],
                np.int64,
            ),
            **arrays,
        )

    @staticmethod
    def load_npz(path: str) -> "World":
        with np.load(path) as data:
            meta = data["__meta__"]
            kwargs = {
                k: data[k] for k in data.files if k != "__meta__"
            }
        return World(
            n_buildings=int(meta[0]),
            n_rooms=int(meta[1]),
            n_output_areas=int(meta[2]),
            max_household_size=int(meta[3]) if len(meta) > 3 else 0,
            **kwargs,
        )


def make_world(
    *,
    age: np.ndarray,
    occupation: np.ndarray,
    home_building: np.ndarray,
    work_building: np.ndarray,
    home_oa: np.ndarray,
    work_oa: np.ndarray,
    room: np.ndarray,
    is_school_work: np.ndarray,
    uses_transport: np.ndarray,
    mask_compliant: np.ndarray,
    n_buildings: int,
    n_rooms: int,
    n_output_areas: int,
    work_start: np.ndarray | int = 9,
    work_end: np.ndarray | int = 17,
) -> World:
    """Build a validated ``World`` from host arrays, coercing dtypes."""
    n = len(age)

    def lane(x, dtype):
        if np.isscalar(x):
            x = np.full(n, x)
        return np.ascontiguousarray(x).astype(dtype)

    # Canonical building numbering: OA-major.  Makes OA runs contiguous in
    # BOTH engine orders (citizen order via home_building, work order via
    # work_building), so per-OA statistics are cumulative ranges instead of
    # segment_sum scatters.  Building ids are internal — relabeling is free.
    hb0 = np.asarray(home_building, np.int32)
    wb0 = np.asarray(work_building, np.int32)
    if n:
        b_oa = np.zeros(int(n_buildings), np.int32)
        b_oa[wb0] = np.asarray(work_oa, np.int32)
        b_oa[hb0] = np.asarray(home_oa, np.int32)
        order_b = np.argsort(b_oa, kind="stable")
        new_id = np.empty(int(n_buildings), np.int32)
        new_id[order_b] = np.arange(int(n_buildings), dtype=np.int32)
        home_building = new_id[hb0]
        work_building = new_id[wb0]

    # Canonical citizen order: sorted by home_building (households
    # contiguous) so household infection pressure is a prefix-sum range.
    hb = np.asarray(home_building)
    if n and (np.diff(hb) < 0).any():
        order = np.argsort(hb, kind="stable")
        (age, occupation, home_building, work_building, home_oa, work_oa,
         room, is_school_work, uses_transport, mask_compliant) = (
            np.asarray(x)[order]
            for x in (age, occupation, home_building, work_building, home_oa,
                      work_oa, room, is_school_work, uses_transport,
                      mask_compliant)
        )
        if not np.isscalar(work_start):
            work_start = np.asarray(work_start)[order]
        if not np.isscalar(work_end):
            work_end = np.asarray(work_end)[order]

    world = World(
        age=lane(age, np.int16),
        occupation=lane(occupation, np.int8),
        home_building=lane(home_building, np.int32),
        work_building=lane(work_building, np.int32),
        home_oa=lane(home_oa, np.int32),
        work_oa=lane(work_oa, np.int32),
        room=lane(room, np.int32),
        is_school_work=lane(is_school_work, np.bool_),
        uses_transport=lane(uses_transport, np.bool_),
        mask_compliant=lane(mask_compliant, np.bool_),
        work_start=lane(work_start, np.int8),
        work_end=lane(work_end, np.int8),
        n_buildings=int(n_buildings),
        n_rooms=int(n_rooms),
        n_output_areas=int(n_output_areas),
    )
    world.validate()
    return world.build_index_tables()
