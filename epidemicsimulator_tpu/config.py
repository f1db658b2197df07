"""Typed configuration for the epidemic engine.

The reference (ESUCD) scatters its epidemiological constants across compile-time
Rust consts (`sim/src/config.rs:22-47`), the disease model constructor
(`sim/src/disease.rs:118-129`) and intervention thresholds
(`sim/src/interventions.rs:50-77`).  Here everything lives in two layers:

* ``DiseaseParams`` / ``InterventionThresholds`` — *traced* pytrees of scalars.
  They flow through ``jax.jit`` as arrays, so ensemble sweeps can ``vmap`` over
  them without recompilation (the reference's own TODO at
  ``interventions.rs:51`` asks for file-driven config).
* ``SimConfig`` — *static* (hashable) structural knobs that change compiled
  shapes: max steps, scan chunking, whether per-OA exposure stats are recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Static structural constants (mirrors sim/src/config.rs)
# ---------------------------------------------------------------------------

#: Number of citizens initially infected (config.rs:27 STARTING_INFECTED_COUNT)
STARTING_INFECTED_COUNT = 10
#: Default floor space assumed per workplace building (config.rs:29)
WORKPLACE_BUILDING_SIZE = 1000
#: Household size used by the toy/synthetic world (config.rs:30)
HOUSEHOLD_SIZE = 4
#: Minimum number of occupants a workplace can hold (config.rs:31)
MIN_WORKPLACE_OCCUPANT_COUNT = 20
#: Fraction of citizens that commute by public transport (config.rs:36)
PUBLIC_TRANSPORT_PERCENTAGE = 0.2
#: Riders per bus (config.rs:37 BUS_CAPACITY)
BUS_CAPACITY = 20
#: Age below which a citizen is a student (config.rs:38 MAX_STUDENT_AGE)
MAX_STUDENT_AGE = 18
#: Minimum workplace floor space in m^2 (building.rs:40 MINIMUM_FLOOR_SPACE_SIZE)
MINIMUM_FLOOR_SPACE_SIZE = 2000
#: Average students per school class (building.rs:307 AVERAGE_CLASS_SIZE)
AVERAGE_CLASS_SIZE = 26.6
#: Teachers per shared school office (building.rs:308 AVERAGE_OFFICE_SIZE)
AVERAGE_OFFICE_SIZE = 12
#: Progress print cadence (config.rs:34 DEBUG_ITERATION_PRINT)
DEBUG_ITERATION_PRINT = 50

# Employment densities, m^2 per employee, per occupation index 0..8
# (load_census_data/src/tables/employment_densities.rs:31-58).  Index order
# matches OccupationType::get_index (citizen.rs:312-324).
EMPLOYMENT_DENSITY_BY_OCCUPATION = (
    12,  # Manager           -> OFFICE_GENERAL_OFFICE
    12,  # Professional      -> OFFICE_GENERAL_OFFICE
    10,  # Technical         -> OFFICE_SERVICED_OFFICE
    12,  # Administrative    -> OFFICE_GENERAL_OFFICE
    36,  # SkilledTrades     -> INDUSTRIAL_GENERAL
    47,  # Caring            -> INDUSTRIAL_LIGHT_INDUSTRY_BUSINESS_PARK
    19,  # Sales             -> RETAIL_HIGH_STREET
    36,  # MachineOperatives -> INDUSTRIAL_GENERAL
    19,  # Teaching          -> RETAIL_HIGH_STREET
)

# Occupation encoding for the int8 occupation lane.
OCC_MANAGER = 0
OCC_PROFESSIONAL = 1
OCC_TECHNICAL = 2
OCC_ADMINISTRATIVE = 3
OCC_SKILLED_TRADES = 4
OCC_CARING = 5
OCC_SALES = 6
OCC_MACHINE_OPERATIVES = 7
OCC_TEACHING = 8
OCC_STUDENT = 9
OCC_UNEMPLOYED = 10

# Disease status encoding for the int8 status lane (disease.rs:36-44).
STATUS_SUSCEPTIBLE = 0
STATUS_EXPOSED = 1
STATUS_INFECTED = 2
STATUS_RECOVERED = 3
STATUS_VACCINATED = 4

# Mask status encoding (interventions.rs:26-30).
MASK_NONE = 0
MASK_PUBLIC_TRANSPORT = 1
MASK_EVERYWHERE = 2

# Storage dtype of the disease state-timer lanes.  Values stay < 400
# (disease.rs:47-71 resets at exposed/infected_time); the citizen-order lane
# is carried int32, the replicated-order twins int16.  Neither width has yet
# been measured against the other on the GPU.
TIMER_DTYPE = jnp.int32
TIMER_TWIN_DTYPE = jnp.int16


# ---------------------------------------------------------------------------
# Traced parameter pytrees
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiseaseParams:
    """SEIR(+V) disease model parameters (disease.rs:96-129).

    All fields are scalars traced through jit, so a ``vmap`` over a stacked
    ``DiseaseParams`` runs a parameter ensemble in one compilation.
    """

    exposure_chance: Any = 0.00055
    death_rate: Any = 0.2           # carried for parity; unused by reference hot loop
    exposed_time: Any = 4 * 24      # E -> I after timer passes this (disease.rs:54)
    infected_time: Any = 14 * 24    # I -> R after timer passes this (disease.rs:61)
    vaccination_rate: Any = 85 * 18  # citizens vaccinated per step (disease.rs:104)
    mask_percentage: Any = 0.8      # probability a citizen is mask compliant
    mask_effectiveness: Any = 0.70

    @staticmethod
    def covid() -> "DiseaseParams":
        """The reference's COVID-19 parameterisation (disease.rs:118-129)."""
        return DiseaseParams()

    def as_arrays(self) -> "DiseaseParams":
        return DiseaseParams(
            exposure_chance=jnp.asarray(self.exposure_chance, jnp.float32),
            death_rate=jnp.asarray(self.death_rate, jnp.float32),
            exposed_time=jnp.asarray(self.exposed_time, jnp.int32),
            infected_time=jnp.asarray(self.infected_time, jnp.int32),
            vaccination_rate=jnp.asarray(self.vaccination_rate, jnp.int32),
            mask_percentage=jnp.asarray(self.mask_percentage, jnp.float32),
            mask_effectiveness=jnp.asarray(self.mask_effectiveness, jnp.float32),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class InterventionThresholds:
    """Fraction-of-infected thresholds that trigger interventions.

    Values from interventions.rs:50-57 (masks) and :74-77 (lockdown /
    vaccination).  A negative value disables the intervention (the reference
    uses ``Option``; a sentinel keeps the pytree flat for vmap).
    """

    lockdown: Any = 0.0034
    vaccination: Any = 0.005
    mask_public_transport: Any = 0.001
    mask_everywhere: Any = 0.0022

    def as_arrays(self) -> "InterventionThresholds":
        return InterventionThresholds(
            lockdown=jnp.asarray(self.lockdown, jnp.float32),
            vaccination=jnp.asarray(self.vaccination, jnp.float32),
            mask_public_transport=jnp.asarray(self.mask_public_transport, jnp.float32),
            mask_everywhere=jnp.asarray(self.mask_everywhere, jnp.float32),
        )


#: v1.6-era exposure chance, calibrated on the census-like York world (mega
#: sites on) against the canonical artifact's trigger anatomy: at the 30%
#: vaccination trigger, E/I 0.571 vs the artifact's 0.568, trigger hour 853
#: vs 850, peak 87,542@949 vs 89,170@946 (docs/FIDELITY.md).
V16_EXPOSURE_CHANCE = 0.003


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Params:
    """Everything traced: disease model + intervention thresholds."""

    disease: DiseaseParams = dataclasses.field(default_factory=DiseaseParams)
    thresholds: InterventionThresholds = dataclasses.field(
        default_factory=InterventionThresholds
    )

    @staticmethod
    def covid() -> "Params":
        return Params(DiseaseParams.covid(), InterventionThresholds())

    @staticmethod
    def covid_v16() -> "Params":
        """The reference's *v1.6-era* parameterisation, recovered from its
        committed run logs (the v1.6 source itself is not in the repo).

        Empirically pinned values (logs/v1.6_test.log +
        logs/v1.6_no_jabs_timing_steps.log, 8 intervention transitions
        across two runs, interpolated against the 50-step SEIRV prints):

        * thresholds are **fractions of population infected** 100x today's:
          masks-on-PT at 0.20 (20.0% / 20.6% observed), vaccination at 0.30
          (28.8% / 30.8%), masks-everywhere at 0.40 (38.9% / 40.4%),
          lockdown at 0.60 (59.8% observed; never reached in the canonical
          York run, statistics_results/york_stats_results/v1.6) — which is
          why v1.6 produced a full epidemic (peak 89,170 infected) while
          v1.7.1's 0.0034 lockdown suppressed it at 2,315;
        * vaccination rate **5,100/step = 85 * 60** (today's disease.rs:126
          has ``85 * 18``).  Rounds 2-4 used 1,700 — the canonical drain
          window's *average* (+84,777 V over 50 steps) — but the faithful
          never-pruned-pool semantics re-pick already-vaccinated members,
          so the instantaneous ramp decays exponentially:
          ``V(t) = P(1 - exp(-r t / P))``.  Fitting that law to the
          canonical York artifact gives a per-step pool fraction
          f = 0.0535 at every probe point (t=10/25/50), i.e.
          r = f x 95,944 ~ 5,133/step — and the SAME fit on the
          reference's own 3.46M Y&H log gives f = 0.0033 with
          r = f x 1,532,302 ~ 5,057/step: one absolute constant across a
          17.5x population change, nailing the rate at ~5,100 (r5,
          docs/FIDELITY.md "the vaccination-rate correction");
        * first recovereds at hour ~336 and first infecteds at ~96 confirm
          exposed_time/infected_time unchanged;
        * ``exposure_chance`` is the one free parameter (the v1.6 source is
          not recoverable); it is calibrated on the census-like York world
          so the run reproduces the canonical artifact's *trigger anatomy*
          — the SEIRV state when infected crosses the 30% vaccination
          threshold (E/I ratio, ever-infected fraction, trigger hour) —
          which pins peak size, peak hour and the final R/V split.  See
          docs/FIDELITY.md for the calibration table and the multi-seed
          envelope.
        """
        return Params(
            DiseaseParams(exposure_chance=V16_EXPOSURE_CHANCE,
                          vaccination_rate=5100),
            InterventionThresholds(
                lockdown=0.60,
                vaccination=0.30,
                mask_public_transport=0.20,
                mask_everywhere=0.40,
            ),
        )

    def as_arrays(self) -> "Params":
        return Params(self.disease.as_arrays(), self.thresholds.as_arrays())

    # File-driven configuration — the reference's own TODO
    # (interventions.rs:51 "Make this loaded from a config file").
    @staticmethod
    def from_json(path: str) -> "Params":
        import json

        with open(path) as f:
            raw = json.load(f)
        return Params(
            disease=DiseaseParams(**raw.get("disease", {})),
            thresholds=InterventionThresholds(**raw.get("thresholds", {})),
        )

    def to_json(self, path: str) -> None:
        import dataclasses as dc
        import json

        with open(path, "w") as f:
            json.dump(
                {
                    "disease": dc.asdict(self.disease),
                    "thresholds": dc.asdict(self.thresholds),
                },
                f,
                indent=2,
            )


# ---------------------------------------------------------------------------
# Static compile-shaping config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static knobs.  Hashable; passed as a static argument to jit.

    * ``max_steps`` — simulation horizon in hours (disease.rs max_time_step).
    * ``chunk_size`` — steps per compiled ``lax.scan`` chunk; the host checks
      the early-exit condition between chunks (simulator.rs:146-150 semantics
      without giving up compiled throughput).
    * ``record_exposures_per_oa`` — per-OA exposure counts per step, the
      ``exposures.json`` artifact (statistics.rs:181-195).  Costs a
      ``(chunk, n_oa)`` output per chunk.
    * ``reference_mask_semantics`` — keep the reference's inverted mask logic
      (citizen.rs:228-232 passes ``MaskStatus::None`` for *compliant*
      citizens, so mask benefits accrue to non-compliant citizens only).
      Set False for the "intended" semantics.
    """

    max_steps: int = 5000
    chunk_size: int = 250
    record_exposures_per_oa: bool = True
    #: Dispatch single-device steps to the gather-free fast path
    #: (engine/fastpath.py) when the world carries fast tables.
    use_fast_path: bool = True
    #: Fuse the every-step citizen phase (timers, movement, census,
    #: household window, home draw, cond packing) into one pass
    #: (ops/citizen.py).  Its per-step counts route the sortless work and
    #: bus levers (use_sortless_dense / use_sortless_work / sparse apply),
    #: which need it.  None = auto (epidemicsimulator_tpu/backend.py: on
    #: for worlds with max_household_size <= 24).  Both formulations give
    #: bitwise-identical trajectories.
    use_fused_citizen: bool | None = None
    reference_mask_semantics: bool = True
    #: Replicate the reference's `exposure_total as u8` truncation
    #: (citizen.rs:239): infected counts wrap modulo 256 in the binomial.
    reference_u8_truncation: bool = True
    #: Replicate the reference's vaccine-eligibility quirks: citizens exposed
    #: via *buildings* stay in the eligible pool (the pruning at
    #: simulator.rs:346-348 targets OutputArea.citizens_eligible_for_vaccine,
    #: which is never initialised), already-vaccinated citizens stay in the
    #: pool (wasting slots), and chosen citizens are set to Vaccinated
    #: regardless of current status (simulator.rs:524-553).  Only bus
    #: exposures prune (simulator.rs:447-449).
    faithful_vaccine_bugs: bool = True
    #: Maintain disease state replicated in citizen, work and rider orders
    #: and move only the per-step deltas (new exposures / vaccinations /
    #: work hits) between them via K-bounded sparse transports — this
    #: removes the three N-sized permutation sorts from the hot loop.
    #: None = auto: off (an opt-in formulation).  Trajectories are
    #: bitwise-identical to the classic fast path.
    use_replicated_orders: bool | None = None
    #: Carry the five schedule bools packed in ONE int8 lane through the
    #: fused chunk scan (state.py::pack_sched).  None = auto: on for
    #: >= 16M citizens (a rule not yet measured on the GPU).  The fused
    #: citizen phase always speaks packed; this only selects the carry
    #: representation.
    use_packed_sched: bool | None = None
    #: Slot count K for the sparse cross-order transports; steps with more
    #: new exposures than this fall back to the dense permutation sort.
    sparse_transport_slots: int = 2048
    #: Apply the gated work/bus exposure hits (and the vaccine-pool prunes
    #: they imply) as K-bounded scatters instead of N-wide select chains:
    #: the fused citizen phase already applies home hits in-pass, the work
    #: branch returns its work-order hit mask (no N-sized backward
    #: permutation sort), and a while-loop drains hits
    #: ``apply_sparse_slots`` at a time (exact at any count; >1 round only
    #: past K hits per step).  Requires the fused citizen phase;
    #: incompatible with use_replicated_orders (which carries its own delta
    #: transport).  None = auto: dense.  engine.scan keeps a legacy
    #: regime-adaptive dense/sparse pair for >= 16M worlds where the dense
    #: sortless branches are off.  Trajectories are bitwise-identical
    #: either way.
    use_sparse_apply: bool | None = None
    #: Hits applied per scatter round of the sparse apply path.
    apply_sparse_slots: int = 8192
    #: Dense work branch only: ship work hits back to citizen order via
    #: K-bounded compaction + scatter through ``work_perm`` (hits per
    #: step are few) instead of the full backward u32 permutation sort.
    #: Exact at any hit count: past ``workback_slots`` hits an inner cond
    #: falls back to the sort, so trajectories are bitwise-identical
    #: either way (tested).  None = auto: on.
    use_sparse_workback: bool | None = None
    #: Hit slots of the dense-branch sparse work-back compaction.
    workback_slots: int = 8192
    #: Dense apply path: replace the forward work permutation sort with
    #: the sortless K-bounded drains (the ``use_sortless_work`` machinery,
    #: hits scattered straight back to citizen order) on hours whose
    #: contributor count fits ``sortless_slots * sortless_max_rounds``;
    #: heavier hours route to the sorted branch via the dispatch switch.
    #: Requires the fused citizen phase.  Bitwise-identical to the sorted
    #: dense branch (same streams, same hit set; tested).  None = auto: on
    #: at every scale.  When active, engine.scan runs one executable for
    #: every regime.
    use_sortless_dense: bool | None = None
    #: SHARDED engine only: run the sortless work/bus formulations inside
    #: the shard_map step (carried slot-space schedule lanes, contributor
    #: drains with ghost-bit merges, deferred susceptibility).
    #: Bitwise-identical to the sorted sharded branches (tested on the
    #: CPU mesh).  None = auto: off; not yet measured on a GPU mesh.
    use_sortless_sharded: bool | None = None
    #: Sortless work branch (sparse-apply path only): replace the forward
    #: N-sized u32 permutation sort with K-bounded drains: the infected
    #: work-contributor bits scatter into work order through the static
    #: ``wpos`` lane, and the post-draw hit candidates (``u < q``, already
    #: a tiny set) compact back through ``work_perm``.  Bitwise-identical
    #: to the sorted formulation (same pressure tables, same counter-hash
    #: streams, same hit set).  Peak hours whose contributor count exceeds
    #: ``sortless_slots * sortless_max_rounds`` are routed to the sorted
    #: branch by the caller's dispatch ``lax.switch`` (fastpath §7/§8);
    #: only the bus side's rare post-draw candidate overflow pays an inner
    #: fallback cond.  None = auto: on for populations >= 16M when the
    #: sparse apply is active (a rule not yet measured on the GPU).
    use_sortless_work: bool | None = None
    #: Contributor/candidate positions drained per round of the sortless
    #: transports.
    sortless_slots: int = 8192
    #: Sorted-formulation routing bound for the sortless transports, in
    #: units of ``sortless_slots`` (the drains stay exact at any count;
    #: past this many rounds of work the sorts are simply cheaper).  A
    #: drain round costs about the same at any N while the sort it
    #: replaces grows with N, so None = auto: 16 below 16M citizens, 64 at
    #: >= 16M (a rule not yet measured on the GPU).
    sortless_max_rounds: int | None = None
    #: Slot bound for the sparse per-OA home-exposure recording path
    #: (fastpath §9: compact hit positions + K-bounded scatter-add instead
    #: of cumsum + boundary gathers).  None = auto: 8192 for populations
    #: >= 16M and off below (a rule not yet measured on the GPU).
    #: 0 disables.
    oa_sparse_slots: int | None = None
    #: Debug/test only: override the bus-hit slot bound (k_bt, normally
    #: min(16384, n_riders)).  A tiny value forces the sortless bus
    #: branch's post-draw candidate-overflow fallback cond — unreachable
    #: below 16384 riders otherwise — so tests can pin its equivalence.
    debug_bus_hit_slots: int | None = None
    #: Debug only: (work, bus) lax.cond gate forcings for the fast path —
    #: None leaves a gate on its computed predicate, True/False pins it.
    #: Forcing a gate False skips that exposure source (NOT
    #: semantics-preserving); for subtractive step-budget measurements.
    debug_force_gates: tuple | None = None
    #: Static upper bound on vaccinations per step (sizes the on-device top-k
    #: selection; the traced DiseaseParams.vaccination_rate must not exceed
    #: it).
    max_vaccinations_per_step: int = 85 * 18
    #: Sampled vaccination draws (fast path only): keep the eligible pool
    #: as a compacted index array (rebuilt by one device sort only when the
    #: pool halves), and each step draw ~8k uniform candidate slots, reject
    #: entries whose citizens left the pool (checked against the live
    #: ``eligible`` lane), and take the first k distinct — a uniform
    #: k-subset of the current pool, i.e. the SAME LAW as the default
    #: fresh-threshold selector, for both faithful and intended pool
    #: semantics.  All per-step work is K-sized; a lax.cond falls back to
    #: the threshold selector on candidate shortfall (exactness preserved
    #: — the fallback is also a uniform k-subset).  Changes which
    #: individual citizens are picked (different draw stream), so
    #: trajectories differ from the default mode but match in law.
    #: Requires init_state(..., fixed_priority_vax=True) for the lanes.
    #: None = auto: on for fast-path worlds with >= 16M citizens, where
    #: the pool-wide threshold search grows with N (a rule not yet
    #: measured on the GPU).
    vaccination_fixed_priority: bool | None = None
    #: Sharded engine's exact-k vaccination selector
    #: (ops/select.py::kth_threshold_sharded): None = auto — the
    #: sampled-band search (3 collective rounds: sample all_gather, packed
    #: psum, band all_gather) when the per-shard sample stride is >= 4,
    #: else the 32-round psum bisection.  True/False pins the branch
    #: (tests / A/B runs).  Both return the identical exact threshold,
    #: so trajectories are bitwise-independent of the setting.
    use_sampled_vax_sharded: bool | None = None
    #: log2 of the per-shard sample size the sharded sampled-band selector
    #: draws (default 2^17 per shard; the auto rule above keeps
    #: stride = shard_size / sample >= 4).  Tests shrink it to force the
    #: sampled branch on tiny CPU-mesh worlds.
    vax_sharded_sample_log2: int = 17
    #: Packed-ensemble bus RNG mode (engine/packed.py): None/False = the
    #: default counter-based streams (random.bits/uniform over the local
    #: rider axis — stream depends on the packed lane length); True = ties
    #: and exposure draws hash GLOBAL rider ids (ops/segments.py bus_hits
    #: tie_bits/draw_seed), making per-replica trajectories invariant to
    #: how replicas are sharded across devices.  Law-identical either way;
    #: the replicate-sharded runner (parallel/ensemble_mesh.py) forces
    #: True so an R-replica run matches the single-device R-packing
    #: bitwise at any mesh size.
    id_keyed_ensemble_rng: bool | None = None
    #: Debug only: bitmask subtracting pieces of the SHARDED step for a
    #: per-collective cost table.  bit0: psum/all_gather collectives
    #: become local values (value-identical on a 1-device mesh), bit1:
    #: ghost all_to_all machinery skipped (value-identical when no
    #: cross-shard worker exists), bit2: the idempotent hit-combine
    #: re-apply after the gated sides skipped (value-identical in the
    #: fused moving regime with both sides forced off and vaccination
    #: disabled).  -1 = all real.  NOT semantics-preserving outside those
    #: regimes.
    debug_shard_parts: int = -1
    #: Debug only: bitmask subtracting pieces of the vaccinate branch
    #: (NOT semantics-preserving).  bit0: real exact-k selector (else a
    #: fixed-threshold fake), bit1: apply the status/eligible updates,
    #: bit2: replicated-order fan-out of the chosen lane.  -1 = all real.
    debug_vax_parts: int = -1
    bus_capacity: int = BUS_CAPACITY
    starting_infected: int = STARTING_INFECTED_COUNT
    debug_print_every: int = DEBUG_ITERATION_PRINT
