"""Fused citizen phase (ops/citizen.py) vs the unfused fast path, and the
levers its per-step counts route (sortless, sparse apply, packed carry).

Both formulations draw home exposures from the same counter-hash stream
with the same chance function, so trajectories agree bitwise in every
regime; the deterministic regime (exposure_chance=1: every draw
probability is exactly 0 or 1) also holds across backends whose float
functions round differently.  The hash stream itself is checked for
uniformity separately.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
from epidemicsimulator_tpu.config import STATUS_INFECTED
from epidemicsimulator_tpu.engine.state import init_state
from epidemicsimulator_tpu.engine.step import step


@pytest.mark.parametrize("transport", [False, True])
def test_fused_matches_unfused_deterministically(transport):
    world = generate_synthetic_world(3000, n_output_areas=6, seed=4)
    if not transport:
        world = dataclasses.replace(
            world,
            uses_transport=np.zeros(world.n_citizens, bool),
            ws_uses_transport=np.zeros(world.n_citizens, bool),
            rider_perm=np.zeros(0, np.int32),
            rider_route=np.zeros(0, np.int32),
            rider_mask_compliant=np.zeros(0, bool),
        )
    base = Params.covid()
    params = Params(
        dataclasses.replace(
            base.disease, exposure_chance=1.0, exposed_time=6,
            infected_time=12, vaccination_rate=0,
        ),
        dataclasses.replace(
            base.thresholds, vaccination=-1.0,
            mask_public_transport=2.0, mask_everywhere=2.0,
        ),
    ).as_arrays()

    trajs = []
    for fused in (True, False):
        cfg = SimConfig(
            use_fused_citizen=fused,
            max_vaccinations_per_step=1,
            bus_capacity=8192 if transport else 20,
        )
        st = init_state(world, seed=0, starting_infected=0)
        status0 = np.zeros(world.n_citizens, np.int8)
        status0[::307] = STATUS_INFECTED
        from epidemicsimulator_tpu.engine.state import with_status
        st = with_status(st, world, status0)
        wd = world.device_put()
        jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
        rows = []
        for _ in range(60):
            st, out = jstep(wd, params, st)
            rows.append(
                (
                    np.asarray(st.status).copy(),
                    np.asarray(st.at_work).copy(),
                    np.asarray(st.on_bus).copy(),
                    np.asarray(out.seirv).copy(),
                    np.asarray(out.exposures_per_oa).copy(),
                )
            )
        trajs.append(rows)

    for t, (a, b) in enumerate(zip(*trajs)):
        for k, name in enumerate(("status", "at_work", "on_bus", "seirv", "oa")):
            assert (a[k] == b[k]).all(), f"{name} diverged at step {t + 1}"


def test_hash_uniform_distribution():
    from epidemicsimulator_tpu.ops.hashrng import hash_uniform

    n = 200_000
    u = np.asarray(
        hash_uniform(jnp.uint32(12345), jnp.arange(n, dtype=jnp.uint32))
    )
    assert (u >= 0).all() and (u < 1).all()
    assert abs(u.mean() - 0.5) < 0.005
    assert abs(u.var() - 1 / 12) < 0.002
    # decile occupancy within 3% of uniform
    h, _ = np.histogram(u, bins=10, range=(0, 1))
    assert (abs(h / (n / 10) - 1) < 0.03).all()
    # successive-step streams decorrelated
    u2 = np.asarray(
        hash_uniform(jnp.uint32(12346), jnp.arange(n, dtype=jnp.uint32))
    )
    assert abs(np.corrcoef(u, u2)[0, 1]) < 0.01


def test_fused_stochastic_epidemic_grows_comparably():
    """Same world, same params, different RNG streams: epidemic sizes after
    a fixed horizon should land in the same ballpark (loose 3x bracket)."""
    world = generate_synthetic_world(20_000, n_output_areas=12, seed=1)
    params = Params.covid().as_arrays()
    totals = {}
    for fused in (True, False):
        cfg = SimConfig(use_fused_citizen=fused)
        st = init_state(world, seed=7, starting_infected=60)
        wd = world.device_put()
        jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
        for _ in range(24 * 14):
            st, out = jstep(wd, params, st)
        seirv = np.asarray(out.seirv)
        totals[fused] = int(seirv[1] + seirv[2] + seirv[3])  # ever-infected
    assert totals[True] > 60 and totals[False] > 60, totals
    ratio = totals[True] / max(totals[False], 1)
    assert 1 / 3 < ratio < 3, totals


def test_packed_sched_carry_bitwise_matches_unpacked():
    """The packed schedule carry (SimConfig.use_packed_sched; one s8 lane
    through the scan, engine/state.py::pack_sched) must be bitwise-identical
    to the unpacked bool-lane carry — same citizen phase, same draws, only
    the carry representation differs.  Runs the fused phase on a small
    world via the real chunk runner."""
    from epidemicsimulator_tpu.engine.scan import make_chunk_runner

    world = generate_synthetic_world(12_000, n_output_areas=8, seed=3)
    wd = world.device_put()
    params = Params.covid().as_arrays()
    results = {}
    for packed in (False, True):
        cfg = SimConfig(
            max_steps=72, chunk_size=24,
            use_fused_citizen=True, use_packed_sched=packed,
        )
        st = init_state(wd, seed=5, starting_infected=40)
        fn = make_chunk_runner(wd, cfg)
        outs = []
        for _ in range(3):
            st, out = fn(params, st)
            outs.append(np.asarray(out.seirv))
        results[packed] = (np.concatenate(outs), np.asarray(st.status),
                          np.asarray(st.timer))
        # the runner must hand back the PUBLIC (unpacked) representation
        assert st.sched is None or st.sched.shape[0] == 0
        assert st.at_work.shape[0] == world.n_citizens
    for a, b in zip(results[False], results[True]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("faithful", [True, False])
def test_sparse_apply_bitwise_matches_dense(faithful):
    """The K-bounded sparse apply (SimConfig.use_sparse_apply: work/bus
    hits drained as scatter rounds) must be bitwise-identical to the dense
    N-wide select apply under the same fused phase.  apply_sparse_slots=4
    forces many while-loop rounds per step; a small bus capacity plus high
    exposure keeps work AND bus branches firing; both vaccine-bug regimes
    (simulator.rs:447-449) exercise their distinct eligible-prune flags."""
    world = generate_synthetic_world(8_000, n_output_areas=6, seed=11)
    wd = world.device_put()
    base = Params.covid()
    params = Params(
        dataclasses.replace(base.disease, exposure_chance=0.9),
        base.thresholds,
    ).as_arrays()
    results = {}
    for sparse in (False, True):
        cfg = SimConfig(
            use_fused_citizen=True, use_sparse_apply=sparse, apply_sparse_slots=4,
            bus_capacity=16, faithful_vaccine_bugs=faithful,
            # force the K-bounded per-OA recording paths (home AND the
            # sparse arm's work-OA scatter) — 8 slots means both the
            # sparse and dense-fallback sides of their conds fire
            oa_sparse_slots=8,
        )
        st = init_state(wd, seed=2, starting_infected=50)
        jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
        rows = []
        for _ in range(48):
            st, out = jstep(wd, params, st)
            rows.append((np.asarray(out.seirv), np.asarray(out.exposures_per_oa)))
        results[sparse] = (
            rows, np.asarray(st.status), np.asarray(st.timer),
            np.asarray(st.eligible),
        )
    for t, (a, b) in enumerate(zip(results[False][0], results[True][0])):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"seirv step {t}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"oa step {t}")
    for k in (1, 2, 3):
        np.testing.assert_array_equal(results[False][k], results[True][k])


@pytest.mark.parametrize("faithful", [True, False])
def test_sortless_work_bitwise_matches_sorted(faithful):
    """The sortless work branch (SimConfig.use_sortless_work: contributor
    bits scattered into work order through wpos, post-draw candidates
    compacted back through work_perm) must be bitwise-identical to the
    sorted sparse work branch.  sortless_slots=4 forces multi-round drains;
    sortless_max_rounds=4 makes peak steps (contributors > 16) take the
    sorted-fallback side of the inner cond, so BOTH sides execute."""
    world = generate_synthetic_world(8_000, n_output_areas=6, seed=11)
    wd = world.device_put()
    base = Params.covid()
    params = Params(
        dataclasses.replace(base.disease, exposure_chance=0.9),
        base.thresholds,
    ).as_arrays()
    results = {}
    for sortless in (False, True):
        cfg = SimConfig(
            use_fused_citizen=True, use_sparse_apply=True, apply_sparse_slots=4,
            use_sortless_work=sortless, sortless_slots=4,
            sortless_max_rounds=4,
            bus_capacity=16, faithful_vaccine_bugs=faithful,
            oa_sparse_slots=8,
        )
        st = init_state(wd, seed=2, starting_infected=50)
        jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
        rows = []
        for _ in range(48):
            st, out = jstep(wd, params, st)
            rows.append(
                (np.asarray(out.seirv), np.asarray(out.exposures_per_oa))
            )
        results[sortless] = (
            rows, np.asarray(st.status), np.asarray(st.timer),
            np.asarray(st.eligible),
        )
    for t, (a, b) in enumerate(zip(results[False][0], results[True][0])):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"seirv step {t}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"oa step {t}")
    for k in (1, 2, 3):
        np.testing.assert_array_equal(results[False][k], results[True][k])


def test_chunk_runner_matches_raw_steps():
    """The chunk runner's scan plumbing (packed carry, hoisted PRNG key,
    packed per-step outputs) must reproduce raw per-step `step()` calls
    bitwise: same seirv series, same final state lanes."""
    from epidemicsimulator_tpu.engine.scan import make_chunk_runner

    world = generate_synthetic_world(9_000, n_output_areas=6, seed=4)
    wd = world.device_put()
    params = Params.covid().as_arrays()
    cfg = SimConfig(
        max_steps=48, chunk_size=24,
        use_fused_citizen=True, use_packed_sched=True,
    )

    st = init_state(wd, seed=9, starting_infected=30)
    fn = make_chunk_runner(wd, cfg)
    seirv_chunks = []
    for _ in range(2):
        st, out = fn(params, st)
        seirv_chunks.append(np.asarray(out.seirv))
    seirv_runner = np.concatenate(seirv_chunks)

    st2 = init_state(wd, seed=9, starting_infected=30)
    jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
    seirv_raw = []
    for _ in range(48):
        st2, out2 = jstep(wd, params, st2)
        seirv_raw.append(np.asarray(out2.seirv))
    seirv_raw = np.stack(seirv_raw)

    np.testing.assert_array_equal(seirv_runner, seirv_raw)
    np.testing.assert_array_equal(np.asarray(st.status), np.asarray(st2.status))
    np.testing.assert_array_equal(np.asarray(st.timer), np.asarray(st2.timer))
    np.testing.assert_array_equal(
        np.asarray(st.at_work), np.asarray(st2.at_work)
    )


def test_sortless_bus_overflow_signal_and_parity():
    """The sortless bus transport's overflow contract (ADVICE r3): with a
    small ``max_hits``, ``bus_hits_sortless`` must REPORT candidate
    overflow via ``cand_total`` (so the fastpath fallback cond fires), and
    with ``max_hits >= n_riders`` its sparse outputs must be bitwise those
    of :func:`bus_hits` (same shuffle/draw keys, susceptibility deferred to
    the compacted candidates)."""
    from epidemicsimulator_tpu.ops.segments import bus_hits, bus_hits_sortless

    r = 256
    rng = np.random.default_rng(7)
    rb_on = jnp.ones((r,), bool)
    rb_inf = jnp.asarray(rng.random(r) < 0.5)
    rb_susc = jnp.asarray(~np.asarray(rb_inf))
    rb_compliant = jnp.asarray(rng.random(r) < 0.3)
    rider_route = jnp.asarray(rng.integers(0, 5, r), jnp.int32)
    rider_citizen_id = jnp.arange(r, dtype=jnp.int32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))

    def p_fn(compliant, valid):
        # high per-contact chance -> nearly every rider on an infected bus
        # is a post-draw candidate
        return jnp.where(valid, jnp.where(compliant, 0.95, 0.99), 0.0)

    def susc_of_rider(rider_ids):
        return jnp.take(rb_susc, jnp.minimum(rider_ids, r - 1))

    # 1. overflow signal: candidates exceed a tiny max_hits
    *_, cand_total_small = bus_hits_sortless(
        k1, k2, rb_on, rb_inf, rb_compliant, rider_route,
        rider_citizen_id, 20, p_fn, susc_of_rider, max_hits=8,
    )
    assert int(cand_total_small) > 8

    # 2. parity when the bound is not hit
    lane_sl, ids_sl, live_sl, nh_sl, cit_sl, cand_total = bus_hits_sortless(
        k1, k2, rb_on, rb_inf, rb_compliant, rider_route,
        rider_citizen_id, 20, p_fn, susc_of_rider, max_hits=r,
    )
    assert int(cand_total) <= r
    _, lane_s, ids_s, live_s, nh_s, cit_s = bus_hits(
        k1, k2, rb_on, rb_inf, rb_susc, rb_compliant, rider_route,
        rider_citizen_id, 20, p_fn, r, max_hits=r, want_cit_lane=False,
    )
    np.testing.assert_array_equal(np.asarray(lane_sl), np.asarray(lane_s))
    assert int(nh_sl) == int(nh_s) > 0
    live_ids_sl = sorted(np.asarray(ids_sl)[np.asarray(live_sl)].tolist())
    live_ids_s = sorted(np.asarray(ids_s)[np.asarray(live_s)].tolist())
    assert live_ids_sl == live_ids_s
    live_cit_sl = sorted(np.asarray(cit_sl)[np.asarray(live_sl)].tolist())
    live_cit_s = sorted(np.asarray(cit_s)[np.asarray(live_s)].tolist())
    assert live_cit_sl == live_cit_s


@pytest.mark.parametrize("faithful", [True, False])
def test_sortless_bus_overflow_fallback_bitwise(faithful):
    """Force the sortless bus branch's inner overflow cond (unreachable at
    the default k_bt = min(16384, R) below 16384 riders) with the
    debug_bus_hit_slots override and assert the full step trajectory stays
    bitwise-identical to the sorted sparse formulation under the SAME
    bound — the fallback must hand off to the sorted body exactly."""
    world = generate_synthetic_world(8_000, n_output_areas=6, seed=11)
    wd = world.device_put()
    base = Params.covid()
    params = Params(
        dataclasses.replace(base.disease, exposure_chance=0.9),
        base.thresholds,
    ).as_arrays()
    results = {}
    for sortless in (False, True):
        cfg = SimConfig(
            use_fused_citizen=True, use_sparse_apply=True, apply_sparse_slots=4,
            use_sortless_work=sortless, sortless_slots=64,
            sortless_max_rounds=16,
            bus_capacity=16, faithful_vaccine_bugs=faithful,
            debug_bus_hit_slots=2,
        )
        st = init_state(wd, seed=2, starting_infected=50)
        jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
        rows = []
        for _ in range(48):
            st, out = jstep(wd, params, st)
            rows.append(np.asarray(out.seirv))
        results[sortless] = (
            rows, np.asarray(st.status), np.asarray(st.timer),
            np.asarray(st.eligible),
        )
    for t, (a, b) in enumerate(zip(results[False][0], results[True][0])):
        np.testing.assert_array_equal(a, b, err_msg=f"seirv step {t}")
    for k in (1, 2, 3):
        np.testing.assert_array_equal(results[False][k], results[True][k])


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("bus_slots", [None, 2])
def test_sortless_dense_bitwise_matches_sorted(faithful, bus_slots):
    """The DENSE apply's sortless work branch (SimConfig.use_sortless_dense:
    the sparse path's K-bounded drains with hits scattered straight back
    to citizen order) must be bitwise-identical to the sorted dense
    branch.  sortless_slots=4 forces multi-round drains; max_rounds=4
    routes peak hours through the sorted side of the dispatch switch, so
    BOTH sides execute."""
    world = generate_synthetic_world(8_000, n_output_areas=6, seed=11)
    wd = world.device_put()
    base = Params.covid()
    params = Params(
        dataclasses.replace(base.disease, exposure_chance=0.9),
        base.thresholds,
    ).as_arrays()
    results = {}
    for sortless in (False, True):
        cfg = SimConfig(
            use_fused_citizen=True, use_sortless_dense=sortless, sortless_slots=4,
            sortless_max_rounds=4,
            bus_capacity=16, faithful_vaccine_bugs=faithful,
            # bus_slots=2 forces the dense sortless bus branch's
            # candidate-overflow fallback cond
            debug_bus_hit_slots=bus_slots,
        )
        st = init_state(wd, seed=2, starting_infected=50)
        jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
        rows = []
        for _ in range(48):
            st, out = jstep(wd, params, st)
            rows.append(
                (np.asarray(out.seirv), np.asarray(out.exposures_per_oa))
            )
        results[sortless] = (
            rows, np.asarray(st.status), np.asarray(st.timer),
            np.asarray(st.eligible),
        )
    for t, (a, b) in enumerate(zip(results[False][0], results[True][0])):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"seirv step {t}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"oa step {t}")
    for k in (1, 2, 3):
        np.testing.assert_array_equal(results[False][k], results[True][k])


def test_citizen_phase_groups_match_per_group_calls():
    """Group mode (one (n_groups,) parameter row per equal contiguous span,
    as the packed ensemble calls it) equals calling the phase on each span
    alone with its own scalars and its global-id offset."""
    from epidemicsimulator_tpu.ops.citizen import (
        citizen_phase, make_citizen_statics,
    )

    world = generate_synthetic_world(4_000, n_output_areas=8, seed=6)
    # spans must not cut a household, as replica spans never do
    starts = set(np.flatnonzero(np.asarray(world.home_start_mask)).tolist())
    half = max(h for h in starts if 2 * h in starts)
    n = 2 * half
    rng = np.random.default_rng(2)
    status = jnp.asarray(
        rng.choice(5, n, p=[0.6, 0.1, 0.2, 0.05, 0.05]).astype(np.int8)
    )
    timer = jnp.asarray(rng.integers(0, 400, n).astype(np.int32))
    sched = jnp.asarray(rng.integers(0, 32, n).astype(np.int8))
    statics = jax.tree.map(lambda x: x[:n], make_citizen_statics(world))
    rows = dict(
        move=jnp.array([True, False]), mask_status=jnp.array([2, 0], jnp.int8),
        exposed_time=jnp.array([96, 5], jnp.int32),
        infected_time=jnp.array([336, 9], jnp.int32),
        exposure_chance=jnp.array([0.3, 0.05], jnp.float32),
        mask_effectiveness=jnp.array([0.7, 0.2], jnp.float32),
    )
    common = dict(h24=jnp.int8(9), seed=jnp.uint32(1234),
                  K=world.max_household_size, ref_mask_sem=False,
                  u8_trunc=True)
    grouped = citizen_phase(statics, status, timer, sched, n_groups=2,
                            **rows, **common)
    for g in range(2):
        sl = slice(g * half, (g + 1) * half)
        alone = citizen_phase(
            jax.tree.map(lambda x: x[sl], statics),
            status[sl], timer[sl], sched[sl],
            gid0=g * half, **{k: v[g] for k, v in rows.items()}, **common,
        )
        for a, b in zip(grouped[:4], alone[:4]):
            np.testing.assert_array_equal(np.asarray(a)[sl], np.asarray(b))
        np.testing.assert_array_equal(
            np.asarray(grouped[4])[g], np.asarray(alone[4])[0]
        )
    assert int(np.asarray(grouped[4])[:, 7].sum()) > 0  # home hits drawn
