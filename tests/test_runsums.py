"""Run totals, range totals and cumsums (ops/runsums.py) against numpy.

These are the plain XLA scans the engines use for per-household,
per-building, per-room and per-OA infected counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epidemicsimulator_tpu.ops.runsums import (
    range_totals,
    run_totals,
    run_totals_from_cumsum,
)


def _random_runs(rng, n, avg_run):
    """Random contiguous partition of [0, n) -> start/end masks."""
    starts = np.zeros(n, bool)
    ends = np.zeros(n, bool)
    i = 0
    while i < n:
        ln = max(1, int(rng.poisson(avg_run)))
        j = min(n, i + ln)
        starts[i] = True
        ends[j - 1] = True
        i = j
    return starts, ends


def _np_run_totals(v, starts):
    ids = np.cumsum(starts) - 1
    return np.bincount(ids, weights=v)[ids].astype(np.int32)


@pytest.mark.parametrize("n", [96, 128, 1024, 4096, 70_000])
def test_single_set_matches_reference(n):
    rng = np.random.default_rng(n)
    v = (rng.random(n) < 0.2).astype(np.int8)
    starts, ends = _random_runs(rng, n, avg_run=4)
    got = run_totals(jnp.asarray(v), jnp.asarray(starts), jnp.asarray(ends))
    np.testing.assert_array_equal(np.asarray(got), _np_run_totals(v, starts))


def test_dual_set_shares_values():
    """Two nested boundary structures over one values lane and one cumsum
    (the work side's building + room structure)."""
    rng = np.random.default_rng(7)
    n = 9_000
    v = (rng.random(n) < 0.3).astype(np.int32)
    coarse = _random_runs(rng, n, avg_run=60)
    # fine runs nested inside coarse ones: room boundaries include every
    # building boundary
    fs, fe = _random_runs(rng, n, avg_run=9)
    fs |= coarse[0]
    fe |= coarse[1]
    # realign: every end must be followed by a start
    fs[1:] |= fe[:-1]
    fe[:-1] |= fs[1:]

    vj = jnp.asarray(v)
    cs = jnp.cumsum(vj)
    got_c = run_totals_from_cumsum(
        cs, vj, jnp.asarray(coarse[0]), jnp.asarray(coarse[1])
    )
    got_f = run_totals_from_cumsum(cs, vj, jnp.asarray(fs), jnp.asarray(fe))
    np.testing.assert_array_equal(np.asarray(got_c), _np_run_totals(v, coarse[0]))
    np.testing.assert_array_equal(np.asarray(got_f), _np_run_totals(v, fs))


def test_all_zero_and_all_one_values():
    n = 2_000
    starts = np.zeros(n, bool)
    ends = np.zeros(n, bool)
    starts[0] = True
    ends[-1] = True  # one giant run
    for v in (np.zeros(n, np.int8), np.ones(n, np.int8)):
        got = run_totals(jnp.asarray(v), jnp.asarray(starts), jnp.asarray(ends))
        np.testing.assert_array_equal(
            np.asarray(got), np.full(n, int(v.sum()), np.int32)
        )


def test_singleton_runs():
    n = 1_111
    rng = np.random.default_rng(3)
    v = rng.integers(0, 3, n).astype(np.int8)
    starts = np.ones(n, bool)
    ends = np.ones(n, bool)
    got = run_totals(jnp.asarray(v), jnp.asarray(starts), jnp.asarray(ends))
    np.testing.assert_array_equal(np.asarray(got), v.astype(np.int32))


def test_world_boundary_sets_match_bincount():
    """Run totals over a synthetic world's own household, workplace and
    room boundary sets equal numpy group sums."""
    from epidemicsimulator_tpu import generate_synthetic_world

    world = generate_synthetic_world(20_000, n_output_areas=16, seed=9)
    rng = np.random.default_rng(5)
    v = (rng.random(world.n_citizens) < 0.25).astype(np.int32)
    rt = jax.jit(run_totals)
    for start, end in (
        (world.home_start_mask, world.home_end_mask),
        (world.ws_wb_start_mask, world.ws_wb_end_mask),
        (world.ws_room_start_mask, world.ws_room_end_mask),
    ):
        got = rt(jnp.asarray(v), jnp.asarray(start), jnp.asarray(end))
        np.testing.assert_array_equal(
            np.asarray(got), _np_run_totals(v, np.asarray(start))
        )


@pytest.mark.parametrize("n", [50, 128, 131_072, 200_000])
def test_cumsum(n):
    rng = np.random.default_rng(n)
    v = (rng.random(n) < 0.3).astype(np.int8)
    got = np.asarray(jnp.cumsum(jnp.asarray(v).astype(jnp.int32)))
    np.testing.assert_array_equal(got, np.cumsum(v).astype(np.int32))


def test_range_totals():
    rng = np.random.default_rng(1)
    n = 33_000
    v = (rng.random(n) < 0.4).astype(np.int8)
    cuts = np.sort(rng.choice(n, 40, replace=False))
    lo = np.r_[0, cuts].astype(np.int32)
    hi = np.r_[cuts, n].astype(np.int32)
    got = range_totals(jnp.asarray(v), jnp.asarray(lo), jnp.asarray(hi))
    want = np.add.reduceat(v.astype(np.int32), lo)
    np.testing.assert_array_equal(np.asarray(got), want)
