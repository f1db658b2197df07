"""Regime-adaptive sparse-apply dispatch in engine.scan.run.

Both formulations of the apply stage are bitwise-identical
(tests/test_fused_citizen.py pins that at the step level); this pins the
dispatch layer itself: run() switching executables mid-run off the
host-visible lockdown flag produces the same trajectory as either fixed
executable, and the dispatcher actually uses both across a lockdown
transition.
"""

import dataclasses

import numpy as np
import pytest

from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
from epidemicsimulator_tpu.engine import scan
from epidemicsimulator_tpu.engine.state import init_state


def _world():
    return generate_synthetic_world(4000, n_output_areas=8, seed=3).device_put()


def _params():
    base = Params.covid()
    # Aggressive disease + short timers so one short run crosses the
    # lockdown threshold on the way up AND lifts it on the way down.
    return Params(
        dataclasses.replace(
            base.disease, exposure_chance=0.02, exposed_time=4,
            infected_time=12, vaccination_rate=0,
        ),
        dataclasses.replace(base.thresholds, lockdown=0.02, vaccination=-1.0),
    )


def _cfg(**kw):
    return SimConfig(
        max_steps=200, chunk_size=25,
        use_fused_citizen=True,
        record_exposures_per_oa=False,
        **kw,
    )


def test_adaptive_dispatch_matches_fixed(monkeypatch):
    monkeypatch.setattr(scan, "ADAPTIVE_SPARSE_MIN_N", 1)
    world = _world()
    params = _params()

    runs = {}
    for name, sparse in (("adaptive", None), ("dense", False), ("sparse", True)):
        st = init_state(world, seed=0, starting_infected=20)
        _, out = scan.run(world, params, _cfg(use_sparse_apply=sparse), st)
        runs[name] = out

    lock = np.asarray(runs["adaptive"].lockdown)
    assert lock.any() and not lock.all(), (
        "regime must transition within the run for this test to bite"
    )
    for name in ("dense", "sparse"):
        np.testing.assert_array_equal(
            np.asarray(runs["adaptive"].seirv), np.asarray(runs[name].seirv)
        )
        np.testing.assert_array_equal(
            np.asarray(runs["adaptive"].exposures_per_oa),
            np.asarray(runs[name].exposures_per_oa),
        )


def test_adaptive_dispatch_uses_both_executables(monkeypatch):
    """With sortless-dense explicitly OFF the legacy dense/sparse pair
    still dispatches across regimes (the retired-by-default machinery
    stays testable)."""
    monkeypatch.setattr(scan, "ADAPTIVE_SPARSE_MIN_N", 1)
    world = _world()
    st = init_state(world, seed=0, starting_infected=20)
    cfg = _cfg(use_sortless_dense=False)

    used = []
    real = scan.make_chunk_runner

    def spy(world_, cfg_):
        fn = real(world_, cfg_)
        if cfg_.use_sparse_apply is None:
            return fn

        def wrapped(params, state):
            used.append(bool(cfg_.use_sparse_apply))
            return fn(params, state)

        return wrapped

    monkeypatch.setattr(scan, "make_chunk_runner", spy)
    scan.run(world, _params(), cfg, st)
    assert True in used and False in used, used


def test_adaptive_dispatch_retired_and_legacy(monkeypatch):
    world = _world()
    st = init_state(world, seed=0, starting_infected=20)
    assert scan.adaptive_sparse_runners(world, _cfg(), st) is None
    monkeypatch.setattr(scan, "ADAPTIVE_SPARSE_MIN_N", 1)
    # r4 final: with sortless-dense active (the default) ONE executable
    # serves both regimes — the dispatch is retired
    assert scan.adaptive_sparse_runners(world, _cfg(), st) is None
    # explicit settings pin one executable
    assert scan.adaptive_sparse_runners(
        world, _cfg(use_sparse_apply=True), st
    ) is None
    assert scan.adaptive_sparse_runners(
        world, _cfg(use_sparse_apply=False), st
    ) is None
    # the legacy pair remains when sortless-dense is explicitly off
    assert scan.adaptive_sparse_runners(
        world, _cfg(use_sortless_dense=False), st
    ) is not None


def test_sortless_rounds_resolution():
    """sortless_max_rounds auto is scale-aware: 16 below 16M citizens, 64
    at >=16M (drain rounds cost ~the same at any N while the sort they
    replace grows with N); explicit values pass through."""
    from epidemicsimulator_tpu.engine.fastpath import sortless_rounds

    assert sortless_rounds(3_457_142, SimConfig()) == 16
    assert sortless_rounds(63_000_000, SimConfig()) == 64
    assert sortless_rounds(63_000_000,
                           SimConfig(sortless_max_rounds=4)) == 4
    assert sortless_rounds(1000, SimConfig(sortless_max_rounds=0)) == 1
