"""Packed-replica ensemble (engine/packed.py) vs solo runs.

In a deterministic regime (exposure_chance=1: every draw probability is 0
or 1) each packed replica must reproduce the solo single-world fast-path
trajectory for its own parameters exactly — replicas are disjoint copies,
so any cross-replica leak or mis-broadcast param lane shows up as a
mismatch.  Transport is stripped for exactness (bus composition is
shuffle-dependent); a stochastic with-transport case checks conservation
and per-replica intervention triggering instead.
"""

import dataclasses

import numpy as np
import pytest

from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
from epidemicsimulator_tpu.config import STATUS_INFECTED
from epidemicsimulator_tpu.engine.packed import (
    init_packed_state, make_packed_runner, pack_replicas,
    run_packed_ensemble,
)
from epidemicsimulator_tpu.engine.state import init_state, with_status
from epidemicsimulator_tpu.engine.step import step


def _strip_transport(world):
    return dataclasses.replace(
        world,
        uses_transport=np.zeros(world.n_citizens, bool),
        ws_uses_transport=np.zeros(world.n_citizens, bool),
        rider_perm=np.zeros(0, np.int32),
        rider_route=np.zeros(0, np.int32),
        rider_mask_compliant=np.zeros(0, bool),
    )


def _solo_run(world, params, status0, steps):
    import jax

    cfg = SimConfig(
        use_fast_path=True, use_fused_citizen=False,
        max_vaccinations_per_step=4096,
    )
    st = init_state(world, seed=0, starting_infected=0)
    st = with_status(st, world, status0)
    jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
    wd = world.device_put()
    p = params.as_arrays()
    rows = []
    for _ in range(steps):
        st, out = jstep(wd, p, st)
        rows.append(np.asarray(out.seirv))
    return np.stack(rows)


def test_packed_matches_solo_deterministic():
    base = _strip_transport(
        generate_synthetic_world(3000, n_output_areas=8, seed=6)
    )
    b = Params.covid()
    th = dataclasses.replace(
        b.thresholds, lockdown=0.5, vaccination=-1.0,
        mask_public_transport=2.0, mask_everywhere=2.0,
    )
    # deterministic regimes with per-replica timer params
    param_list = [
        Params(
            dataclasses.replace(
                b.disease, exposure_chance=1.0, exposed_time=et,
                infected_time=it, vaccination_rate=0,
            ),
            th,
        )
        for et, it in [(6, 12), (10, 20), (4, 30)]
    ]
    steps = 50
    status0 = np.zeros(base.n_citizens, np.int8)
    status0[::191] = STATUS_INFECTED

    pe = pack_replicas(base, param_list)
    R, n, stride = pe.n_replicas, pe.rep_size, pe.rep_stride
    st = init_packed_state(pe, seed=0, starting_infected=0)
    # real citizens get status0; the block-alignment pad lanes stay 5
    packed_status0 = np.tile(
        np.concatenate([status0, np.full(stride - n, 5, np.int8)]), R
    )
    st = dataclasses.replace(
        st, status=__import__("jax").numpy.asarray(packed_status0)
    )
    cfg = SimConfig(max_steps=steps, chunk_size=steps)
    runner = make_packed_runner(pe, cfg)
    _, seirv = runner(param_list[0].as_arrays().thresholds, st)
    seirv = np.asarray(seirv)  # (steps, R, 5)

    for r, params in enumerate(param_list):
        solo = _solo_run(base, params, status0, steps)
        np.testing.assert_array_equal(
            seirv[:, r], solo,
            err_msg=f"replica {r} diverged from its solo run",
        )


def test_packed_stochastic_conservation_and_interventions():
    base = generate_synthetic_world(6000, n_output_areas=10, seed=2)
    b = Params.covid()
    param_list = [
        Params(
            dataclasses.replace(
                b.disease, exposure_chance=0.005 * (r + 1),
                vaccination_rate=25,
            ),
            dataclasses.replace(
                b.thresholds, lockdown=0.3, vaccination=0.03,
                mask_public_transport=0.01, mask_everywhere=0.10,
            ),
        )
        for r in range(4)
    ]
    cfg = SimConfig(max_steps=160, chunk_size=40, starting_infected=25)
    seirv = run_packed_ensemble(base, param_list, cfg, seed=3)
    assert seirv.shape[0] == 4 and seirv.shape[2] == 5
    assert (seirv.sum(axis=2) == base.n_citizens).all(), "population leak"
    # the highest-exposure replica must infect at least as much as the
    # lowest (wide margin: 4x chance spread)
    ever = seirv[:, -1, 1:4].sum(axis=1) + seirv[:, -1, 4]
    assert ever[3] > ever[0]
    # per-replica vaccination trigger: once V > 0 in one replica, the step's
    # vax count is at most rate per replica and only in started replicas
    v = seirv[:, :, 4]
    dv = np.diff(v, axis=1)
    assert (dv <= 25).all(), "per-replica exact-k violated"
    started_any = (v > 0).any()
    if started_any:
        # replicas that never started must stay at zero
        assert ((v[:, -1] == 0) | (v.max(axis=1) > 0)).all()


def test_packed_replica_independence():
    """Identical params + identical per-replica seeding pattern on a
    no-transport world: every replica's draws hash disjoint global index
    ranges, so trajectories must differ across replicas (independent
    streams) while each conserves population."""
    base = _strip_transport(
        generate_synthetic_world(4000, n_output_areas=8, seed=9)
    )
    b = Params.covid()
    pl = [
        Params(
            dataclasses.replace(b.disease, exposure_chance=0.05),
            b.thresholds,
        )
    ] * 3
    cfg = SimConfig(max_steps=80, chunk_size=40, starting_infected=15)
    seirv = run_packed_ensemble(base, pl, cfg, seed=1)
    assert (seirv.sum(axis=2) == base.n_citizens).all()
    assert not np.array_equal(seirv[0], seirv[1]), (
        "replicas share RNG streams"
    )


def test_packed_fused_kernel_bitwise_matches_xla():
    """The fused citizen phase's group mode (per-replica parameter rows,
    one group per replica span; ops/citizen.py) must reproduce the unfused
    packed step bitwise in deterministic regimes.  Per-replica parameter
    routing is exercised hard: replica 2 has exposure_chance=0 so any
    row mix-up floods it with infections; different exposed/
    infected times desynchronise the replicas' lockdown + vaccination
    triggers, so the per-replica move/mask rows vary across blocks."""
    import jax

    base = generate_synthetic_world(3000, n_output_areas=8, seed=6)
    b = Params.covid()
    th = dataclasses.replace(
        b.thresholds, lockdown=0.2, vaccination=0.05,
        mask_public_transport=2.0, mask_everywhere=2.0,
    )
    param_list = [
        Params(
            dataclasses.replace(
                b.disease, exposure_chance=ch, exposed_time=et,
                infected_time=it, vaccination_rate=10,
            ),
            th,
        )
        for ch, et, it in [(1.0, 6, 12), (1.0, 10, 20), (0.0, 4, 30)]
    ]
    steps = 60
    status0 = np.zeros(base.n_citizens, np.int8)
    status0[::191] = STATUS_INFECTED

    pe = pack_replicas(base, param_list, block_rows=32)
    assert pe.rep_stride > pe.rep_size, "padding path not exercised"
    results = {}
    for fused in (False, True):
        cfg = SimConfig(
            max_steps=steps, chunk_size=steps,
            use_fused_citizen=fused, bus_capacity=8192,
        )
        st = init_packed_state(pe, seed=0, starting_infected=0)
        stride, n, R = pe.rep_stride, pe.rep_size, pe.n_replicas
        packed_status0 = np.tile(
            np.concatenate([status0, np.full(stride - n, 5, np.int8)]), R
        )
        st = dataclasses.replace(
            st, status=__import__("jax").numpy.asarray(packed_status0)
        )
        runner = make_packed_runner(pe, cfg)
        fs, seirv = runner(param_list[0].as_arrays().thresholds, st)
        results[fused] = (
            np.asarray(seirv),
            np.asarray(fs.status), np.asarray(fs.timer),
            np.asarray(fs.sched), np.asarray(fs.lockdown),
            np.asarray(fs.mask_status), np.asarray(fs.eligible),
        )
    names = ("seirv", "status", "timer", "sched", "lockdown", "mask", "elig")
    for name, a, bb in zip(names, results[False], results[True]):
        np.testing.assert_array_equal(a, bb, err_msg=f"{name} diverged")
    # replica 2 (chance 0): nobody beyond the seeds ever gets exposed
    seirv = results[True][0]
    assert (seirv[:, 2, 1] == 0).all(), "chance-0 replica saw exposures"
    # replicas 0/1 must diverge from each other (different timer params)
    assert not np.array_equal(seirv[:, 0], seirv[:, 1])


def test_ensemble_early_exit_semantics():
    """One early-exit semantics across library and tool (VERDICT r3 #7):
    ``ensemble_done`` implements both contracts — faithful 'sei'
    (statistics.rs:289-291: run while S+E+I > 0, i.e. the vaccination
    tail keeps stepping after the epidemic dies) and the opt-in 'ei'
    benchmarking shortcut — and ``run_packed_ensemble`` routes through it
    (default 'sei')."""
    from epidemicsimulator_tpu.engine.packed import ensemble_done

    # dead epidemic, susceptibles remain: sei keeps going, ei stops
    row = np.array([[100, 0, 0, 5, 20], [0, 0, 0, 50, 10]], np.int64)
    assert not ensemble_done(row, "sei")
    assert ensemble_done(row, "ei")
    # all three pools empty everywhere: both stop
    row2 = np.array([[0, 0, 0, 105, 20], [0, 0, 0, 50, 10]], np.int64)
    assert ensemble_done(row2, "sei")
    assert ensemble_done(row2, "ei")
    # one replica still infectious: neither stops
    row3 = np.array([[0, 0, 3, 102, 20], [0, 0, 0, 50, 10]], np.int64)
    assert not ensemble_done(row3, "sei")
    assert not ensemble_done(row3, "ei")
    with pytest.raises(ValueError):
        ensemble_done(row, "bogus")

    # end-to-end: with vaccination on and exposure_chance=0 the epidemic
    # dies fast but S drains slowly -> 'ei' exits strictly earlier than
    # 'sei' under the same chunking
    world = _strip_transport(
        generate_synthetic_world(600, n_output_areas=2, seed=3)
    )
    base = Params.covid()
    p = Params(
        dataclasses.replace(
            base.disease, exposure_chance=0.0, exposed_time=4,
            infected_time=8, vaccination_rate=5,
        ),
        dataclasses.replace(base.thresholds, vaccination=0.0),
    )
    cfg = SimConfig(
        max_steps=400, chunk_size=25, use_fused_citizen=False, starting_infected=10,
        max_vaccinations_per_step=64,
    )
    out_sei = run_packed_ensemble(world, [p, p], cfg, seed=0)
    out_ei = run_packed_ensemble(world, [p, p], cfg, seed=0,
                                 early_exit="ei")
    assert out_ei.shape[1] < out_sei.shape[1]
    # the overlap is the same trajectory
    np.testing.assert_array_equal(
        out_sei[:, : out_ei.shape[1]], out_ei
    )
