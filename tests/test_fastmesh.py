"""Sharded fast path (parallel/fastmesh.py) vs the single-device fast path.

Runs on the 8-device virtual CPU mesh (tests/conftest.py).  In the
deterministic regime (exposure_chance=1: every draw probability is exactly
0 or 1) the sharded step must reproduce the single-device trajectory
bitwise — RNG streams differ per shard but never decide anything.
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
from epidemicsimulator_tpu.parallel.fastmesh import (
    fast_shard_step, init_sharded_state, make_fast_sharded_runner,
    run_fast_sharded,
)
from epidemicsimulator_tpu.parallel.mesh import make_mesh
from epidemicsimulator_tpu.parallel.partition import (
    gather_state_arrays, partition_world,
)


def _det_params():
    base = Params.covid()
    return Params(
        dataclasses.replace(
            base.disease, exposure_chance=1.0, exposed_time=6,
            infected_time=12, vaccination_rate=0,
        ),
        dataclasses.replace(
            base.thresholds, vaccination=-1.0,
            mask_public_transport=2.0, mask_everywhere=2.0,
        ),
    ).as_arrays()


def _single_device_reference(world, status0, steps, transport, params=None):
    cfg = SimConfig(
        use_fast_path=True, use_fused_citizen=False,
        max_vaccinations_per_step=1 if params is None else 4096,
        bus_capacity=1_000_000 if transport else 20,
    )
    if params is None:
        params = _det_params()
    st = init_state(world, seed=0, starting_infected=0)
    from epidemicsimulator_tpu.engine.state import with_status
    st = with_status(st, world, status0)
    wd = world.device_put()
    jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
    rows = []
    for _ in range(steps):
        st, out = jstep(wd, params, st)
        rows.append((np.asarray(st.status).copy(), np.asarray(out.seirv).copy(),
                     np.asarray(out.exposures_per_oa).copy()))
    return rows


def _strip_transport(world):
    return dataclasses.replace(
        world,
        uses_transport=np.zeros(world.n_citizens, bool),
        ws_uses_transport=np.zeros(world.n_citizens, bool),
        rider_perm=np.zeros(0, np.int32),
        rider_route=np.zeros(0, np.int32),
        rider_mask_compliant=np.zeros(0, bool),
    )


def _run_sharded_vs_ref(world, params, status0, steps, n_dev, ref,
                        bus_capacity=20, check_final=True):
    """Drive the sharded runner and assert per-step bitwise equality."""
    mesh = make_mesh(n_dev)
    sw = partition_world(world, n_dev)
    st = init_sharded_state(world, sw, seed=0, starting_infected=0)
    from epidemicsimulator_tpu.parallel.partition import (
        PAD_STATUS, shard_state_arrays,
    )
    lanes = shard_state_arrays(sw, {"status": (status0, PAD_STATUS)})
    st = dataclasses.replace(st, status=jnp.asarray(lanes["status"]).reshape(-1))

    cfg = SimConfig(
        chunk_size=steps, max_steps=steps, max_vaccinations_per_step=4096,
        bus_capacity=bus_capacity,
    )
    runner = make_fast_sharded_runner(sw, cfg, mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P

    w_sh = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("pop")))
        if hasattr(x, "shape") else x,
        sw,
    )
    fs, outs = runner(w_sh, params, st)
    for t in range(steps):
        np.testing.assert_array_equal(
            np.asarray(outs.seirv[t]), ref[t][1],
            err_msg=f"seirv diverged at step {t + 1}",
        )
        np.testing.assert_array_equal(
            np.asarray(outs.exposures_per_oa[t]), ref[t][2],
            err_msg=f"per-OA exposures diverged at step {t + 1}",
        )
    if check_final:
        g = gather_state_arrays(
            sw,
            {"status": np.asarray(fs.status).reshape(sw.n_dev, sw.shard_size)},
        )
        np.testing.assert_array_equal(g["status"], ref[-1][0])
    return outs


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_matches_single_device_stochastic(n_dev):
    """FULLY stochastic regime — fractional draw probabilities, mask +
    vaccination + lockdown transitions mid-run.  Every citizen-keyed draw
    hashes (per-step seed, global citizen / work-order id), so the sharded
    trajectory must equal the single-device fast path BITWISE.  Transport
    is stripped: bus assembly is shard-local, the one documented
    divergence (FIDELITY.md)."""
    world = _strip_transport(
        generate_synthetic_world(4000, n_output_areas=12, seed=4)
    )
    base = Params.covid()
    params = Params(
        dataclasses.replace(
            base.disease, exposure_chance=0.04, exposed_time=24,
            infected_time=72, vaccination_rate=25,
        ),
        dataclasses.replace(
            base.thresholds, lockdown=0.20, vaccination=0.05,
            mask_public_transport=0.01, mask_everywhere=0.08,
        ),
    ).as_arrays()
    status0 = np.zeros(world.n_citizens, np.int8)
    status0[::101] = STATUS_INFECTED
    steps = 100
    ref = _single_device_reference(world, status0, steps, False, params=params)
    outs = _run_sharded_vs_ref(world, params, status0, steps, n_dev, ref)
    # the run must actually exercise the stochastic transitions it claims to
    assert np.asarray(outs.n_vaccinated_now).max() > 0, "vaccination never fired"
    assert np.asarray(outs.lockdown).any(), "lockdown never engaged"
    assert np.asarray(outs.mask_status).max() >= 1, "masks never mandated"


@pytest.mark.parametrize("n_dev,transport", [(4, False), (8, True), (3, True)])
def test_sharded_matches_single_device_deterministically(n_dev, transport):
    world = generate_synthetic_world(4000, n_output_areas=12, seed=4)
    if not transport:
        world = _strip_transport(world)
    status0 = np.zeros(world.n_citizens, np.int8)
    status0[::157] = STATUS_INFECTED
    steps = 60
    ref = _single_device_reference(world, status0, steps, transport)

    mesh = make_mesh(n_dev)
    sw = partition_world(world, n_dev)
    st = init_sharded_state(world, sw, seed=0, starting_infected=0)
    # overwrite the seeded infections with the reference pattern
    from epidemicsimulator_tpu.parallel.partition import (
        PAD_STATUS, shard_state_arrays,
    )
    lanes = shard_state_arrays(sw, {"status": (status0, PAD_STATUS)})
    st = dataclasses.replace(st, status=jnp.asarray(lanes["status"]).reshape(-1))

    cfg = SimConfig(
        chunk_size=steps, max_steps=steps, max_vaccinations_per_step=1,
        bus_capacity=1_000_000 if transport else 20,
    )
    runner = make_fast_sharded_runner(sw, cfg, mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P

    w_sh = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("pop")))
        if hasattr(x, "shape") else x,
        sw,
    )
    fs, outs = runner(w_sh, _det_params(), st)

    # trajectory comparison
    for t in range(steps):
        np.testing.assert_array_equal(
            np.asarray(outs.seirv[t]), ref[t][1],
            err_msg=f"seirv diverged at step {t + 1}",
        )
        np.testing.assert_array_equal(
            np.asarray(outs.exposures_per_oa[t]), ref[t][2],
            err_msg=f"per-OA exposures diverged at step {t + 1}",
        )
    # final per-citizen status equality (gather back to global order)
    g = gather_state_arrays(
        sw, {"status": np.asarray(fs.status).reshape(sw.n_dev, sw.shard_size)}
    )
    np.testing.assert_array_equal(g["status"], ref[-1][0])


def test_sharded_runner_stochastic_conservation():
    """Full stochastic run: population conserved, epidemic progresses,
    vaccination exact-k per step."""
    world = generate_synthetic_world(6000, n_output_areas=10, seed=2)
    mesh = make_mesh(8)
    base = Params.covid()
    params = Params(
        dataclasses.replace(base.disease, exposure_chance=0.02,
                            vaccination_rate=50),
        dataclasses.replace(base.thresholds, lockdown=0.05, vaccination=0.01,
                            mask_public_transport=0.005, mask_everywhere=0.03),
    )
    cfg = SimConfig(max_steps=120, chunk_size=40)
    _, sw, outs = run_fast_sharded(
        world, params, cfg, mesh, seed=1, starting_infected=100
    )
    seirv = outs.seirv
    assert (seirv.sum(axis=1) == world.n_citizens).all(), "population leak"
    assert seirv[-1, 3] + seirv[-1, 1] + seirv[-1, 2] > 100, "no dynamics"
    vax = outs.n_vaccinated_now
    started = np.flatnonzero(vax > 0)
    if len(started) > 3:
        # exact-k while the pool lasts
        assert (vax[started[:3]] == 50).all(), vax[started[:5]]


def test_partition_roundtrip_and_alignment():
    world = generate_synthetic_world(5000, n_output_areas=9, seed=7)
    sw = partition_world(world, 5)
    gid = np.asarray(sw.global_id)
    # every citizen appears exactly once
    ids = gid[gid >= 0]
    assert sorted(ids.tolist()) == list(range(world.n_citizens))
    # households never straddle shards
    hb = np.asarray(world.home_building)
    for d in range(5):
        mine = gid[d][gid[d] >= 0]
        if d + 1 < 5:
            nxt = gid[d + 1][gid[d + 1] >= 0]
            assert hb[mine[-1]] != hb[nxt[0]], "household split across shards"
    # every work participant has exactly one slot
    wneq = np.asarray(world.work_building) != np.asarray(world.home_building)
    assert int(np.asarray(sw.slot_active).sum()) == int(wneq.sum())


@pytest.mark.parametrize("n_dev", [4])
def test_sharded_fused_kernel_bitwise_matches_xla(n_dev):
    """The sharded fused branch (per-shard fused citizen phase with the
    gid0 offset, packed sched carry, gated work/bus conds, sparse hit
    return) must reproduce the unfused sharded branch bitwise — in a fully
    stochastic regime with transport ON and mask/vaccination/lockdown
    transitions firing mid-run."""
    world = generate_synthetic_world(4000, n_output_areas=12, seed=4)
    base = Params.covid()
    params = Params(
        dataclasses.replace(
            base.disease, exposure_chance=0.04, exposed_time=24,
            infected_time=72, vaccination_rate=25,
        ),
        dataclasses.replace(
            base.thresholds, lockdown=0.20, vaccination=0.05,
            mask_public_transport=0.01, mask_everywhere=0.08,
        ),
    ).as_arrays()
    status0 = np.zeros(world.n_citizens, np.int8)
    status0[::101] = STATUS_INFECTED
    steps = 60

    mesh = make_mesh(n_dev)
    sw = partition_world(world, n_dev)
    from epidemicsimulator_tpu.parallel.partition import (
        PAD_STATUS, shard_state_arrays,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    w_sh = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("pop")))
        if hasattr(x, "shape") else x,
        sw,
    )
    results = {}
    for fused in (False, True):
        st = init_sharded_state(world, sw, seed=0, starting_infected=0)
        lanes = shard_state_arrays(sw, {"status": (status0, PAD_STATUS)})
        st = dataclasses.replace(
            st, status=jnp.asarray(lanes["status"]).reshape(-1)
        )
        cfg = SimConfig(
            chunk_size=steps, max_steps=steps,
            max_vaccinations_per_step=4096,
            use_fused_citizen=fused,
        )
        runner = make_fast_sharded_runner(sw, cfg, mesh)
        fs, outs = runner(w_sh, params, st)
        results[fused] = (
            np.asarray(outs.seirv), np.asarray(outs.exposures_per_oa),
            np.asarray(fs.status), np.asarray(fs.timer),
            np.asarray(fs.at_work), np.asarray(fs.on_bus),
            np.asarray(fs.eligible),
            np.asarray(outs.lockdown), np.asarray(outs.mask_status),
            np.asarray(outs.n_vaccinated_now),
        )
    names = ("seirv", "oa", "status", "timer", "at_work", "on_bus",
             "eligible", "lockdown", "mask", "n_vax")
    for name, a, b in zip(names, results[False], results[True]):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} diverged")
    # the run must actually exercise the machinery it claims to
    seirv = results[True][0]
    assert results[True][9].max() > 0, "vaccination never fired"
    assert results[True][7].any(), "lockdown never engaged"
    assert seirv[-1, 1] + seirv[-1, 2] > 0 or seirv[-1, 3] > 0, "no dynamics"


def test_sortless_sharded_bitwise_matches_sorted():
    """The opt-in sortless sharded branches (use_sortless_sharded: carried
    slot-space schedule lanes, contributor drains with ghost-bit merges,
    deferred susceptibility, sortless local bus) must be bitwise the
    sorted sharded formulation — including across intervention
    transitions and with cross-shard ghost workers live.  (Off by
    default; not yet measured on a GPU mesh.)"""
    from epidemicsimulator_tpu.parallel.fastmesh import (
        init_sharded_state, make_fast_sharded_runner,
    )
    from epidemicsimulator_tpu.parallel.mesh import make_mesh
    from epidemicsimulator_tpu.parallel.partition import (
        PAD_STATUS, partition_world, shard_state_arrays,
    )
    from jax.sharding import NamedSharding, PartitionSpec as P

    world = generate_synthetic_world(4000, n_output_areas=12, seed=4)
    base = Params.covid()
    params = Params(
        dataclasses.replace(
            base.disease, exposure_chance=0.04, exposed_time=24,
            infected_time=72, vaccination_rate=25,
        ),
        dataclasses.replace(
            base.thresholds, lockdown=0.20, vaccination=0.05,
            mask_public_transport=0.01, mask_everywhere=0.08,
        ),
    ).as_arrays()
    status0 = np.zeros(world.n_citizens, np.int8)
    status0[::101] = STATUS_INFECTED
    mesh = make_mesh(4)
    sw = partition_world(world, 4)
    w_sh = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("pop")))
        if hasattr(x, "shape") else x,
        sw,
    )
    res = {}
    for sl in (False, True):
        cfg = SimConfig(
            chunk_size=60, max_steps=60, max_vaccinations_per_step=4096,
            use_fused_citizen=True, use_sortless_sharded=sl,
        )
        st = init_sharded_state(world, sw, seed=0, starting_infected=0,
                                cfg=cfg)
        lanes = shard_state_arrays(sw, {"status": (status0, PAD_STATUS)})
        st = dataclasses.replace(
            st, status=jnp.asarray(lanes["status"]).reshape(-1)
        )
        runner = make_fast_sharded_runner(sw, cfg, mesh)
        fs, outs = runner(w_sh, params, st)
        res[sl] = (
            np.asarray(outs.seirv), np.asarray(outs.exposures_per_oa),
            np.asarray(fs.status), np.asarray(fs.timer),
            np.asarray(outs.mask_status), np.asarray(outs.lockdown),
            np.asarray(outs.n_vaccinated_now),
        )
    for name, a, b in zip(
        ("seirv", "oa", "status", "timer", "mask", "lockdown", "n_vax"),
        res[False], res[True],
    ):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} diverged")
    # the run must have exercised exposures + interventions
    assert res[True][0][-1, 1] > 0
    assert res[True][4].max() > 0


def test_sharded_sampled_vax_bitwise_matches_bisection():
    """The sampled-band sharded vaccination selector
    (cfg.use_sampled_vax_sharded, ops/select.py::kth_threshold_sharded)
    must leave the whole trajectory bitwise-identical to the psum
    bisection — vaccination live every step after activation."""
    world = _strip_transport(
        generate_synthetic_world(6000, n_output_areas=10, seed=2)
    )
    mesh = make_mesh(8)
    base = Params.covid()
    params = Params(
        dataclasses.replace(base.disease, exposure_chance=0.02,
                            vaccination_rate=50),
        dataclasses.replace(base.thresholds, lockdown=0.05, vaccination=0.01,
                            mask_public_transport=0.005, mask_everywhere=0.03),
    )
    res = {}
    for sampled in (False, True):
        cfg = SimConfig(
            max_steps=120, chunk_size=40,
            use_sampled_vax_sharded=sampled, vax_sharded_sample_log2=6,
        )
        _, _, outs = run_fast_sharded(
            world, params, cfg, mesh, seed=1, starting_infected=100
        )
        res[sampled] = (
            np.asarray(outs.seirv), np.asarray(outs.n_vaccinated_now),
            np.asarray(outs.lockdown), np.asarray(outs.mask_status),
        )
    for name, a, b in zip(("seirv", "n_vax", "lockdown", "mask"),
                          res[False], res[True]):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} diverged")
    assert res[True][1].max() > 0, "vaccination never fired"
