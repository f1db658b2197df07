"""Population sharding over a device mesh.

The reference scales only inside one node's RAM (rayon over
``Vec<Mutex<OutputArea>>``; "MPI horizontal scaling" is an unimplemented
future goal, README.md:24).  Here population scale-out is first-class:
citizens are sharded across devices by home-OA blocks
(:func:`pad_world_for_mesh` keeps the synthetic/preprocessed OA-sorted order,
so commuting locality maps to shard locality), and each step exchanges only
B-sized infection-pressure tables via ``psum`` — agent state never
migrates, unlike the reference's citizen-struct moves between OA mutexes
(simulator.rs:199-257).

Sharding rules inside :func:`make_sharded_chunk_runner`:

* per-citizen ``World``/``SimState`` lanes: ``P('pop')``
* params, scalars, per-building/OA outputs: replicated ``P()``
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import OCC_UNEMPLOYED, TIMER_DTYPE, Params, SimConfig
from ..engine.state import SimState
from ..engine.step import step
from ..world.schema import World

AXIS = "pop"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def pad_world_for_mesh(world: World, n_devices: int) -> World:
    """Pad citizen lanes to a multiple of n_devices with inert citizens.

    Padding citizens are Recovered-forever residents of a dedicated padding
    household in OA 0: they join no workplace, school or bus and never
    contribute to or receive exposure (their state is set Recovered in
    :func:`pad_state_for_mesh`, and Recovered is terminal).
    """
    world = world.without_index_tables()
    n = world.n_citizens
    rem = (-n) % n_devices
    if rem == 0:
        return world
    pad_building = world.n_buildings  # fresh building id for the padding
    pads = {
        "age": np.full(rem, 99, np.int16),
        "occupation": np.full(rem, OCC_UNEMPLOYED, np.int8),
        "home_building": np.full(rem, pad_building, np.int32),
        "work_building": np.full(rem, pad_building, np.int32),
        "home_oa": np.zeros(rem, np.int32),
        "work_oa": np.zeros(rem, np.int32),
        "room": np.full(rem, world.n_rooms, np.int32),
        "is_school_work": np.zeros(rem, np.bool_),
        "uses_transport": np.zeros(rem, np.bool_),
        "mask_compliant": np.zeros(rem, np.bool_),
        "work_start": np.full(rem, 9, np.int8),
        "work_end": np.full(rem, 17, np.int8),
    }
    return dataclasses.replace(
        world,
        n_buildings=world.n_buildings + 1,
        **{
            k: np.concatenate([np.asarray(getattr(world, k)), v])
            for k, v in pads.items()
        },
    )


def pad_state_for_mesh(state: SimState, n_total: int) -> SimState:
    n = state.status.shape[0]
    rem = n_total - n
    if rem == 0:
        return state
    # STATUS_RECOVERED = 3: terminal, invisible to exposure, uncounted as
    # S/E/I so it never delays the early-exit check — but it does appear in
    # the R column; callers subtract the pad count when reporting.
    return dataclasses.replace(
        state,
        status=jnp.concatenate([state.status, jnp.full(rem, 3, jnp.int8)]),
        timer=jnp.concatenate([state.timer, jnp.zeros(rem, TIMER_DTYPE)]),
        at_work=jnp.concatenate([state.at_work, jnp.zeros(rem, bool)]),
        on_bus=jnp.concatenate([state.on_bus, jnp.zeros(rem, bool)]),
        bus_to_work=jnp.concatenate([state.bus_to_work, jnp.zeros(rem, bool)]),
        eligible=jnp.concatenate([state.eligible, jnp.zeros(rem, bool)]),
    )


def _world_specs(world: World) -> World:
    return jax.tree.map(lambda _: P(AXIS), world)


def _state_specs(state: SimState) -> SimState:
    lane_fields = {
        "status", "timer", "at_work", "on_bus", "bus_to_work", "eligible",
        "at_work_ws", "on_bus_ws", "sched",
    }
    return SimState(
        **{
            f: P(AXIS) if f in lane_fields else P()
            for f in SimState.__dataclass_fields__
        }
    )


def make_sharded_chunk_runner(world: World, cfg: SimConfig, mesh: Mesh):
    """jitted ``chunk(world, params, state) -> (state, outputs)`` under
    shard_map over the population axis."""
    w_specs = _world_specs(world)
    s_specs = _state_specs(None)  # field-name based; instance not needed
    out_specs = (
        s_specs,
        # StepOutput fields are all replicated post-psum, stacked over time.
        jax.tree.map(lambda _: P(), _stepoutput_proto()),
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(w_specs, jax.tree.map(lambda _: P(), Params.covid()), s_specs),
        out_specs=out_specs,
        check_vma=False,
    )
    def chunk(world_l, params, state_l):
        def body(carry, _):
            ns, out = step(world_l, params, cfg, carry, axis_name=AXIS)
            return ns, out

        return jax.lax.scan(body, state_l, None, length=cfg.chunk_size)

    return jax.jit(chunk)


def _stepoutput_proto():
    from ..engine.step import StepOutput

    z = jnp.zeros(())
    return StepOutput(z, z, z, z, z, z, z)


def shard_inputs(world: World, state: SimState, mesh: Mesh):
    """Device_put world/state with their NamedShardings."""
    w_sh = jax.tree.map(
        lambda spec: NamedSharding(mesh, spec), _world_specs(world)
    )
    s_sh = jax.tree.map(lambda spec: NamedSharding(mesh, spec), _state_specs(None))
    world = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s), world, w_sh)
    state = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s), state, s_sh)
    return world, state


def run_sharded(
    world: World,
    params: Params,
    cfg: SimConfig,
    state: SimState,
    mesh: Mesh,
    *,
    callback=None,
):
    """Sharded analog of engine.scan.run with host early exit."""
    n_dev = mesh.devices.size
    world = pad_world_for_mesh(world, n_dev)
    # The sharded step uses the portable formulation; drop the work-order
    # twin lanes (they are fast-path-only and don't shard meaningfully).
    state = dataclasses.replace(
        state,
        at_work_ws=jnp.zeros((0,), jnp.bool_),
        on_bus_ws=jnp.zeros((0,), jnp.bool_),
    )
    state = pad_state_for_mesh(state, world.n_citizens)
    world, state = shard_inputs(world, state, mesh)
    chunk_fn = make_sharded_chunk_runner(world, cfg, mesh)
    params = params.as_arrays()

    chunks = []
    steps_done = 0
    while steps_done < cfg.max_steps:
        state, out = chunk_fn(world, params, state)
        out = jax.tree.map(np.asarray, out)
        chunks.append(out)
        steps_done += cfg.chunk_size
        if callback is not None:
            callback(steps_done, out, state)
        seirv = out.seirv
        if not (seirv[-1, 0] + seirv[-1, 1] + seirv[-1, 2] > 0):
            break

    outputs = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *chunks)
    outputs = jax.tree.map(lambda x: x[: cfg.max_steps], outputs)
    seirv = outputs.seirv
    alive = seirv[:, 0] + seirv[:, 1] + seirv[:, 2] > 0
    if not alive.all():
        end = int(np.argmin(alive)) + 1
        outputs = jax.tree.map(lambda x: x[:end], outputs)
    return state, outputs
