"""Replicate-per-device packed ensembles: shard the R axis over a mesh.

The packed-replica engine (engine/packed.py) tiles R parameter replicates
into ONE world and steps them with the fused fast-path formulation on a
single device.  Replicates never interact — the R axis is embarrassingly
parallel — so multi-device ensembles are pure data parallelism: each device
holds R/n_dev whole replicas of the SAME base world and runs the identical
packed step with **zero per-step collectives** (the reference has no
counterpart: its runs are one process per parameter set, run/src/main.rs).

Layout
------
* The packed world for R_local = R/n_dev replicas is structurally
  identical on every device (replica blocks are tiled copies of the base
  world; absolute building/OA/room offsets only ever enter the dynamics
  through intra-replica comparisons), so the world rides shard_map
  REPLICATED — ``P()`` — and only the (R,) parameter/threshold rows and
  the (R*stride,) state lanes are split on the mesh axis.
* Every stochastic draw is keyed on GLOBAL ids: the citizen-lane draws
  (home / work / vaccination scores) hash ``gid0 + lane`` where
  ``gid0 = device_rank * R_local * stride``, and the bus tie/draw streams
  run in id-keyed mode (``SimConfig.id_keyed_ensemble_rng``, forced True
  here; ops/segments.py::bus_hits ``tie_bits``/``draw_seed``).  A sharded
  run is therefore **bitwise identical** to the single-device R-replica
  packing run in the same RNG mode, at any mesh size
  (tests/test_ensemble_mesh.py).

Scaling: per-device work is R_local/R of the single-device packing with no
communication, so throughput should scale with devices until the packed
sub-world no longer fills a device (at the reference's York scale one
replica is ~208k lanes).  Not yet measured on a GPU mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import use_fused_citizen
from ..config import Params, SimConfig
from ..engine.packed import (
    PackedEnsemble, PackedState, derive_step_rng, ensemble_done,
    init_packed_state, make_perm_rels, pack_replicas, packed_step,
)
from ..world.schema import World
from .mesh import AXIS, make_mesh

#: PackedState fields split on the mesh axis — per-citizen lanes
#: (R*stride,) and per-replica rows (R,).  ``hour`` is a replicated
#: scalar; ``rng_key`` is hoisted out of the carry (None inside).
_SHARDED_STATE_FIELDS = frozenset({
    "status", "timer", "sched", "eligible",
    "lockdown", "mask_status", "vaccination_started",
})
#: PackedEnsemble leaves split on the mesh axis — the (R,) swept
#: parameter rows.  The world subtree is replicated.
_SHARDED_PE_FIELDS = frozenset({
    "chance", "exposed_time", "infected_time", "mask_effectiveness",
    "vaccination_rate",
})


def _state_specs(spec_lane, spec_rep):
    return PackedState(**{
        f: spec_lane if f in _SHARDED_STATE_FIELDS else spec_rep
        for f in PackedState.__dataclass_fields__
    })


def _pe_specs(pe, spec_lane, spec_rep):
    return dataclasses.replace(
        jax.tree.map(lambda _: spec_rep, pe),
        **{f: spec_lane for f in _SHARDED_PE_FIELDS},
    )


def make_sharded_packed_runner(pe: PackedEnsemble, cfg: SimConfig,
                               mesh: Mesh):
    """jitted chunk(pe_mixed, th, state) -> (state, (chunk, R, 5)).

    ``pe_mixed``: a PackedEnsemble whose world/statics describe ONE
    device's R_local-replica packing (static ``n_replicas = R_local``)
    while its parameter rows are the FULL (R,) sweep — shard_map splits
    the rows so each device sees its own (R_local,) slice over the
    replicated world.  ``th``/``state`` carry (R,) / (R*stride,) leaves,
    split likewise.
    """
    n_dev = int(np.prod(list(mesh.shape.values())))
    R_l, stride = pe.n_replicas, pe.rep_stride
    n_riders_l = int(pe.world.rider_perm.shape[0])
    cfg = dataclasses.replace(cfg, id_keyed_ensemble_rng=True)

    use_fused = use_fused_citizen(cfg, pe.world.max_household_size)

    pe_in_specs = _pe_specs(pe, P(AXIS), P())
    th_specs = jax.tree.map(lambda _: P(AXIS), Params.covid().thresholds)
    st_specs = _state_specs(P(AXIS), P())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(pe_in_specs, th_specs, st_specs),
        out_specs=(st_specs, P(None, AXIS)),
        check_vma=False,
    )
    def chunk(pe_d, th, state):
        me = jax.lax.axis_index(AXIS)
        gid0 = me.astype(jnp.uint32) * jnp.uint32(R_l * stride)
        rgid0 = me.astype(jnp.uint32) * jnp.uint32(n_riders_l)

        if use_fused:
            from ..ops.citizen import make_citizen_statics

            statics = make_citizen_statics(pe_d.world)  # loop-invariant
        else:
            statics = None
        rels = make_perm_rels(pe_d.world, R_l, stride)  # loop-invariant

        # rng material batched outside the scan (engine/packed.py
        # derive_step_rng) — identical replicated computation per device,
        # so the per-step seeds equal the single-device packing's.
        base_key = state.rng_key
        state = dataclasses.replace(state, rng_key=None)
        hours = state.hour + 1 + jnp.arange(cfg.chunk_size, dtype=jnp.int32)
        xs = derive_step_rng(base_key, hours)

        def body(carry, x):
            ns, seirv = packed_step(
                pe_d, th, cfg, carry, fused_statics=statics, rng=x,
                perm_rels=rels, gid0=gid0, rider_gid0=rgid0,
            )
            return ns, seirv

        state, seirv_t = jax.lax.scan(body, state, xs,
                                      length=cfg.chunk_size)
        return dataclasses.replace(state, rng_key=base_key), seirv_t

    shard = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    pe_sh = _pe_specs(pe, shard, rep)
    th_sh = jax.tree.map(lambda _: shard, Params.covid().thresholds)
    st_sh = _state_specs(shard, rep)
    jitted = jax.jit(chunk, donate_argnums=(2,),
                     in_shardings=(pe_sh, th_sh, st_sh))

    def put(x, s):
        return jax.device_put(jnp.asarray(x), s)

    def prepare(pe_mixed, th):
        pe_d = jax.tree.map(
            lambda x, s: put(x, s) if hasattr(x, "shape") else x,
            pe_mixed, pe_sh,
        )
        th_d = jax.tree.map(put, th, th_sh)
        return pe_d, th_d

    return jitted, prepare, (shard, rep)


def run_packed_ensemble_sharded(
    base: World, param_list: list[Params], cfg: SimConfig, *,
    mesh: Mesh | None = None, n_devices: int | None = None,
    seed: int = 0, block_rows: int = 128, early_exit: str = "sei",
):
    """Run R replicates sharded replica-per-device; returns (R, T, 5).

    Same surface as engine/packed.py::run_packed_ensemble plus the mesh;
    R must divide evenly across the mesh.  Trajectories are bitwise the
    single-device packing's under ``id_keyed_ensemble_rng=True`` (which
    this runner forces — see module docstring).
    """
    mesh = mesh if mesh is not None else make_mesh(n_devices)
    n_dev = int(np.prod(list(mesh.shape.values())))
    R = len(param_list)
    if R % n_dev != 0:
        raise ValueError(
            f"{R} replicates do not divide over {n_dev} devices"
        )
    R_l = R // n_dev
    cfg = dataclasses.replace(cfg, id_keyed_ensemble_rng=True)

    # Device-local packing structure (identical on every device) + the
    # full-R parameter rows riding the same pytree.
    pe_l = pack_replicas(base, param_list[:R_l], block_rows=block_rows)
    pe_full = pack_replicas_params_only(param_list)
    pe_mixed = dataclasses.replace(pe_l, **pe_full)

    # Global initial state: init_packed_state only reads
    # (n_replicas, rep_size, rep_stride), so a full-R shim of the local
    # packing reproduces the single-device R-packing's init bitwise.
    pe_g = dataclasses.replace(pe_l, n_replicas=R)
    state = init_packed_state(
        pe_g, seed=seed, starting_infected=cfg.starting_infected
    )
    th = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[p.as_arrays().thresholds for p in param_list],
    )

    jitted, prepare, (shard, rep) = make_sharded_packed_runner(
        pe_l, cfg, mesh
    )
    pe_d, th_d = prepare(pe_mixed, th)
    state = jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x), s)
        if hasattr(x, "shape") else x,
        state, _state_specs(shard, rep),
    )

    chunks = []
    steps = 0
    while steps < cfg.max_steps:
        state, seirv = jitted(pe_d, th_d, state)
        seirv = np.asarray(seirv)  # (chunk, R, 5)
        chunks.append(seirv)
        steps += cfg.chunk_size
        if ensemble_done(seirv[-1], early_exit):
            break
    out = np.concatenate(chunks, axis=0)[: cfg.max_steps]
    return np.transpose(out, (1, 0, 2))


def pack_replicas_params_only(param_list: list[Params]) -> dict:
    """The (R,) swept parameter rows of pack_replicas, without the world
    (engine/packed.py:174-189 extraction, shared layout contract)."""
    ds = [p.as_arrays().disease for p in param_list]
    return dict(
        chance=np.array(
            [float(jax.device_get(d.exposure_chance)) for d in ds],
            np.float32,
        ),
        exposed_time=np.array(
            [int(jax.device_get(d.exposed_time)) for d in ds], np.int32
        ),
        infected_time=np.array(
            [int(jax.device_get(d.infected_time)) for d in ds], np.int32
        ),
        mask_effectiveness=np.array(
            [float(jax.device_get(d.mask_effectiveness)) for d in ds],
            np.float32,
        ),
        vaccination_rate=np.array(
            [int(jax.device_get(d.vaccination_rate)) for d in ds], np.int32
        ),
    )
