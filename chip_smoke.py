"""Smoke test of the engine on an NVIDIA GPU, at the Yorkshire & Humber width.

Drives the main path through the entry points a user calls and checks what
comes out, in one process:

* Phase 0: environment (card, JAX, devices, flags, compile cache, which
  optional packages exist); refuses any platform but ``gpu``.
* Phase 1: ``cli.main`` on a 3,457,142-citizen synthetic world, 500 steps;
  checks the four reference artifacts and population conservation.
* Phase 2: the Y&H-shaped world (15,669 OAs) through
  ``engine.scan.make_chunk_runner`` with 20,000 seeded infected until
  lockdown, a mask mandate and vaccination have all fired.
* Phase 3: 48 deterministic steps of the default fast path against the
  portable engine (engine/step.py), exactly equal at every step.
* Phase 4: run totals, range totals and cumsum against numpy on the world's
  own boundary sets; the fused citizen phase against the unfused fast path
  (deterministic regime, exact) and against itself on the CPU (stochastic
  regime, bounded).
* Phase 5: 250 steps with ``use_sortless_dense`` on and off, bitwise equal.

``--devices 4`` runs only the multi-card phases instead: the population-
sharded fast path against the single-device fast path, and a 16-replica
sharded packed ensemble against the single-device packing, both bitwise,
with per-device memory after each.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed check
exits non-zero before printing it.

Usage:  python chip_smoke.py [--devices 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

N_YH = 3_457_142
OAS_YH = 15_669
SEED_INFECTED = 20_000
N_YORK = 197_603
OAS_YORK = 637
OPTIONAL = ("pandas", "matplotlib", "networkx", "requests")


def say(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def phase0(n_devices):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    import jax

    from epidemicsimulator_tpu.utils import enable_compilation_cache

    say(card)
    say(f"[phase 0] jax {jax.__version__}, devices {jax.devices()}")
    say(f"[phase 0] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    say(f"[phase 0] compile cache: {enable_compilation_cache()}")
    for m in OPTIONAL:
        say(f"[phase 0] optional {m}: "
            f"{'present' if importlib.util.find_spec(m) else 'absent'}")
    check(jax.default_backend() == "gpu",
          f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, JAX sees {len(jax.devices())}")
    return card.splitlines()[0]


def yh_world():
    from epidemicsimulator_tpu import generate_synthetic_world

    t0 = time.perf_counter()
    world = generate_synthetic_world(N_YH, n_output_areas=OAS_YH, seed=0)
    return world, time.perf_counter() - t0


def transport_off(world):
    import numpy as np

    return dataclasses.replace(
        world,
        uses_transport=np.zeros(world.n_citizens, bool),
        ws_uses_transport=np.zeros(world.n_citizens, bool),
        rider_perm=np.zeros(0, np.int32),
        rider_route=np.zeros(0, np.int32),
        rider_mask_compliant=np.zeros(0, bool),
    )


def deterministic_params():
    """exposure_chance 1, masks and vaccination off: every draw has p in
    {0, 1} (tests/test_fastpath.py)."""
    from epidemicsimulator_tpu import Params

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


def phase1():
    import numpy as np

    from epidemicsimulator_tpu import cli

    steps = 500
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        rc = cli.main([
            "yh", "--synthetic", str(N_YH), "--simulate",
            "--max-steps", str(steps), "--chunk-size", "250",
            "--directory", os.path.join(tmp, "no_data"),
            "--output-name", out,
        ])
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli.main returned {rc}")
        for name in ("global_stats.json", "exposures.json", "timings.json",
                     "memory.json"):
            check(os.path.exists(os.path.join(out, name)), f"{name} missing")
        with open(os.path.join(out, "global_stats.json")) as f:
            rows = json.load(f)
        with open(os.path.join(out, "timings.json")) as f:
            n_steps = len(json.load(f))
    keys = ("susceptible", "exposed", "infected", "recovered", "vaccinated")
    seirv = np.array([[r[k] for k in keys] for r in rows], np.int64)
    check(len(rows) == n_steps + 1, f"{len(rows)} rows for {n_steps} steps")
    check(0 < n_steps <= steps, f"{n_steps} steps recorded")
    check(not seirv[-1].any(), "no trailing zero row")
    total = seirv[:-1].sum(axis=1)
    check((total == total[0]).all(), "population not conserved")
    check(total[0] == N_YH, f"population {total[0]} != {N_YH}")
    leaked = [m for m in OPTIONAL if m in sys.modules]
    check(not leaked, f"main path imported {leaked}")
    say(f"[phase 1] cli.main --synthetic {N_YH} --simulate: {n_steps} steps "
        f"+ trailing row, population {int(total[0]):,} conserved, wall "
        f"{wall:.1f}s, final SEIRV {seirv[-2].tolist()}")


def phase2(card, world_h, build_s):
    import jax
    import numpy as np

    from epidemicsimulator_tpu import Params, SimConfig
    from epidemicsimulator_tpu.engine.scan import make_chunk_runner
    from epidemicsimulator_tpu.engine.state import init_state

    world = world_h.device_put()
    chunk, n_chunks = 250, 3
    cfg = SimConfig(max_steps=chunk * n_chunks, chunk_size=chunk)
    params = Params.covid().as_arrays()
    state = init_state(world, seed=0, starting_infected=SEED_INFECTED)
    fn = make_chunk_runner(world, cfg)
    t0 = time.perf_counter()
    state, out = fn(params, state)
    jax.block_until_ready(out.seirv)
    compile_s = time.perf_counter() - t0
    outs = [jax.tree.map(np.asarray, out)]
    t0 = time.perf_counter()
    for _ in range(n_chunks - 1):
        state, out = fn(params, state)
    jax.block_until_ready(out.seirv)
    steady = (time.perf_counter() - t0) / ((n_chunks - 1) * chunk)
    outs.append(jax.tree.map(np.asarray, out))
    lockdown = any(o.lockdown.any() for o in outs)
    masks = max(int(o.mask_status.max()) for o in outs)
    vax = sum(int(o.n_vaccinated_now.sum()) for o in outs)
    check(lockdown, "lockdown never fired")
    check(masks >= 1, "no mask mandate fired")
    check(vax > 0, "vaccination never fired")
    seirv = outs[-1].seirv[-1]
    check(int(seirv.sum()) == N_YH, "population not conserved")
    say(f"[phase 2] interventions fired: lockdown, mask level {masks}, "
        f"{vax:,} vaccinated; final SEIRV {seirv.tolist()}")
    say(f"[phase 2] world build {build_s:.1f}s, compile+first chunk "
        f"{compile_s:.1f}s, steady {steady * 1e3:.4f} ms/step, "
        f"{N_YH / steady:,.0f} citizen-steps/s [{card}] (information only)")


def det_initial_state(world):
    import numpy as np

    from epidemicsimulator_tpu.config import STATUS_INFECTED
    from epidemicsimulator_tpu.engine.state import init_state, with_status

    st = init_state(world, seed=0, starting_infected=0)
    status0 = np.zeros(world.n_citizens, np.int8)
    status0[::307] = STATUS_INFECTED
    return with_status(st, world, status0)


def det_trajectory(world_d, cfg, steps=48):
    import jax
    import numpy as np

    from epidemicsimulator_tpu.engine.step import step

    params = deterministic_params()
    st = det_initial_state(world_d)
    jstep = jax.jit(lambda w, p, s: step(w, p, cfg, s))
    rows = []
    for _ in range(steps):
        st, out = jstep(world_d, params, st)
        rows.append((np.asarray(st.status), np.asarray(st.at_work),
                     np.asarray(out.seirv), np.asarray(out.exposures_per_oa)))
    return rows


def same_trajectory(a, b, what):
    names = ("status", "at_work", "seirv", "exposures_per_oa")
    for t, (ra, rb) in enumerate(zip(a, b)):
        for name, x, y in zip(names, ra, rb):
            check(x.shape == y.shape and (x == y).all(),
                  f"{what}: {name} differs at step {t + 1}")


def phase3_4(world_h):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from epidemicsimulator_tpu import SimConfig
    from epidemicsimulator_tpu.backend import use_fused_citizen
    from epidemicsimulator_tpu.ops.runsums import range_totals, run_totals

    world = transport_off(world_h).device_put()
    base = dict(max_vaccinations_per_step=1, bus_capacity=20)
    default_fused = use_fused_citizen(SimConfig(), world.max_household_size)
    fast = det_trajectory(world, SimConfig(**base))
    portable = det_trajectory(world, SimConfig(use_fast_path=False, **base))
    same_trajectory(fast, portable, "fast path vs portable engine")
    exposed = int(fast[-1][2][1] + fast[-1][2][2] + fast[-1][2][3])
    check(exposed > 0, "deterministic run exposed nobody")
    say(f"[phase 3] 48 steps, fast path (fused citizen phase: "
        f"{default_fused}) == portable engine exactly; final SEIRV "
        f"{fast[-1][2].tolist()}")

    # --- phase 4a: run totals, range totals, cumsum vs numpy --------------
    rng = np.random.default_rng(0)
    n = world_h.n_citizens
    v = (rng.random(n) < 0.3).astype(np.int32)
    rt = jax.jit(run_totals)
    for name, start, end in (
        ("household", world_h.home_start_mask, world_h.home_end_mask),
        ("building", world_h.ws_wb_start_mask, world_h.ws_wb_end_mask),
        ("room", world_h.ws_room_start_mask, world_h.ws_room_end_mask),
    ):
        start = np.asarray(start)
        ids = np.cumsum(start) - 1
        want = np.bincount(ids, weights=v)[ids].astype(np.int32)
        got = np.asarray(rt(jnp.asarray(v), jnp.asarray(start),
                            jnp.asarray(end)))
        check((got == want).all(), f"run_totals over {name} runs")
        say(f"[phase 4] run_totals over {ids[-1] + 1:,} {name} runs == "
            f"np.bincount exactly")
    lo, hi = np.asarray(world_h.oa_lo), np.asarray(world_h.oa_hi)
    cs = np.concatenate([[0], np.cumsum(v)])
    got = np.asarray(jax.jit(range_totals)(
        jnp.asarray(v), jnp.asarray(lo), jnp.asarray(hi)))
    check((got == cs[hi] - cs[lo]).all(), "range_totals over OA ranges")
    got = np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(v)))
    check((got == cs[1:]).all(), "jnp.cumsum")
    say(f"[phase 4] range_totals over {lo.size:,} OA ranges and cumsum of "
        f"{n:,} lanes == numpy exactly")

    # --- phase 4b: fused vs unfused, deterministic regime -----------------
    fused = det_trajectory(world, SimConfig(use_fused_citizen=True, **base))
    unfused = det_trajectory(world, SimConfig(use_fused_citizen=False,
                                              **base))
    same_trajectory(fused, unfused, "fused vs unfused citizen phase")
    same_trajectory(fused, fast, "fused vs default fast path")
    say("[phase 4] fused citizen phase == unfused fast path exactly "
        "(48 deterministic steps)")


def phase4c(world_h):
    """Stochastic regime: the fused citizen phase on the GPU against the
    same function on the CPU.  Float32 expm1/log1p may round differently on
    the two backends, so a home draw whose uniform lies within a few ulps
    of its threshold may flip; nothing else may differ."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from epidemicsimulator_tpu.ops.citizen import (
        citizen_phase, make_citizen_statics,
    )

    rng = np.random.default_rng(1)
    n = world_h.n_citizens
    status = rng.choice(5, n, p=[0.80, 0.04, 0.06, 0.05, 0.05]).astype(np.int8)
    timer = rng.integers(0, 400, n).astype(np.int32)
    sched = rng.integers(0, 32, n).astype(np.int8)
    kw = dict(h24=jnp.int8(12), move=True, mask_status=jnp.int8(2),
              seed=jnp.uint32(0x9E3779B9), exposed_time=96,
              infected_time=336, exposure_chance=0.00055,
              mask_effectiveness=0.7, K=world_h.max_household_size,
              ref_mask_sem=True, u8_trunc=True)
    outs = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            statics = make_citizen_statics(jax.device_put(world_h, dev))
            res = citizen_phase(statics, jnp.asarray(status),
                                jnp.asarray(timer), jnp.asarray(sched), **kw)
            outs.append([np.asarray(r) for r in res])
    g, c = outs
    names = ("status", "timer", "sched", "gates")
    diff = np.zeros(n, bool)
    for name, x, y in zip(names, g[:4], c[:4]):
        diff |= x != y
    flips = int(diff.sum())
    home_bit = ((g[3] ^ c[3]) & ~np.int8(4)) == 0
    check((g[2] == c[2]).all(), "sched differs between GPU and CPU")
    check(home_bit.all(), "gates differ outside the home-hit bit")
    check(flips <= 16, f"{flips} lanes differ (bound 16)")
    check(np.abs(g[4] - c[4]).sum() <= 2 * flips,
          "counts differ beyond the flipped lanes")
    hits = int(g[4][0, 7])
    check(hits > 0, "stochastic regime drew no home hit")
    say(f"[phase 4] fused citizen phase GPU vs CPU, stochastic regime: "
        f"{hits:,} home hits, {flips} lanes differ (bound 16, home-hit "
        f"draws only)")


def phase5(world_h):
    import jax
    import numpy as np

    from epidemicsimulator_tpu import Params, SimConfig
    from epidemicsimulator_tpu.engine.scan import make_chunk_runner
    from epidemicsimulator_tpu.engine.state import init_state

    world = world_h.device_put()
    params = Params.covid().as_arrays()
    res = {}
    for sortless in (True, False):
        cfg = SimConfig(max_steps=250, chunk_size=250,
                        use_sortless_dense=sortless)
        state = init_state(world, seed=0, starting_infected=SEED_INFECTED)
        state, out = make_chunk_runner(world, cfg)(params, state)
        res[sortless] = [np.asarray(x) for x in (
            out.seirv, out.exposures_per_oa, out.n_exposures,
            out.n_vaccinated_now, state.status, state.timer, state.eligible,
        )]
        jax.block_until_ready(state.status)
    for a, b in zip(res[True], res[False]):
        check(a.shape == b.shape and (a == b).all(),
              "use_sortless_dense on/off diverged")
    say(f"[phase 5] 250 steps, use_sortless_dense on == off bitwise; "
        f"final SEIRV {res[True][0][-1].tolist()}")


def memory_line(tag):
    import jax

    for d in jax.devices():
        st = d.memory_stats() or {}
        say(f"[{tag}] device {d.id}: {st.get('bytes_in_use', 0) / 2**30:.3f} "
            f"GiB in use, peak {st.get('peak_bytes_in_use', 0) / 2**30:.3f} "
            f"GiB")


def multi_sharded(n_dev):
    import numpy as np

    from epidemicsimulator_tpu import Params, SimConfig
    from epidemicsimulator_tpu.engine.scan import run as run_single
    from epidemicsimulator_tpu.engine.state import init_state
    from epidemicsimulator_tpu.parallel.fastmesh import run_fast_sharded
    from epidemicsimulator_tpu.parallel.mesh import make_mesh

    world_h, _ = yh_world()
    world_h = transport_off(world_h)
    cfg = SimConfig(max_steps=48, chunk_size=24)
    params = Params.covid()
    t0 = time.perf_counter()
    state_n, _, outn = run_fast_sharded(
        world_h, params, cfg, make_mesh(n_dev), seed=0,
        starting_infected=SEED_INFECTED,
    )
    wall = time.perf_counter() - t0
    memory_line(f"devices {n_dev}, sharded fast path state live")
    del state_n
    st = init_state(world_h, seed=0, starting_infected=SEED_INFECTED)
    _, out1 = run_single(world_h.device_put(), params, cfg, st)
    for f in ("seirv", "exposures_per_oa", "n_exposures", "lockdown",
              "mask_status", "n_vaccinated_now"):
        a, b = np.asarray(getattr(out1, f)), np.asarray(getattr(outn, f))
        check(a.shape == b.shape and (a == b).all(),
              f"sharded fast path: {f} differs from single device")
    say(f"[devices {n_dev}] transport-off sharded fast path == single "
        f"device bitwise, {N_YH:,} citizens, 48 steps, final SEIRV "
        f"{np.asarray(outn.seirv)[-1].tolist()} (sharded wall {wall:.1f}s)")


def multi_ensemble(n_dev):
    import numpy as np

    from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
    from epidemicsimulator_tpu.engine.packed import run_packed_ensemble
    from epidemicsimulator_tpu.parallel.ensemble_mesh import (
        run_packed_ensemble_sharded,
    )
    from epidemicsimulator_tpu.parallel.mesh import make_mesh

    base = generate_synthetic_world(N_YORK, n_output_areas=OAS_YORK, seed=5)
    p = Params.covid()
    sweep = [
        Params(dataclasses.replace(p.disease, exposure_chance=0.002 + 0.0005 * r),
               p.thresholds)
        for r in range(16)
    ]
    cfg = SimConfig(max_steps=96, chunk_size=48, starting_infected=400,
                    id_keyed_ensemble_rng=True)
    t0 = time.perf_counter()
    many = run_packed_ensemble_sharded(base, sweep, cfg, mesh=make_mesh(n_dev),
                                       seed=2)
    wall = time.perf_counter() - t0
    memory_line(f"devices {n_dev}, after the sharded ensemble")
    one = run_packed_ensemble(base, sweep, cfg, seed=2)
    one, many = np.asarray(one), np.asarray(many)
    check(one.shape == many.shape and (one == many).all(),
          "sharded ensemble differs from the single-device packing")
    check((many.sum(axis=2) == base.n_citizens).all(),
          "ensemble population not conserved")
    say(f"[devices {n_dev}] 16-replica sharded packed ensemble == "
        f"single-device packing bitwise, {base.n_citizens:,} citizens per "
        f"replica, {one.shape[1]} steps (sharded wall {wall:.1f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    card = phase0(args.devices)
    if args.devices > 1:
        multi_ensemble(args.devices)
        multi_sharded(args.devices)
    else:
        phase1()
        world_h, build_s = yh_world()
        phase2(card, world_h, build_s)
        phase3_4(world_h)
        phase4c(world_h)
        phase5(world_h)

    from epidemicsimulator_tpu.backend import device_info

    say(json.dumps({"ok": True, "device": device_info()}))


if __name__ == "__main__":
    main()
