"""Headline benchmark: Yorkshire&Humber-scale epidemic throughput on a GPU.

Reference baseline (BASELINE.md): 3,457,142 citizens x 5000 hourly steps ran
at ~0.80 s/step => ~4.3M citizen-steps/s on a 32-core node
(`epidemic_sim_v1.6_17739074.log`).  This benchmark builds a synthetic world
of identical scale (same citizen count, same OA count), runs the full step
(SEIR + movement + building/room/bus exposure + interventions +
vaccination) and reports steady-state citizen-steps/s on one GPU.

The device (platform, kind, count) and the card's name and power limit go
to stderr; any platform other than ``gpu`` is refused.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_CITIZENS = 3_457_142
N_OAS = 15_669
WARMUP_STEPS = 250
TIMED_STEPS = 1_000
CHUNK = 250
BASELINE_CITIZEN_STEPS_PER_SEC = 4.3e6


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
    from epidemicsimulator_tpu.backend import device_info
    from epidemicsimulator_tpu.utils import enable_compilation_cache

    dev = device_info()
    log(f"device: {dev}")
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev['platform']}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"card: {card}")

    enable_compilation_cache()
    from epidemicsimulator_tpu.engine.scan import make_chunk_runner
    from epidemicsimulator_tpu.engine.state import init_state

    t0 = time.perf_counter()
    world = generate_synthetic_world(N_CITIZENS, n_output_areas=N_OAS, seed=0)
    log(f"world built in {time.perf_counter() - t0:.1f}s: "
        f"{world.n_citizens:,} citizens, {world.n_buildings:,} buildings, "
        f"{world.n_rooms:,} rooms, {world.n_output_areas:,} OAs")

    world = world.device_put()
    cfg = SimConfig(max_steps=WARMUP_STEPS + TIMED_STEPS, chunk_size=CHUNK)
    params = Params.covid().as_arrays()

    # Seed enough infections that every intervention subsystem is live in
    # the timed window: mask mandates on, vaccination program running
    # (trigger is 0.5% infected), buses every day — the steady-state load of
    # a real 5000-step run, measured at its most expensive.
    state = init_state(world, seed=0, starting_infected=20_000)

    chunk_fn = make_chunk_runner(world, cfg)

    t0 = time.perf_counter()
    state, out = chunk_fn(params, state)
    jax.block_until_ready(out.seirv)
    log(f"compile+warmup chunk ({CHUNK} steps) in {time.perf_counter() - t0:.1f}s")
    log(f"seirv after warmup: {np.asarray(out.seirv)[-1].tolist()}")

    n_chunks = TIMED_STEPS // CHUNK
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, out = chunk_fn(params, state)
    jax.block_until_ready(out.seirv)
    elapsed = time.perf_counter() - t0

    seirv = np.asarray(out.seirv)[-1]
    log(f"{TIMED_STEPS} steps in {elapsed:.2f}s "
        f"({elapsed / TIMED_STEPS * 1e3:.2f} ms/step); final seirv {seirv.tolist()}")

    rate = N_CITIZENS * TIMED_STEPS / elapsed
    print(
        json.dumps(
            {
                "metric": "citizen_steps_per_sec_3.46M_world",
                "value": round(rate),
                "unit": "citizen-steps/s",
                "vs_baseline": round(rate / BASELINE_CITIZEN_STEPS_PER_SEC, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
