"""Time the fast path's two citizen-phase formulations on the GPU.

Runs the chunk runner (engine/scan.py) on one world with
``use_fused_citizen`` False and True, in turns (unfused, fused, fused,
unfused by default), from the same seeded state, and prints steady-state
ms/step for each arm.  Both arms must end in the same state bitwise; the
tool fails otherwise.  It then times two pieces alone in a device loop:

* ``run_totals``: the work side's building + room run totals over one
  cumsum (ops/runsums.py), as ``work_side`` computes them;
* ``citizen_phase``: the fused citizen phase (ops/citizen.py) stepping its
  own carry.

Each piece is printed beside the least time one read and one write of its
lanes take at the card's published bandwidth.  ``--trace DIR`` also writes
a profiler trace of one simulated day per arm.

Usage:
  python tools/time_formulations.py --world synthetic --n 3457142 --oas 15669
  python tools/time_formulations.py --world census-like --n 63000000 \\
      --oas 227759 --steps 96 --chunk 24
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: Published device-memory bandwidth, bytes/s, keyed by ``device_kind``
#: (NVIDIA H100 SXM data sheet).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def build_world(kind: str, n: int, oas: int):
    if kind == "census-like":
        from epidemicsimulator_tpu.world.census_like import (
            generate_census_like_world as gen,
        )
    else:
        from epidemicsimulator_tpu.world.synthetic import (
            generate_synthetic_world as gen,
        )
    return gen(n, n_output_areas=oas, seed=0)


def loop_time(fn, carry, iters):
    """Seconds per iteration of ``carry = fn(carry)`` in a device loop."""
    import jax

    run = jax.jit(lambda c: jax.lax.fori_loop(0, iters, lambda i, c: fn(c), c))
    jax.block_until_ready(run(carry))
    t0 = time.perf_counter()
    jax.block_until_ready(run(carry))
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", choices=("synthetic", "census-like"),
                    default="synthetic")
    ap.add_argument("--n", type=int, default=3_457_142)
    ap.add_argument("--oas", type=int, default=15_669)
    ap.add_argument("--seed-infected", type=int, default=20_000)
    ap.add_argument("--warm-steps", type=int, default=250)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--arms", default="unfused,fused,fused,unfused")
    ap.add_argument("--trace", default=None, metavar="DIR")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from epidemicsimulator_tpu import Params, SimConfig
    from epidemicsimulator_tpu.backend import device_info
    from epidemicsimulator_tpu.engine.scan import make_chunk_runner
    from epidemicsimulator_tpu.engine.state import init_state

    dev = device_info()
    if dev["platform"] != "gpu":
        raise SystemExit(f"needs a GPU, found {dev}")
    peak = PEAK_BYTES_PER_S[dev["kind"]]
    name_power = card()
    log(f"device {dev}; card {name_power}")

    t0 = time.perf_counter()
    world = build_world(args.world, args.n, args.oas).device_put()
    log(f"{args.world} world {world.n_citizens:,} citizens built in "
        f"{time.perf_counter() - t0:.1f}s")
    params = Params.covid().as_arrays()
    steps = args.warm_steps + args.steps
    results = {}
    ref = None
    for arm in args.arms.split(","):
        fused = arm == "fused"
        cfg = SimConfig(max_steps=steps, chunk_size=args.chunk,
                        use_fused_citizen=fused)
        fn = make_chunk_runner(world, cfg)
        st = init_state(world, seed=0, starting_infected=args.seed_infected)
        t0 = time.perf_counter()
        for _ in range(args.warm_steps // args.chunk):
            st, out = fn(params, st)
        jax.block_until_ready(out.seirv)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.steps // args.chunk):
            st, out = fn(params, st)
        jax.block_until_ready(out.seirv)
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        seirv = np.asarray(out.seirv)[-1].tolist()
        log(f"arm {arm}: warm+compile {warm:.1f}s, {ms:.4f} ms/step, "
            f"final seirv {seirv} [{name_power}]")
        results.setdefault(arm, []).append(ms)
        final = (np.asarray(st.status), np.asarray(st.timer))
        if ref is None:
            ref = final
        assert all((x == y).all() for x, y in zip(ref, final)), (
            f"arm {arm} diverged from the first arm"
        )
        if args.trace:
            tcfg = SimConfig(max_steps=24, chunk_size=24,
                             use_fused_citizen=fused)
            tfn = make_chunk_runner(world, tcfg)
            st2, o2 = tfn(params, st)
            jax.block_until_ready(o2.seirv)
            with jax.profiler.trace(os.path.join(args.trace, arm)):
                st2, o2 = tfn(params, st2)
                jax.block_until_ready(o2.seirv)

    # --- pieces alone -----------------------------------------------------
    from epidemicsimulator_tpu.ops.citizen import (
        citizen_phase, make_citizen_statics,
    )
    from epidemicsimulator_tpu.ops.runsums import run_totals_from_cumsum

    n = world.n_citizens
    v0 = (jnp.arange(n) % 7 == 0).astype(jnp.int8)

    def rt(v):
        c = v.astype(jnp.int32)
        cs = jnp.cumsum(c)
        a = run_totals_from_cumsum(cs, c, world.ws_wb_start_mask,
                                   world.ws_wb_end_mask)
        b = run_totals_from_cumsum(cs, c, world.ws_room_start_mask,
                                   world.ws_room_end_mask)
        return ((a + b) & 1).astype(jnp.int8) ^ v

    t_rt = loop_time(rt, v0, 200)
    # one read of the value lane and four boundary masks, one write of two
    # int32 total lanes
    bytes_rt = n * (1 + 4 + 2 * 4)
    statics = make_citizen_statics(world)
    st0 = init_state(world, seed=0, starting_infected=args.seed_infected)
    sched0 = jnp.zeros((n,), jnp.int8)

    def cp(c):
        status, timer, sched, h = c
        s1, t1, sc1, _, _ = citizen_phase(
            statics, status, timer, sched,
            h24=(h % 24).astype(jnp.int8), move=True, mask_status=0,
            seed=h.astype(jnp.uint32), exposed_time=96, infected_time=336,
            exposure_chance=0.00055, mask_effectiveness=0.7,
            K=world.max_household_size, ref_mask_sem=True, u8_trunc=True,
        )
        return s1, t1, sc1, h + 1

    t_cp = loop_time(cp, (st0.status, st0.timer, sched0, jnp.int32(1)), 200)
    # statics a-e + status + timer + sched in; status, timer, sched, gates out
    bytes_cp = n * ((5 + 1 + 4 + 1) + (1 + 4 + 1 + 1))
    rows = {
        "card": name_power,
        "device": dev,
        "world": args.world,
        "n": n,
        "ms_per_step": results,
        "run_totals_us": t_rt * 1e6,
        "run_totals_bound_us": bytes_rt / peak * 1e6,
        "citizen_phase_us": t_cp * 1e6,
        "citizen_phase_bound_us": bytes_cp / peak * 1e6,
    }
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
