"""Reproduce the Y&H head-to-head artifact (sample_results/yh_full_run).

The reference's headline run: 3,457,142 citizens, 15,669 OAs, 5,000 hourly
steps on a 32-core cluster node in 4,378s total (399.5s init + ~3,978s sim;
`epidemic_sim_v1.6_17739074.log`).  This runs the identical-scale synthetic
world end to end on one accelerator — world build, device transfer, compile,
5,000 steps, artifact dump — and writes the four JSON artifacts + a SEIRV
curve PNG.

Usage: python tools/run_yh_headtohead.py [outdir]
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "sample_results/yh_full_run"
    from epidemicsimulator_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    import jax

    from epidemicsimulator_tpu import (
        Params,
        SimConfig,
        generate_synthetic_world_device,
    )
    from epidemicsimulator_tpu.engine.simulator import Simulator

    t0 = time.perf_counter()
    # World generation runs on the device (world/device_build.py).
    world = generate_synthetic_world_device(
        3_457_142, n_output_areas=15_669, seed=0
    )
    jax.block_until_ready(world.age)
    t_build = time.perf_counter() - t0
    print(f"world build (on-device): {t_build:.1f}s", flush=True)

    t1 = time.perf_counter()
    sim = Simulator(
        world,
        Params.covid(),
        SimConfig(max_steps=5000, chunk_size=250),
        seed=0,
    )
    t_init = time.perf_counter() - t1
    print(f"simulator init (device transfer + state): {t_init:.1f}s", flush=True)

    t1 = time.perf_counter()
    sim.simulate(outdir)
    t_sim = time.perf_counter() - t1
    total = time.perf_counter() - t0

    seirv = np.array(
        [[e["susceptible"], e["exposed"], e["infected"], e["recovered"],
          e["vaccinated"]]
         for e in json.load(open(f"{outdir}/global_stats.json"))]
    )
    np.save(f"{outdir}/seirv.npy", seirv)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(9, 5))
        for i, name in enumerate("SEIRV"):
            ax.plot(seirv[:, i], label=name)
        ax.set_xlabel("hour")
        ax.set_ylabel("citizens")
        ax.legend()
        ax.set_title(
            f"Y&H-scale 3.46M x {len(seirv)} steps — one "
            f"{jax.devices()[0].device_kind}, "
            f"{total:.0f}s end-to-end (reference: 4,378s on 32 cores)"
        )
        fig.tight_layout()
        fig.savefig(f"{outdir}/curves.png", dpi=110)
    except Exception as e:  # viz optional
        print("plot skipped:", e)

    summary = {
        "world_build_s": round(t_build, 1),
        "sim_init_s": round(t_init, 1),
        "simulate_s": round(t_sim, 1),
        "total_s": round(total, 1),
        "steps": int(len(seirv)),
        "reference_total_s": 4378,
        "speedup": round(4378 / total, 1),
    }
    with open(f"{outdir}/summary.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
