"""Recover the v1.6 exposure chance from the reference's canonical artifact.

docs/FIDELITY.md recovers every v1.6 parameter from the reference's logs
EXCEPT `exposure_chance` — "the one free parameter", hand-calibrated to
`V16_EXPOSURE_CHANCE = 0.003`.  This closes the loop with the automated
calibrator (`calibrate.py`): fit exposure_chance against the canonical
v1.6 York series (`statistics_results/york_stats_results/v1.6/
global_stats.json`) on the census-like York world using the
packed-ensemble grid search, and record how close the automated fit lands
to the shipped constant.

Writes sample_results/calibration/summary.json.

Usage: python tools/run_calibration.py [--replicates 12] [--rounds 2]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, ".")

TARGET = ("/root/reference/statistics_results/york_stats_results/"
          "v1.6/global_stats.json")
YORK_N = 197_603
YORK_OA = 637


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicates", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--target", default=TARGET)
    ap.add_argument("--out", default="sample_results/calibration")
    args = ap.parse_args()

    from epidemicsimulator_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    import jax

    from epidemicsimulator_tpu import Params, SimConfig
    from epidemicsimulator_tpu.calibrate import calibrate, load_target_series
    from epidemicsimulator_tpu.config import V16_EXPOSURE_CHANCE
    from epidemicsimulator_tpu.world.census_like import (
        generate_census_like_world,
    )

    t0 = time.perf_counter()
    world = generate_census_like_world(YORK_N, YORK_OA, seed=42)
    print(f"world: {time.perf_counter() - t0:.1f}s", flush=True)

    target = load_target_series(args.target)
    cfg = SimConfig(max_steps=args.steps, chunk_size=250,
                    record_exposures_per_oa=False)
    t0 = time.perf_counter()
    result = calibrate(
        world, Params.covid_v16(), cfg, target,
        param="exposure_chance", bounds=(5e-4, 1e-2),
        replicates=args.replicates, rounds=args.rounds, seed=1,
    )
    wall = time.perf_counter() - t0
    result.update(
        target="reference v1.6 canonical York artifact",
        world="census-like York (197,603/637, mega sites, seed 42)",
        shipped_constant=V16_EXPOSURE_CHANCE,
        rel_err_vs_shipped=round(
            abs(result["value"] - V16_EXPOSURE_CHANCE) / V16_EXPOSURE_CHANCE,
            4,
        ),
        wall_s=round(wall, 1),
        note=("Automated recovery of the one hand-calibrated v1.6 "
              "parameter (docs/FIDELITY.md): the packed-ensemble grid "
              "search evaluates every candidate column in one run per "
              "round."),
    )
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in
                      ("param", "value", "shipped_constant",
                       "rel_err_vs_shipped", "wall_s")}, indent=1),
          flush=True)


if __name__ == "__main__":
    main()
