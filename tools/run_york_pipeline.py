"""York-scale run of the REAL CLI data path, end to end (VERDICT r2 next #5).

Generates a full offline data-directory fixture at York scale (637 OAs,
~197.5k citizens — BASELINE.md York row) with tools/gen_fixture.py, then
drives `epidemicsimulator_tpu.cli.main` exactly as a user would:

    parse census CSVs -> parse PBF -> WGS84->OSGB36 -> dedupe ->
    polygon assignment -> build_world (8 phases) -> simulate -> artifacts

and commits the four reference JSON artifacts + builder phase timings to
sample_results/york_pipeline/.  The reference's equivalent run is the
Viking York job: 197,603 citizens / 637 OAs, init 284.7s, total 343.0s
(epidemic_sim_v1.6_17739074.log; simulator_builder.rs:1162-1292).

Usage: python tools/run_york_pipeline.py [--steps 5000] [--oas 637]
"""

import argparse
import json
import os
import pathlib
import shutil
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="/tmp/york_fixture")
    ap.add_argument("--out", default="sample_results/york_pipeline")
    ap.add_argument("--oas", type=int, default=637)
    ap.add_argument("--pop", type=int, default=310)
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--params", choices=["covid_v16", "covid"],
                    default="covid_v16",
                    help="covid_v16 reproduces the reference's full v1.6 "
                    "York epidemic (peak ~89k); plain covid is the "
                    "v1.7.1-era suppressed parameterisation")
    args = ap.parse_args()

    from gen_fixture import write_fixture

    t0 = time.perf_counter()
    pbf, shp, codes = write_fixture(
        args.dir, n_oas=args.oas, pop_per_oa=args.pop, seed=0
    )
    fixture_s = time.perf_counter() - t0
    print(f"fixture: {len(codes)} OAs in {fixture_s:.1f}s", flush=True)

    from epidemicsimulator_tpu.cli import main as cli_main
    from epidemicsimulator_tpu.config import Params

    params_file = os.path.join(args.dir, "params_v16.json")
    getattr(Params, args.params)().to_json(params_file)

    sim_out = os.path.join(args.dir, "sim_out")
    t0 = time.perf_counter()
    rc = cli_main([
        "york_pipeline",
        "--directory", args.dir,
        "--pbf", pbf,
        "--shapefile", shp,
        "--simulate",
        "--max-steps", str(args.steps),
        "--seed", str(args.seed),
        "--params-file", params_file,
        "--output-name", sim_out,
    ])
    total_s = time.perf_counter() - t0
    assert rc == 0, f"cli exited {rc}"

    os.makedirs(args.out, exist_ok=True)
    for name in ("global_stats.json", "exposures.json", "timings.json",
                 "memory.json"):
        shutil.copy(os.path.join(sim_out, name), os.path.join(args.out, name))

    # builder phase timings persisted by the CLI next to the world cache
    tpath = None
    for p in pathlib.Path(args.dir).glob("*.build_timings.json"):
        tpath = p
    build_timings = json.load(open(tpath)) if tpath else {}

    stats = json.load(open(os.path.join(args.out, "global_stats.json")))
    first, last = stats[0], stats[-2] if len(stats) > 1 else stats[-1]
    n_citizens = sum(
        first[k] for k in
        ("susceptible", "exposed", "infected", "recovered", "vaccinated")
    )
    peak = max(s["infected"] for s in stats)
    peak_h = max(stats, key=lambda s: s["infected"])["time_step"]
    attack = last["recovered"]
    max_v = max(s["vaccinated"] for s in stats)
    end_h = len(stats) - 1

    cli_phases = {}
    cp = os.path.join(sim_out, "cli_phases.json")
    if os.path.exists(cp):
        cli_phases = json.load(open(cp))

    # gate the curve against the 32-seed v1.6 envelope (VERDICT r3 #4:
    # done = peak/attack inside the envelope, produced by cli.main)
    envelope_gate = None
    env_path = "sample_results/york_v16/summary.json"
    if args.params == "covid_v16" and os.path.exists(env_path):
        env = json.load(open(env_path))
        scale = n_citizens / 197_603  # envelope is at reference population

        def inside(val, rng_key):
            lo, hi = env[rng_key]
            return bool(lo * scale <= val <= hi * scale), [lo, hi]

        checks = {
            "peak": inside(peak, "peak_range"),
            "peak_h": (
                env["peak_h_range"][0] <= peak_h <= env["peak_h_range"][1],
                env["peak_h_range"],
            ),
            "attack": inside(attack, "attack_range"),
            "max_V": inside(max_v, "max_V_range"),
            "end_h": (
                env["end_h_range"][0] <= end_h <= env["end_h_range"][1],
                env["end_h_range"],
            ),
        }
        envelope_gate = {
            k: {"value": v, "inside": c[0], "envelope": c[1]}
            for (k, c), v in zip(
                checks.items(), [peak, peak_h, attack, max_v, end_h]
            )
        }

    # reference comparators: the Viking jobs in the same log — York 637
    # OAs (init 284.7s) and the headline Y&H run at 15,669 OAs
    # (init 399.55s, 0.80 s/step)
    if args.oas >= 10_000:
        reference = {
            "n_citizens": 3_457_142, "n_output_areas": 15_669,
            "init_s": 399.55, "s_per_step": 0.80,
            "source": "epidemic_sim_v1.6_17739074.log (Y&H headline)",
        }
        label = "real CLI data path at Y&H scale (gen_fixture inputs)"
    else:
        reference = {
            "n_citizens": 197_603, "n_output_areas": 637,
            "init_s": 284.7, "total_s": 343.0,
            "source": "epidemic_sim_v1.6_17739074.log",
        }
        label = "real CLI data path at York scale (gen_fixture inputs)"

    summary = {
        "what": label,
        "params": args.params,
        "n_output_areas": len(codes),
        "n_citizens": n_citizens,
        "steps_run": len(stats) - 1,
        "peak_infected": peak,
        "peak_hour": peak_h,
        "attack_final_R": attack,
        "max_vaccinated": max_v,
        "final": {k: last[k] for k in
                  ("susceptible", "exposed", "infected", "recovered",
                   "vaccinated")},
        "envelope_gate": envelope_gate,
        "fixture_gen_s": round(fixture_s, 1),
        "cli_total_s": round(total_s, 1),
        "cli_phases": cli_phases,
        "builder_phase_s": build_timings,
        "reference": reference,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
