"""Gate the Y&H pipeline against the reference's OWN Y&H run — r5.

The reference's headline 3.46M-citizen Yorkshire&Humber v1.6 run left
its full census series in its log (`epidemic_sim_v1.6_17739074.log`:
100 `StatisticEntry` lines, one per 50 steps) — a comparator the York
envelope can't give (different scale, different structure).  This tool:

1. extracts that series (the entries whose census totals ~3.46M — the
   log also contains a York run);
2. runs N seeds of the Y&H-scale fixture through the REAL CLI data path
   (`cli.main`, --use-cache so the world builds once), `covid_v16`
   parameters;
3. gates the reference's per-capita I and V curves against the seed
   band the way tools/v16_curve_gate.py gates York: pointwise and
   phase-tolerant coverage at the log's 50-step sampling, plus the
   scalar anatomy (peak fraction, peak step, attack, max V).

Writes sample_results/yh_pipeline/log_gate.json (+ seed curves).

Usage: python tools/yh_log_gate.py [--seeds 5] [--dir /tmp/yh_fixture]
"""

import argparse
import json
import os
import pathlib
import re
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np

LOG = "/root/reference/epidemic_sim_v1.6_17739074.log"
REF_POP = 3_457_142
ENTRY = re.compile(
    r"time_step: (\d+), susceptible: (\d+), exposed: (\d+), "
    r"infected: (\d+), recovered: (\d+), vaccinated: (\d+)"
)


def reference_series():
    rows = []
    for line in open(LOG):
        m = ENTRY.search(line)
        if m:
            t, s, e, i, r, v = map(int, m.groups())
            if s + e + i + r + v > 1_000_000:
                rows.append((t, s, e, i, r, v))
    a = np.array(rows, np.int64)
    assert a.shape[0] == 100, f"expected 100 Y&H entries, got {a.shape[0]}"
    return a  # (100, 6): step, S, E, I, R, V


def run_seed(args, seed, out_dir):
    from epidemicsimulator_tpu.cli import main as cli_main

    sim_out = os.path.join(args.dir, f"band_seed{seed}")
    rc = cli_main([
        "york_pipeline",
        "--directory", args.dir,
        "--pbf", os.path.join(args.dir, "fixture.osm.pbf"),
        "--shapefile", os.path.join(args.dir, "areas.shp"),
        "--use-cache",
        "--simulate",
        "--max-steps", "5000",
        "--seed", str(seed),
        "--params-file", os.path.join(args.dir, "params_v16.json"),
        "--output-name", sim_out,
    ])
    assert rc == 0
    stats = json.load(open(os.path.join(sim_out, "global_stats.json")))
    arr = np.array(
        [[r["susceptible"], r["exposed"], r["infected"], r["recovered"],
          r["vaccinated"]] for r in stats], np.int64
    )
    if arr[-1].sum() == 0:
        arr = arr[:-1]
    np.save(os.path.join(out_dir, f"seirv_seed{seed}.npy"), arr)
    return arr


def band_cov(ref_pc, seed_pc, shift_rows=0):
    """ref_pc (T,), seed_pc (S, T): pointwise band coverage, optionally
    min/max over a +/- shift_rows window (each row = 50 hours)."""
    lo, hi = seed_pc.min(axis=0), seed_pc.max(axis=0)
    if shift_rows:
        from numpy.lib.stride_tricks import sliding_window_view

        lo = sliding_window_view(
            np.pad(lo, shift_rows, mode="edge"), 2 * shift_rows + 1
        ).min(axis=1)
        hi = sliding_window_view(
            np.pad(hi, shift_rows, mode="edge"), 2 * shift_rows + 1
        ).max(axis=1)
    return float(((ref_pc >= lo) & (ref_pc <= hi)).mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="/tmp/yh_fixture")
    ap.add_argument("--out", default="sample_results/yh_pipeline")
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args()

    ref = reference_series()
    steps = ref[:, 0]  # 1, 51, ... 4951

    import jax

    os.makedirs(args.out, exist_ok=True)
    curves = []
    pops = []
    for seed in range(1, args.seeds + 1):
        p = os.path.join(args.out, f"seirv_seed{seed}.npy")
        t0 = time.perf_counter()
        if os.path.exists(p):
            arr = np.load(p)
        else:
            arr = run_seed(args, seed, args.out)
        print(f"seed {seed}: {arr.shape[0]} hours in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        curves.append(arr)
        pops.append(int(arr[0].sum()))

    pop = pops[0]
    assert all(p == pop for p in pops)
    # sample the seed curves at the log's 50-step grid (time_step t is
    # row t-1 of global_stats' per-step series; pad short runs with
    # their final row — post-extinction censuses are constant)
    T = max(c.shape[0] for c in curves)
    grid = np.stack([
        np.pad(c, ((0, T - c.shape[0]), (0, 0)), mode="edge")
        for c in curves
    ])  # (S, T, 5)
    idx = np.minimum(steps - 1, T - 1)
    sampled = grid[:, idx, :]  # (S, 100, 5)

    report = {
        "n_seeds": args.seeds,
        "sim_population": pop,
        "reference_population": REF_POP,
        "reference_log": LOG,
        "reference_anatomy": {
            "peak_I_frac": round(float(ref[:, 3].max()) / REF_POP, 4),
            "peak_step": int(ref[ref[:, 3].argmax(), 0]),
            "attack_frac": round(float(ref[-1, 4]) / REF_POP, 4),
            "max_V_frac": round(float(ref[:, 5].max()) / REF_POP, 4),
        },
        "sim_anatomy_band": {},
        "coverage": {},
    }
    for name, ref_col, sim_col in (("infected", 3, 2), ("vaccinated", 5, 4)):
        ref_pc = ref[:, ref_col].astype(np.float64) / REF_POP
        sim_pc = sampled[:, :, sim_col].astype(np.float64) / pop
        report["coverage"][name] = {
            "pointwise": round(band_cov(ref_pc, sim_pc), 4),
            # each row is 50 hours; +/-2 rows ~ the +/-72h tolerance the
            # York curve gate uses for trigger-hour jitter
            "phase100h": round(band_cov(ref_pc, sim_pc, 2), 4),
            "phase200h": round(band_cov(ref_pc, sim_pc, 4), 4),
        }
    peak_fr = [float(c[:, 2].max()) / pop for c in curves]
    peak_h = [int(c[:, 2].argmax()) for c in curves]
    att = [float(c[-1, 3]) / pop for c in curves]
    maxv = [float(c[:, 4].max()) / pop for c in curves]
    report["sim_anatomy_band"] = {
        "peak_I_frac": [round(min(peak_fr), 4), round(max(peak_fr), 4)],
        "peak_hour": [min(peak_h), max(peak_h)],
        "attack_frac": [round(min(att), 4), round(max(att), 4)],
        "max_V_frac": [round(min(maxv), 4), round(max(maxv), 4)],
    }
    ra = report["reference_anatomy"]
    band = report["sim_anatomy_band"]

    def inside(v, rng, tol=0.0):
        lo, hi = rng
        w = (hi - lo) * tol
        return bool(lo - w <= v <= hi + w)

    report["anatomy_gate"] = {
        "peak_I_frac_inside": inside(ra["peak_I_frac"], band["peak_I_frac"]),
        "attack_frac_inside": inside(ra["attack_frac"], band["attack_frac"]),
        "max_V_frac_inside": inside(ra["max_V_frac"], band["max_V_frac"]),
        "peak_step_inside": inside(
            float(ra["peak_step"]), [float(x) for x in band["peak_hour"]]
        ),
    }
    with open(os.path.join(args.out, "log_gate.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
