"""Calibration tool (calibrate.py): recovers a known parameter and runs
through the CLI.  The reference ships no fitting code (its calibration was
by-eye notebook comparison); this is a capability beyond parity, so the
tests pin the machinery, not reference semantics."""

import dataclasses
import json
import os

import numpy as np

from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
from epidemicsimulator_tpu.calibrate import (
    calibrate, load_target_series, score_against_target,
)


def _toy_params(base, chance):
    # interventions off + short timers: the score valley around the
    # generating chance is steep and clean in this regime (0.1 scores
    # 0.016 vs 0.25+ for 2x off — measured)
    th = dataclasses.replace(
        base.thresholds, lockdown=-1.0, vaccination=-1.0,
        mask_public_transport=-1.0, mask_everywhere=-1.0,
    )
    return Params(
        dataclasses.replace(base.disease, exposure_chance=chance,
                            exposed_time=12, infected_time=48),
        th,
    )


def _run_once(world, params, cfg, seed=0):
    from epidemicsimulator_tpu.engine.scan import run
    from epidemicsimulator_tpu.engine.state import init_state

    st = init_state(world.device_put(), seed=seed, starting_infected=30)
    _, out = run(world.device_put(), params.as_arrays(), cfg, st)
    return np.asarray(out.seirv)


def test_score_prefers_the_generating_value():
    """The shape score is minimised at (or adjacent to) the parameter
    value that generated the target."""
    world = generate_synthetic_world(12_000, n_output_areas=6, seed=8)
    base = Params.covid()
    cfg = SimConfig(max_steps=240, chunk_size=60, record_exposures_per_oa=False)
    true_c = 0.1
    target = _run_once(world, _toy_params(base, true_c), cfg)
    scores = {}
    for c in (0.02, 0.1, 0.6):
        s = _run_once(world, _toy_params(base, c), cfg, seed=1)
        scores[c] = score_against_target(s, target)["score"]
    assert scores[0.1] < scores[0.02]
    assert scores[0.1] < scores[0.6]


def test_calibrate_recovers_known_chance():
    world = generate_synthetic_world(12_000, n_output_areas=6, seed=8)
    base = Params.covid()
    cfg = SimConfig(max_steps=240, chunk_size=60, record_exposures_per_oa=False)
    true_c = 0.1
    target = _run_once(world, _toy_params(base, true_c), cfg)
    result = calibrate(
        world, _toy_params(base, 0.5), cfg, target,
        param="exposure_chance", bounds=(0.01, 1.0),
        replicates=8, rounds=2, verbose=False,
    )
    assert true_c / 2 <= result["value"] <= true_c * 2, result["value"]
    assert len(result["rounds"]) == 2


def test_cli_calibrate(tmp_path):
    """--calibrate drives the fit end-to-end from a reference-format
    global_stats.json and writes the result artifact."""
    from epidemicsimulator_tpu.cli import main

    world = generate_synthetic_world(2000, n_output_areas=4, seed=3)
    base = Params.covid()
    cfg = SimConfig(max_steps=96, chunk_size=48)
    series = _run_once(world, _toy_params(base, 0.4), cfg)
    keys = ("susceptible", "exposed", "infected", "recovered", "vaccinated")
    rows = [
        {"time_step": t + 1, **{k: int(v) for k, v in zip(keys, row)}}
        for t, row in enumerate(series)
    ]
    tpath = tmp_path / "target.json"
    tpath.write_text(json.dumps(rows))
    out = tmp_path / "cal.json"
    rc = main([
        "demo", "--synthetic", "2000", "--seed", "3",
        "--directory", str(tmp_path),
        "--calibrate", str(tpath),
        "--calibrate-range", "0.05,1.0",
        "--calibrate-replicates", "6",
        "--calibrate-rounds", "1",
        "--max-steps", "96", "--chunk-size", "48",
        "--output-name", str(out),
    ])
    assert rc == 0
    result = json.load(open(out))
    assert result["param"] == "exposure_chance"
    assert 0.05 <= result["value"] <= 1.0
    assert os.path.exists(out)
