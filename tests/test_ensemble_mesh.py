"""Replicate-per-device packed ensembles (parallel/ensemble_mesh.py).

Runs on the 8-device virtual CPU mesh (tests/conftest.py).  The contract
is exactness, not law: under id-keyed bus RNG every draw is keyed on a
GLOBAL id, so an R-replica ensemble sharded over n devices must reproduce
the single-device R-packing trajectory BITWISE at any mesh size — the
replicate axis is pure data parallelism with zero per-step collectives.
"""

import dataclasses

import numpy as np
import pytest

from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
from epidemicsimulator_tpu.engine.packed import run_packed_ensemble
from epidemicsimulator_tpu.parallel.ensemble_mesh import (
    run_packed_ensemble_sharded,
)

R = 16
STEPS = 72


def _sweep_params():
    """R-replica sweep with live interventions: exposure_chance swept so
    replicas diverge, thresholds low so lockdown/masks/vaccination all
    fire mid-run (interventions.rs:110-184 semantics per replica)."""
    base = Params.covid()
    out = []
    for r in range(R):
        out.append(Params(
            dataclasses.replace(
                base.disease,
                exposure_chance=0.05 + 0.01 * r,
                exposed_time=4, infected_time=24,
                vaccination_rate=40,
            ),
            dataclasses.replace(
                base.thresholds,
                lockdown=0.02, vaccination=0.01,
                mask_public_transport=0.005, mask_everywhere=0.015,
            ),
        ))
    return out


def _cfg(**kw):
    return SimConfig(
        max_steps=STEPS, chunk_size=24, starting_infected=12,
        use_fast_path=True, use_fused_citizen=False, bus_capacity=10, **kw,
    )


@pytest.fixture(scope="module")
def base_world():
    # transport ON: the id-keyed bus tie/draw streams are the hard part
    return generate_synthetic_world(4000, n_output_areas=8, seed=11)


@pytest.fixture(scope="module")
def single_device_idkeyed(base_world):
    return run_packed_ensemble(
        base_world, _sweep_params(),
        _cfg(id_keyed_ensemble_rng=True), seed=3,
    )


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matches_single_device_bitwise(
    base_world, single_device_idkeyed, n_dev
):
    sharded = run_packed_ensemble_sharded(
        base_world, _sweep_params(), _cfg(), n_devices=n_dev, seed=3,
    )
    np.testing.assert_array_equal(
        np.asarray(single_device_idkeyed), np.asarray(sharded),
        err_msg=f"sharded R={R} over {n_dev} devices diverged from the "
        "single-device packing",
    )


def test_epidemic_and_interventions_live(single_device_idkeyed):
    """The comparison above must not be vacuous: replicas diverge, expose
    and vaccinate."""
    seirv = np.asarray(single_device_idkeyed)  # (R, T, 5)
    n = seirv[0, 0].sum()
    assert (seirv.sum(axis=2) == n).all(), "census leak"
    assert (seirv[:, -1, 1] + seirv[:, -1, 2] > 0).any(), "epidemic died"
    assert (seirv[:, -1, 4] > 0).any(), "vaccination never fired"
    # swept exposure_chance must actually separate replicas
    assert len({int(x) for x in seirv[:, -1, 0]}) > 4


def test_id_keyed_stream_is_law_identical_not_bitwise(base_world):
    """id-keyed mode reseeds the bus streams: trajectories differ from the
    default counter-based mode (documented in SimConfig), while census
    conservation and intervention behavior hold in both."""
    default = run_packed_ensemble(
        base_world, _sweep_params(), _cfg(), seed=3,
    )
    keyed = run_packed_ensemble(
        base_world, _sweep_params(),
        _cfg(id_keyed_ensemble_rng=True), seed=3,
    )
    d, k = np.asarray(default), np.asarray(keyed)
    n = d[0, 0].sum()
    assert (d.sum(axis=2) == n).all() and (k.sum(axis=2) == n).all()
    assert not np.array_equal(d, k), (
        "bus restream should shift trajectories (transport is live)"
    )
    # same epidemic scale: total attack within 30% between RNG modes
    att_d = (n - d[:, -1, 0]).sum()
    att_k = (n - k[:, -1, 0]).sum()
    assert abs(att_d - att_k) / max(att_d, 1) < 0.3


def test_uneven_replicas_rejected(base_world):
    with pytest.raises(ValueError, match="divide"):
        run_packed_ensemble_sharded(
            base_world, _sweep_params()[:6], _cfg(), n_devices=4, seed=3,
        )
