"""The single formulation resolver (epidemicsimulator_tpu/backend.py).

The engines read their citizen-phase formulation from one place, and the
rule never looks at the device: no branch for a particular accelerator,
and no kernel that drops to an interpreter.
"""

import pathlib

import jax
import numpy as np
import pytest

from epidemicsimulator_tpu import Params, SimConfig, generate_synthetic_world
from epidemicsimulator_tpu.backend import device_info, use_fused_citizen

PKG = pathlib.Path(__file__).resolve().parent.parent / "epidemicsimulator_tpu"


@pytest.mark.parametrize("platform", ["cpu", "gpu", "tpu"])
def test_resolver_ignores_the_platform(monkeypatch, platform):
    from epidemicsimulator_tpu.engine.fastpath import wants_fused_citizen

    world = generate_synthetic_world(2_000, n_output_areas=4, seed=1)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert use_fused_citizen(SimConfig(), world.max_household_size)
    assert wants_fused_citizen(world, SimConfig())
    assert not wants_fused_citizen(world, SimConfig(use_fused_citizen=False))


def test_resolver_explicit_settings():
    assert use_fused_citizen(SimConfig(), 24)
    assert not use_fused_citizen(SimConfig(), 25)
    assert not use_fused_citizen(SimConfig(), 0)
    assert not use_fused_citizen(SimConfig(use_fused_citizen=False), 4)
    assert use_fused_citizen(SimConfig(use_fused_citizen=True), 4)
    with pytest.raises(ValueError, match="max_household_size"):
        use_fused_citizen(SimConfig(use_fused_citizen=True), 30)


@pytest.mark.parametrize("fused", [True, False])
def test_step_runs_no_pallas_kernel(fused):
    """Neither formulation lowers to a Pallas call, so nothing can run in
    the Pallas interpreter."""
    from epidemicsimulator_tpu.engine.state import init_state
    from epidemicsimulator_tpu.engine.step import step

    world = generate_synthetic_world(3_000, n_output_areas=6, seed=2)
    cfg = SimConfig(use_fused_citizen=fused)
    st = init_state(world, seed=0, starting_infected=30)
    jaxpr = jax.make_jaxpr(lambda w, p, s: step(w, p, cfg, s))(
        world.device_put(), Params.covid().as_arrays(), st
    )
    assert "pallas_call" not in str(jaxpr)


def test_package_has_no_device_branch_or_interpreter():
    """No module of the package imports a Pallas backend, selects the
    interpreter, or branches on a particular platform."""
    banned = ("pallas", "interpret=", "default_backend() ==",
              "default_backend() !=")
    hits = [
        f"{p.relative_to(PKG)}: {b}"
        for p in sorted(PKG.rglob("*.py"))
        for b in banned
        if b in p.read_text()
    ]
    assert not hits, hits


def test_device_info_reports_the_backend():
    info = device_info()
    assert info["platform"] == jax.devices()[0].platform
    assert info["kind"] == jax.devices()[0].device_kind
    assert info["count"] == len(jax.devices())
    assert np.int64(info["count"]) >= 1
