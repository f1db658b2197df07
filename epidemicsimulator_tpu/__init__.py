"""Agent-based epidemic simulation framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of
NoSuchThingAsRandom/EpidemicSimulator (ESUCD): synthetic UK populations from
census data, hourly SEIR(+V) dynamics with building-colocation exposure,
public-transport mixing and threshold-triggered interventions — expressed as
struct-of-arrays device tensors, segment reductions and one jit-scanned step
instead of an object graph behind mutexes.
"""

from .config import DiseaseParams, InterventionThresholds, Params, SimConfig
from .engine.simulator import Simulator
from .engine.state import SimState, init_state
from .engine.step import step
from .world.schema import World, make_world
from .engine.ensemble import run_ensemble
from .world.census_like import generate_census_like_world
from .world.synthetic import generate_synthetic_world
from .world.device_build import (
    build_tables_device,
    generate_synthetic_world_device,
)

__version__ = "0.1.0"

__all__ = [
    "DiseaseParams",
    "InterventionThresholds",
    "Params",
    "SimConfig",
    "SimState",
    "Simulator",
    "World",
    "generate_census_like_world",
    "generate_synthetic_world",
    "generate_synthetic_world_device",
    "build_tables_device",
    "run_ensemble",
    "init_state",
    "make_world",
    "step",
]
