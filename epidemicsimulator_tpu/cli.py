"""Command-line driver: the `run` crate equivalent (run/src/main.rs:68-167).

Modes (mutually exclusive, like the reference's clap flags):

  --download            fetch the four census tables from NOMIS
  --resume ROW --table T  resume a partial table download
  --simulate            build/load the world and run the epidemic
  --render              render the OA map PNG
  --visualise-buildings scatter the classified OSM buildings
  --visualise           buildings + output areas overlay
  --synthetic N         use a synthetic world of N citizens (no data files)

Shared flags: positional area code, --directory (data dir), --use-cache,
--output-name, --seed, --max-steps.

Examples:
  python -m epidemicsimulator_tpu.cli 1946157112 --directory data --simulate
  python -m epidemicsimulator_tpu.cli york --synthetic 200000 --simulate
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="epidemicsimulator-tpu",
        description="Agent-based epidemic simulation on census data, in JAX",
    )
    p.add_argument("area", help="NOMIS area code (e.g. 1946157112 for York) or a label")
    p.add_argument("--directory", default="data", help="data directory")
    p.add_argument("--grid-size", type=int, default=700_000,
                   help="accepted for reference-CLI parity; unused (geometry is metric)")
    p.add_argument("--use-cache", action="store_true",
                   help="reuse the preprocessed world .npz if present")
    p.add_argument("--allow-download", action="store_true")
    p.add_argument("--simulate", action="store_true")
    p.add_argument("--download", action="store_true")
    p.add_argument("--resume", type=int, default=None, metavar="ROW")
    p.add_argument("--table", default=None)
    p.add_argument("--render", action="store_true")
    p.add_argument("--visualise", action="store_true")
    p.add_argument("--visualise-buildings", action="store_true")
    p.add_argument("--synthetic", type=int, default=None, metavar="N_CITIZENS")
    p.add_argument("--census-like", action="store_true",
                   help="with --synthetic: census-shaped structure (England "
                        "age pyramid, KS608 occupations, hub commuting, "
                        "lognormal workplaces) instead of the toy generator")
    p.add_argument("--output-name", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=5000)
    p.add_argument("--chunk-size", type=int, default=250)
    p.add_argument("--calibrate", default=None, metavar="TARGET_JSON",
                   help="fit a parameter so the epidemic matches a "
                   "reference-format global_stats.json (packed-ensemble "
                   "grid refinement; calibrate.py) instead of simulating")
    p.add_argument("--calibrate-param", default="exposure_chance")
    p.add_argument("--calibrate-range", default="1e-4,1e-2",
                   help="lo,hi bracket for the calibrated parameter")
    p.add_argument("--calibrate-replicates", type=int, default=16)
    p.add_argument("--calibrate-rounds", type=int, default=2)
    p.add_argument("--devices", type=int, default=None, metavar="N",
                   help="run the population-sharded engine over an N-device "
                   "mesh (0 = every visible device; default: single-device "
                   "fast path) — the mesh analog of the reference CLI's "
                   "parallel engine, run/src/main.rs:64-67")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between device-state snapshots (0 = off)")
    p.add_argument("--pbf", default=None, help="OSM .pbf extract path")
    p.add_argument("--shapefile", default=None, help="OA boundary shapefile path")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="disable the persistent XLA compilation cache "
                        "($JAX_COMPILATION_CACHE_DIR if set, else .cache/xla "
                        "in the checkout)")
    p.add_argument("--params-file", default=None,
                   help="JSON disease/threshold parameters (default: COVID)")
    return p


def _cache_suffix(args) -> str:
    return "_censuslike" if getattr(args, "census_like", False) else ""


def _world_cache_path(args) -> str:
    return os.path.join(args.directory, f"world_{args.area}{_cache_suffix(args)}.npz")


def _geometry_cache_path(args) -> str:
    return os.path.join(
        args.directory, f"geometry_{args.area}{_cache_suffix(args)}.npz"
    )


def load_or_build_world(args):
    """-> (World, WorldGeometry | None).

    Geometry (OA rings + building scatter) is persisted in a sidecar npz
    next to the world cache so --render/--visualise work on cached worlds
    too (the reference re-reads the shapefile every run instead).
    """
    from .world.geometry import WorldGeometry, synthetic_geometry
    from .world.schema import World

    cache = _world_cache_path(args)
    geo_cache = _geometry_cache_path(args)
    if args.use_cache and os.path.exists(cache):
        logging.info("loading cached world from %s", cache)
        geometry = (
            WorldGeometry.load_npz(geo_cache)
            if os.path.exists(geo_cache)
            else None
        )
        return World.load_npz(cache), geometry

    if args.synthetic:
        if getattr(args, "census_like", False):
            from .world.census_like import generate_census_like_world as gen
        else:
            from .world.synthetic import generate_synthetic_world as gen

        world = gen(
            args.synthetic, n_output_areas=max(4, args.synthetic // 300),
            seed=args.seed,
        )
        geometry = synthetic_geometry(world, seed=args.seed)
        if os.path.isdir(args.directory):
            world.save_npz(cache)
            geometry.save_npz(geo_cache)
        return world, geometry

    # full pipeline: census CSVs + OSM pbf + OA shapefile
    from .data.census.container import load_census_data
    from .data.geo.convert import wgs84_to_national_grid
    from .data.osm.native import parse_pbf
    from .data.osm.shapefile import read_polygons
    from .world.preprocess.builder import (
        OSMBuildings,
        build_world,
        dedupe_close_buildings,
    )

    census = load_census_data(args.directory)
    shp = args.shapefile or os.path.join(
        args.directory, "census_map_areas_converted", f"{args.area}.shp"
    )
    codes, rings, starts = read_polygons(shp)
    pbf = args.pbf or os.path.join(args.directory, f"{args.area}.osm.pbf")
    # OSM parse cache: the npz analog of the reference's bincode cache
    # (osm_data/src/lib.rs:395-474), honoured by --use-cache.
    import numpy as np

    osm_cache = pbf + ".parsed.npz"
    if args.use_cache and os.path.exists(osm_cache):
        with np.load(osm_cache) as z:
            classes, lats, lons, areas = (
                z["classes"], z["lats"], z["lons"], z["areas"]
            )
    else:
        classes, lats, lons, areas = parse_pbf(pbf)
        np.savez_compressed(
            osm_cache, classes=classes, lats=lats, lons=lons, areas=areas
        )
    east, north = wgs84_to_national_grid(lats, lons)
    keep = dedupe_close_buildings(classes, east, north)
    osm = OSMBuildings(
        classes=classes[keep], east=east[keep], north=north[keep],
        areas=areas[keep],
    )
    # per-phase wall clock, the reference's per-init-stage Timer prints
    # (simulator_builder.rs:1168-1290); persisted next to the world cache
    timings: dict = {}
    world = build_world(
        census, osm, rings, starts, codes, seed=args.seed, timings=timings
    )
    import json as _json

    with open(cache + ".build_timings.json", "w") as f:
        _json.dump(timings, f, indent=1)
    world.save_npz(cache)
    geometry = WorldGeometry(
        rings=rings, ring_starts=starts, codes=list(codes),
        b_east=osm.east, b_north=osm.north, b_classes=osm.classes,
    )
    geometry.save_npz(geo_cache)
    return world, geometry


def main(argv=None) -> int:
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = make_parser().parse_args(argv)

    if not args.no_compile_cache:
        from .utils import enable_compilation_cache

        logging.info("compilation cache: %s", enable_compilation_cache())

    phases: dict = {}  # coarse wall-clock phases -> <output>/cli_phases.json
    t_start = time.perf_counter()

    if args.download or args.resume is not None:
        from .data.census.nomis import (
            GEOGRAPHY_CODES,
            download_all_tables,
            download_table,
        )
        from .data.census.tables import CensusTable, TABLE_SPECS

        os.makedirs(args.directory, exist_ok=True)
        if args.resume is not None:
            table = CensusTable[args.table] if args.table else CensusTable.AGE_STRUCTURE
            dest = os.path.join(args.directory, TABLE_SPECS[table].filename)
            download_table(
                table, GEOGRAPHY_CODES.get(args.area, args.area), dest,
                resume_from_row=args.resume,
            )
        else:
            download_all_tables(args.directory, args.area)
        return 0

    world, geometry = load_or_build_world(args)
    phases["world_load_or_build_s"] = round(time.perf_counter() - t_start, 2)

    if args.render or args.visualise or args.visualise_buildings:
        if geometry is None:
            logging.error(
                "visualisation needs geometry: rebuild the world once "
                "without --use-cache (writes the geometry sidecar), or "
                "pass --shapefile"
            )
            return 1

        if args.visualise_buildings:
            # classified building scatter (run/src/main.rs:214-232
            # "raw_buildings.png")
            from .viz.maps import draw_buildings

            out = args.output_name or f"{args.area}_raw_buildings.png"
            draw_buildings(
                out, geometry.b_east, geometry.b_north, geometry.b_classes
            )
        elif args.visualise:
            # polygons + building overlay (run/src/main.rs:263-288
            # "BuildingsAndOutputAreas.png")
            from .viz.maps import draw_buildings_and_output_areas

            out = args.output_name or f"{args.area}_buildings_and_oas.png"
            draw_buildings_and_output_areas(
                out, geometry.rings, geometry.ring_starts,
                geometry.b_east, geometry.b_north, geometry.b_classes,
            )
        else:
            # value-coloured OA choropleth: buildings per OA / 100, the
            # reference's BuildingDensity measure (run/src/main.rs:246-261),
            # plus the citizen-graph stats print (visualise.rs:44-59).
            from .viz.graphs import (
                citizen_connections,
                connected_components_count,
            )
            from .viz.maps import draw_output_areas
            from .world.geometry import buildings_per_output_area

            out = args.output_name or f"{args.area}_building_density.png"
            density = buildings_per_output_area(world) / 100.0
            draw_output_areas(
                out, geometry.rings, geometry.ring_starts,
                values=density[: geometry.n_polygons],
                title="Building density",
            )
            g = citizen_connections(world)
            print(
                f"There are {g.number_of_nodes()} nodes and "
                f"{g.number_of_edges()} edges"
            )
            print(
                f"There are {connected_components_count(g)} connected groups"
            )
        logging.info("wrote %s", out)
        return 0

    if args.calibrate:
        from .calibrate import calibrate, load_target_series
        from .config import Params, SimConfig

        cfg = SimConfig(max_steps=args.max_steps, chunk_size=args.chunk_size)
        base = (
            Params.from_json(args.params_file)
            if args.params_file else Params.covid()
        )
        target = load_target_series(args.calibrate)
        lo, hi = (float(x) for x in args.calibrate_range.split(","))
        result = calibrate(
            world, base, cfg, target,
            param=args.calibrate_param, bounds=(lo, hi),
            replicates=args.calibrate_replicates,
            rounds=args.calibrate_rounds, seed=args.seed,
        )
        out_path = args.output_name or f"{args.area}_calibration.json"
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        print(
            f"calibrated {result['param']} = {result['value']:.6g} "
            f"(score {result['score']['score']:.4f}); wrote {out_path}"
        )
        return 0

    if args.simulate:
        from .backend import device_info
        from .config import Params, SimConfig
        from .engine.simulator import Simulator

        logging.info("JAX devices: %s", device_info())

        cfg = SimConfig(max_steps=args.max_steps, chunk_size=args.chunk_size)
        params = (
            Params.from_json(args.params_file) if args.params_file else Params.covid()
        )
        out_dir = args.output_name or os.path.join(
            "statistics_output", f"{args.area}_{int(time.time())}"
        )
        ckpt = (
            os.path.join(args.directory, f"ckpt_{args.area}.npz")
            if args.checkpoint_every
            else None
        )
        t0 = time.perf_counter()
        sim = Simulator(
            world, params, cfg, seed=args.seed,
            checkpoint_path=ckpt,
            checkpoint_every_chunks=max(1, args.checkpoint_every // cfg.chunk_size)
            if args.checkpoint_every else 0,
            devices=args.devices,
        )
        phases["sim_init_s"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
        sim.simulate(out_dir + os.sep)
        phases["simulate_s"] = round(time.perf_counter() - t0, 2)
        phases["simulate_loop"] = {
            k: round(v, 2) for k, v in getattr(sim, "last_timing", {}).items()
        }
        phases["total_s"] = round(time.perf_counter() - t_start, 2)
        # dispatch/compile/sync split from the chunk loop (PERF.md rule:
        # "interpret any end-to-end wall number with the per-phase
        # breakdown in hand"; the first chunk's dispatch includes compile)
        import json as _json

        with open(os.path.join(out_dir, "cli_phases.json"), "w") as f:
            _json.dump(phases, f, indent=1)
        logging.info("results dumped to %s", out_dir)
        return 0

    logging.warning("no mode selected; try --simulate")
    return 1


if __name__ == "__main__":
    sys.exit(main())
