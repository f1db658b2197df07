"""Data-layer benchmarks: the criterion-bench analog.

The reference benches census load, OSM load, polygon load and sim init
(run/benches/bench.rs:36-80).  This script times the same phases of this
framework's host data layer on generated fixtures at two scales:

* york:  637 OAs / 197,603 citizens  (the reference's York configuration)
* yh:    15,669 OAs / 3,457,142 citizens (Yorkshire & Humber)

Phases (one JSON line each):
  census_parse   4-table CSV parse -> CensusData   (load_census_data)
  pbf_parse      native C++ protobuf+zlib PBF parse (data/osm/native.py)
  point_in_poly  native batch point->OA polygon assignment
  world_build    census-like world generation (world/census_like.py)

Usage: python bench_data.py [york|yh] ...   (default: york)
No accelerator needed — every phase is host-side by design (SURVEY.md L0/L1).
"""

import json
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, "tests")

SCALES = {
    "york": {"n_oa": 637, "pop_per_oa": 310, "n_citizens": 197_603,
             "pbf_nodes": 60_000, "pbf_ways": 6_000, "pip_points": 500_000},
    "yh": {"n_oa": 15_669, "pop_per_oa": 221, "n_citizens": 3_457_142,
           "pbf_nodes": 1_000_000, "pbf_ways": 100_000,
           "pip_points": 4_000_000},
}


def _timed(label, scale, fn, detail=""):
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    print(json.dumps({"bench": label, "scale": scale,
                      "seconds": round(dt, 3), "detail": detail}), flush=True)
    return out, dt


def gen_census_csvs(d, n_oa, pop_per_oa, rng):
    """Write the 4 census tables in the NOMIS API long format for n_oa OAs
    (table shapes per load_census_data/src/tables/, column layouts per
    tables.py TABLE_SPECS)."""
    from epidemicsimulator_tpu.data.census.tables import (
        CensusTable, TABLE_SPECS,
    )

    codes = [f"E00{i:06d}" for i in range(n_oa)]

    rows = ["GEOGRAPHY_NAME,GEOGRAPHY_TYPE,C_AGE,OBS_VALUE,RURAL_URBAN_NAME,"
            "OBS_STATUS,RECORD_OFFSET,RECORD_COUNT"]
    counts = rng.integers(0, 8, size=(n_oa, 101))
    rows.extend(
        f"{codes[i]},output area,{a + 1},{counts[i, a]},Total,A,0,0"
        for i in range(n_oa) for a in range(101)
    )
    (d / TABLE_SPECS[CensusTable.AGE_STRUCTURE].filename).write_text(
        "\n".join(rows))

    occ_names = [
        "1. Managers, directors and senior officials",
        "2. Professional occupations",
        "3. Associate professional and technical occupations",
        "4. Administrative and secretarial occupations",
        "5. Skilled trades occupations",
        "6. Caring, leisure and other service occupations",
        "7. Sales and customer service occupations",
        "8. Process plant and machine operatives",
        "9. Elementary occupations",
    ]
    rows = ["GEOGRAPHY_NAME,GEOGRAPHY_TYPE,CELL_NAME,MEASURES_NAME,OBS_VALUE,"
            "OBS_STATUS,RECORD_OFFSET,RECORD_COUNT"]
    occ = rng.integers(1, 60, size=(n_oa, 9))
    for i in range(n_oa):
        rows.append(f"{codes[i]},output area,All categories: Occupation,"
                    f"Value,{occ[i].sum()},A,0,0")
        rows.extend(
            f'{codes[i]},output area,"{nm}",Value,{occ[i, j]},A,0,0'
            for j, nm in enumerate(occ_names)
        )
    (d / TABLE_SPECS[CensusTable.OCCUPATION_COUNT].filename).write_text(
        "\n".join(rows))

    rows = ["GEOGRAPHY_NAME,GEOGRAPHY_TYPE,RURAL_URBAN_NAME,CELL_NAME,"
            "MEASURES_NAME,OBS_VALUE,OBS_STATUS,RECORD_OFFSET,RECORD_COUNT"]
    for i in range(n_oa):
        pop = pop_per_oa + int(rng.integers(-40, 40))
        rows.append(f"{codes[i]},output area,Total,All usual residents,"
                    f"Value,{pop},A,0,0")
        rows.append(f"{codes[i]},output area,Total,Males,Value,{pop // 2},A,0,0")
        rows.append(f"{codes[i]},output area,Total,Females,Value,"
                    f"{pop - pop // 2},A,0,0")
    (d / TABLE_SPECS[CensusTable.POPULATION_DENSITY].filename).write_text(
        "\n".join(rows))

    # commuting: ~8 destination OAs per home OA (sparse like WF01BEW)
    rows = ["CURRENTLY_RESIDING_IN_CODE,PLACE_OF_WORK_NAME,OBS_VALUE"]
    dests = rng.integers(0, n_oa, size=(n_oa, 8))
    flows = rng.integers(1, 60, size=(n_oa, 8))
    rows.extend(
        f"{codes[i]},{codes[dests[i, j]]},{flows[i, j]}"
        for i in range(n_oa) for j in range(8)
    )
    (d / TABLE_SPECS[CensusTable.RESIDES_VS_WORKPLACE].filename).write_text(
        "\n".join(rows))


def gen_pbf(path, n_nodes, n_ways, rng):
    """Synthetic OSM PBF: tagged building nodes + square building ways,
    written with the wire-format writer the native-parser tests use."""
    from pbf_writer import build_pbf

    lat0, lon0 = 53.5, -1.5
    lats = rng.uniform(lat0, lat0 + 1.0, n_nodes)
    lons = rng.uniform(lon0, lon0 + 1.5, n_nodes)
    tags_cycle = [{"building": "house"}, {}, {"shop": "supermarket"}, {},
                  {"building": "commercial"}, {}, {"amenity": "school"}, {}]
    nodes = [
        (i + 1, lats[i], lons[i], tags_cycle[i % len(tags_cycle)])
        for i in range(n_nodes)
    ]
    ways = []
    nid = n_nodes + 1
    extra_nodes = []
    wlats = rng.uniform(lat0, lat0 + 1.0, n_ways)
    wlons = rng.uniform(lon0, lon0 + 1.5, n_ways)
    for w in range(n_ways):
        la, lg = wlats[w], wlons[w]
        ring = list(range(nid, nid + 4))
        extra_nodes.extend([
            (nid, la, lg, {}), (nid + 1, la + 3e-4, lg, {}),
            (nid + 2, la + 3e-4, lg + 3e-4, {}), (nid + 3, la, lg + 3e-4, {}),
        ])
        nid += 4
        ways.append((w + 1, ring + [ring[0]], {"building": "commercial"}))
    path.write_bytes(build_pbf(nodes + extra_nodes, ways))


def main():
    import pathlib

    scales = sys.argv[1:] or ["york"]
    rng = np.random.default_rng(0)
    from epidemicsimulator_tpu.data.census.container import load_census_data
    from epidemicsimulator_tpu.data.osm.native import (
        assign_points_to_polygons, parse_pbf,
    )
    from epidemicsimulator_tpu.world.census_like import (
        generate_census_like_world,
    )

    for scale in scales:
        cfgs = SCALES[scale]
        tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"benchdata_{scale}_"))
        try:
            gen_census_csvs(tmp, cfgs["n_oa"], cfgs["pop_per_oa"], rng)
            census, _ = _timed(
                "census_parse", scale,
                lambda: load_census_data(str(tmp)),
                detail=f"{cfgs['n_oa']} OAs x 4 tables",
            )

            pbf = tmp / "bench.osm.pbf"
            gen_pbf(pbf, cfgs["pbf_nodes"], cfgs["pbf_ways"], rng)
            parsed, _ = _timed(
                "pbf_parse", scale,
                lambda: parse_pbf(str(pbf)),
                detail=(f"{cfgs['pbf_nodes']:,} nodes + "
                        f"{cfgs['pbf_ways']:,} ways, "
                        f"{pbf.stat().st_size / 1e6:.1f} MB"),
            )

            # point-in-polygon: OA grid of square cells over the bbox
            n_oa = cfgs["n_oa"]
            side = int(np.ceil(np.sqrt(n_oa)))
            cell = 700_000.0 / side
            rings, starts = [], [0]
            for i in range(n_oa):
                x0, y0 = (i % side) * cell, (i // side) * cell
                rings.append(np.array(
                    [[x0, y0], [x0 + cell, y0], [x0 + cell, y0 + cell],
                     [x0, y0 + cell], [x0, y0]]))
                starts.append(starts[-1] + 5)
            rings = np.concatenate(rings).astype(np.float64)
            starts = np.asarray(starts, np.int64)
            px = rng.uniform(0, 700_000, cfgs["pip_points"])
            py = rng.uniform(0, 700_000, cfgs["pip_points"])
            _timed(
                "point_in_poly", scale,
                lambda: assign_points_to_polygons(px, py, rings, starts),
                detail=f"{cfgs['pip_points']:,} points vs {n_oa:,} polygons",
            )

            _timed(
                "world_build", scale,
                lambda: generate_census_like_world(
                    cfgs["n_citizens"], cfgs["n_oa"], seed=1),
                detail=f"{cfgs['n_citizens']:,} citizens census-like",
            )
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
