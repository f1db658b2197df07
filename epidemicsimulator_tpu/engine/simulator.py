"""User-facing Simulator: the analog of ``sim/src/simulator.rs``'s Simulator.

Owns a static :class:`World`, traced :class:`Params`, and runs the compiled
chunked scan with host-side statistics recording and progress printing
(simulator.rs:108-127).
"""

from __future__ import annotations

import time

import numpy as np

from ..config import Params, SimConfig
from ..stats.recorder import StatisticsRecorder, _memory_usage_string
from ..world.schema import World
from .fastpath import wants_fixed_priority_vax as _wants_fp_vax
from .scan import run
from .state import SimState, init_state


class Simulator:
    def __init__(
        self,
        world: World,
        params: Params | None = None,
        cfg: SimConfig | None = None,
        *,
        seed: int = 0,
        oa_codes: list[str] | None = None,
        verbose: bool = True,
        profile_dir: str | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every_chunks: int = 0,
        devices: int | None = None,
    ):
        """``profile_dir``: capture a jax.profiler trace of one mid-run chunk
        (the analog of the reference's criterion+cpuprofiler benches,
        run/benches/bench.rs).  ``checkpoint_path``: snapshot the device
        state every ``checkpoint_every_chunks`` chunks and resume from an
        existing snapshot.  ``devices``: run the population-sharded engine
        over an N-device mesh (parallel/fastmesh.py) — 0 = every visible
        device; None = the single-device fast path.  The reference's CLI
        runs its parallel engine by default (run/src/main.rs:64-67 pins a
        40-thread rayon pool); this is the mesh analog, with recorder /
        checkpoint / artifact behaviour identical to the single-device
        path."""
        import os

        if os.environ.get("ESUCD_NO_COMPILE_CACHE", "") != "1":
            # Idempotent; warm processes load the chunk executable instead
            # of compiling it.  Opt out with ESUCD_NO_COMPILE_CACHE=1.
            from ..utils import enable_compilation_cache

            enable_compilation_cache()
        self.devices = devices
        self.params = (params or Params.covid()).as_arrays()
        self.cfg = cfg or SimConfig()
        self.seed = seed
        self.verbose = verbose
        self.recorder = StatisticsRecorder(oa_codes=oa_codes)
        self.profile_dir = profile_dir
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every_chunks = checkpoint_every_chunks
        if devices is not None:
            # Sharded setup: partition on host, shard lanes over the mesh.
            from ..parallel.fastmesh import init_sharded_state
            from ..parallel.mesh import make_mesh
            from ..parallel.partition import partition_world

            self.mesh = make_mesh(devices if devices > 0 else None)
            n_dev = int(self.mesh.devices.size)
            if verbose:
                print(f"population-sharded engine over {n_dev} device(s)")
            self.world = world  # host copy; shards are device_put below
            self.sw = partition_world(world, n_dev)
            self.state = init_sharded_state(
                world, self.sw, seed=seed,
                starting_infected=self.cfg.starting_infected, cfg=self.cfg,
            )
        else:
            self.world = world.device_put()
            self.state: SimState = init_state(
                self.world,
                seed=seed,
                starting_infected=self.cfg.starting_infected,
                fixed_priority_vax=_wants_fp_vax(self.world, self.cfg),
            )
        if checkpoint_path is not None:
            import os

            if os.path.exists(checkpoint_path):
                from .checkpoint import load_state

                self.state, _ = load_state(checkpoint_path)
                if verbose:
                    print(f"resumed from {checkpoint_path} at hour {int(self.state.hour)}")

    def _run_sharded(self, callback, timing: dict):
        """Chunk loop over the population-sharded runner (same structure as
        engine/scan.py::run: host-checked S+E+I early exit matching
        statistics.rs:289-291, per-chunk callback for recorder/checkpoint/
        progress).  Per-chunk materialisation is deliberate: the callback
        reads the state the chunk just produced, before the next dispatch
        donates its buffers."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.fastmesh import make_fast_sharded_runner
        from ..parallel.mesh import AXIS

        t0 = time.perf_counter()
        shard = NamedSharding(self.mesh, P(AXIS))
        w_sh = jax.tree.map(
            lambda x: jax.device_put(jnp.asarray(x), shard)
            if hasattr(x, "shape") else x,
            self.sw,
        )
        runner = make_fast_sharded_runner(self.sw, self.cfg, self.mesh)
        timing["shard upload"] = time.perf_counter() - t0

        state = self.state
        chunks = []
        steps = int(state.hour)
        t_disp = 0.0
        t_cb = 0.0
        while steps < self.cfg.max_steps:
            t0 = time.perf_counter()
            state, out = runner(w_sh, self.params, state)
            out = jax.tree.map(np.asarray, out)
            t_disp += time.perf_counter() - t0
            chunks.append(out)
            steps += self.cfg.chunk_size
            t0 = time.perf_counter()
            callback(steps, out, state)
            t_cb += time.perf_counter() - t0
            seirv = out.seirv
            if not (seirv[-1, 0] + seirv[-1, 1] + seirv[-1, 2] > 0):
                break
        timing["dispatch"] = t_disp
        timing["callback"] = t_cb
        outputs = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *chunks)
        outputs = jax.tree.map(lambda x: x[: self.cfg.max_steps], outputs)
        seirv = outputs.seirv
        alive = seirv[:, 0] + seirv[:, 1] + seirv[:, 2] > 0
        if not alive.all():
            end = int(np.argmin(alive)) + 1
            outputs = jax.tree.map(lambda x: x[:end], outputs)
        return state, outputs

    def simulate(self, output_dir: str | None = None) -> np.ndarray:
        """Run to completion; optionally dump the four JSON artifacts.

        Returns the (T, 5) SEIRV series.
        """
        t0 = time.perf_counter()
        last_print = [t0]

        chunk_counter = [0]
        prev_flags = [False, 0]  # lockdown, mask_status

        def _log_interventions(steps_done, out):
            # Transition logging, matching the reference's info! lines
            # (simulator.rs:462-521, interventions.rs:145-175).
            lock = np.asarray(out.lockdown)
            mask = np.asarray(out.mask_status)
            base = steps_done - len(lock)
            mask_names = {0: "None", 1: "Only Public Transport", 2: "Everywhere"}
            for i in range(len(lock)):
                if bool(lock[i]) != prev_flags[0]:
                    print(
                        f"Lockdown is {'enabled' if lock[i] else 'lifted'} "
                        f"at hour {base + i + 1}"
                    )
                    prev_flags[0] = bool(lock[i])
                if int(mask[i]) != prev_flags[1]:
                    print(
                        f"Mask wearing status has changed: "
                        f"{mask_names[int(mask[i])]} at hour {base + i + 1}"
                    )
                    prev_flags[1] = int(mask[i])

        def callback(steps_done, out, state):
            self.recorder.record_chunk(out)
            if self.verbose:
                _log_interventions(steps_done, out)
            chunk_counter[0] += 1
            if self.profile_dir and chunk_counter[0] == 2:
                import jax

                jax.profiler.start_trace(self.profile_dir)
            elif self.profile_dir and chunk_counter[0] == 3:
                import jax

                jax.profiler.stop_trace()
            if (
                self.checkpoint_path
                and self.checkpoint_every_chunks
                and chunk_counter[0] % self.checkpoint_every_chunks == 0
            ):
                from .checkpoint import save_state

                save_state(self.checkpoint_path, state,
                           self.recorder.global_stats)
            if self.verbose:
                row = out.seirv[-1]
                now = time.perf_counter()
                print(
                    f"Completed {steps_done:>5} time steps, in: "
                    f"{now - last_print[0]:6.2f} seconds  "
                    f"S: {row[0]:,} E: {row[1]:,} I: {row[2]:,} "
                    f"R: {row[3]:,} V: {row[4]:,},   "
                    f"Memory usage: {_memory_usage_string()}"
                )
                last_print[0] = now

        self.recorder.start_chunk()
        timing: dict = {}
        self.last_timing = timing  # exposed for callers (cli_phases.json)
        if self.devices is not None:
            self.state, outputs = self._run_sharded(callback, timing)
        else:
            # Transfer/compute overlap hands the callback a state whose
            # buffers the next dispatch already donated — checkpointing
            # must read it.
            overlap = not (
                self.checkpoint_path and self.checkpoint_every_chunks
            )
            self.state, outputs = run(
                self.world, self.params, self.cfg, self.state,
                callback=callback, timing=timing, overlap=overlap,
            )
        seirv = np.asarray(outputs.seirv)
        self.recorder.truncate(seirv.shape[0])
        if self.verbose:
            print(f"Finished in {time.perf_counter() - t0:.2f}s")
            print(
                "  loop breakdown: "
                + ", ".join(f"{k} {v:.2f}s" for k, v in timing.items())
            )
        if output_dir is not None:
            t1 = time.perf_counter()
            self.recorder.dump_to_file(output_dir)
            if self.verbose:
                print(f"  artifact dump: {time.perf_counter() - t1:.2f}s")
        return seirv
