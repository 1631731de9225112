"""Host-side simulation driver.

The replacement for ``PoroElasticProblem::run()``
(``PoroelasticityFSS.h:295-415``) minus what is compiled on-chip: this layer
only builds the problem, steps time, and handles I/O (VTK, run log,
checkpoints).  One jit-compiled ``FixedStressSolver.time_step`` call does all
numerics for a Δt.

AMR (the reference refines every 5th step, ``:333-340``) is an explicitly
gated feature: uniform static meshes are the baseline configuration (SURVEY
§7 defers AMR; ``configs`` in BASELINE.json don't require it).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..config import InputData, read_input_file
from ..mesh import read_msh
from ..solvers import FixedStressSolver, build_discretization
from ..solvers.fss import State
from ..utils.checkpoint import (load_checkpoint_any, save_checkpoint,
                                save_checkpoint_orbax, wait_for_checkpoints)
from ..utils.compile_cache import enable_compile_cache
from ..utils.logging_utils import RunLogger
from ..utils.vtk_io import displacement_at_pressure_nodes, write_vtk


def _apply_sharding(disc, data: InputData):
    """'TPU / Sharding = psum|ghost|gspmd|production': wrap the built
    discretization in the requested multi-chip domain decomposition
    (parallel/); 'TPU / Devices = N' limits the mesh (0 = all visible).
    The solver runs unchanged on the wrapped discretization.  Returns
    ``(disc, n_devices)`` — 1 when it ran unsharded."""
    from ..parallel import make_device_mesh
    dmesh = make_device_mesh(data.n_devices or None)
    mode = data.sharding
    n = dmesh.devices.size
    if n < 2 and mode != "none":
        import warnings
        warnings.warn(f"'TPU / Sharding = {mode}' with a single visible "
                      "device: running unsharded", RuntimeWarning)
        return disc, 1
    if mode == "psum":
        from ..parallel import shard_discretization
        return shard_discretization(disc, dmesh), n
    if mode == "ghost":
        from ..parallel import shard_discretization_ghost
        return shard_discretization_ghost(disc, dmesh), n
    if mode == "gspmd":
        from ..parallel import shard_grid_discretization
        return shard_grid_discretization(disc, dmesh), n
    if mode == "production":
        from ..parallel.rows import shard_production_discretization
        return shard_production_discretization(disc, dmesh), n
    raise ValueError(f"unknown sharding mode {mode!r}")


class SimulationRunner:
    def __init__(self, data: InputData, mesh=None,
                 logger: Optional[RunLogger] = None, disc=None,
                 scales=None):
        """``scales``: a :class:`..models.scaling.Scales` when ``data`` is
        the nondimensionalized deck — VTK output is rescaled back to SI
        (run logs and checkpoints stay in solver units)."""
        self.scales = scales
        self.data = data
        enable_compile_cache()   # re-runs/restarts warm-start compiles
        if disc is not None:
            self.disc = disc
        elif mesh is not None:
            self.disc = build_discretization(mesh, data)
        elif data.mesh_file:
            mesh = read_msh(data.mesh_file, dim=data.dim)
            if scales is not None:      # same L as the deck rescale
                from .scaling import scale_mesh
                mesh = scale_mesh(mesh, scales)
            self.disc = build_discretization(mesh, data)
        else:
            # uniform rectilinear domain: gather/scatter-free fast path
            from ..solvers.structured import build_grid_discretization
            self.disc = build_grid_discretization(data)
        n_devices = 1
        if getattr(data, "sharding", "none") != "none":
            self.disc, n_devices = _apply_sharding(self.disc, data)
        from ..solvers.structured import mechanics_backend_name
        # what every run-log record names: the mechanics path actually
        # built and the number of devices the state is sharded over
        self.log_extra = {"mechanics_backend":
                          mechanics_backend_name(self.disc),
                          "devices": n_devices}
        self.mesh = self.disc.pressure_space.mesh
        self.solver = FixedStressSolver(self.disc, data)
        self.logger = logger or RunLogger(
            os.path.join(data.output_directory, "run_log.jsonl"))

    # -------------------------------------------------------------------
    def output(self, state: State, step: int):
        if not self.data.output_vtk:
            return
        sp = self.disc.pressure_space
        su = self.disc.displacement_space
        u_p = displacement_at_pressure_nodes(sp, su, np.asarray(state.u))
        stresses = np.asarray(self.solver.effective_stresses(state.strains))
        p = np.asarray(state.p)
        if self.scales is not None:       # back to SI for visualization
            import dataclasses as _dc
            u_p = self.scales.u(u_p)
            stresses = self.scales.stresses(stresses)
            p = self.scales.p(p)
            sp = _dc.replace(sp, node_coords=self.scales.u(sp.node_coords))
        path = os.path.join(self.data.output_directory,
                            f"solution-{step:04d}.vtk")
        write_vtk(path, sp, u_p, p, np.asarray(state.strains), stresses)

    # -------------------------------------------------------------------
    def run(self, resume_from: Optional[str] = None) -> State:
        data = self.data
        if resume_from:
            state, t, step = load_checkpoint_any(resume_from,
                                                 self.disc.dtype)
        else:
            state, t, step = self.solver.initial_state(), 0.0, 0
            self.output(state, 0)

        dt = data.time_step
        # 'TPU / Sync every = N' trades observability for throughput: the
        # host dispatches N steps before blocking, so (a) divergence is
        # detected up to N steps late, and (b) up to N full States stay
        # live on device until the flush (~11 MB each at 1.66M DOF f32) —
        # except that States no output/VTK/checkpoint will read are dropped
        # immediately (only their scalar stats are buffered).
        sync_every = max(1, getattr(data, "sync_every", 1))
        pending = []   # (step, t, stats, state|None, wall_s) awaiting sync

        def flush(last_state):
            """Sync point: read stats, log, write VTK/checkpoints, check
            for divergence — for every buffered step."""
            if not pending:
                return
            last_state.p.block_until_ready()
            for (s, ts, stats, st, wall) in pending:
                self.logger.log_step(s, ts, stats, wall, self.log_extra)
                if st is not None:
                    self.output(st, s)
                if data.checkpoint_every and s % data.checkpoint_every == 0:
                    if data.checkpoint_format == "orbax":
                        save_checkpoint_orbax(
                            os.path.join(data.checkpoint_directory,
                                         f"ckpt-{s:06d}"), st, ts, s)
                    else:
                        save_checkpoint(
                            os.path.join(data.checkpoint_directory,
                                         f"ckpt-{s:06d}.npz"), st, ts, s)
                if not np.isfinite(float(stats.pressure_error)):
                    raise FloatingPointError(
                        f"FSS residual diverged at step {s}")
                if not bool(stats.cg_converged):
                    # the reference aborts from deal.II SolverControl; we
                    # warn and keep the run alive with the partial solve
                    import warnings
                    if bool(getattr(stats, "cg_stalled", False)):
                        reason = ("stagnated (residual reduction < 2%/iter "
                                  "— often the benign f32 attainable floor)")
                    else:
                        reason = "hit its iteration cap"
                    warnings.warn(
                        f"step {s}: a linear solve {reason} before "
                        "reaching tolerance", RuntimeWarning)
            pending.clear()

        # 'TPU / Steps per dispatch = K' fuses K steps into ONE jitted
        # lax.scan dispatch (FixedStressSolver.multi_step): per-step host
        # dispatch cost vanishes; per-step stats still come out (stacked).
        # Blocks end early at steps a host consumer must read (VTK cadence,
        # checkpoints) — with 'Output VTK = true' every step is read, so K
        # effectively stays 1 there.
        steps_per_dispatch = max(1, getattr(data, "steps_per_dispatch", 1))

        def _needed(s):
            """Host consumers of step s's full State (VTK / checkpoint)."""
            return bool(data.output_vtk
                        or (data.checkpoint_every
                            and s % data.checkpoint_every == 0))

        import jax

        while t < data.t_max:
            remaining = max(1, int(np.ceil((data.t_max - t) / dt - 1e-12)))
            B = min(steps_per_dispatch, remaining)
            for j in range(1, B):     # end the block at the first read step
                if _needed(step + j):
                    B = j
                    break
            needed = _needed(step + B)
            t0 = time.perf_counter()
            if B == 1:
                state, stats = self.solver.time_step(state, dt,
                                                     want_u=needed)
                block_stats = [stats]
            else:
                state, stacked = self.solver.multi_step(state, dt,
                                                        n_steps=B,
                                                        want_u=needed)
                block_stats = [jax.tree_util.tree_map(lambda a, i=i: a[i],
                                                      stacked)
                               for i in range(B)]
            if sync_every == 1 and B == 1:
                # default: block per step so wall times are per-step exact
                state.p.block_until_ready()
            wall = (time.perf_counter() - t0) / B
            for i, stats in enumerate(block_stats):
                t += dt
                step += 1
                last = i == B - 1
                pending.append((step, t, stats,
                                state if (needed and last) else None, wall))
            if step % sync_every == 0 or (B > 1 and needed):
                flush(state)
        flush(state)
        if data.checkpoint_format == "orbax":
            wait_for_checkpoints()   # async saves must be durable on exit
        self.logger.close()
        return self.solver.materialize_u(state)


def run_from_data(data: InputData, resume_from: Optional[str] = None) -> State:
    """Full simulation from a parsed deck: applies runtime deck options
    (debug NaNs) and dispatches to the AMR or uniform-mesh driver."""
    if data.debug_nans:
        import jax
        jax.config.update("jax_debug_nans", True)
    enable_compile_cache()
    scales = None
    if data.nondimensionalize:
        from .scaling import nondimensionalize
        data, scales = nondimensionalize(data)
    if data.amr:
        from ..amr.driver import AMRSimulationRunner
        runner = AMRSimulationRunner(
            data, logger=RunLogger(
                os.path.join(data.output_directory, "run_log.jsonl")),
            scales=scales)
        state, _ = runner.run(resume_from=resume_from)
        return state
    runner = SimulationRunner(data, scales=scales)
    return runner.run(resume_from=resume_from)


def run_from_deck(path: str, resume_from: Optional[str] = None) -> State:
    """CLI entry: deck file -> full simulation (parse_command_line.h + main
    semantics)."""
    return run_from_data(read_input_file(path), resume_from=resume_from)
