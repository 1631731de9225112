"""Conv stencil vs 3D row layout for the mechanics path, on the GPU.

The measurement behind the 3D ``Elasticity backend = auto`` choice.  On
bench.py's 3D problem (40^3 cells, float32, bench tolerances) it times,
for each backend:

* the constrained elasticity apply (in-jit chain slope, bench._time_chained);
* one mechanics CG iteration (Jacobi-CG at tol 0: slope between a 50- and
  a 250-iteration solve, i.e. including the per-iteration loop overhead);
* the evolving-load time step (bench.measure, chained), in the order
  conv, rows, rows, conv.

Then the smoother-precision check: the pressure-GMG smoothers run at the
default matmul precision in float32 (TF32 on the GPU); the same steps of
the 3D and 2D float32 problems are re-run with HIGHEST and the per-step
iteration counts compared.

Usage: python scripts/mech_backend_ab.py [--cells N] [--cells-2d N]
Prints the record as one JSON object on the last line of stdout.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def _arg(name, default):
    return int(sys.argv[sys.argv.index(name) + 1]) if name in sys.argv \
        else default


CELLS = _arg("--cells", bench.CELLS_PER_AXIS)
CELLS_2D = _arg("--cells-2d", bench.CELLS_2D)


def cg_iteration_ms(apply, apply_iter, b, x0, diag):
    import jax
    from poroelasticity_dealii_tpu.solvers.cg import cg_solve

    def best_s(k):
        f = jax.jit(lambda bb: cg_solve(apply, bb, x0, diag, tol=0.0,
                                        max_iter=k, apply_iter=apply_iter).x)
        jax.block_until_ready(f(b))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(f(b))
            best = min(best, time.perf_counter() - t0)
        return best
    return (best_s(250) - best_s(50)) / 200 * 1e3


def op_times(disc):
    import jax
    import jax.numpy as jnp
    import numpy as np
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(disc.n_udofs), disc.dtype)
    ro = disc.row_ops
    if ro is None:
        apply, x = jax.jit(disc.elasticity_constrained), u
        it = cg_iteration_ms(disc.elasticity_constrained, None, u,
                             jnp.zeros_like(u), disc.diag_elasticity)
    else:
        R = ro.to_rows(u)
        apply, x = jax.jit(ro.constrained_apply), R
        m = ro.free_mask_rows
        it = cg_iteration_ms(ro.constrained_apply, ro.free_apply, R * m,
                             jnp.zeros_like(R), ro.diag_rows)
    return {"apply_ms": bench._time_chained(apply, x),
            "cg_iteration_ms": it}


def step_counts(data, disc, n_steps=5):
    """Per-step (pressure iterations, pressure CG, mechanics CG) of the
    plain deck regime, from a fresh solver."""
    from poroelasticity_dealii_tpu.solvers import FixedStressSolver
    solver = FixedStressSolver(disc, data)
    st = solver.initial_state()
    out = []
    for _ in range(n_steps):
        st, s = solver.time_step(st, data.time_step, want_u=False)
        out.append([int(s.pressure_iterations),
                    int(s.pressure_cg_iterations),
                    int(s.mech_cg_iterations)])
    return out


def smoother_precision_check(data, disc):
    """Iteration counts with the default smoother precision, then with
    the pressure-GMG smoothers forced to HIGHEST."""
    from jax import lax

    from poroelasticity_dealii_tpu.solvers import multigrid
    default = step_counts(data, disc)
    orig = multigrid.build_gmg_pressure

    def highest(*a, **kw):
        kw["smoother_precision"] = lax.Precision.HIGHEST
        return orig(*a, **kw)
    multigrid.build_gmg_pressure = highest
    try:
        full = step_counts(data, disc)
    finally:
        multigrid.build_gmg_pressure = orig
    return {"default": default, "highest": full, "equal": default == full}


def main():
    import jax
    rec = {"device": None, "cells": CELLS}
    discs = {}
    for backend in ("conv", "rows"):
        t0 = time.perf_counter()
        data, disc, solver, _ = bench.build(cells=CELLS,
                                            elasticity_backend=backend)
        rec["device"] = rec["device"] or bench.device_record()
        discs[backend] = (data, disc, solver)
        rec[backend] = {"setup_s": time.perf_counter() - t0,
                        "path": bench.mechanics_backend_name(disc)}
        rec[backend].update(op_times(disc))
        print(f"# {backend}: {rec[backend]}", file=sys.stderr, flush=True)
    for backend in ("conv", "rows", "rows", "conv"):
        data, disc, solver = discs[backend]
        res = bench.measure(data, solver, n_steps=3, bc_rate=bench.BC_RATE,
                            tag=f"{backend} evolving ", chain_reps=3)
        r = rec[backend]
        r.setdefault("evolving_chained_ms", []).append(res.chained * 1e3)
        r.setdefault("evolving_chained_reps_ms", []).append(
            [c * 1e3 for c in res.chained_reps])
        r.setdefault("mech_cg_per_step", []).append(list(res.mech_cg))
    data, disc, _ = discs["rows"]
    del discs
    rec["smoother_precision_3d"] = smoother_precision_check(data, disc)
    data2, disc2, _, _ = bench.build_2d(cells=CELLS_2D)
    rec["smoother_precision_2d"] = smoother_precision_check(data2, disc2)
    rec["peak_bytes_in_use"] = (jax.devices()[0].memory_stats()
                                or {}).get("peak_bytes_in_use")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
