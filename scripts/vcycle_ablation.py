"""Component-attribute the 2D parity-GMG V-cycle: apply, Chebyshev sweep,
transfer pair, and the full ``precond.rows`` at 512^2, on the accelerator.

The two stages it singles out when they regress: flat conv-form transfers
with per-level layout conversions (fixed by the parity-resident transfers,
ops/parity2d.make_parity_transfers), and interleaves that materialize a
minor-dim-2 layout (fixed by ``_ileave2``/``_ileave_lanes``; find such
copies with ``jit(...).lower(...).compile().as_text()``).

Timing method: K-fold in-jit chains with the 4K/K slope, synced through a
``float(jnp.sum(...))`` device->host pull.

Usage: python scripts/vcycle_ablation.py [--cells N] [--levels L]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dataclasses  # noqa: E402

from poroelasticity_dealii_tpu.config import read_input_file  # noqa: E402
from poroelasticity_dealii_tpu.ops.parity2d import to_parity  # noqa: E402
from poroelasticity_dealii_tpu.solvers.multigrid import (  # noqa: E402
    build_gmg_elasticity, chebyshev_smooth)

CELLS = int(sys.argv[sys.argv.index("--cells") + 1]) \
    if "--cells" in sys.argv else 512
LEVELS = int(sys.argv[sys.argv.index("--levels") + 1]) \
    if "--levels" in sys.argv else 6

T0 = time.time()


def log(msg):
    print("[%7.1fs] %s" % (time.time() - T0, msg), flush=True)


def meas(name, fn, x, K=16):
    """ms per application: 4K/K chain slope, d2h-scalar synced."""
    def chain(x0, reps):
        def body(i, xx):
            y = fn(xx)
            return y * jax.lax.rsqrt(jnp.mean(jnp.square(y)) + 1e-30)
        return jax.lax.fori_loop(0, reps, body, x0)
    c1 = jax.jit(lambda x0: jnp.sum(chain(x0, K)))
    c4 = jax.jit(lambda x0: jnp.sum(chain(x0, 4 * K)))
    float(c1(x)), float(c4(x))                       # compile + warm
    b1 = b4 = 1e9
    for _ in range(4):
        t0 = time.perf_counter(); float(c1(x))
        b1 = min(b1, time.perf_counter() - t0)
        t0 = time.perf_counter(); float(c4(x))
        b4 = min(b4, time.perf_counter() - t0)
    ms = (b4 - b1) / (3 * K) * 1e3
    log("%-28s %8.3f ms   (T1=%.1f T4=%.1f ms)" % (name, ms, b1 * 1e3,
                                                   b4 * 1e3))
    return ms


def main():
    n = CELLS
    data = read_input_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs/golden_2d.data"))
    data = dataclasses.replace(
        data, dtype="float32", flow_rate=1.0, fss_tol=2e-5,
        pressure_tol=2e-5, mech_cg_tol=1e-5, mech_cg_relative=True,
        pressure_cg_tol=1e-5, projection_cg_tol=1e-5)
    pre, levels = build_gmg_elasticity(data, n_fine=n, n_levels=LEVELS,
                                       dtype=jnp.float32,
                                       parity_layout=True)
    log("gmg built: sizes=%s parity_transfers=%s"
        % ([lv.n_cells for lv in levels],
           [lv.prolong_l is not None for lv in levels]))
    rng = np.random.default_rng(0)
    rp = jax.device_put(to_parity(jnp.asarray(
        rng.standard_normal((2 * n + 1) ** 2 * 2), jnp.float32), n, 2))

    lev = levels[0]
    meas("apply_l L0", lev.apply_l, rp, 32)
    meas("cheb3 L0",
         lambda x: chebyshev_smooth(lev.apply_l, lev.inv_diag_l, x, 3,
                                    lev.lmax, lev.lmax / 8), rp)
    if lev.prolong_l is not None:
        meas("P(R(x)) L0<->L1 pair",
             lambda x: lev.prolong_l(lev.restrict_l(x)), rp)
    meas("precond.rows (full V-cycle)", pre.rows, rp, 4)


if __name__ == "__main__":
    main()
