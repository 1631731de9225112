"""Resident-layout operators vs their plain reference, at any size.

The production mechanics path runs the elasticity apply and the two
coupling right-hand sides in a resident layout (3D rows, ops/rows3d.py;
2D parity, ops/parity2d.py).  Each :class:`Case` pairs such an operator
with the conv/stencil operator of the same discretization that computes
the same thing (ops/stencil.py), on one random input.  The test suite runs
the cases at small sizes on the CPU and, marked ``gpu``, at production
sizes on the card; ``chip_smoke.py`` runs and times them on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

# Max-norm relative error allowed between the two forms.  Both sum the
# same products (81-term element dots, then at most 8 overlapping cell
# contributions per node) in different orders, so the gap is a few
# hundred ulps of the result's scale at worst: float32 (ulp 6e-8) -> 1e-5,
# float64 (ulp 1.1e-16) -> 1e-12.
TOLERANCE = {"float32": 1e-5, "float64": 1e-12}


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    fast: Callable        # jitted resident-layout operator
    x_fast: jax.Array
    ref: Callable         # jitted conv/stencil reference
    x_ref: jax.Array
    to_ref: Callable      # fast output -> reference layout

    def rel_error(self) -> float:
        got = self.to_ref(self.fast(self.x_fast))
        want = self.ref(self.x_ref)
        return float(jnp.max(jnp.abs(got - want)) / jnp.max(jnp.abs(want)))


def operator_cases(data, n: int, dtype: str, seed: int = 0) -> list:
    """Cases for the deck ``data`` (3D -> rows, 2D -> parity) on ``n``
    cells per axis in ``dtype``."""
    from ..solvers.structured import build_grid_discretization
    backend = "rows" if data.dim == 3 else "parity"
    disc = build_grid_discretization(data, cells_per_axis=n,
                                     multigrid="off", dtype=dtype,
                                     elasticity_backend=backend)
    ro = disc.row_ops
    rng = np.random.default_rng(seed)
    u = jax.device_put(rng.standard_normal(disc.n_udofs).astype(dtype))
    p = jax.device_put(rng.standard_normal(disc.n_pdofs).astype(dtype))
    u_res = ro.to_rows(u)
    biot = data.biot_coef
    return [
        Case("elasticity constrained apply", jax.jit(ro.constrained_apply),
             u_res, jax.jit(disc.elasticity_constrained), u, ro.from_rows),
        Case("coupling rhs", jax.jit(ro.coupling_rows), p,
             jax.jit(lambda x: disc.coupling_rhs(x, biot)), p,
             ro.from_rows),
        Case("strain projection rhs", jax.jit(ro.projection_rows), u_res,
             jax.jit(disc.strain_projection_rhs), u, lambda y: y),
    ]
