"""Multi-chip PRODUCTION path tests (parallel/rows.py).

The production configuration (row-layout mechanics +
slice-stencil/fused-Jacobian pressure) must itself shard.
Tiers:

* sharded row-apply equality vs the index-math oracle (8 virtual devices);
* full production FSS step, 1 vs 8 shards;
* HLO audit: the mechanics CG loop's collectives are ONE 24-row halo band
  each way per apply (interface-scaled: 24*W values, independent of slab
  depth) plus scalar all-reduce dots — never a full-volume gather;
* pressure GMG V-cycle under the sharded mesh (round-2 weakness: untested).
"""

import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from poroelasticity_dealii_tpu.config import read_input_file
from poroelasticity_dealii_tpu.ops import rows3d
from poroelasticity_dealii_tpu.parallel import make_device_mesh
from poroelasticity_dealii_tpu.parallel.rows import (
    make_row_ops_sharded, shard_production_discretization, slab_layers)
from poroelasticity_dealii_tpu.solvers import FixedStressSolver
from poroelasticity_dealii_tpu.solvers.structured import \
    build_grid_discretization

DECK = "configs/consolidation_3d.data"

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

_DTYPE_BYTES = {"f32": 4, "f64": 8, "u32": 4, "s32": 4, "pred": 1}


def _collectives(hlo: str):
    out = []
    for line in hlo.splitlines():
        m = re.search(
            r"= (\w+)\[([\d,]*)\][^\n]*?"
            r"(all-gather|all-reduce|collective-permute|all-to-all|"
            r"reduce-scatter)", line)
        if m:
            dt, shape_s, kind = m.groups()
            n = 1
            for tok in shape_s.split(","):
                if tok:
                    n *= int(tok)
            out.append((kind, n * _DTYPE_BYTES.get(dt, 4)))
    return out


@pytest.fixture(scope="module")
def dmesh():
    return make_device_mesh(8)


@pytest.mark.parametrize("n", [5, 8])   # 6 zh-layers (tail-heavy) and 9
def test_sharded_rows_apply_matches_oracle(n, dmesh):
    rng = np.random.default_rng(0)
    Ke = rng.standard_normal((81, 81))
    Ke = Ke + Ke.T
    nud = (2 * n + 1) ** 3 * 3
    u = jnp.asarray(rng.standard_normal(nud), jnp.float64)
    y0 = rows3d.make_reference_apply(Ke, n, dtype=jnp.float64)(u)
    ro = make_row_ops_sharded(Ke, n, jnp.ones(nud), jnp.ones(nud), dmesh,
                              dtype=jnp.float64)
    R = ro.to_rows(u)
    Lz = slab_layers(n, 8)
    assert R.shape[0] == 8 * Lz * 24
    y1 = ro.from_rows(ro.apply_rows(R))
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y0), rtol=1e-12,
                               atol=1e-12 * float(jnp.abs(y0).max()))
    # layout roundtrip through the padded shape
    np.testing.assert_allclose(np.asarray(ro.from_rows(R)), np.asarray(u))


def _production_pair(n, dmesh):
    data = read_input_file(DECK)
    disc = build_grid_discretization(data, cells_per_axis=n,
                                     multigrid="off",
                                     elasticity_backend="rows")
    sdisc = shard_production_discretization(disc, dmesh)
    return data, disc, sdisc


def test_production_step_1_vs_8(dmesh):
    data, disc, sdisc = _production_pair(6, dmesh)
    s1 = FixedStressSolver(disc, data)
    s8 = FixedStressSolver(sdisc, data)
    st1, st8 = s1.initial_state(), s8.initial_state()
    np.testing.assert_allclose(np.asarray(st8.u), np.asarray(st1.u),
                               rtol=1e-9,
                               atol=1e-11 * float(jnp.abs(st1.u).max()))
    a1, t1 = s1.time_step(st1, data.time_step)
    a8, t8 = s8.time_step(st8, data.time_step)
    assert int(t8.pressure_iterations) > 0     # non-degenerate
    assert int(t8.mech_cg_iterations) > 0
    np.testing.assert_allclose(np.asarray(a8.p), np.asarray(a1.p),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(a8.u), np.asarray(a1.u),
                               rtol=1e-8,
                               atol=1e-10 * float(jnp.abs(a1.u).max()))


def test_mech_cg_loop_collectives_are_halo_bands(dmesh):
    """5 CG iterations through the sharded production row apply: every
    collective-permute moves exactly one 24-row band (24*W values) and
    all-reduces are scalar dots."""
    n = 8
    data, disc, sdisc = _production_pair(n, dmesh)
    ro = sdisc.row_ops
    W = rows3d._width(n)
    band = 24 * W * jnp.dtype(sdisc.dtype).itemsize

    def cg5(b):
        x = jnp.zeros_like(b)
        r = b
        p = r
        rs = jnp.vdot(r, r)

        def body(i, c):
            x, r, p, rs = c
            ap = ro.constrained_apply(p)
            alpha = rs / jnp.vdot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            rs2 = jnp.vdot(r, r)
            return x, r, r + (rs2 / rs) * p, rs2

        return jax.lax.fori_loop(0, 5, body, (x, r, p, rs))[0]

    hlo = jax.jit(cg5).lower(
        jnp.zeros_like(ro.free_mask_rows)).compile().as_text()
    cols = _collectives(hlo)
    perms = [b for k, b in cols if k == "collective-permute"]
    assert perms, "no halo ppermutes found"
    for b in perms:
        assert b <= band, (b, band)
    for k, b in cols:
        if k == "all-reduce":
            assert b <= 16, (k, b)           # scalar dots (f32/f64)
        assert k not in ("all-gather", "all-to-all"), k
    # total permute traffic is interface-scaled: far below one volume
    vol = ro.free_mask_rows.size * jnp.dtype(sdisc.dtype).itemsize
    assert sum(perms) < vol, (sum(perms), vol)


def test_pressure_gmg_under_sharded_mesh(dmesh):
    """The pressure GMG V-cycle compiles and acts correctly on a p-vector
    produced under the sharded production discretization (round-2 weak
    item: no test built GMG under a sharded mesh)."""
    from poroelasticity_dealii_tpu.solvers.multigrid import \
        build_gmg_pressure
    n = 8
    data, disc, sdisc = _production_pair(n, dmesh)
    dt = data.time_step
    mesh = sdisc.pressure_space.mesh
    lo = mesh.vertices.min(axis=0)
    hi = mesh.vertices.max(axis=0)
    precond, _ = build_gmg_pressure(data, n_fine=n, n_levels=2,
                                    dtype=sdisc.dtype, dt=dt,
                                    pressure_degree=1, lower=lo, upper=hi)
    rng = np.random.default_rng(1)
    r = jnp.asarray(rng.standard_normal(sdisc.n_pdofs), sdisc.dtype)
    # reference: same V-cycle on the unsharded array
    y_ref = jax.jit(precond)(r)
    # sharded: feed a GSPMD-sharded residual (as produced in the solver)
    from jax.sharding import NamedSharding, PartitionSpec as P
    rs = jax.device_put(r, NamedSharding(dmesh, P()))
    y_sh = jax.jit(precond)(rs)
    np.testing.assert_allclose(np.asarray(y_sh), np.asarray(y_ref),
                               rtol=1e-12)


def test_production_multi_step_sharded_matches_sequential(dmesh):
    """Fused multi-step dispatch ('TPU / Steps per dispatch') composes with
    the sharded production path: a K=3 ``multi_step`` scan over the z-slab
    row layout on 8 devices equals 3 sequential unsharded ``time_step``
    calls — the max-throughput mode and the multi-chip mode are one mode."""
    data, disc, sdisc = _production_pair(6, dmesh)
    s1 = FixedStressSolver(disc, data)
    s8 = FixedStressSolver(sdisc, data)
    dt = data.time_step
    st = s1.initial_state()
    for _ in range(3):
        st, _ = s1.time_step(st, dt)
    st = s1.materialize_u(st)
    stb, stacked = s8.multi_step(s8.initial_state(), dt, n_steps=3,
                                 want_u=True)
    # every scanned step does real inner work (non-degenerate)
    assert (np.asarray(stacked.pressure_iterations) > 0).all()
    assert (np.asarray(stacked.mech_cg_iterations) > 0).all()
    np.testing.assert_allclose(np.asarray(stb.p), np.asarray(st.p),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(stb.u), np.asarray(st.u),
                               rtol=1e-8,
                               atol=1e-10 * float(jnp.abs(st.u).max()))


def test_sharded_block_precond_step_matches_unsharded_jacobi(dmesh):
    """'Mechanics preconditioner = block' on the SHARDED production path:
    the identity-padded coefficient planes (nz_pad = n_dev * Lz) must ride
    the z-slab decomposition, and — blocks being exactly diagonal on this
    uniform deck (docs/VALIDATION.md node-block ablation) — the sharded
    block-preconditioned step must match the unsharded scalar-Jacobi one."""
    data, disc, sdisc = _production_pair(6, dmesh)
    data_b = dataclasses.replace(data, mech_precond="block")
    s1 = FixedStressSolver(disc, data)                  # jacobi, 1 device
    s8 = FixedStressSolver(sdisc, data_b)               # block, 8 devices
    a1, t1 = s1.time_step(s1.initial_state(), data.time_step)
    a8, t8 = s8.time_step(s8.initial_state(), data.time_step)
    assert int(t8.mech_cg_iterations) > 0
    # identical preconditioner => same iteration trajectory
    assert int(t8.mech_cg_iterations) == int(t1.mech_cg_iterations)
    np.testing.assert_allclose(np.asarray(a8.p), np.asarray(a1.p),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(a8.u), np.asarray(a1.u),
                               rtol=1e-8,
                               atol=1e-10 * float(jnp.abs(a1.u).max()))
