"""3D comp-major row layout (ops/rows3d.py) vs the conv-stencil path and
independent numpy/loop oracles.

Several cases also run the z-slab form of the row apply (``nz`` cell
layers per slab, runtime count of real layers ``nv``) that the sharded
production path composes across devices (parallel/rows.py); here the
slabs are summed on one device, so the slab bookkeeping is checked
without collectives.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from poroelasticity_dealii_tpu.config import read_input_file
from poroelasticity_dealii_tpu.ops import rows3d
from poroelasticity_dealii_tpu.ops.rows3d import from_rows, to_rows
from poroelasticity_dealii_tpu.ops.shape import node_lattice
from poroelasticity_dealii_tpu.solvers.structured import \
    build_grid_discretization

DECK = "configs/consolidation_3d.data"


# ------------------------------------------------- comp-major kernel -----

def _cm_setup(n):
    from poroelasticity_dealii_tpu.mesh.generator import hyper_rectangle
    from poroelasticity_dealii_tpu.mesh.qk import build_fe_space
    from poroelasticity_dealii_tpu.ops import dense
    data = read_input_file("configs/consolidation_3d.data")
    h = [data.domain_size[d] / n for d in range(3)]
    su1 = build_fe_space(hyper_rectangle(h, cells_per_axis=1), 2)
    Ke = dense.elasticity_element_matrices(su1, data.lame_constant,
                                           data.shear_modulus)[0]
    disc = build_grid_discretization(data, cells_per_axis=n,
                                     multigrid="off")
    return Ke, disc


def _slab_sum_apply(Ke, n, nz, R, dtype):
    """The z-slab decomposition of the row apply on ONE device: slab k
    owns cell layers [k*nz, (k+1)*nz), reads its nz+1 z-half layers
    (zero-padded past the grid), masks layers past the real count, and
    its nz+1 output layers are summed back — parallel/rows.py's dataflow
    with the halo ppermutes replaced by slicing."""
    slab = rows3d.make_apply_rows(Ke, n, dtype, nz=nz)
    n_slabs = -(-n // nz)
    rows = (n_slabs * nz + 1) * 24
    Rp = jnp.pad(R, ((0, rows - R.shape[0]), (0, 0)))
    out = jnp.zeros_like(Rp)
    for k in range(n_slabs):
        lo = k * nz * 24
        nv = jnp.int32(min(nz, n - k * nz))
        y = slab(Rp[lo:lo + (nz + 1) * 24], nv)
        out = out.at[lo:lo + (nz + 1) * 24].add(y)
    return out[:R.shape[0]]


def _row_ops(Ke, disc, n, dtype):
    return rows3d.make_row_ops(Ke, n, np.asarray(disc.free_mask_u),
                               np.asarray(disc.diag_elasticity), dtype)


def test_comp_major_rows_roundtrip():
    n = 3
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((2 * n + 1) ** 3 * 3))
    np.testing.assert_allclose(np.asarray(from_rows(to_rows(u, n), n)),
                               np.asarray(u))


def test_comp_major_reference_matches_conv():
    n = 4
    Ke, disc = _cm_setup(n)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(disc.n_udofs), jnp.float64)
    y_ref = np.asarray(rows3d.make_reference_apply(Ke, n, jnp.float64)(u))
    y_conv = np.asarray(disc.elasticity(jnp.asarray(u, disc.dtype)))
    np.testing.assert_allclose(y_ref, y_conv,
                               atol=1e-12 * np.abs(y_conv).max())


@pytest.mark.parametrize("n,nz", [(4, 2), (6, 4)])  # incl. tail slab
def test_comp_major_pallas_interpret_matches_conv(n, nz):
    """f64: the vectorized row apply and its z-slab form (depth nz) both
    reproduce the conv stencil to rounding."""
    Ke, disc = _cm_setup(n)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(disc.n_udofs), jnp.float64)
    y_conv = np.asarray(disc.elasticity(u))
    R = to_rows(u, n)
    full = rows3d.make_apply_rows(Ke, n, jnp.float64)(R)
    slabs = _slab_sum_apply(Ke, n, nz, R, jnp.float64)
    scale = np.abs(y_conv).max()
    for Y in (full, slabs):
        np.testing.assert_allclose(np.asarray(from_rows(Y, n)), y_conv,
                                   atol=1e-12 * scale)


@pytest.mark.parametrize("n,nz", [(4, 2), (6, 4), (5, 2), (4, 4)])
def test_comp_major_v2_rows_matches_conv(n, nz):
    """f32 rows -> rows apply == conv, the padding invariant holds (zero
    in -> zero out, required for persistent-row CG), and the z-slab form
    of depth nz agrees."""
    Ke, disc = _cm_setup(n)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(disc.n_udofs), jnp.float32)
    R = to_rows(u, n)
    Y = jax.jit(rows3d.make_apply_rows(Ke, n, jnp.float32))(R)
    y = np.asarray(from_rows(Y, n))
    y_conv = np.asarray(disc.elasticity(jnp.asarray(u, disc.dtype)))
    err = np.abs(y - y_conv).max() / np.abs(y_conv).max()
    assert err < 1e-5, err
    real = (n + 1) * (n + 1)
    assert np.abs(np.asarray(Y[:, real:])).max() == 0.0
    Ys = _slab_sum_apply(Ke, n, nz, R, jnp.float32)
    err = np.abs(np.asarray(Ys - Y)).max() / np.abs(np.asarray(Y)).max()
    assert err < 1e-6, err


def test_row_ops_solver_path_matches_conv():
    """Full FSS step with the row-layout mechanics CG == the conv-stencil
    path ('pallas' is the older deck name of the rows backend)."""
    import dataclasses

    from poroelasticity_dealii_tpu.solvers import FixedStressSolver
    data = read_input_file(DECK)
    data = dataclasses.replace(
        data, dtype="float32", fss_tol=1e-4, pressure_tol=1e-4,
        mech_cg_tol=1e-5, mech_cg_relative=True,
        pressure_cg_tol=1e-5, projection_cg_tol=1e-5)
    n = 4
    disc_c = build_grid_discretization(data, cells_per_axis=n,
                                       multigrid="off",
                                       elasticity_backend="conv")
    disc_p = build_grid_discretization(data, cells_per_axis=n,
                                       multigrid="off",
                                       elasticity_backend="pallas")
    assert disc_p.row_ops is not None and disc_c.row_ops is None
    sc = FixedStressSolver(disc_c, data)
    sp = FixedStressSolver(disc_p, data)
    # cold mechanics solve (zero warm start): the row-layout CG must
    # actually iterate through the kernel and agree with the conv CG
    p0 = jnp.full((disc_c.n_pdofs,), data.p_init, disc_c.dtype)
    u0 = jnp.zeros((disc_c.n_udofs,), disc_c.dtype)
    uc, it_c, _, _, _, _ = sc._mechanics_solve(p0, u0)
    up, it_p, _, _, up_rows, _ = sp._mechanics_solve(p0, u0)
    # rows path keeps u resident in the row layout (u=None); the flat
    # vector materializes only at State boundaries
    assert up is None
    up = disc_p.row_ops.from_rows(up_rows)
    assert int(it_p) > 0
    np.testing.assert_allclose(np.asarray(up), np.asarray(uc),
                               atol=2e-5 * np.abs(np.asarray(uc)).max())
    st_c, _ = sc.time_step(sc.initial_state(), data.time_step)
    st_p, stats_p = sp.time_step(sp.initial_state(), data.time_step)
    scale = np.abs(np.asarray(st_c.u)).max()
    np.testing.assert_allclose(np.asarray(st_p.u), np.asarray(st_c.u),
                               atol=2e-5 * scale)
    np.testing.assert_allclose(np.asarray(st_p.p), np.asarray(st_c.p),
                               rtol=2e-5)


def test_coupling_rows_matches_flat_coupling():
    """make_coupling_rows assembles exactly to_rows(coupling_rhs(p)) — the
    direct-in-rows mechanics RHS path (f64, several grid sizes)."""
    import dataclasses

    from poroelasticity_dealii_tpu.ops.rows3d import to_rows
    data = read_input_file(DECK)
    for n in (2, 3, 5):
        disc = build_grid_discretization(data, cells_per_axis=n,
                                         multigrid="off",
                                         elasticity_backend="rows")
        ro = disc.row_ops
        assert ro.coupling_rows is not None
        rng = np.random.default_rng(n)
        p = jnp.asarray(rng.standard_normal(disc.n_pdofs), disc.dtype)
        ref = to_rows(disc.coupling_rhs(p, data.biot_coef), n)
        got = ro.coupling_rows(p)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-10,
                                   atol=1e-12 * float(jnp.abs(ref).max()))


def test_projection_rows_matches_flat_projection():
    """make_projection_rows assembles exactly strain_projection_rhs(u) from
    the row layout — the rows-resident strain-projection path (f64,
    several grid sizes)."""
    from poroelasticity_dealii_tpu.ops.rows3d import to_rows
    data = read_input_file(DECK)
    for n in (2, 3, 5):
        disc = build_grid_discretization(data, cells_per_axis=n,
                                         multigrid="off",
                                         elasticity_backend="rows")
        ro = disc.row_ops
        assert ro.projection_rows is not None
        rng = np.random.default_rng(n)
        u = jnp.asarray(rng.standard_normal(disc.n_udofs), disc.dtype)
        ref = disc.strain_projection_rhs(u)          # (C, n_pdofs) conv
        got = ro.projection_rows(to_rows(u, n))
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-10,
                                   atol=1e-12 * float(jnp.abs(ref).max()))


@pytest.mark.parametrize("n,nz", [(4, 2), (5, 2), (4, 4), (6, 3)])
def test_fused_constrained_apply_matches_composed(n, nz):
    """ElasticityRowOps.constrained_apply == the flat constrained operator
    ``m*A(mx)+(1-m)x`` of the conv discretization, including
    boundary-constrained rows and phantom lanes; the z-slab apply of
    depth nz composes to the same constrained apply."""
    Ke, disc = _cm_setup(n)
    ro = _row_ops(Ke, disc, n, jnp.float64)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(disc.n_udofs), jnp.float64)
    R = to_rows(u, n)
    ref = np.asarray(disc.elasticity_constrained(u))
    got = np.asarray(from_rows(ro.constrained_apply(R), n))
    np.testing.assert_allclose(got, ref, atol=1e-12 * np.abs(ref).max())
    m = ro.free_mask_rows
    slab = _slab_sum_apply(Ke, n, nz, R * m, jnp.float64) * m \
        + R * (1.0 - m)
    np.testing.assert_allclose(np.asarray(from_rows(slab, n)), ref,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("n,nz", [(4, 2), (5, 2), (6, 3)])
def test_free_apply_matches_constrained_on_free_subspace(n, nz):
    """free_apply (no input mask) == constrained_apply on vectors that are
    zero at constrained rows/padding — the invariant cg_solve's
    per-iteration directions satisfy — for the single-chip apply and the
    z-slab form of depth nz."""
    Ke, disc = _cm_setup(n)
    ro = _row_ops(Ke, disc, n, jnp.float32)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal(disc.n_udofs), jnp.float32)
    m = ro.free_mask_rows
    p = to_rows(u, n) * m                       # free-subspace vector
    got = np.asarray(jax.jit(ro.free_apply)(p))
    ref = np.asarray(jax.jit(ro.constrained_apply)(p))
    assert np.array_equal(got, ref), np.abs(got - ref).max()
    slab_free = np.asarray(_slab_sum_apply(Ke, n, nz, p, jnp.float32) * m)
    err = np.abs(slab_free - ref).max() / np.abs(ref).max()
    assert err < 1e-6, err


def test_cg_apply_iter_invariant():
    """cg_solve(apply_iter=free_apply) returns the identical solve as the
    plain constrained-apply CG when b/x0 carry the Dirichlet values (the
    free-subspace invariant holds for every direction vector)."""
    from poroelasticity_dealii_tpu.solvers.cg import cg_solve
    n = 4
    Ke, disc = _cm_setup(n)
    ro = _row_ops(Ke, disc, n, jnp.float32)
    rng = np.random.default_rng(2)
    m = ro.free_mask_rows
    g = to_rows(jnp.asarray(
        rng.standard_normal(disc.n_udofs), jnp.float32), n)
    b = m * to_rows(jnp.asarray(
        rng.standard_normal(disc.n_udofs), jnp.float32), n) + (1.0 - m) * g
    x0 = (1.0 - m) * g
    tol = 1e-5 * float(jnp.linalg.norm(b))
    ref = cg_solve(ro.constrained_apply, b, x0, ro.diag_rows, tol=tol,
                   max_iter=200)
    got = cg_solve(ro.constrained_apply, b, x0, ro.diag_rows, tol=tol,
                   max_iter=200, apply_iter=ro.free_apply)
    assert bool(ref.converged) and bool(got.converged)
    assert int(ref.iterations) == int(got.iterations)
    assert np.array_equal(np.asarray(ref.x), np.asarray(got.x))


def test_deferred_u_rows_residency():
    """want_u=False keeps u in the row layout across steps (State.u is
    None — no per-step from_rows transpose) and the deferred chain is
    bitwise identical to the eager one; materialize_u recovers the flat
    vector, and the bc-ramp superposition warm start works on the
    rows-only state (round-3 'finish the row-layout residency' item)."""
    import dataclasses

    from poroelasticity_dealii_tpu.solvers import FixedStressSolver
    data = read_input_file(DECK)
    data = dataclasses.replace(
        data, dtype="float32", fss_tol=1e-4, pressure_tol=1e-4,
        mech_cg_tol=1e-5, mech_cg_relative=True,
        pressure_cg_tol=1e-5, projection_cg_tol=1e-5)
    disc = build_grid_discretization(data, cells_per_axis=4,
                                     multigrid="off",
                                     elasticity_backend="rows")
    solver = FixedStressSolver(disc, data)
    s0 = solver.initial_state()
    dt = data.time_step
    sA, _ = solver.time_step(s0, dt)                    # eager (default)
    sB, _ = solver.time_step(s0, dt, want_u=False)      # deferred
    assert sB.u is None
    np.testing.assert_array_equal(np.asarray(sB.p), np.asarray(sA.p))
    np.testing.assert_array_equal(
        np.asarray(solver.materialize_u(sB).u), np.asarray(sA.u))
    # the deferred state feeds the next step unchanged (structure is
    # normalized in the host wrapper, so no extra compile variants)
    sC, _ = solver.time_step(sB, dt, want_u=False)
    sD, _ = solver.time_step(sA, dt, want_u=False)
    np.testing.assert_array_equal(np.asarray(sC.p), np.asarray(sD.p))
    np.testing.assert_array_equal(
        np.asarray(solver.materialize_u(sC).u),
        np.asarray(solver.materialize_u(sD).u))
    # linear-superposition bc ramp on a u=None state
    sE, _ = solver.time_step(sB, dt, bc_scale=1.1, bc_scale_prev=1.0,
                             want_u=False)
    sF, _ = solver.time_step(sA, dt, bc_scale=1.1, bc_scale_prev=1.0)
    np.testing.assert_array_equal(np.asarray(sE.p), np.asarray(sF.p))
    np.testing.assert_array_equal(
        np.asarray(solver.materialize_u(sE).u), np.asarray(sF.u))
    # materialize_u is a no-op on an eager state
    assert solver.materialize_u(sA) is sA


# ------------------------------------------- node-block Jacobi precond ----

def test_elasticity_node_blocks_diag_matches_diagonal():
    """The (c, c) entries of the per-node 3x3 blocks must reproduce the
    assembled (Dirichlet-masked) operator diagonal exactly."""
    from poroelasticity_dealii_tpu.ops.rows3d import \
        elasticity_node_blocks
    n = 4
    Ke, disc = _cm_setup(n)
    B = elasticity_node_blocks(Ke, n, np.asarray(disc.free_mask_u))
    diag = np.einsum("ncc->nc", B).reshape(-1)
    np.testing.assert_allclose(diag, np.asarray(disc.diag_elasticity),
                               rtol=1e-12)


def test_block_precond_matches_dense_blocks():
    """rows-layout block apply == per-node 3x3 matvec on the flat layout,
    and zeros at constrained/padding positions stay zero (the
    free-subspace invariant the v4 apply_iter relies on)."""
    from poroelasticity_dealii_tpu.ops.rows3d import (
        elasticity_node_blocks, from_rows, make_block_precond, to_rows)
    n = 3
    Ke, disc = _cm_setup(n)
    free = np.asarray(disc.free_mask_u)
    B = elasticity_node_blocks(Ke, n, free)
    Binv = np.linalg.inv(B)
    bp = make_block_precond(Binv, n, dtype=jnp.float64)
    rng = np.random.default_rng(7)
    r = rng.standard_normal(disc.n_udofs) * free       # free subspace
    z_rows = bp(to_rows(jnp.asarray(r), n))
    z = np.asarray(from_rows(z_rows, n))
    z_ref = np.einsum("ncd,nd->nc", Binv, r.reshape(-1, 3)).reshape(-1)
    np.testing.assert_allclose(z, z_ref, rtol=1e-12, atol=1e-14)
    assert np.all(z[free == 0] == 0.0)
    # padded plane count (the sharded rows shape): same answer
    bp_pad = make_block_precond(Binv, n, dtype=jnp.float64, nz_pad=n + 3)
    R = to_rows(jnp.asarray(r), n)
    Rp = jnp.pad(R, ((0, 2 * 24), (0, 0)))
    zp = np.asarray(from_rows(bp_pad(Rp)[:(n + 1) * 24], n))
    np.testing.assert_allclose(zp, z_ref, rtol=1e-12, atol=1e-14)


def test_mech_solve_block_precond_matches_jacobi():
    """Block-preconditioned rows CG converges to the same solution as the
    scalar-Jacobi one, in no more iterations (measured lever: fewer)."""
    import dataclasses

    from poroelasticity_dealii_tpu.solvers import FixedStressSolver
    data = read_input_file(DECK)
    data = dataclasses.replace(
        data, dtype="float32", mech_cg_tol=1e-6, mech_cg_relative=True)
    n = 4
    sols = {}
    for pc in ("jacobi", "block"):
        d = dataclasses.replace(data, mech_precond=pc)
        disc = build_grid_discretization(d, cells_per_axis=n,
                                         multigrid="off",
                                         elasticity_backend="rows")
        s = FixedStressSolver(disc, d)
        p0 = jnp.full((disc.n_pdofs,), d.p_init, disc.dtype)
        u0 = jnp.zeros((disc.n_udofs,), disc.dtype)
        _, it, ok, _, u_rows, _ = s._mechanics_solve(p0, u0)
        assert bool(ok)
        sols[pc] = (int(it), np.asarray(disc.row_ops.from_rows(u_rows)))
    it_j, u_j = sols["jacobi"]
    it_b, u_b = sols["block"]
    scale = np.abs(u_j).max()
    np.testing.assert_allclose(u_b, u_j, atol=5e-5 * scale)
    assert it_b <= it_j, (it_b, it_j)


def test_to_rows_np_matches_device():
    """Host-side setup-constant layout (round-5 devconst fix) is bit-for-bit
    the device to_rows it replaced, for both fill conventions."""
    import numpy as np
    import jax.numpy as jnp
    from poroelasticity_dealii_tpu.ops.rows3d import (
        to_rows, to_rows_np, _width)
    n = 3
    g = 2 * n + 1
    rng = np.random.default_rng(5)
    v = rng.standard_normal(g ** 3 * 3)
    dev = np.asarray(to_rows(jnp.asarray(v), n))
    host = to_rows_np(v, n, fill=0.0)
    np.testing.assert_allclose(host, dev, rtol=0, atol=0)
    # fill=1.0 == t(diag) + (1 - t(ones)) (the diag-rows convention)
    ones = np.asarray(to_rows(jnp.ones(g ** 3 * 3), n))
    dev_diag = dev + (1.0 - ones)
    np.testing.assert_allclose(to_rows_np(v, n, fill=1.0), dev_diag,
                               rtol=0, atol=0)
    assert to_rows_np(v, n).shape == ((n + 1) * 24, _width(n))


def _coupling_oracle(Ce, p, n):
    """Cell-loop numpy assembly of the Q1 -> Q2 coupling RHS (flat)."""
    g, g1 = 2 * n + 1, n + 1
    P = np.asarray(p, np.float64).reshape(g1, g1, g1)
    lat_p, lat_u = node_lattice(1, 3), node_lattice(2, 3)
    out = np.zeros((g, g, g, 3))
    for cz in range(n):
        for cy in range(n):
            for cx in range(n):
                pl = np.array([P[cz + oz, cy + oy, cx + ox]
                               for (ox, oy, oz) in lat_p])
                ye = (Ce @ pl).reshape(27, 3)
                for a, (ox, oy, oz) in enumerate(lat_u):
                    out[2 * cz + oz, 2 * cy + oy, 2 * cx + ox] += ye[a]
    return out.reshape(-1)


def _projection_oracle(Pe, u, n):
    """Cell-loop numpy assembly of the Q2 -> Q1 strain-projection RHS,
    (C, n_pdofs)."""
    g1 = n + 1
    C = Pe.shape[0] // 8
    U = np.asarray(u, np.float64).reshape(2 * n + 1, 2 * n + 1,
                                          2 * n + 1, 3)
    lat_p, lat_u = node_lattice(1, 3), node_lattice(2, 3)
    out = np.zeros((C, g1, g1, g1))
    for cz in range(n):
        for cy in range(n):
            for cx in range(n):
                ul = np.concatenate([U[2 * cz + oz, 2 * cy + oy, 2 * cx + ox]
                                     for (ox, oy, oz) in lat_u])
                ye = (Pe @ ul).reshape(8, C)
                for i, (ox, oy, oz) in enumerate(lat_p):
                    out[:, cz + oz, cy + oy, cx + ox] += ye[i]
    return out.reshape(C, -1)


@pytest.mark.parametrize("n", [5, 9])
def test_coupling_rows_pallas_matches_jnp_oracle(n):
    """make_coupling_rows (Q1 p -> u rows) == an independent cell-loop
    numpy assembly, for a random (81, 8) element matrix (f32)."""
    rng = np.random.default_rng(0)
    Ce = rng.standard_normal((81, 8))
    p = rng.standard_normal((n + 1) ** 3)
    got = rows3d.make_coupling_rows(Ce, n, jnp.float32)(
        jnp.asarray(p, jnp.float32))
    ref = to_rows(jnp.asarray(_coupling_oracle(Ce, p, n)), n)
    err = (np.abs(np.asarray(got) - np.asarray(ref)).max()
           / np.abs(np.asarray(ref)).max())
    assert err < 1e-6, err


@pytest.mark.parametrize("n,pad", [(5, 2), (5, 3), (9, 4)])
def test_projection_rows_pallas_matches_jnp_oracle(n, pad):
    """make_projection_rows (u rows -> Q1 VOIGT planes) == an independent
    cell-loop numpy assembly, for a random (48, 81) element matrix (f32);
    ``pad`` extra zero z-half layers (the sharded row shape) feed straight
    in."""
    rng = np.random.default_rng(1)
    Pe = rng.standard_normal((48, 81))
    u = rng.standard_normal((2 * n + 1) ** 3 * 3)
    R = to_rows(jnp.asarray(u, jnp.float32), n)
    R = jnp.pad(R, ((0, pad * 24), (0, 0)))
    got = np.asarray(rows3d.make_projection_rows(Pe, n, jnp.float32)(R))
    ref = _projection_oracle(Pe, u, n)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < 1e-6, err
