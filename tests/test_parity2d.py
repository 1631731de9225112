"""Parity-resident 2D operator layout (ops/parity2d) vs the conv oracle.

The parity layout is the 2D production mechanics path (the analogue of the
3D row layout, ops/rows3d): these tests pin its layout-map exactness and its
operator equality against the conv-pair stencils, which are themselves
pinned bit-for-bit against the dense oracle (tests/test_structured.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from poroelasticity_dealii_tpu.config import read_input_file
from poroelasticity_dealii_tpu.ops import dense, parity2d, stencil
from poroelasticity_dealii_tpu.solvers.structured import (
    _coupling_element_matrix, _projection_element_matrix,
    _single_cell_spaces, build_grid_discretization)

@pytest.fixture(scope="module")
def setup():
    data = read_input_file("configs/golden_2d.data")
    n = 12
    span = np.asarray(data.domain_size[:2])
    cell_mesh, sp1, su1 = _single_cell_spaces(data, (n, n), 1, 2, span=span)
    Ke = dense.elasticity_element_matrices(
        su1, data.lame_constant, data.shear_modulus)[0]
    Ce = _coupling_element_matrix(cell_mesh, su1, sp1, data.biot_coef)
    Pe = _projection_element_matrix(cell_mesh, su1, sp1)
    return data, n, Ke, Ce, Pe


def _rand(shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                       jnp.float32)


def test_roundtrip_exact(setup):
    _, n, *_ = setup
    x = _rand(((2 * n + 1) ** 2) * 2)
    Xp = parity2d.to_parity(x, n, 2)
    assert Xp.shape == (2, 2, 2, n + 1, n + 1)
    back = parity2d.from_parity(Xp, n, 2)
    assert float(jnp.max(jnp.abs(back - x))) == 0.0


def test_padding_invariant(setup):
    """Padding entries of to_parity are zero and stay zero through the
    apply — the invariant that makes dots/axpys in parity equal flat."""
    _, n, Ke, *_ = setup
    x = _rand(((2 * n + 1) ** 2) * 2)
    ones_p = parity2d.to_parity(jnp.ones_like(x), n, 2)
    pad = 1.0 - ones_p                      # 1 at padding, 0 at real dofs
    Xp = parity2d.to_parity(x, n, 2)
    assert float(jnp.max(jnp.abs(Xp * pad))) == 0.0
    apply_p = make_jit(parity2d.make_apply_parity(Ke, n, 2))
    assert float(jnp.max(jnp.abs(apply_p(Xp) * pad))) == 0.0
    # dot equality: <x, y>_flat == <Xp, Yp>_parity
    y = _rand(x.shape, seed=1)
    Yp = parity2d.to_parity(y, n, 2)
    np.testing.assert_allclose(float(jnp.vdot(Xp, Yp)),
                               float(jnp.vdot(x, y)), rtol=1e-5)


def make_jit(f):
    return jax.jit(f)


def test_elasticity_apply_matches_conv(setup):
    _, n, Ke, *_ = setup
    g = 2 * n + 1
    x = _rand(g * g * 2)
    wg = jnp.asarray(stencil._to_kernel(Ke, 2, 2, 2), jnp.float32)
    ws = jnp.asarray(stencil._scatter_kernel(2, Ke.shape[0] // 2, 2, 2, 2),
                     jnp.float32)
    y_ref = stencil.conv_scatter(
        stencil.conv_cellwise(x, wg, 2, 2, 2, (g, g)), ws, 2, 2, 2, (n, n))
    apply_p = make_jit(parity2d.make_apply_parity(Ke, n, 2))
    y = parity2d.from_parity(apply_p(parity2d.to_parity(x, n, 2)), n, 2)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=2e-5, atol=2e-5 * float(jnp.max(
                                   jnp.abs(y_ref))))


def test_coupling_matches_conv(setup):
    _, n, _, Ce, _ = setup
    p = _rand((n + 1) ** 2)
    wg = jnp.asarray(stencil._to_kernel(Ce, 1, 1, 2), jnp.float32)
    ws = jnp.asarray(stencil._scatter_kernel(2, Ce.shape[0] // 2, 2, 2, 2),
                     jnp.float32)
    y_ref = stencil.conv_scatter(
        stencil.conv_cellwise(p, wg, 1, 2, 1, (n + 1, n + 1)),
        ws, 2, 2, 2, (n, n))
    cp = make_jit(parity2d.make_coupling_parity(Ce, n, 2))
    y = parity2d.from_parity(cp(p), n, 2)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=2e-5, atol=2e-5 * float(jnp.max(
                                   jnp.abs(y_ref))))


def test_projection_matches_stencil(setup):
    data, n, _, _, Pe = setup
    disc = build_grid_discretization(data, cells_per_axis=(n, n),
                                     multigrid="off")
    g = 2 * n + 1
    u = _rand(g * g * 2)
    y_ref = disc.stencil_projection(u)          # (C, n_pdofs)
    pp = make_jit(parity2d.make_projection_parity(Pe, n, 2))
    y = pp(parity2d.to_parity(u, n, 2))
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               rtol=2e-5, atol=2e-5 * float(jnp.max(
                                   jnp.abs(y_ref))))


@pytest.mark.parametrize("multigrid", ["off", "on"])
def test_fss_parity_backend_matches_conv(setup, multigrid):
    """End-to-end fixed-stress steps on the parity rows path (multigrid
    'on' additionally exercises the parity-resident V-cycle + rows
    Richardson solve) match the conv backend's states."""
    from poroelasticity_dealii_tpu.solvers import FixedStressSolver
    from poroelasticity_dealii_tpu.solvers.structured import \
        build_grid_discretization
    data, n, *_ = setup
    states = {}
    for backend in ("conv", "parity"):
        disc = build_grid_discretization(
            data, cells_per_axis=(n, n), multigrid=multigrid,
            elasticity_backend=backend)
        if backend == "parity":
            assert disc.row_ops is not None
            if multigrid == "on":
                assert getattr(disc, "gmg_precond_rows", None) is not None
        solver = FixedStressSolver(disc, data)
        state = solver.initial_state()
        for _ in range(3):
            state, s = solver.time_step(state, data.time_step)
            assert bool(s.cg_converged)
        states[backend] = state
    for field in ("p", "u"):
        a = np.asarray(getattr(states["conv"], field))
        b = np.asarray(getattr(states["parity"], field))
        scale = float(np.max(np.abs(a)))
        np.testing.assert_allclose(b, a, atol=5e-5 * scale, rtol=0,
                                   err_msg=field)


def test_parity_ops_kit(setup):
    """make_parity_ops: mask/diag transforms and the constrained apply."""
    data, n, Ke, Ce, Pe = setup
    disc = build_grid_discretization(data, cells_per_axis=(n, n),
                                     multigrid="off")
    ops = parity2d.make_parity_ops(Ke, n, disc.free_mask_u,
                                   disc.diag_elasticity,
                                   coupling_matrix=Ce, projection_matrix=Pe)
    x = _rand(disc.n_udofs)
    # constrained apply == flat constrained apply
    m = jnp.asarray(disc.free_mask_u, jnp.float32)
    y_flat = disc.stencil_elasticity(x * m) * m + x * (1 - m)
    y = ops.from_rows(ops.constrained_apply(ops.to_rows(x)))
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_flat),
                               rtol=2e-5, atol=2e-5 * float(jnp.max(
                                   jnp.abs(y_flat))))
    # diag padding is 1 (safe divisor), mask padding is 0
    ones_p = ops.to_rows(jnp.ones_like(x))
    pad = 1.0 - ones_p
    assert float(jnp.min(jnp.where(pad > 0, ops.diag_rows, 1.0))) == 1.0
    assert float(jnp.max(jnp.abs(ops.free_mask_rows * pad))) == 0.0
