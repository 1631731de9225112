"""Structured fast path vs generic path: identical operators up to the node
renumbering, identical physics end-to-end."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from poroelasticity_dealii_tpu.config import read_input_file
from poroelasticity_dealii_tpu.mesh import hyper_rectangle
from poroelasticity_dealii_tpu.solvers import (FixedStressSolver,
                                               build_discretization)
from poroelasticity_dealii_tpu.solvers.structured import \
    build_grid_discretization

GOLDEN = "configs/golden_2d.data"


def _perm(space_from, space_to):
    """index array P with coords_to[P[i]] == coords_from[i]."""
    scale = max(1.0, np.abs(space_to.node_coords).max())
    key = lambda c: tuple(np.round(c / scale, 10))  # noqa: E731
    lookup = {key(c): i for i, c in enumerate(space_to.node_coords)}
    return np.array([lookup[key(c)] for c in space_from.node_coords])


def _setup(dim):
    data = read_input_file(GOLDEN)
    if dim == 3:
        data = dataclasses.replace(
            data, dim=3, domain_size=(6.0, 6.0, 6.0),
            displacement_boundary_labels=(0, 1, 2, 3, 4, 5),
            displacement_boundary_components=(0, 0, 1, 1, 2, 2),
            displacement_boundary_values=(0, -1e-5, 0, -1e-5, 0, -1e-5),
            initial_refinement_level=1)
    else:
        data = dataclasses.replace(data, initial_refinement_level=3)
    n = 2 ** data.initial_refinement_level
    mesh = hyper_rectangle(data.domain_size[:dim],
                           data.initial_refinement_level)
    disc_g = build_discretization(mesh, data)
    disc_s = build_grid_discretization(data, cells_per_axis=n)
    return data, disc_g, disc_s


@pytest.mark.parametrize("dim", [2, 3])
def test_operators_match_generic(dim):
    data, dg, ds = _setup(dim)
    perm_p = _perm(ds.pressure_space, dg.pressure_space)
    perm_u = _perm(ds.displacement_space, dg.displacement_space)
    rng = np.random.default_rng(0)

    # scalar fields: value at a node is a function of its coordinates
    f = rng.standard_normal(ds.n_pdofs)
    p_s = jnp.asarray(f)
    p_g = jnp.asarray(np.empty_like(f))
    p_g = jnp.asarray(np.zeros(dg.n_pdofs).copy())
    tmp = np.zeros(dg.n_pdofs)
    tmp[perm_p] = f
    p_g = jnp.asarray(tmp)

    np.testing.assert_allclose(np.asarray(ds.mass(p_s)),
                               np.asarray(dg.mass(p_g))[perm_p], rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(np.asarray(ds.laplace(p_s)),
                               np.asarray(dg.laplace(p_g))[perm_p],
                               rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ds.diag_mass),
                               np.asarray(dg.diag_mass)[perm_p], rtol=1e-11)
    np.testing.assert_allclose(np.asarray(ds.diag_laplace),
                               np.asarray(dg.diag_laplace)[perm_p],
                               rtol=1e-11)

    # vector field on displacement dofs
    fu = rng.standard_normal(ds.n_udofs)
    u_s = jnp.asarray(fu)
    tmp = np.zeros(dg.n_udofs)
    fu2 = fu.reshape(-1, dim)
    tmp2 = tmp.reshape(-1, dim)
    tmp2[perm_u] = fu2
    u_g = jnp.asarray(tmp2.reshape(-1))
    perm_ud = (perm_u[:, None] * dim + np.arange(dim)).reshape(-1)

    ref = np.asarray(dg.elasticity(u_g))[perm_ud]
    got = np.asarray(ds.elasticity(u_s))
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=1e-8 * np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(ds.diag_elasticity),
                               np.asarray(dg.diag_elasticity)[perm_ud],
                               rtol=1e-11)
    np.testing.assert_allclose(
        np.asarray(ds.coupling_rhs(p_s, data.biot_coef)),
        np.asarray(dg.coupling_rhs(p_g, data.biot_coef))[perm_ud],
        rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(
        np.asarray(ds.strain_projection_rhs(u_s)),
        np.asarray(dg.strain_projection_rhs(u_g))[:, perm_p],
        rtol=1e-10, atol=1e-12)
    # boundary machinery permutes identically
    np.testing.assert_allclose(np.asarray(ds.free_mask_u),
                               np.asarray(dg.free_mask_u)[perm_ud])
    np.testing.assert_allclose(np.asarray(ds.dirichlet_values),
                               np.asarray(dg.dirichlet_values)[perm_ud])
    np.testing.assert_allclose(np.asarray(ds.f_well),
                               np.asarray(dg.f_well)[perm_p], rtol=1e-12,
                               atol=1e-20)


def test_full_time_step_matches_generic_2d():
    data, dg, ds = _setup(2)
    perm_p = _perm(ds.pressure_space, dg.pressure_space)
    sg = FixedStressSolver(dg, data)
    ss = FixedStressSolver(ds, data)
    stg = sg.initial_state()
    sts = ss.initial_state()
    np.testing.assert_allclose(np.asarray(sts.eps_v),
                               np.asarray(stg.eps_v)[perm_p], rtol=1e-6)
    ag, tg = sg.time_step(stg, data.time_step)
    as_, ts = ss.time_step(sts, data.time_step)
    assert int(tg.fss_iterations) == int(ts.fss_iterations)
    assert int(tg.pressure_iterations) == int(ts.pressure_iterations)
    np.testing.assert_allclose(np.asarray(as_.p),
                               np.asarray(ag.p)[perm_p], rtol=1e-9)


# ----------------------------------------------------- anisotropic grids --

def _setup_aniso(dim):
    """Anisotropic cell counts on an anisotropic box: conv path vs generic."""
    data = read_input_file(GOLDEN)
    if dim == 3:
        data = dataclasses.replace(
            data, dim=3, domain_size=(12.0, 6.0, 3.0),
            displacement_boundary_labels=(0, 1, 2, 3, 4, 5),
            displacement_boundary_components=(0, 0, 1, 1, 2, 2),
            displacement_boundary_values=(0, -1e-5, 0, -1e-5, 0, -1e-5))
        ns = (4, 2, 3)
    else:
        data = dataclasses.replace(data, domain_size=(10.0, 4.0))
        ns = (8, 3)
    mesh = hyper_rectangle(data.domain_size[:dim], cells_per_axis=ns)
    disc_g = build_discretization(mesh, data)
    disc_s = build_grid_discretization(data, cells_per_axis=ns)
    return data, disc_g, disc_s


@pytest.mark.parametrize("dim", [2, 3])
def test_aniso_operators_match_generic(dim):
    data, dg, ds = _setup_aniso(dim)
    assert not ds.info_p.isotropic
    perm_p = _perm(ds.pressure_space, dg.pressure_space)
    perm_u = _perm(ds.displacement_space, dg.displacement_space)
    rng = np.random.default_rng(1)

    f = rng.standard_normal(ds.n_pdofs)
    tmp = np.zeros(dg.n_pdofs)
    tmp[perm_p] = f
    p_s, p_g = jnp.asarray(f), jnp.asarray(tmp)
    np.testing.assert_allclose(np.asarray(ds.mass(p_s)),
                               np.asarray(dg.mass(p_g))[perm_p], rtol=1e-11,
                               atol=1e-13)
    np.testing.assert_allclose(np.asarray(ds.laplace(p_s)),
                               np.asarray(dg.laplace(p_g))[perm_p],
                               rtol=1e-11, atol=1e-12)

    fu = rng.standard_normal(ds.n_udofs)
    tmp2 = np.zeros(dg.n_udofs).reshape(-1, dim)
    tmp2[perm_u] = fu.reshape(-1, dim)
    u_s, u_g = jnp.asarray(fu), jnp.asarray(tmp2.reshape(-1))
    perm_ud = (perm_u[:, None] * dim + np.arange(dim)).reshape(-1)
    ref = np.asarray(dg.elasticity(u_g))[perm_ud]
    np.testing.assert_allclose(np.asarray(ds.elasticity(u_s)), ref,
                               rtol=1e-10, atol=1e-8 * np.abs(ref).max())
    np.testing.assert_allclose(
        np.asarray(ds.coupling_rhs(p_s, data.biot_coef)),
        np.asarray(dg.coupling_rhs(p_g, data.biot_coef))[perm_ud],
        rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(
        np.asarray(ds.strain_projection_rhs(u_s)),
        np.asarray(dg.strain_projection_rhs(u_g))[:, perm_p],
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ds.free_mask_u),
                               np.asarray(dg.free_mask_u)[perm_ud])


def test_aniso_full_time_step_matches_generic_2d():
    data, dg, ds = _setup_aniso(2)
    perm_p = _perm(ds.pressure_space, dg.pressure_space)
    sg = FixedStressSolver(dg, data)
    ss = FixedStressSolver(ds, data)
    ag, tg = sg.time_step(sg.initial_state(), data.time_step)
    as_, ts = ss.time_step(ss.initial_state(), data.time_step)
    assert int(tg.fss_iterations) == int(ts.fss_iterations)
    np.testing.assert_allclose(np.asarray(as_.p),
                               np.asarray(ag.p)[perm_p], rtol=1e-9)


def test_aniso_deck_entry_drives_structured_runner():
    """The 'Cells per axis' deck entry reaches the structured fast path."""
    from poroelasticity_dealii_tpu.config import from_entries, parse_deck
    from poroelasticity_dealii_tpu.models.runner import SimulationRunner
    deck = open(GOLDEN).read() + """
subsection Mesh
  set Domain size    = 10, 5
  set Cells per axis = 10, 4
end
subsection TPU
  set Output VTK = false
end
"""
    data = from_entries(parse_deck(deck))
    assert data.cells_per_axis == (10, 4)
    runner = SimulationRunner(data)
    assert runner.disc.info_p.cells_per_axis == (10, 4)
    assert runner.disc.n_cells == 40
    state, stats = runner.solver.time_step(runner.solver.initial_state(),
                                           data.time_step)
    assert np.isfinite(float(stats.pressure_error))
    assert float(stats.pressure_error) < data.fss_tol


def test_custom_bounds_conv_path_matches_generic():
    """Conv element matrices must use the mesh's actual cell size when the
    grid spans custom lower/upper bounds (not data.domain_size — e.g.
    Mandel's quarter domain [0, a]^2 with Domain size = 2a)."""
    data = read_input_file(GOLDEN)   # domain_size (10, 10)
    lo, up = [0.0, 0.0], [5.0, 5.0]  # span 5 != 10
    mesh = hyper_rectangle([5.0, 5.0], cells_per_axis=4,
                           lower=lo, upper=up)
    dg = build_discretization(mesh, data)
    ds = build_grid_discretization(data, cells_per_axis=4,
                                   lower=lo, upper=up)
    perm_p = _perm(ds.pressure_space, dg.pressure_space)
    rng = np.random.default_rng(2)
    f = rng.standard_normal(ds.n_pdofs)
    tmp = np.zeros(dg.n_pdofs)
    tmp[perm_p] = f
    np.testing.assert_allclose(
        np.asarray(ds.laplace(jnp.asarray(f))),
        np.asarray(dg.laplace(jnp.asarray(tmp)))[perm_p],
        rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(ds.mass(jnp.asarray(f))),
        np.asarray(dg.mass(jnp.asarray(tmp)))[perm_p],
        rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_q1_slices_fast_path_matches_conv_pair(dim):
    """make_stencil_apply's scalar-Q1 shifted-slices fast path (the
    production pressure apply) is exactly the
    two-conv cellwise operator, on anisotropic grids, in f64."""
    from poroelasticity_dealii_tpu.mesh.generator import hyper_rectangle as hr
    from poroelasticity_dealii_tpu.mesh.qk import build_fe_space
    from poroelasticity_dealii_tpu.ops import dense
    from poroelasticity_dealii_tpu.ops.stencil import (
        _make_q1_slices_apply, _scatter_kernel, _to_kernel, conv_cellwise,
        conv_scatter)

    ns = (5, 3, 4)[:dim]
    h = [1.3 / n for n in ns]
    cm = hr(h, cells_per_axis=1)
    sp1 = build_fe_space(cm, 1)
    Le = np.asarray(dense.laplace_element_matrices(sp1)[0])
    gs = tuple(n + 1 for n in ns)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(int(np.prod(gs))))

    fast = _make_q1_slices_apply(Le, dim, ns, jnp.float64)
    wg = jnp.asarray(_to_kernel(Le, 1, 1, dim), jnp.float64)
    ws = jnp.asarray(_scatter_kernel(1, 2 ** dim, 1, 1, dim), jnp.float64)
    ref = conv_scatter(conv_cellwise(x, wg, 1, dim, 1, gs), ws, 1, dim, 1,
                       ns)
    np.testing.assert_allclose(np.asarray(fast(x)), np.asarray(ref),
                               rtol=1e-13, atol=1e-14)
