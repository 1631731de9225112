"""Mixed-precision iterative refinement for f64 mechanics: an f64
Richardson outer loop preconditioned by a full f32 inner solve
(fss._mixed_precision_inner).  On a device with slow f64 this replaces
f64 GMG-CG with 2-3 refinement passes of f32 work; here (CPU, knob forced
'on') we verify the math: the refined solve
reaches the same reference tolerances and the same solution as the
plain f64 path."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from poroelasticity_dealii_tpu.config import read_input_file
from poroelasticity_dealii_tpu.solvers import FixedStressSolver
from poroelasticity_dealii_tpu.solvers.structured import \
    build_grid_discretization

DECK = "configs/consolidation_3d.data"


def _solver(mode, cells=4):
    data = read_input_file(DECK)
    data = dataclasses.replace(
        data, dtype="float64", t_max=120.0,
        mech_cg_tol=1e-12, mech_cg_relative=True,
        mixed_precision_refinement=mode)
    disc = build_grid_discretization(data, cells_per_axis=cells,
                                     multigrid="off")
    return data, disc, FixedStressSolver(disc, data)


def test_knob_parses():
    data = read_input_file(DECK)
    assert data.mixed_precision_refinement == "auto"
    from poroelasticity_dealii_tpu.config import from_entries
    with pytest.raises(Exception):
        from_entries({("TPU", "Mixed precision refinement"): "sometimes"})


def test_auto_is_off_on_cpu():
    data, disc, solver = _solver("auto")
    assert solver._mixed_precision_inner() is None
    data, disc, solver = _solver("off")
    assert solver._mixed_precision_inner() is None


def test_refined_matches_plain_f64():
    """Same deck, knob on vs off: both converge, solutions agree to the
    mechanics tolerance (1e-12 relative), and the refined path reports
    outer passes (a handful) instead of CG iterations."""
    _, _, plain = _solver("off")
    data, disc, refined = _solver("on")
    assert refined._mixed_precision_inner() is not None
    st_p, st_r = plain.initial_state(), refined.initial_state()
    np.testing.assert_allclose(np.asarray(st_r.u), np.asarray(st_p.u),
                               rtol=0, atol=1e-11 * float(
                                   np.abs(np.asarray(st_p.u)).max()))
    for _ in range(2):
        st_p, stats_p = plain.time_step(st_p, data.time_step)
        st_r, stats_r = refined.time_step(st_r, data.time_step)
        assert bool(stats_p.cg_converged) and bool(stats_r.cg_converged)
        # refinement converges in a handful of outer passes — mechanics,
        # pressure AND the batched projection all run refined (their
        # iteration counters now count Richardson outer passes)
        assert int(stats_r.mech_cg_iterations) <= 6
        assert int(stats_r.pressure_cg_iterations) <= \
            3 * int(stats_r.pressure_iterations) + 3
        assert int(stats_r.projection_cg_iterations) <= \
            int(stats_p.projection_cg_iterations)
    scale = float(np.abs(np.asarray(st_p.u)).max())
    np.testing.assert_allclose(np.asarray(st_r.u), np.asarray(st_p.u),
                               rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(np.asarray(st_r.p), np.asarray(st_p.p),
                               rtol=1e-10)
    assert int(stats_r.fss_iterations) == int(stats_p.fss_iterations)
    assert int(stats_r.pressure_iterations) == int(
        stats_p.pressure_iterations)


def test_refined_bc_response_ramp():
    """Time-dependent Dirichlet loading (bc_scale ramp) drives the
    refined one-time _bc_response solve; the superposition warm start and
    the step itself must match the plain f64 path."""
    _, _, plain = _solver("off")
    data, _, refined = _solver("on")
    st_p, st_r = plain.initial_state(), refined.initial_state()
    st_p, stats_p = plain.time_step(st_p, data.time_step, bc_scale=1.1,
                                    bc_scale_prev=1.0)
    st_r, stats_r = refined.time_step(st_r, data.time_step, bc_scale=1.1,
                                      bc_scale_prev=1.0)
    assert bool(stats_p.cg_converged) and bool(stats_r.cg_converged)
    scale = float(np.abs(np.asarray(st_p.u)).max())
    np.testing.assert_allclose(np.asarray(st_r.u), np.asarray(st_p.u),
                               rtol=0, atol=1e-9 * scale)


def test_refined_residual_meets_reference_tolerance():
    """The f64 residual of the refined mechanics solution itself (not the
    inner f32 one) meets the 1e-12-relative reference tolerance."""
    data, disc, refined = _solver("on")
    st = refined.initial_state()
    st, stats = refined.time_step(st, data.time_step)
    # rebuild the constrained system exactly as _mechanics_solve does
    d = disc
    rhs = d._hcu.condense_vec(
        d.coupling_rhs(st.p, data.biot_coef) + d.f_neumann)
    g = d.dirichlet_values
    b = d.free_mask_u * (rhs - refined._elasticity_lift) \
        + (1.0 - d.free_mask_u) * g
    r = b - d.elasticity_constrained(jnp.asarray(st.u))
    rel = float(jnp.linalg.norm(r)) / float(jnp.linalg.norm(b))
    assert rel < 1e-12, rel


def test_refined_bc_response_ramp_rows_inner():
    """The same bc-scale ramp with the ROWS f32 inner: regression for the free-subspace violation where _bc_response
    started Richardson from x0=0, leaving the Dirichlet pattern in the
    residual — which the rows inner (apply_iter=free_apply, zero on
    constrained rows) could never reduce, spinning the inner CG to its cap
    with polluted step scalars."""
    data = read_input_file(DECK)
    data = dataclasses.replace(
        data, dtype="float64", t_max=120.0,
        mech_cg_tol=1e-12, mech_cg_relative=True,
        elasticity_backend="rows")
    n = 4
    sols = {}
    for mode in ("off", "on"):
        d = dataclasses.replace(data, mixed_precision_refinement=mode)
        disc = build_grid_discretization(d, cells_per_axis=n,
                                         multigrid="off")
        s = FixedStressSolver(disc, d)
        if mode == "on":
            assert s._mixed_precision_inner() is not None
            # the rows inner must actually be in play
            assert getattr(s.__dict__.get("_ir_disc32"), "row_ops", None) \
                is not None
        st = s.initial_state()
        st, stats = s.time_step(st, d.time_step, bc_scale=1.1,
                                bc_scale_prev=1.0)
        assert bool(stats.cg_converged), mode
        sols[mode] = np.asarray(s.materialize_u(st).u)
    scale = float(np.abs(sols["off"]).max())
    np.testing.assert_allclose(sols["on"], sols["off"],
                               rtol=0, atol=1e-9 * scale)
