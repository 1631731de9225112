"""Fused multi-step dispatch (FixedStressSolver.multi_step): K time steps
scanned inside ONE jitted call must be semantically identical to K
sequential time_step calls — same states, same convergence trajectory.

The reference's time loop is a serial C++ while (PoroelasticityFSS.h:
327-413); multi_step is its compiler-visible form, used by
the runner's 'TPU / Steps per dispatch' knob and the bench throughput
pass.
"""

import dataclasses

import numpy as np
import pytest

from poroelasticity_dealii_tpu.config import read_input_file
from poroelasticity_dealii_tpu.mesh import hyper_rectangle
from poroelasticity_dealii_tpu.solvers import (FixedStressSolver,
                                               build_discretization)

GOLDEN = "configs/golden_2d.data"


@pytest.fixture(scope="module")
def golden():
    data = read_input_file(GOLDEN)
    mesh = hyper_rectangle(data.domain_size, 3)
    disc = build_discretization(mesh, data)
    solver = FixedStressSolver(disc, data)
    return data, disc, solver


def _assert_states_match(a, b, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(a.p), np.asarray(b.p), rtol=rtol)
    np.testing.assert_allclose(np.asarray(a.eps_v), np.asarray(b.eps_v),
                               rtol=rtol, atol=1e-20)
    np.testing.assert_allclose(np.asarray(a.strains), np.asarray(b.strains),
                               rtol=rtol, atol=1e-20)
    ua = a.u if a.u is not None else None
    ub = b.u if b.u is not None else None
    if ua is not None and ub is not None:
        np.testing.assert_allclose(np.asarray(ua), np.asarray(ub),
                                   rtol=rtol, atol=1e-20)


def test_multi_step_equals_sequential(golden):
    data, disc, solver = golden
    dt = data.time_step
    K = 3

    st_seq = solver.initial_state()
    seq_stats = []
    for _ in range(K):
        st_seq, stats = solver.time_step(st_seq, dt)
        seq_stats.append(stats)

    st_blk, stacked = solver.multi_step(solver.initial_state(), dt,
                                        n_steps=K, want_u=True)
    _assert_states_match(st_blk, st_seq)
    # stats are stacked along a leading (K,) axis and match per step
    assert stacked.fss_iterations.shape == (K,)
    assert stacked.fss_error_history.shape[0] == K
    for i, s in enumerate(seq_stats):
        assert int(stacked.fss_iterations[i]) == int(s.fss_iterations)
        assert int(stacked.pressure_iterations[i]) == int(
            s.pressure_iterations)
        assert int(stacked.pressure_cg_iterations[i]) == int(
            s.pressure_cg_iterations)
        assert int(stacked.mech_cg_iterations[i]) == int(
            s.mech_cg_iterations)
        np.testing.assert_allclose(float(stacked.pressure_error[i]),
                                   float(s.pressure_error), rtol=1e-10)


def test_multi_step_bc_ramp_matches_sequential(golden):
    """Per-step bc_scales ramp with the in-graph superposition warm start
    == the host-side time_step(bc_scale, bc_scale_prev) chain."""
    data, disc, solver = golden
    dt = data.time_step
    scales = [1.05, 1.10, 1.15]

    st_seq = solver.initial_state()
    prev = 1.0
    for bc in scales:
        st_seq, _ = solver.time_step(st_seq, dt, bc, bc_scale_prev=prev)
        prev = bc

    st_blk, _ = solver.multi_step(solver.initial_state(), dt,
                                  bc_scales=scales, bc_scale_prev=1.0,
                                  want_u=True)
    # the warm start changes iteration paths, not solutions: compare at
    # solver tolerance
    np.testing.assert_allclose(np.asarray(st_blk.p), np.asarray(st_seq.p),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(st_blk.u), np.asarray(st_seq.u),
                               rtol=1e-5, atol=1e-14)


def test_multi_step_structured_conv_path():
    """The 3D conv backend (fused Jacobian stencil + per-dt caches) under
    the scan: equivalence vs sequential steps."""
    from poroelasticity_dealii_tpu.solvers.structured import \
        build_grid_discretization
    data = read_input_file("configs/consolidation_3d.data")
    data = dataclasses.replace(data, initial_refinement_level=0)
    disc = build_grid_discretization(data, cells_per_axis=4)
    solver = FixedStressSolver(disc, data)
    dt = data.time_step
    K = 2

    st_seq = solver.initial_state()
    for _ in range(K):
        st_seq, stats_seq = solver.time_step(st_seq, dt)
    st_blk, stacked = solver.multi_step(solver.initial_state(), dt,
                                        n_steps=K, want_u=True)
    _assert_states_match(st_blk, st_seq, rtol=1e-10)
    assert int(stacked.fss_iterations[-1]) == int(stats_seq.fss_iterations)


def test_runner_steps_per_dispatch_matches_default(tmp_path):
    """'TPU / Steps per dispatch = 4' through the runner: same final state
    as the per-step run, run log still has one record per step, and
    checkpoint steps break blocks correctly."""
    import json
    import os

    from poroelasticity_dealii_tpu.models.runner import SimulationRunner

    base = read_input_file(GOLDEN)
    base = dataclasses.replace(
        base, initial_refinement_level=3, t_max=420.0, output_vtk=False,
        output_directory=str(tmp_path / "a"))
    st_ref = SimulationRunner(base).run()

    fused = dataclasses.replace(
        base, steps_per_dispatch=4, checkpoint_every=5,
        output_directory=str(tmp_path / "b"),
        checkpoint_directory=str(tmp_path / "b_ckpt"))
    st_fused = SimulationRunner(fused).run()

    np.testing.assert_allclose(np.asarray(st_fused.p), np.asarray(st_ref.p),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(st_fused.u), np.asarray(st_ref.u),
                               rtol=1e-10, atol=1e-20)
    n_steps = 7                                   # ceil(420 / 60)
    for d in ("a", "b"):
        with open(tmp_path / d / "run_log.jsonl") as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
        assert len(recs) == n_steps
        assert [r["step"] for r in recs] == list(range(1, n_steps + 1))
    # checkpoint at step 5 exists (the block ended there to read the state)
    names = os.listdir(tmp_path / "b_ckpt")
    assert any("000005" in nm for nm in names)


def test_deck_knob_steps_per_dispatch(tmp_path):
    """The deck entry parses and reaches InputData."""
    deck = tmp_path / "k.data"
    deck.write_text(
        "subsection TPU\n  set Steps per dispatch = 8\nend\n")
    data = read_input_file(str(deck))
    assert data.steps_per_dispatch == 8


def test_amr_runner_warns_steps_per_dispatch_with_vtk(tmp_path):
    """Per-step VTK/checkpoint output forces the per-step AMR path — the
    knob degrades loudly, not silently."""
    from poroelasticity_dealii_tpu.amr.driver import AMRSimulationRunner
    data = read_input_file(GOLDEN)
    data = dataclasses.replace(
        data, amr=True, initial_refinement_level=3, max_refinement_level=4,
        steps_per_dispatch=4, output_vtk=True,
        output_directory=str(tmp_path))
    with pytest.warns(RuntimeWarning, match="Steps per dispatch"):
        runner = AMRSimulationRunner(data)
    assert not runner._fused


def test_amr_fused_dispatch_matches_per_step(tmp_path):
    """Fused multi-step dispatch between remesh points (round-3 verdict
    item 8): an adaptive run with 'Steps per dispatch = 3' reproduces the
    per-step adaptive run — same mesh sequence, same per-step iteration
    counts, same fields."""
    from poroelasticity_dealii_tpu.amr.driver import AMRSimulationRunner
    data = read_input_file(GOLDEN)
    base = dataclasses.replace(
        data, amr=True, initial_refinement_level=3, max_refinement_level=5,
        t_max=660.0, output_vtk=False, output_directory=str(tmp_path))

    runner_ref = AMRSimulationRunner(base)
    state_ref, hist_ref = runner_ref.run()
    runner_fus = AMRSimulationRunner(
        dataclasses.replace(base, steps_per_dispatch=3))
    assert runner_fus._fused
    state_fus, hist_fus = runner_fus.run()

    assert runner_fus.forest.leaves == runner_ref.forest.leaves
    assert len(hist_fus) == len(hist_ref) == 11
    for hf, hr in zip(hist_fus, hist_ref):
        assert hf["n_cells"] == hr["n_cells"], hf["step"]
        assert hf["fss"] == hr["fss"], hf["step"]
        assert hf["press"] == hr["press"], hf["step"]
        np.testing.assert_allclose(hf["err"], hr["err"], rtol=1e-9)
    np.testing.assert_allclose(np.asarray(state_fus.p),
                               np.asarray(state_ref.p), rtol=1e-12)


def test_multi_step_rejects_traced_dt(golden):
    data, disc, solver = golden
    import jax.numpy as jnp
    with pytest.raises(TypeError):
        solver.multi_step(solver.initial_state(), jnp.float64(60.0),
                          n_steps=2)


def test_multi_step_requires_length(golden):
    data, disc, solver = golden
    with pytest.raises(ValueError):
        solver.multi_step(solver.initial_state(), data.time_step)
