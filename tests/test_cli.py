"""CLI surface tests: deck validation and a short end-to-end run via the
actual command-line entry point, plus a gmsh-mesh-driven run."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_MSH = "/root/reference/domain.msh"


def _run_cli(args, cwd):
    # PYTHONPATH=REPO: the subprocess must find the package even when it is
    # not installed into the interpreter's site-packages
    pypath = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "poroelasticity_dealii_tpu", *args],
        cwd=cwd, capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": pypath},
        timeout=600)


def test_check_subcommand(tmp_path):
    r = _run_cli(["check", os.path.join(REPO, "configs/golden_2d.data")],
                 cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "derived" in r.stdout and "M=5.58214e+09" in r.stdout


def test_check_rejects_bad_deck(tmp_path):
    deck = tmp_path / "bad.data"
    deck.write_text("subsection Properties\n set Poisson ratio = 0.9\nend\n")
    r = _run_cli(["check", str(deck)], cwd=tmp_path)
    assert r.returncode != 0
    assert "Poisson ratio" in r.stderr


def test_short_run_produces_outputs(tmp_path):
    deck = tmp_path / "run.data"
    deck.write_text("""
subsection Mesh
  set Initial refinement level = 3
end
subsection Solver
  set Time step = 60
  set Time max  = 120
end
subsection Properties
  set Well radius = 1
  set Flow rate   = 1e-5
end
""")
    r = _run_cli(["run", str(deck), "--platform", "cpu"], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    sol = tmp_path / "solution"
    files = sorted(os.listdir(sol))
    assert "solution-0000.vtk" in files and "solution-0002.vtk" in files
    log = [json.loads(l) for l in open(sol / "run_log.jsonl")]
    assert len(log) == 2
    assert all(rec["pressure_error"] < 1e-8 for rec in log)


@pytest.mark.skipif(not os.path.exists(REFERENCE_MSH),
                    reason="reference mesh asset unavailable")
def test_run_on_gmsh_mesh(tmp_path):
    """End-to-end on the reference's own gmsh asset via the 'Mesh file'
    deck key (the capability the reference's dead read_mesh() intended)."""
    deck = tmp_path / "msh.data"
    deck.write_text(f"""
subsection Mesh
  set Mesh file = {REFERENCE_MSH}
end
subsection Solver
  set Time step = 60
  set Time max  = 60
end
subsection Properties
  set Well radius = 1
  set Flow rate   = 1e-5
end
""")
    r = _run_cli(["run", str(deck), "--platform", "cpu"], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    vtk = (tmp_path / "solution" / "solution-0001.vtk").read_text()
    assert "POINTS 121 double" in vtk   # the asset's 121 nodes


def test_deck_sharding_knob(tmp_path):
    """'TPU / Sharding = psum' + 'Devices = 8' runs the full simulation
    through the sharded discretization from the deck alone (multi-chip is
    reachable from the CLI, not only the library API)."""
    import numpy as np
    from poroelasticity_dealii_tpu.models.runner import run_from_deck
    deck = open("configs/golden_2d.data").read() + (
        "\nsubsection Solver\n  set Time max = 120\nend\n"
        "subsection TPU\n  set Sharding = psum\n  set Devices = 8\n"
        "  set Output VTK = false\n"
        f"  set Output directory = {tmp_path}\nend\n")
    p = tmp_path / "shard.data"
    p.write_text(deck)
    state = run_from_deck(str(p))
    assert np.isfinite(np.asarray(state.p)).all()


def test_deck_sharding_production_knob(tmp_path):
    """'TPU / Sharding = production' from the deck alone: the z-slab
    sharded row backend + GSPMD stencil pressure runs end-to-end through
    the CLI runner (3D rows-eligible deck selected by the older deck name
    'pallas', 2 steps)."""
    import numpy as np
    from poroelasticity_dealii_tpu.models.runner import run_from_deck
    deck = open("configs/consolidation_3d.data").read() + (
        "\nsubsection Mesh\n  set Initial refinement level = 2\nend\n"
        "subsection Solver\n  set Time max = 120\nend\n"
        "subsection TPU\n  set Sharding = production\n  set Devices = 8\n"
        "  set Elasticity backend = pallas\n"
        "  set Dtype = float32\n  set Mechanics CG relative = true\n"
        "  set Mechanics CG tolerance = 1e-5\n"
        "  set Output VTK = false\n"
        f"  set Output directory = {tmp_path}\nend\n")
    p = tmp_path / "prod.data"
    p.write_text(deck)
    state = run_from_deck(str(p))
    assert np.isfinite(np.asarray(state.p)).all()
