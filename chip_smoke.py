#!/usr/bin/env python3
"""Smoke run of the solver's main path on an NVIDIA GPU.

    python chip_smoke.py                 # one card
    python chip_smoke.py --multichip 4   # four cards: sharded decks only

One card, in order (any failure exits non-zero; there is no CPU fallback):

5. the ``gpu``-marked tests, in a child pytest that ends before this
   process opens the card (one JAX process per card);
1. the resident-layout operators (3D rows at 40^3, 2D parity at 512^2)
   against the conv/stencil reference, in float32 and float64, with their
   errors, tolerances and warm times;
2. the 3D consolidation deck at 40^3 (1.66M DOF, float32) through
   ``cli.main(["run", deck])``;
3. the golden deck's physics at 512^2 (2.37M DOF, float32, parity layout
   with parity-resident GMG) through the same entry point;
4. the golden deck itself (float64) against its pinned convergence
   history (tests/data/golden_history.json).

``--multichip N`` runs only the 3D 40^3 and 2D 512^2 decks with
``Sharding = production`` over N cards, the same decks on one card, and
compares the final fields.

Output: the card's ``name, power.limit`` (nvidia-smi) first, one line per
check, and as the last line one JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DECK_3D = os.path.join(HERE, "configs", "consolidation_3d.data")
DECK_2D = os.path.join(HERE, "configs", "golden_2d.data")
GOLDEN_HISTORY = os.path.join(HERE, "tests", "data", "golden_history.json")

# the f32 solver tolerances of bench.py's 3D and 2D sections
F32_TOLERANCES = """
subsection Solver
  set FSS tolerance      = 2e-5
  set Pressure tolerance = 2e-5
end
subsection TPU
  set Dtype                   = float32
  set Mechanics CG tolerance  = 1e-5
  set Mechanics CG relative   = true
  set Pressure CG tolerance   = 1e-5
  set Projection CG tolerance = 1e-5
end
"""


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def gpu_identity() -> list:
    """``name, power.limit`` of every card, as nvidia-smi reports them,
    read before JAX opens any card."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not any(p in platforms for p in ("cuda", "gpu")):
        fail(f"JAX_PLATFORMS={platforms!r} excludes the GPU")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"no NVIDIA GPU visible (nvidia-smi: {e})")
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    check(bool(lines), "nvidia-smi lists no GPU")
    return lines


def require_gpu(count: int):
    """The JAX devices, which must be ``count`` NVIDIA GPUs or more."""
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (device 0 is {devs[0].platform} / "
          f"{devs[0].device_kind})")
    check(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    return devs


def run_gpu_tests():
    """Phase 5: the ``gpu``-marked tests, on the card, in a child process
    that exits before this one opens the card."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rs",
         "-p", "no:cacheprovider", "tests/"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    tail = "\n".join(proc.stdout.strip().splitlines()[-12:])
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    check(proc.returncode == 0 and " passed" in summary
          and "skipped" not in summary,
          f"gpu-marked tests (rc={proc.returncode}):\n{tail}\n"
          f"{proc.stderr[-2000:]}")
    return f"{summary} ({time.perf_counter() - t0:.1f} s)"


def _warm_ms(fn, x, calls: int = 20) -> float:
    """Warm ms per call: ``calls`` back-to-back dispatches of an already
    compiled function, one sync at the end (host clock)."""
    import jax
    jax.block_until_ready(fn(x))
    t0 = time.perf_counter()
    for _ in range(calls):
        y = fn(x)
    jax.block_until_ready(y)
    return (time.perf_counter() - t0) / calls * 1e3


def check_operators(dim: int, n: int, dtypes=("float32", "float64")):
    """Phase 1: resident-layout operators vs the conv/stencil reference."""
    from poroelasticity_dealii_tpu.config import read_input_file
    from poroelasticity_dealii_tpu.ops.crosscheck import (TOLERANCE,
                                                          operator_cases)
    data = read_input_file(DECK_3D if dim == 3 else DECK_2D)
    for dtype in dtypes:
        for case in operator_cases(data, n, dtype):
            err = case.rel_error()
            tol = TOLERANCE[dtype]
            print(f"op {dim}D n={n} {dtype} {case.name}: max rel err "
                  f"{err:.3e} (tol {tol:.0e}); warm ms/call resident "
                  f"{_warm_ms(case.fast, case.x_fast):.4f}, reference "
                  f"{_warm_ms(case.ref, case.x_ref):.4f}", flush=True)
            check(err < tol, f"{dim}D {dtype} {case.name}: {err} >= {tol}")


def deck_text(base: str, cells: int, dim: int, steps: int, out_dir: str,
              extra: str = "", f32: bool = True) -> str:
    """``base`` deck + overrides (later ``set`` lines win): grid size,
    step count, output and checkpoint directories (final state saved)."""
    with open(base) as fh:
        text = fh.read()
    cells_s = ",".join([str(cells)] * dim)
    text += f"""
subsection Mesh
  set Cells per axis = {cells_s}
end
subsection Solver
  set Time max = {60.0 * steps}
end
subsection TPU
  set Output VTK           = false
  set Output directory     = {out_dir}
  set Checkpoint every     = {steps}
  set Checkpoint directory = {out_dir}
end
"""
    return text + (F32_TOLERANCES if f32 else "") + extra


def run_deck(text: str, out_dir: str, tag: str):
    """Write the deck, run it through the CLI, and return (run-log
    records, final state arrays, wall seconds)."""
    import numpy as np

    from poroelasticity_dealii_tpu import cli
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "deck.data")
    with open(path, "w") as fh:
        fh.write(text)
    t0 = time.perf_counter()
    rc = cli.main(["run", path])
    wall = time.perf_counter() - t0
    check(rc == 0, f"{tag}: cli returned {rc}")
    with open(os.path.join(out_dir, "run_log.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    ckpts = sorted(f for f in os.listdir(out_dir) if f.endswith(".npz"))
    check(bool(ckpts), f"{tag}: no final checkpoint written")
    with np.load(os.path.join(out_dir, ckpts[-1])) as z:
        state = {k: np.asarray(z[k]) for k in ("p", "u", "eps_v",
                                               "strains")}
    return recs, state, wall


def check_run(recs, state, tag: str, fss_tol: float, backend: str = None,
              devices: int = 1):
    """Finite fields; mechanics CG > 0, FSS converged and no linear solve
    at its cap on every step; the expected mechanics path and device
    count."""
    import numpy as np
    for k, v in state.items():
        check(bool(np.isfinite(v).all()), f"{tag}: non-finite {k}")
    for r in recs:
        s, cg = r["step"], r["cg_iterations"]
        check(cg["mechanics"] > 0, f"{tag} step {s}: mechanics CG = 0")
        check(r["pressure_error"] <= fss_tol,
              f"{tag} step {s}: FSS not converged "
              f"(err {r['pressure_error']:.3e} > {fss_tol:.1e})")
        check(r["cg_converged"] or r["cg_stalled"],
              f"{tag} step {s}: a linear solve hit its iteration cap "
              f"(CG counts {cg})")
        if backend is not None:
            check(r["mechanics_backend"].startswith(backend),
                  f"{tag}: mechanics backend {r['mechanics_backend']!r}, "
                  f"expected {backend!r}")
        check(r["devices"] == devices,
              f"{tag}: state on {r['devices']} device(s), "
              f"expected {devices}")


def report_run(recs, wall: float, tag: str):
    """Steady ms/step is the median of steps 3..N-1: steps 1-2 compile
    the two state variants, and step N (its state is read for the final
    checkpoint) compiles the variant that also returns the flat u."""
    import statistics

    import jax
    walls = [r["wall_s"] for r in recs]
    steady_ms = 1e3 * statistics.median(walls[2:-1])
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    counts = " ".join(
        f"{r['fss_iterations']}/{r['pressure_iterations']}/"
        f"{r['cg_iterations']['pressure']}/{r['cg_iterations']['mechanics']}/"
        f"{r['cg_iterations']['projection']}" for r in recs)
    print(f"{tag}: {len(recs)} steps, steady {steady_ms:.2f} ms/step "
          f"(median of steps 3-{len(recs) - 1}), steps 1-2 incl. compile "
          f"{sum(walls[:2]):.1f} s, last step incl. compile "
          f"{walls[-1]:.1f} s, setup {wall - sum(walls):.1f} s, process "
          f"peak device memory {peak} B; per step "
          f"fss/press/cg(p/u/proj) = {counts}; "
          f"backend {recs[0]['mechanics_backend']}", flush=True)


def main_path_3d(tmp: str, cells: int = 40, steps: int = 6,
                 backend: str = "rows3d"):
    """Phase 2: the 3D consolidation deck through the CLI."""
    out = os.path.join(tmp, "d3")
    extra = "subsection Properties\n  set Flow rate = 1e-2\nend\n"
    recs, state, wall = run_deck(
        deck_text(DECK_3D, cells, 3, steps, out, extra), out, "3D")
    check(len(recs) == steps, f"3D: {len(recs)} steps logged")
    check_run(recs, state, "3D", 2e-5, backend)
    report_run(recs, wall, f"3D {cells}^3 f32 deck")


def main_path_2d(tmp: str, cells: int = 512, steps: int = 6):
    """Phase 3: the golden deck's physics at production size."""
    out = os.path.join(tmp, "d2")
    extra = "subsection Properties\n  set Flow rate = 1.0\nend\n"
    recs, state, wall = run_deck(
        deck_text(DECK_2D, cells, 2, steps, out, extra), out, "2D")
    check(len(recs) == steps, f"2D: {len(recs)} steps logged")
    check_run(recs, state, "2D", 2e-5, "parity2d")
    report_run(recs, wall, f"2D {cells}^2 f32 deck")


def golden_history(tmp: str):
    """Phase 4: the golden deck (float64) reproduces its pinned history:
    iteration counts equal, residuals within rtol 1e-6."""
    import numpy as np
    out = os.path.join(tmp, "golden")
    with open(DECK_2D) as fh:
        text = fh.read() + f"""
subsection TPU
  set Output VTK       = false
  set Output directory = {out}
end
"""
    from poroelasticity_dealii_tpu import cli
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "deck.data")
    with open(path, "w") as fh:
        fh.write(text)
    check(cli.main(["run", path]) == 0, "golden: cli failed")
    with open(os.path.join(out, "run_log.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    with open(GOLDEN_HISTORY) as fh:
        pinned = json.load(fh)
    check(len(recs) == len(pinned) == 17, f"golden: {len(recs)} steps")
    worst = 0.0
    for got, want in zip(recs, pinned):
        for key in ("fss_iterations", "pressure_iterations"):
            check(got[key] == want[key],
                  f"golden step {got['step']}: {key} {got[key]} != "
                  f"pinned {want[key]}")
        for key in ("pressure_error", "fss_error_history"):
            a = np.asarray(got[key], np.float64)
            b = np.asarray(want[key], np.float64)
            check(a.shape == b.shape and np.allclose(a, b, rtol=1e-6,
                                                     atol=0.0),
                  f"golden step {got['step']}: {key} {a} vs pinned {b}")
            worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    print(f"golden 2D f64 deck: 17 steps, iteration counts equal to the "
          f"pinned history, worst residual rel diff {worst:.3e} "
          "(rtol 1e-6)", flush=True)


def multichip(tmp: str, n_dev: int, cells_3d: int = 40,
              cells_2d: int = 512):
    """Sharded production decks over ``n_dev`` cards vs one card."""
    import numpy as np
    sharded = (f"subsection TPU\n  set Sharding = production\n"
               f"  set Devices = {n_dev}\nend\n")
    for dim, deck, cells, flow, backend in (
            (3, DECK_3D, cells_3d, "1e-2", "rows3d"),
            (2, DECK_2D, cells_2d, "1.0", "parity2d")):
        extra = f"subsection Properties\n  set Flow rate = {flow}\nend\n"
        res = {}
        for devs in (n_dev, 1):
            tag = f"{dim}D x{devs}"
            out = os.path.join(tmp, f"d{dim}-{devs}")
            recs, state, wall = run_deck(
                deck_text(deck, cells, dim, 5, out,
                          extra + (sharded if devs > 1 else "")), out, tag)
            check_run(recs, state, tag, 2e-5, backend, devs)
            report_run(recs, wall, f"{tag} {cells}^{dim} f32 deck")
            res[devs] = state
        for k in ("p", "u"):
            a, b = res[n_dev][k], res[1][k]
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            print(f"{dim}D 1-vs-{n_dev} {k}: rel L2 diff {rel:.3e} "
                  "(tol 2e-4)", flush=True)
            check(rel < 2e-4, f"{dim}D 1-vs-{n_dev} {k} differs: {rel}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", type=int, default=0, metavar="N",
                    help="run only the sharded decks over N cards")
    args = ap.parse_args(argv)
    n_dev = args.multichip or 1

    cards = gpu_identity()
    for line in cards[:n_dev]:
        print(line, flush=True)
    check(len(cards) >= n_dev, f"need {n_dev} GPUs, nvidia-smi lists "
          f"{len(cards)}")
    sys.path.insert(0, HERE)
    gpu_tests = None if args.multichip else run_gpu_tests()

    import jax
    jax.config.update("jax_enable_x64", True)
    from poroelasticity_dealii_tpu.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    devs = require_gpu(n_dev)
    print(f"jax: {jax.__version__}, {len(devs)} x {devs[0].device_kind}",
          flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        if args.multichip:
            multichip(tmp, n_dev)
        else:
            print(f"gpu-marked tests: {gpu_tests}", flush=True)
            check_operators(3, 40)
            check_operators(2, 512)
            main_path_3d(tmp)
            main_path_2d(tmp)
            golden_history(tmp)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
