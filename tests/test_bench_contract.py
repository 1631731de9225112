"""The bench stdout contract and its device bookkeeping.

Readers tail-capture bench stdout and parse the LAST line as the JSON
record, so ``bench.emit`` prints ONE compact headline line and writes
everything bulky to ``bench_detail.json``; every record names its device,
peaks come from one table keyed by ``device_kind``, and cached slow
sections are keyed by the device they were measured on.  These tests pin
that contract.
"""

import json
import sys
import os

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from poroelasticity_dealii_tpu.solvers.structured import \
    mechanics_backend_name  # noqa: E402


def _representative_headline():
    # worst-case realistic widths for every field the real main() emits
    return {
        "metric": "evolving_chained_wall_clock_per_fss_timestep_1.66M_dof_3d",
        "value": 7777.77,
        "unit": "ms",
        "vs_baseline": 111475.9,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1, "power_limit": "NVIDIA H100 80GB HBM3, "
                                              "700.00 W"},
        "steady_ms": 7777.777777777777,
        "steady_vs_baseline": 111475.9,
        "scan_ms_per_step": 7777.77,
        "evolving_scan_ms_per_step": 7777.77,
        "synced_ms_per_step": 7777.77,
        "backend": "rows3d (comp-major row layout, one-matmul apply)",
        "x64_reference_tol_ms": 77777.77,
        "vs_baseline_x64": 111475.9,
        "d2_ms": 7777.777777777777,
        "d2_evolving_ms": 7777.777777777777,
        "detail": "bench_detail.json",
    }


def test_headline_fits_capture_window(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "DETAIL_FILE", str(tmp_path / "detail.json"))
    monkeypatch.setattr(bench, "CACHE_FILE", str(tmp_path / "cache.json"))
    line = bench.emit(_representative_headline(),
                      {"utilization": {"op": {"ms": 1.0}}})
    assert len(line) <= bench.HEADLINE_MAX_BYTES
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, "bench must print exactly ONE stdout line"
    parsed = json.loads(out[-1])
    assert parsed["value"] == 7777.77
    assert parsed["vs_baseline"] == 111475.9
    # no headline key was dropped for a representative record
    assert set(parsed) == set(_representative_headline())


def test_emit_writes_detail_sidecar(tmp_path, monkeypatch):
    detail_file = tmp_path / "detail.json"
    monkeypatch.setattr(bench, "DETAIL_FILE", str(detail_file))
    monkeypatch.setattr(bench, "CACHE_FILE", str(tmp_path / "cache.json"))
    big = {"utilization": {f"op{i}": {"ms": i} for i in range(40)},
           "chained_reps_ms": [1.0, 2.0, 3.0]}
    bench.emit(_representative_headline(), big)
    saved = json.loads(detail_file.read_text())
    assert saved["chained_reps_ms"] == [1.0, 2.0, 3.0]
    assert "op39" in saved["utilization"]
    assert saved["headline"]["value"] == 7777.77


def test_cache_roundtrip_stamps_measured_at(tmp_path, monkeypatch):
    """Slow sections (x64 / 2D) are cached with a measured_at stamp, per
    device_kind."""
    monkeypatch.setattr(bench, "CACHE_FILE", str(tmp_path / "cache.json"))
    kind = "NVIDIA H100 80GB HBM3"
    saved = bench._save_cache(kind, "d2_at_scale",
                              {"ms_per_step_chained": 3.14})
    assert saved["measured_at"].endswith("Z")
    loaded = bench._load_cache(kind)["d2_at_scale"]
    assert loaded["ms_per_step_chained"] == 3.14
    assert loaded["measured_at"] == saved["measured_at"]
    # second key does not clobber the first
    bench._save_cache(kind, "x64_reference_tol", {"ms_per_step_chained": 9})
    assert bench._load_cache(kind)["d2_at_scale"]["ms_per_step_chained"] \
        == 3.14


def test_cache_never_attaches_another_devices_value(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "CACHE_FILE", str(tmp_path / "cache.json"))
    bench._save_cache("NVIDIA A100-SXM4-80GB", "d2_at_scale",
                      {"ms_per_step_chained": 5.8})
    assert bench._load_cache("NVIDIA H100 80GB HBM3") == {}
    assert bench._load_cache("NVIDIA A100-SXM4-80GB")["d2_at_scale"][
        "ms_per_step_chained"] == 5.8


def test_peaks_table_rejects_unknown_device():
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks_for("cpu")
    h100 = bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert h100["hbm_gbps"] == 3350.0 and h100["f32_tflops"] == 67.0
    assert h100["source"]


def test_bench_refuses_cpu_device():
    """The measured path never reports CPU numbers under device names."""
    with pytest.raises(SystemExit, match="no GPU found"):
        bench._require_gpu()
    rec = bench.device_record()
    assert rec["platform"] == "cpu" and rec["count"] >= 1
    assert set(rec) == {"platform", "kind", "count", "power_limit"}


def test_backend_name_reports_selected_path():
    """A hardcoded label would misreport the experiment once
    auto-selection switches paths — the label must follow the object."""
    class _Disc:
        row_ops = None
        gmg_precond = None
        gmg_precond_rows = None
    d = _Disc()
    assert "Jacobi" in mechanics_backend_name(d)
    d.gmg_precond = object()
    assert "GMG-Richardson" in mechanics_backend_name(d)

    class ElasticityParityOps:     # type name is what's sniffed
        pass
    d.row_ops = ElasticityParityOps()
    assert mechanics_backend_name(d).startswith("parity2d")
    d.gmg_precond_rows = object()
    assert "parity-resident GMG" in mechanics_backend_name(d)

    class ElasticityRowOps:
        pass
    d.row_ops = ElasticityRowOps()
    assert mechanics_backend_name(d).startswith("rows3d")


def test_oversized_headline_degrades_not_breaks(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(bench, "DETAIL_FILE", str(tmp_path / "detail.json"))
    monkeypatch.setattr(bench, "CACHE_FILE", str(tmp_path / "cache.json"))
    headline = _representative_headline()
    headline["giant"] = "x" * 5000           # would overflow the capture
    line = bench.emit(headline, {})
    assert len(line) <= bench.HEADLINE_MAX_BYTES
    parsed = json.loads(line)
    assert "giant" not in parsed              # dropped to the sidecar...
    assert parsed["value"] == 7777.77         # ...required keys survive
    saved = json.loads((tmp_path / "detail.json").read_text())
    assert saved["giant"] == "x" * 5000


def test_emit_writes_detail_sidecar_cache_isolated(tmp_path, monkeypatch):
    """emit() writes the detail sidecar and leaves the section cache
    alone (the cache holds measured sections only)."""
    monkeypatch.setattr(bench, "DETAIL_FILE", str(tmp_path / "detail.json"))
    monkeypatch.setattr(bench, "CACHE_FILE", str(tmp_path / "cache.json"))
    bench.emit(_representative_headline(), {"x": 1})
    assert not (tmp_path / "cache.json").exists()
    saved = json.loads((tmp_path / "detail.json").read_text())
    assert saved["headline"]["value"] == 7777.77
    assert saved["headline"]["device"]["kind"] == "NVIDIA H100 80GB HBM3"
