"""Structured per-step run log.

The observability layer the reference lacks (it prints free-form progress to
stdout only, ``PoroelasticityFSS.h:325-330,352,367-369,387-389,406``; SURVEY
§5): every time step appends one JSON record with the full convergence
history — this is the artifact used to compare fixed-stress convergence
histories between runs/configurations.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np


class RunLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "w")
        self._t0 = time.perf_counter()

    def log_step(self, step: int, t: float, stats, wall_s: float,
                 extra: Optional[dict] = None):
        hist = np.asarray(stats.fss_error_history)
        rec = {
            "step": step,
            "time": t,
            "wall_s": round(wall_s, 6),
            "fss_iterations": int(stats.fss_iterations),
            "pressure_error": float(stats.pressure_error),
            "pressure_iterations": int(stats.pressure_iterations),
            "cg_iterations": {
                "pressure": int(stats.pressure_cg_iterations),
                "mechanics": int(stats.mech_cg_iterations),
                "projection": int(stats.projection_cg_iterations),
            },
            "fss_error_history": [float(x) for x in hist[hist >= 0]],
            # False if any linear solve of the step ended before its
            # tolerance; cg_stalled then says whether it stagnated (f32
            # floor) rather than hitting its iteration cap
            "cg_converged": bool(getattr(stats, "cg_converged", True)),
            "cg_stalled": bool(getattr(stats, "cg_stalled", False)),
        }
        if extra:
            rec.update(extra)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            print(f"Time: {t:g}  [step {step}] fss={rec['fss_iterations']} "
                  f"press={rec['pressure_iterations']} "
                  f"cg(p/u/proj)={rec['cg_iterations']['pressure']}/"
                  f"{rec['cg_iterations']['mechanics']}/"
                  f"{rec['cg_iterations']['projection']} "
                  f"err={rec['pressure_error']:.3e} "
                  f"wall={wall_s*1e3:.1f}ms", file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
