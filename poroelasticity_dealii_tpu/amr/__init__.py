"""Adaptive mesh refinement (2D quadtree / 3D octree).

Accelerator re-design of the reference's AMR pipeline
(``PoroelasticityFSS.h:448-498``): Kelly error estimation on the pressure
solution, fixed-*error*-fraction refine/coarsen marking with level clamps,
1-irregular quadtree conformity, hanging-node constraints for the Q1/Q2
spaces, and nodal solution transfer of {p, eps_v, eps_v0}.

Dynamic shapes are fundamentally at odds with XLA's compile-once model, so
AMR is organized as: host-side remesh (this package, numpy) -> rebuild the
Discretization -> recompile the jitted step for the new static shapes.  The
performance-critical configs (BASELINE.json) use uniform meshes; AMR exists
for capability parity with the reference and runs at CPU-problem scales.
"""

from .forest import QuadForest  # noqa: F401
from .kelly import kelly_estimate, kelly_estimate_3d  # noqa: F401
from .octforest import OctForest  # noqa: F401
from .transfer import transfer_nodal  # noqa: F401
