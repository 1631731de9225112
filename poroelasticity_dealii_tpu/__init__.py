"""poroelasticity_dealii_tpu — a matrix-free Biot poroelasticity framework
in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
``ishovkun/poroelasticity-dealii`` reference solver (a serial C++/deal.II
finite-element code for quasi-static Biot poroelasticity with fixed-stress
operator splitting; see reference ``lib/include/PoroelasticityFSS.h``).

Architecture (array-first, not a translation):

* immutable SoA mesh / DOF arrays (``mesh``),
* batched per-element quadrature kernels producing element operators
  (``ops``), applied matrix-free via gather -> batched matvec (GEMM) ->
  ``segment_sum`` scatter,
* preconditioned CG and the fixed-stress-split outer loop compiled as
  ``lax.while_loop``s running entirely on the device (``solvers``),
* multi-device domain decomposition as GSPMD element sharding with
  collective reduction of interface DOFs (``parallel``),
* host-side time loop, deck-compatible config, VTK output, logging and
  checkpointing (``utils``, ``models``).
"""

from .config import InputData, read_input_file, parse_deck  # noqa: F401

__version__ = "0.1.0"
