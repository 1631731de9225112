"""Resident-layout operators (3D rows, 2D parity) == the conv/stencil
reference, through ops/crosscheck.py: small sizes on the CPU, production
sizes on the GPU (``gpu`` marker; skips elsewhere)."""

import pytest

from poroelasticity_dealii_tpu.config import read_input_file
from poroelasticity_dealii_tpu.ops.crosscheck import (TOLERANCE,
                                                      operator_cases)

DECKS = {3: "configs/consolidation_3d.data", 2: "configs/golden_2d.data"}


def _check(dim, n, dtype):
    cases = operator_cases(read_input_file(DECKS[dim]), n, dtype)
    assert len(cases) == 3
    for case in cases:
        err = case.rel_error()
        assert err < TOLERANCE[dtype], (case.name, err)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dim,n", [(3, 4), (2, 8)])
def test_resident_operators_match_reference(dim, n, dtype):
    _check(dim, n, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dim,n", [(3, 40), (2, 512)])
def test_resident_operators_match_reference_on_gpu(gpu, dim, n, dtype):
    _check(dim, n, dtype)
