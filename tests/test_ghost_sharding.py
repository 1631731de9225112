"""Interface-scaled (ghost-exchange) domain decomposition tests.

The psum element-shard path moves O(n_dofs) bytes per operator apply;
the ghost path must move O(interface).  Three tiers:

* operator-apply and full-FSS-step equality, 1 vs 8 shards;
* an HLO audit proving the CG loop body's collectives are halo-sized
  ppermutes + scalar all-reduces (no full-vector all-gather/all-reduce);
* a weak-scaling assertion: collective bytes per apply grow with the
  interface (n^2), not the volume (n^3).
"""

import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from poroelasticity_dealii_tpu.config import read_input_file
from poroelasticity_dealii_tpu.mesh import hyper_rectangle
from poroelasticity_dealii_tpu.parallel import (make_device_mesh,
                                                renumber_discretization,
                                                shard_discretization_ghost)
from poroelasticity_dealii_tpu.solvers import (FixedStressSolver,
                                               build_discretization)

GOLDEN = "configs/golden_2d.data"

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

_DTYPE_BYTES = {"f32": 4, "f64": 8, "u32": 4, "s32": 4, "pred": 1}


def _collectives_by_computation(hlo: str):
    """{computation_name: [(kind, nbytes), ...]} from an HLO text dump."""
    out = {}
    cur = "?"
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\([^)]*\)\s*->", line)
        if m and line.rstrip().endswith("{"):
            cur = m.group(1)
        m = re.search(
            r"= (\w+)\[([\d,]*)\][^\n]*?"
            r"(all-gather|all-reduce|collective-permute|all-to-all|"
            r"reduce-scatter)", line)
        if m:
            dt, shape_s, kind = m.groups()
            n = 1
            for tok in shape_s.split(","):
                if tok:
                    n *= int(tok)
            out.setdefault(cur, []).append((kind, n * _DTYPE_BYTES.get(dt, 4)))
    return out


def _loop_body_collectives(hlo: str):
    """Collectives of the computation(s) that contain the halo ppermutes
    (the CG loop body), as [(kind, bytes)]."""
    per = _collectives_by_computation(hlo)
    found = []
    for name, cols in per.items():
        if any(k == "collective-permute" for k, _ in cols):
            found.extend(cols)
    return found


# --------------------------------------------------------------- 2D tier --

@pytest.fixture(scope="module")
def setup2d():
    data = read_input_file(GOLDEN)
    mesh = hyper_rectangle(data.domain_size, 3)
    disc = build_discretization(mesh, data)
    rdisc, order_p, order_udof = renumber_discretization(disc)
    gdisc = shard_discretization_ghost(disc, make_device_mesh(8))
    return data, rdisc, gdisc


def test_renumbering_is_a_permutation(setup2d):
    _, rdisc, gdisc = setup2d
    for order, n in ((gdisc.order_p, rdisc.n_pdofs),
                     (gdisc.order_udof, rdisc.n_udofs)):
        assert sorted(order.tolist()) == list(range(n))


def test_ghost_operator_applies_match(setup2d):
    data, rdisc, gdisc = setup2d
    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.standard_normal(rdisc.n_pdofs))
    u = jnp.asarray(rng.standard_normal(rdisc.n_udofs))
    np.testing.assert_allclose(gdisc.mass(p), rdisc.mass(p), rtol=1e-13)
    np.testing.assert_allclose(gdisc.laplace(p), rdisc.laplace(p),
                               rtol=1e-12, atol=1e-13)
    ref = rdisc.elasticity(u)
    np.testing.assert_allclose(gdisc.elasticity(u), ref, rtol=1e-12,
                               atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(gdisc.coupling_rhs(p, data.biot_coef),
                               rdisc.coupling_rhs(p, data.biot_coef),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(gdisc.strain_projection_rhs(u),
                               rdisc.strain_projection_rhs(u),
                               rtol=1e-12, atol=1e-13)


def test_ghost_full_time_step_1_vs_8(setup2d):
    data, rdisc, gdisc = setup2d
    s1 = FixedStressSolver(rdisc, data)
    s8 = FixedStressSolver(gdisc, data)
    st1, st8 = s1.initial_state(), s8.initial_state()
    np.testing.assert_allclose(np.asarray(st8.u), np.asarray(st1.u),
                               atol=1e-14)
    a1, t1 = s1.time_step(st1, data.time_step)
    a8, t8 = s8.time_step(st8, data.time_step)
    assert int(t1.fss_iterations) == int(t8.fss_iterations)
    assert int(t1.pressure_iterations) == int(t8.pressure_iterations)
    np.testing.assert_allclose(np.asarray(a8.p), np.asarray(a1.p),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(a8.u), np.asarray(a1.u),
                               atol=1e-13)


# ------------------------------------------------------ weak scaling tier --

def _ghost_3d(cells):
    data = read_input_file(GOLDEN)
    data = dataclasses.replace(
        data, dim=3, domain_size=(10.0, 10.0, 10.0),
        displacement_boundary_labels=(0, 1, 2, 3, 4, 5),
        displacement_boundary_components=(0, 0, 1, 1, 2, 2),
        displacement_boundary_values=(0, -1e-5, 0, -1e-5, 0, -1e-5))
    mesh = hyper_rectangle((10.0, 10.0, 10.0), cells_per_axis=cells)
    disc = build_discretization(mesh, data)
    return shard_discretization_ghost(disc, make_device_mesh(8))


def _cg_loop_hlo(gdisc):
    def cg5(b):
        x = jnp.zeros_like(b)
        r = b
        p = r
        rs = jnp.vdot(r, r)

        def body(i, c):
            x, r, p, rs = c
            ap = gdisc.elasticity(p)
            alpha = rs / jnp.vdot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            rs2 = jnp.vdot(r, r)
            return x, r, r + (rs2 / rs) * p, rs2

        return jax.lax.fori_loop(0, 5, body, (x, r, p, rs))[0]

    return jax.jit(cg5).lower(
        jnp.zeros(gdisc.n_udofs, gdisc.dtype)).compile().as_text()


def test_cg_loop_collectives_are_interface_only():
    """Inside the CG loop: only halo-sized ppermutes and scalar
    all-reduces — never a full-vector gather or reduce."""
    g = _ghost_3d(8)
    body = _loop_body_collectives(_cg_loop_hlo(g))
    assert body, "no collectives found in the loop body"
    itemsize = jnp.dtype(g.dtype).itemsize
    for kind, nbytes in body:
        if kind == "collective-permute":
            assert nbytes <= g.H_u * itemsize, (kind, nbytes)
        elif kind == "all-reduce":
            assert nbytes <= 8, (kind, nbytes)     # scalar dots
        else:
            raise AssertionError(f"unexpected collective {kind} in loop body")


def test_weak_scaling_collective_bytes():
    """Doubling the grid (volume x8, interface x~4) must grow loop-body
    collective bytes by the interface factor, not the volume factor."""
    sizes = (8, 16)
    byt = []
    h_ratio = None
    gs = [_ghost_3d(c) for c in sizes]
    h_ratio = gs[1].H_u / gs[0].H_u
    for g in gs:
        body = _loop_body_collectives(_cg_loop_hlo(g))
        byt.append(sum(b for k, b in body if k == "collective-permute"))
    ratio = byt[1] / byt[0]
    vol_ratio = gs[1].n_udofs / gs[0].n_udofs          # ~7.3
    assert ratio == pytest.approx(h_ratio, rel=0.01)
    assert ratio < 0.75 * vol_ratio, (ratio, vol_ratio)
    # and the psum path, for contrast, moves >= the full vector per apply
    # (documented O(n) behavior this module replaces) — sanity-check the
    # interface path is actually cheaper than one vector
    assert byt[1] < gs[1].n_udofs * jnp.dtype(gs[1].dtype).itemsize
