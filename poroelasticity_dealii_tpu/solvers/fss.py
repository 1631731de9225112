"""Fixed-stress-split coupled Biot solver — the framework's flagship driver.

Accelerator re-design of the reference's ``PoroElasticProblem::run()``
(``PoroelasticityFSS.h:295-415``): the entire time step — pressure inner
iterations, both CG solves, the strain projection and the convergence checks
— is ONE jit-compiled function of device arrays, with the FSS outer loop and
the pressure inner loop as nested ``lax.while_loop``s.  The host only steps
time, logs, and writes output.

Semantics replicated exactly (SURVEY §2.1 quirks, deliberate):

* The volumetric strain evolves ONLY through the fixed-stress predictor
  ``eps_v += (b/K) * delta_p`` (``PoroElasticPressureSolver.h:187-194``); it
  is never resynchronized from the displacement solution during FSS
  (``PoroelasticityFSS.h:399`` is commented out in the reference).
* ``initial_volumetric_strain`` is the t=0 projection, fixed for all time
  (``PoroelasticityFSS.h:316-317``).
* The pressure inner loop warm-starts each CG from the previous update and
  resets the update to zero once per FSS iteration
  (``PoroelasticityFSS.h:356-384``).
* Normal-strain components are re-projected every FSS iteration, shear
  components once per time step after convergence (``:398, :409``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple


import jax
import jax.numpy as jnp
import numpy as np

from ..config import InputData
from ..ops.operators import SHEAR_ENTRIES, VOIGT_PAIRS, VOLUMETRIC_ENTRIES
from .cg import cg_solve, cg_solve_batched
from .discretization import Discretization

# reference defaults live in config.InputData: mech CG abs 1e-12
# (PoroElasticDisplacementSolver.h:298), pressure/projection CG rel 1e-8
# (PoroElasticPressureSolver.h:175, StrainProjector.h:209), 1000 iters
# (SolverControl(1000, ...) everywhere); all overridable per deck for
# float32 runs.


# CI plumbing for the XLA:CPU in-process-communicator deadlock lives in
# utils/backend_quirks.py (no-op on accelerators and single-device backends)
from ..utils.backend_quirks import \
    no_persistent_cache_for_cpu_collectives as \
    _no_persistent_cache_for_cpu_collectives  # noqa: E402


class StepStats(NamedTuple):
    """Per-time-step convergence record (the observability the reference
    only ever printed to stdout; SURVEY §5 metrics row)."""
    fss_iterations: jnp.ndarray        # int32
    pressure_error: jnp.ndarray        # final FSS residual norm
    pressure_iterations: jnp.ndarray   # total inner pressure solves
    pressure_cg_iterations: jnp.ndarray
    mech_cg_iterations: jnp.ndarray
    projection_cg_iterations: jnp.ndarray
    fss_error_history: jnp.ndarray     # (max_fss,) padded with -1
    cg_converged: jnp.ndarray = True   # False if ANY linear solve ended
    #                                    before tolerance (the reference
    #                                    throws from deal.II SolverControl)
    cg_stalled: jnp.ndarray = False    # True if a non-converged solve ended
    #                                    on the stagnation early-exit (f32
    #                                    floor) rather than the iteration cap


def _refined_inner(solve32, dtype):
    """Mixed-precision refinement inner wrapper shared by the mechanics,
    mass and pressure solves: normalize the f64 residual to unit norm
    (guarding r == 0), solve in f32, rescale back.  ``solve32``:
    f32 unit-norm rhs -> f32 solution."""
    def inner(r):
        s = jnp.linalg.norm(r)
        safe = jnp.where(s > 0, s, 1.0)
        x32 = solve32((r / safe).astype(jnp.float32))
        return x32.astype(dtype) * safe
    return inner


def _rows_ready(ro) -> bool:
    """True when the full row-residency path is available: resident apply
    + rows-direct coupling AND projection RHS (one source of truth for the
    trace-time branch in _mechanics_solve and _time_step_impl)."""
    return (ro is not None and ro.coupling_rows is not None
            and ro.projection_rows is not None)


class State(NamedTuple):
    """Minimal restart state (what the reference's SolutionTransfer carries
    across mesh changes, PoroelasticityFSS.h:474-497, plus u and strains)."""
    p: jnp.ndarray        # pressure (n_pdofs,)
    u: jnp.ndarray        # displacement (n_udofs,); None after a
    #                       want_u=False rows-path step (recover with
    #                       FixedStressSolver.materialize_u)
    eps_v: jnp.ndarray    # volumetric strain (n_pdofs,)
    eps_v0: jnp.ndarray   # initial volumetric strain (n_pdofs,)
    strains: jnp.ndarray  # (n_voigt, n_pdofs) projected strain components
    # derived cache, NOT part of the restart vector (checkpoints omit it;
    # None -> recomputed on first use): u in the comp-major row layout,
    # carried across steps so the mechanics warm start skips a to_rows
    # transpose.  A stale value only costs CG iterations, never
    # correctness (constrained rows are overwritten from the bc pattern).
    u_rows: jnp.ndarray = None
    # derived cache: the last mechanics RHS (constrained form).  When the
    # freshly assembled RHS is BITWISE identical (quasi-static tail steps:
    # p stops changing, so the deterministic assembly reproduces it
    # exactly), the mechanics solve is skipped — u already solves the
    # system to the previously achieved residual (roadmap lever "skip the
    # mechanics re-solve when the coupling RHS is unchanged").
    mech_b: jnp.ndarray = None


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash so
class FixedStressSolver:                        # jit static_argnums=0 caches
    """Owns the jitted step functions for one Discretization + InputData."""

    disc: Discretization
    data: InputData

    def __post_init__(self):
        # K̂(dirichlet_values), computed once at construction (outside any
        # trace).  Inside jit this conv chain on constants would either be
        # constant-folded by XLA at enormous compile cost or recomputed per
        # solve; by linearity the bc_scale-dependent lift is just
        # ``bc_scale * lift``.
        d = self.disc
        k_hat = d._hcu.constrained(d.elasticity)
        # under jit so sharding-constrained (GSPMD) applies accept uneven
        # grid dimensions (the eager path enforces divisibility)
        lift = jax.jit(k_hat)(d.dirichlet_values)
        object.__setattr__(self, "_elasticity_lift",
                           jax.block_until_ready(lift))
        # row-layout constants for the direct-rows mechanics RHS (skips
        # the to_rows transpose of b_mod AND the Q2 coupling scatter conv)
        ro = getattr(d, "row_ops", None)
        if ro is not None and ro.coupling_rows is not None:
            object.__setattr__(self, "_lift_rows", ro.to_rows(lift))
            object.__setattr__(self, "_f_neumann_rows",
                               ro.to_rows(d.f_neumann))
            object.__setattr__(self, "_dirichlet_rows",
                               jax.block_until_ready(
                                   ro.to_rows(d.dirichlet_values)))

    # ---------------- mixed-precision refinement ----------------------------

    def _mixed_precision_inner(self):
        """f32 inner mechanics solve used as the preconditioner of an f64
        Richardson outer loop (classical iterative refinement): each outer
        pass computes the TRUE f64 residual r = b - A64 x, solves
        A32 d = r/||r|| entirely in f32 (the row-layout CG when available),
        and corrects x += ||r|| d — contracting the f64 residual by the
        inner tolerance (~1e-5) per pass, so reference tolerances
        (1e-8..1e-12 relative) are reached in 2-3 passes at f32 solve
        speed.  Pays off only where f64 arithmetic is much slower than
        f32.

        Built once (host-side; called from the time_step/initial_state
        wrappers BEFORE tracing).  Returns the precond callable or None
        when disabled/ineligible.  Deck value 'on' enables it; 'auto' and
        'off' leave it off (native-f64 devices gain nothing from an f32
        detour)."""
        if "_ir_inner" in self.__dict__:
            return self.__dict__["_ir_inner"]
        d, data = self.disc, self.data
        inner = None
        mode = getattr(data, "mixed_precision_refinement", "auto")
        enabled = mode == "on"
        from .structured import ConvGridDiscretization
        if (enabled and d.dtype == jnp.float64
                and isinstance(d, ConvGridDiscretization)
                and getattr(d, "wrap_pressure_stencil", None) is None):
            from .structured import build_grid_discretization
            data32 = dataclasses.replace(data, dtype="float32")
            verts = d.pressure_space.mesh.vertices
            disc32 = build_grid_discretization(
                data32, cells_per_axis=d.info_u.cells_per_axis,
                pressure_degree=d.info_p.degree,
                displacement_degree=d.info_u.degree,
                lower=verts.min(axis=0), upper=verts.max(axis=0),
                multigrid="off",
                elasticity_backend=data.elasticity_backend)
            ro32 = getattr(disc32, "row_ops", None)
            # inner tolerance: safely above the f32 Jacobi-CG attainable
            # floor (the rhs is normalized to unit norm, so this is
            # relative); each outer pass contracts by ~this factor
            itol = jnp.float32(1e-5)
            cap = data.cg_max_iterations
            if ro32 is not None:
                z0 = jnp.zeros_like(ro32.diag_rows)
                bp32 = (ro32.block_precond
                        if getattr(data, "mech_precond", "jacobi") == "block"
                        else None)
                inner = _refined_inner(
                    lambda r32: ro32.from_rows(cg_solve(
                        ro32.constrained_apply, ro32.to_rows(r32), z0,
                        ro32.diag_rows, tol=itol, max_iter=cap,
                        apply_iter=ro32.free_apply,
                        precond=bp32, flexible=False).x), d.dtype)
            else:
                z0 = jnp.zeros((disc32.n_udofs,), jnp.float32)
                inner = _refined_inner(
                    lambda r32: cg_solve(
                        disc32.elasticity_constrained, r32, z0,
                        disc32.diag_elasticity, tol=itol,
                        max_iter=cap).x, d.dtype)

            # same-scheme inner for the strain projection's mass solves
            mass32 = disc32._hcp.constrained(disc32.mass)
            zp = jnp.zeros((disc32.n_pdofs,), jnp.float32)
            inner_mass = _refined_inner(
                lambda r32: cg_solve(mass32, r32, zp, disc32.diag_mass,
                                     tol=itol, max_iter=cap).x, d.dtype)
            object.__setattr__(self, "_ir_mass", inner_mass)
            object.__setattr__(self, "_ir_disc32", disc32)
        object.__setattr__(self, "_ir_inner", inner)
        return inner

    def _ir_pressure(self, dt):
        """Per-dt f32 inner pressure solve (fused f32 Jacobian stencil +
        f32 GMG V-cycle of a twin solver) for f64 refinement; host-side
        build, cached — returns the precond callable or None."""
        if not isinstance(dt, (int, float)):
            return None
        cache = self.__dict__.setdefault("_ir_press", {})
        if dt in cache:
            return cache[dt]
        disc32 = self.__dict__.get("_ir_disc32")
        if disc32 is None:
            cache[dt] = None
            return None
        solver32 = self.__dict__.get("_ir_solver32")
        if solver32 is None:
            data32 = dataclasses.replace(self.data, dtype="float32")
            solver32 = FixedStressSolver(disc32, data32)
            object.__setattr__(self, "_ir_solver32", solver32)
        solver32._fused_jacobian_stencil(dt)     # eager per-dt caches
        pre32 = solver32._pressure_precond(dt)
        diag32 = solver32._pressure_jacobian_diag(dt)
        itol = jnp.float32(1e-5)
        cap = self.data.cg_max_iterations
        zp = jnp.zeros((disc32.n_pdofs,), jnp.float32)
        dtype = self.disc.dtype

        inner = _refined_inner(
            lambda r32: cg_solve(
                lambda x: solver32._pressure_jacobian_apply(x, dt),
                r32, zp, diag32, tol=itol, max_iter=cap,
                precond=pre32).x, dtype)
        cache[dt] = inner
        return inner

    def _ir_press_for(self, dt):
        """Tracer-safe ``_ir_press`` cache lookup.  A TRACED dt (e.g. the
        jitted ``__graft_entry__.entry()`` step takes dt as an argument)
        is unhashable and can never have a cache entry anyway — the host
        warm only populates Python-number dts."""
        if not isinstance(dt, (int, float)):
            return None
        return self.__dict__.get("_ir_press", {}).get(dt)

    # ---------------- pressure system pieces -------------------------------

    def _pressure_residual(self, p, p_old, eps_v, eps_v0, dt):
        """Negated Biot flow residual (PoroElasticPressureSolver.h:113-155):
        -[ M ((b/dt)(eps_v - eps_v0) + (p - p_old)/(M_biot dt)) + (k/mu) L p
           + F_well ], restricted to free pressure dofs (drainage-BC rows are
        constrained — an extension over the reference)."""
        d, data = self.disc, self.data
        acc = (data.biot_coef / dt) * (eps_v - eps_v0) \
            + (1.0 / data.m_modulus / dt) * (p - p_old)
        res = (d.mass(acc) + (data.perm / data.visc) * d.laplace(p)
               + d.f_well)
        # hanging-row condensation (constraints.condense(residual), :153)
        return d._hcp.condense_vec(-res) * d.free_mask_p

    def _pressure_jacobian_apply(self, x, dt):
        d, data = self.disc, self.data
        fused = self._fused_jacobian_stencil(dt)
        if fused is not None:
            base = fused          # ONE conv pair instead of two
        else:
            def base(z):
                return (1.0 / data.m_modulus / dt) * d.mass(z) \
                    + (data.perm / data.visc) * d.laplace(z)
        hat = d._hcp.constrained(base)
        xm = x * d.free_mask_p
        y = hat(xm)
        return y * d.free_mask_p + x * (1.0 - d.free_mask_p)

    def _pressure_precond(self, dt):
        """GMG V-cycle for the pressure Jacobian (conv backend + static dt
        only); None -> caller falls back to Jacobi."""
        if not isinstance(dt, (int, float)):
            return None       # traced dt: unhashable, and the hierarchy
            #                   must not be built inside a trace anyway
        from .structured import ConvGridDiscretization, _gmg_levels
        d, data = self.disc, self.data
        if not isinstance(d, ConvGridDiscretization):
            return None
        if not d.info_p.isotropic:
            return None       # V-cycle hierarchy needs equal cells per axis
        n = d.info_p.cells_per_axis[0]
        n_levels = _gmg_levels(n, d.dim, d.n_pdofs, "auto",
                               auto_threshold=30_000, degree=d.info_p.degree,
                               n_comp=1)
        if n_levels < 2:
            return None
        cache = self.__dict__.setdefault("_p_gmg", {})
        if dt not in cache:
            import jax.lax as lax

            from .multigrid import build_gmg_pressure
            mesh = d.pressure_space.mesh
            lo = mesh.vertices.min(axis=0)
            hi = mesh.vertices.max(axis=0)
            # smoothers at default matmul precision in f32 runs (TF32 on
            # GPUs that have it): the V-cycle only needs to approximate
            # A^{-1}; the outer CG operator stays at HIGHEST precision
            sp = (lax.Precision.DEFAULT if d.dtype == jnp.float32
                  else lax.Precision.HIGHEST)
            precond, _ = build_gmg_pressure(
                data, n_fine=n, n_levels=n_levels, dtype=d.dtype, dt=dt,
                pressure_degree=d.info_p.degree, lower=lo, upper=hi,
                smoother_precision=sp)
            cache[dt] = precond
        return cache[dt]

    def _fused_jacobian_stencil(self, dt):
        """Pressure Jacobian (mass/(M dt) + (k/mu) L) folded into a single
        conv stencil — possible on the conv backend when dt is a static
        Python number (it is: the deck's fixed time step)."""
        if not isinstance(dt, (int, float)):
            return None
        from .structured import ConvGridDiscretization
        d, data = self.disc, self.data
        if not isinstance(d, ConvGridDiscretization):
            return None
        cache = self.__dict__.setdefault("_jac_stencils", {})
        if dt not in cache:
            from ..ops.stencil import make_stencil_apply
            from ..ops import dense
            from .structured import _single_cell_spaces
            n = d.info_p.cells_per_axis
            verts = d.pressure_space.mesh.vertices
            span = verts.max(axis=0) - verts.min(axis=0)
            _, sp1, _ = _single_cell_spaces(data, n, d.info_p.degree,
                                            d.info_u.degree, span=span)
            Me = dense.mass_element_matrices(sp1)[0]
            Le = dense.laplace_element_matrices(sp1)[0]
            J = Me / (data.m_modulus * dt) + (data.perm / data.visc) * Le
            kp = d.info_p.degree
            st = make_stencil_apply(J, kp, kp, 1, 1, d.dim, n, d.dtype)
            wrap = getattr(d, "wrap_pressure_stencil", None)
            if wrap is not None:    # sharded path: GSPMD slab constraint
                st = wrap(st)
            cache[dt] = st
        return cache[dt]

    def _pressure_jacobian_diag(self, dt):
        d, data = self.disc, self.data
        diag = (1.0 / data.m_modulus / dt) * d.diag_mass \
            + (data.perm / data.visc) * d.diag_laplace
        return jnp.where(d.free_mask_p > 0, diag,
                         jnp.ones((), d.dtype))

    # ---------------- mechanics solve ---------------------------------------

    def _mechanics_solve(self, p, u_warm, bc_scale=1.0, u_warm_rows=None,
                         b_prev=None):
        """Elasticity solve with pressure-coupling RHS + traction + Dirichlet
        (PoroElasticDisplacementSolver.h:155-307).  Body force follows the
        reference's effective default: zero (gravity quirk, SURVEY §2.1.2).

        ``bc_scale`` (traced scalar) scales the Dirichlet value pattern —
        time-dependent loading (e.g. Mandel's rigid plate) without
        recompiling.

        ``b_prev`` (optional, traced): the previous constrained RHS.  When
        the new RHS is BITWISE identical (quasi-static tail: p stopped
        changing, the deterministic assembly reproduces b exactly), the
        solve is skipped — the warm start IS the solution of that
        identical system — by lifting the CG tolerance to +inf, so the
        while_loop exits after the initial residual check (0 iterations,
        one operator apply).  Exact equality means zero behavioral risk:
        any real update changes at least one bit of b.  (A lax.cond
        around the solve was tried first and hit a deterministic XLA:CPU
        compiler segfault on the cond(while(while)) nesting inside the
        FSS loop; the tolerance lift expresses the same thing with no
        extra control flow.)

        Returns ``(u_flat_or_None, iters, converged, stalled, u_rows, b)``.
        """
        d, data = self.disc, self.data
        row_ops = getattr(d, "row_ops", None)

        def maybe_solve(b, x0, solve):
            if b_prev is None:
                res = solve(b, x0, None)
            else:
                res = solve(b, x0, jnp.all(b == b_prev))
            return res.x, res.iterations, res.converged, \
                jnp.asarray(res.stalled)

        def skip_tol(tol, unchanged):
            if unchanged is None:
                return tol
            return jnp.where(unchanged, jnp.asarray(jnp.inf, d.dtype), tol)

        if _rows_ready(row_ops):
            # fully-in-rows RHS assembly (conforming structured grid: the
            # hanging-node maps are empty): coupling scatters straight into
            # the row layout and b_mod never exists flat — saves the Q2
            # scatter conv + one to_rows transpose per solve
            m = row_ops.free_mask_rows
            rhs_rows = row_ops.coupling_rows(p) + self._f_neumann_rows
            b_rows = m * (rhs_rows - bc_scale * self._lift_rows) \
                + (1.0 - m) * (bc_scale * self._dirichlet_rows)
            warm_rows = (u_warm_rows if u_warm_rows is not None
                         else row_ops.to_rows(u_warm))
            x0_rows = m * warm_rows \
                + (1.0 - m) * (bc_scale * self._dirichlet_rows)

            # node-block (3x3) Jacobi when available: couples each node's
            # displacement components through the inverted diagonal block
            # of the constrained operator — a FIXED SPD preconditioner, so
            # flexible=False keeps the 2-dots-per-iteration update.  It
            # preserves the free-subspace invariant (identity blocks at
            # constrained nodes), so the v4 apply_iter stays valid.
            bp = (row_ops.block_precond
                  if getattr(data, "mech_precond", "jacobi") == "block"
                  else None)
            # 2D parity path: GMG V-cycle with parity-resident smoothers
            # (structured.py builds it — 2D production sizes are ~10x more
            # cells per axis than 3D, so Jacobi row-CG alone hits the
            # iteration cap; preconditioned Richardson for the same
            # f32 p.Ap-noise reason as the flat GMG path below)
            gmg_rows = getattr(d, "gmg_precond_rows", None)

            def solve(b, x0, unchanged):
                tol = jnp.asarray(data.mech_cg_tol, d.dtype)
                if data.mech_cg_relative:
                    tol = tol * jnp.linalg.norm(b)
                if gmg_rows is not None:
                    if d.dtype == jnp.float32:
                        # f32 + strong operator preconditioner: Richardson
                        # (same p.Ap-noise rationale as the flat GMG path
                        # below)
                        from .cg import richardson_solve
                        return richardson_solve(row_ops.constrained_apply,
                                                b, x0, gmg_rows,
                                                skip_tol(tol, unchanged),
                                                data.cg_max_iterations)
                    # f64: preconditioned CG.  NOT Richardson — the
                    # reference's absolute tolerances (1e-12) sit below
                    # the f64 TRUE-residual floor of b - A x (~1e-8 at
                    # GPa stiffness scales), which deal.II's SolverCG
                    # never sees because it checks the RECURRED residual;
                    # cg_solve matches those semantics, while Richardson
                    # recomputes the true residual and honestly stalls.
                    return cg_solve(row_ops.constrained_apply, b, x0,
                                    row_ops.diag_rows,
                                    tol=skip_tol(tol, unchanged),
                                    max_iter=data.cg_max_iterations,
                                    precond=gmg_rows)
                # per-iteration applies use the free-subspace apply
                # (m*A(p), no input mask): b/x0 carry the Dirichlet values
                # so every CG direction is exactly zero at constrained
                # rows — bitwise-equal solve, one mask pass cheaper/iter
                return cg_solve(row_ops.constrained_apply, b, x0,
                                row_ops.diag_rows,
                                tol=skip_tol(tol, unchanged),
                                max_iter=data.cg_max_iterations,
                                apply_iter=row_ops.free_apply,
                                precond=bp, flexible=False)

            x, it, ok, st = maybe_solve(b_rows, x0_rows, solve)
            # u stays in rows — NO from_rows here: the projection RHS also
            # reads rows (projection_rows), so the flat layout is
            # materialized exactly once per step, at the State boundary
            return (None, it, ok, st, x, b_rows)
        rhs = d._hcu.condense_vec(
            d.coupling_rhs(p, data.biot_coef) + d.f_neumann)
        g = d.dirichlet_values * bc_scale
        b_mod = d.free_mask_u * (rhs - bc_scale * self._elasticity_lift) \
            + (1.0 - d.free_mask_u) * g
        apply = d.elasticity_constrained
        x0 = d._hcu.zero_hanging(
            d.free_mask_u * u_warm + (1.0 - d.free_mask_u) * g)
        precond = getattr(d, "gmg_precond", None)  # multigrid when available
        ir = self.__dict__.get("_ir_inner")  # built by the host wrappers

        def solve(b, x0, unchanged):
            tol = jnp.asarray(data.mech_cg_tol, d.dtype)
            if data.mech_cg_relative:
                tol = tol * jnp.linalg.norm(b)
            tol = skip_tol(tol, unchanged)
            if ir is not None:
                # f64 via mixed-precision iterative refinement: Richardson
                # whose preconditioner is a full f32 inner solve on the
                # normalized residual (see _mixed_precision_inner) — each
                # pass costs ONE f64 operator apply + one f32 CG,
                # contracting ~1e-5/pass; reference tolerances land in
                # 2-3 passes.
                from .cg import richardson_solve
                return richardson_solve(apply, b, x0, ir, tol,
                                        max_iter=30)
            if row_ops is not None:
                # resident-layout path FIRST: the WHOLE CG runs in the
                # row layout (dots/axpys/masks are layout-exact — see
                # ops/rows3d.ElasticityRowOps); layout conversions happen
                # once per solve, not once per operator apply.
                res = cg_solve(row_ops.constrained_apply,
                               row_ops.to_rows(b), row_ops.to_rows(x0),
                               row_ops.diag_rows, tol=tol,
                               max_iter=data.cg_max_iterations)
                return res._replace(x=row_ops.from_rows(res.x))
            if precond is not None and d.dtype == jnp.float32:
                # f32 + strong operator preconditioner: CG's p·Ap is
                # dominated by the operator apply's forward-error noise
                # (docs/VALIDATION "known limitations"); preconditioned
                # Richardson has no quadratic forms and contracts at the
                # V-cycle rate.
                from .cg import richardson_solve
                return richardson_solve(apply, b, x0, precond, tol,
                                        data.cg_max_iterations)
            return cg_solve(apply, b, x0, d.diag_elasticity,
                            tol=tol, max_iter=data.cg_max_iterations,
                            precond=precond)

        x, it, ok, st = maybe_solve(b_mod, x0, solve)
        return (d._hcu.distribute(x), it, ok, st, None, b_mod)

    # ---------------- strain projection -------------------------------------

    def _projection_rhs(self, u, u_rows=None):
        """All-Voigt strain-projection RHS (n_voigt, n_pdofs).  When
        ``u_rows`` is given (production rows path), assembles directly
        from the comp-major row layout — the flat ``u`` is not touched
        (may be None)."""
        d = self.disc
        ro = getattr(d, "row_ops", None)
        if u_rows is not None and ro is not None \
                and ro.projection_rows is not None:
            return ro.projection_rows(u_rows)
        return d.strain_projection_rhs(u)

    def _project(self, u, entries, warm, u_rows=None, rhs_all=None):
        """L2-project selected Voigt strain components onto pressure space:
        one batched multi-RHS mass-matrix CG (StrainProjector.h:109-232).

        ``rhs_all`` lets callers reuse an already-assembled all-Voigt RHS
        (the FSS loop assembles it once per iteration; the end-of-step
        shear solve reuses the final iteration's — same ``u``)."""
        d = self.disc
        if rhs_all is None:
            rhs_all = self._projection_rhs(u, u_rows)
        rhs = rhs_all[jnp.asarray(entries)]
        rhs = jax.vmap(d._hcp.condense_vec)(rhs)
        tol = self.data.projection_cg_tol * jnp.linalg.norm(rhs, axis=1)
        mass_hat = d._hcp.constrained(d.mass)
        x0 = jax.vmap(d._hcp.zero_hanging)(warm)
        irm = self.__dict__.get("_ir_mass")
        if irm is not None:
            # f64 refinement, batched: vmapped Richardson whose precond is
            # a per-lane f32 mass CG (vmap runs the lanes lockstep — the
            # same structure cg_solve_batched gives the plain path)
            from .cg import richardson_solve
            res = jax.vmap(lambda bb, xx, tt: richardson_solve(
                mass_hat, bb, xx, irm, tt, 20))(rhs, x0, tol)
        else:
            res = cg_solve_batched(mass_hat, rhs, x0, d.diag_mass, tol,
                                   self.data.cg_max_iterations)
        x = jax.vmap(d._hcp.distribute)(res.x)
        return x, jnp.sum(res.iterations).astype(jnp.int32), \
            jnp.all(res.converged)

    # ---------------- initialization (PoroelasticityFSS.h:311-317) ----------

    def initial_state(self, bc_scale=1.0) -> State:
        """Host wrapper: builds the initial vectors as *device arrays* so
        the jitted body sees traced inputs — otherwise XLA constant-folds
        entire operator applies on the constant initial fields at huge
        compile cost."""
        d = self.disc
        self._mixed_precision_inner()   # host-side build before tracing
        p0 = jnp.full((d.n_pdofs,), self.data.p_init, d.dtype)
        u0 = jnp.zeros((d.n_udofs,), d.dtype)
        return self._initial_state_impl(p0, u0, bc_scale)

    @partial(jax.jit, static_argnums=0)
    def _initial_state_impl(self, p0, u0, bc_scale) -> State:
        d, data = self.disc, self.data
        dim = d.dim
        n_voigt = len(VOIGT_PAIRS[dim])
        p = p0 * d.free_mask_p + d.dirichlet_values_p * (1.0 - d.free_mask_p)
        u, _, _, _, u_rows, b0 = self._mechanics_solve(p, u0, bc_scale)
        if u is None:                      # rows path: one boundary convert
            u = d.row_ops.from_rows(u_rows)
        vol = VOLUMETRIC_ENTRIES[dim]
        warm = jnp.zeros((len(vol), d.n_pdofs), d.dtype)
        vol_strains, _, _ = self._project(u, vol, warm, u_rows=u_rows)
        strains = jnp.zeros((n_voigt, d.n_pdofs), d.dtype)
        strains = strains.at[jnp.asarray(vol)].set(vol_strains)
        eps_v = jnp.sum(vol_strains, axis=0)
        # mech_b = ZEROS (not b0): the first time step must re-solve
        # unconditionally (reference semantics); a zeros cache of the right
        # SHAPE keeps the State pytree structure identical before and after
        # the first step, so time_step compiles once, not twice
        return State(p=p, u=u, eps_v=eps_v, eps_v0=eps_v, strains=strains,
                     u_rows=u_rows, mech_b=jnp.zeros_like(b0))

    # ---------------- one full time step (jitted) ---------------------------

    def time_step(self, state: State, dt, bc_scale=1.0,
                  bc_scale_prev=None, want_u=True):
        """One Δt: FSS outer loop over (pressure inner loop, mechanics solve,
        normal-strain projection), then shear strains — all on-chip.
        ``bc_scale`` scales Dirichlet displacement values (traced);
        passing the previous step's ``bc_scale_prev`` enables the
        linear-superposition warm start (:meth:`_bc_response`).
        ``dt`` is static (one compile per distinct time step), which lets
        the pressure Jacobian fold into a single conv stencil.

        ``want_u`` (static): on the rows production path the displacement
        lives in the comp-major row layout for the whole step; the flat
        ``State.u`` exists only for host consumers (VTK, checkpoints,
        analytics).  ``want_u=False`` skips that ``from_rows`` transpose
        and returns ``u=None`` — call
        :meth:`materialize_u` at an output boundary to recover it.  On
        non-rows backends the flag is a no-op (``u`` is always returned).

        This host wrapper warms the per-dt caches (fused Jacobian stencil,
        pressure multigrid — their construction runs eager device code like
        power iterations that must not happen inside a trace)."""
        self._mixed_precision_inner()   # host-side build before tracing
        if isinstance(dt, (int, float)):
            self._fused_jacobian_stencil(dt)
            # when refinement supplies the f32 pressure inner, the f64
            # GMG hierarchy would be dead weight (pressure_inner's irp
            # branch never touches it) — skip its f64 build
            if self._ir_pressure(dt) is None:
                self._pressure_precond(dt)
        ro = getattr(self.disc, "row_ops", None)
        rows_active = _rows_ready(ro)
        if not rows_active:
            # want_u is a static jit arg but a no-op off the rows path —
            # clamp it so alternating values don't compile the identical
            # graph twice (VTK/checkpoint cadence flips it per step)
            want_u = True
        if rows_active:
            # normalize the input pytree: u_rows is the authoritative
            # layout through the step; dropping the (redundant) flat u
            # keeps ONE input structure regardless of whether the caller's
            # state came from initial_state (u set), a checkpoint (u set,
            # u_rows None) or a prior want_u=False step (u None)
            if state.u_rows is None:
                state = state._replace(u_rows=ro.to_rows(state.u))
            if state.u is not None:
                state = state._replace(u=None)
        if bc_scale_prev is not None and bc_scale_prev != bc_scale:
            # mechanics is linear, so du/d(bc_scale) is a fixed field:
            # superpose it onto the warm start and the mechanics CG only
            # works on the pressure-driven part of the update (host-side
            # pre-step; the jitted graph is unchanged)
            ds = bc_scale - bc_scale_prev
            if rows_active:
                # to_rows is linear: the response superposes in row layout
                cached = self.__dict__.get("_bc_response_rows")
                if cached is None:
                    cached = jax.block_until_ready(
                        ro.to_rows(self._bc_response()))
                    object.__setattr__(self, "_bc_response_rows", cached)
                state = state._replace(u_rows=state.u_rows + ds * cached)
            else:
                state = state._replace(
                    u=state.u + ds * self._bc_response())
        return self._time_step_impl(state, dt, bc_scale, want_u)

    def materialize_u(self, state: State) -> State:
        """Fill ``state.u`` from the row-layout cache after a
        ``want_u=False`` step (one transpose; no-op when already flat).

        Drains the state's async execution FIRST: on XLA:CPU with N
        in-process virtual devices, tracing/compiling from_rows on the
        main thread while a sharded scan is still executing starves the
        device threads mid-collective past the rendezvous termination
        timeout (~340 s) and ABORTS the process — observed
        deterministically as the 4-threads-at-op-76 / 4-at-op-112
        collective-permute split in the suite (tests/conftest.py notes).
        On an accelerator this costs one host sync at a State boundary
        where the caller is about to read the arrays anyway."""
        if state.u is not None:
            return state
        jax.block_until_ready(state.u_rows)
        return state._replace(
            u=self.disc.row_ops.from_rows(state.u_rows))

    # ---------------- fused multi-step (one dispatch for K steps) -----------

    def multi_step(self, state: State, dt, n_steps: int = None,
                   bc_scales=None, bc_scale_prev=None, want_u=False):
        """K time steps fused into ONE device dispatch: ``lax.scan`` over
        the jitted step body.  The host loop's per-step dispatch (Python
        wrapper + runtime enqueue) is paid once per BLOCK instead of once
        per step — for a settled quasi-static step of little device work
        that is the difference between dispatch-bound and device-bound
        throughput.  The reference has no analogue (its loop is a serial
        C++ while, ``PoroelasticityFSS.h:327-413``); this is the form of
        "the time loop is compiler-visible".

        ``bc_scales``: optional (K,) per-step Dirichlet scales (default
        all 1.0); ``bc_scale_prev`` enables the same linear-superposition
        mechanics warm start as :meth:`time_step`, applied in-graph per
        scanned step.  ``dt`` must be a static Python number (one compile
        per (dt, K) pair).  Returns ``(state, stats)`` with every
        :class:`StepStats` field stacked along a leading (K,) axis.
        Semantically identical to K :meth:`time_step` calls (tested);
        the trade-off is observability granularity: divergence/stall
        checks read the stacked stats after the block."""
        if not isinstance(dt, (int, float)):
            raise TypeError("multi_step requires a static (Python number) "
                            "dt — per-step traced dts defeat the per-dt "
                            "solver caches")
        if bc_scales is None:
            if n_steps is None:
                raise ValueError("pass n_steps or bc_scales")
            bc_scales = np.ones((n_steps,), float)
        bc_scales = np.asarray(bc_scales, float)
        prev = float(bc_scales[0]) if bc_scale_prev is None \
            else float(bc_scale_prev)
        ds = np.diff(np.concatenate([[prev], bc_scales]))
        self._mixed_precision_inner()   # host-side builds before tracing
        self._fused_jacobian_stencil(dt)
        if self._ir_pressure(dt) is None:
            self._pressure_precond(dt)
        d = self.disc
        ro = getattr(d, "row_ops", None)
        rows_active = _rows_ready(ro)
        # normalize the carry pytree ONCE so the scan carry structure is
        # stable: u_rows authoritative on the rows path (u dropped), mech_b
        # always an array (zeros == "first step must solve")
        if rows_active:
            if state.u_rows is None:
                state = state._replace(u_rows=ro.to_rows(state.u))
            if state.u is not None:
                state = state._replace(u=None)
            b_like = ro.free_mask_rows
        else:
            b_like = d.free_mask_u
        if state.mech_b is None:
            state = state._replace(mech_b=jnp.zeros_like(b_like))
        use_resp = bool(np.any(ds != 0.0))
        if use_resp:    # cache the response field host-side before tracing
            if rows_active and "_bc_response_rows" not in self.__dict__:
                object.__setattr__(self, "_bc_response_rows",
                                   jax.block_until_ready(
                                       ro.to_rows(self._bc_response())))
            elif not rows_active:
                self._bc_response()
        xs = (jnp.asarray(bc_scales, d.dtype), jnp.asarray(ds, d.dtype))
        with _no_persistent_cache_for_cpu_collectives():
            state, stats = self._multi_step_impl(state, dt, xs, use_resp)
        if want_u and rows_active:
            state = self.materialize_u(state)
        return state, stats

    @partial(jax.jit, static_argnums=(0, 2, 4))
    def _multi_step_impl(self, state: State, dt, xs, use_resp):
        ro = getattr(self.disc, "row_ops", None)
        rows_active = _rows_ready(ro)
        resp = None
        if use_resp:
            resp = (self.__dict__["_bc_response_rows"] if rows_active
                    else self.__dict__["_bc_response_cache"])

        def body(st, x):
            bc, dsi = x
            if resp is not None:
                if rows_active:
                    st = st._replace(u_rows=st.u_rows + dsi * resp)
                else:
                    st = st._replace(u=st.u + dsi * resp)
            # want_u=False on the rows path (u stays in rows across the
            # whole block; the carry structure has u=None)
            return self._time_step_impl(st, dt, bc, not rows_active)

        return jax.lax.scan(body, state, xs)

    def _bc_response(self):
        """du/d(bc_scale): the constrained elasticity solve against the
        unit-bc-pattern RHS, computed once (eager, cached).  Constrained
        rows carry the Dirichlet pattern itself, so a warm start
        ``u + Δs * response`` lands exactly on the new boundary values."""
        cached = self.__dict__.get("_bc_response_cache")
        if cached is not None:
            return cached
        d, data = self.disc, self.data
        b = d.free_mask_u * (-self._elasticity_lift) \
            + (1.0 - d.free_mask_u) * d.dirichlet_values
        # the response only seeds a warm start, so a few digits suffice;
        # 1e-8 relative sits below the f32 attainable floor of Jacobi-CG at
        # bench scale and would spin to max_iter (advisor round 2)
        rel = 1e-8 if d.dtype == jnp.float64 else 2e-6
        tol = rel * jnp.linalg.norm(b)
        row_ops = getattr(d, "row_ops", None)
        ir = self._mixed_precision_inner()   # host context: safe to build
        if ir is not None:
            # f64 with refinement on: 2-3 refinement passes instead of a
            # 5000-iteration f64 Jacobi-CG.
            # x0 carries the Dirichlet pattern so r0 = b - A x0 is zero at
            # constrained rows — the inner f32 rows CG iterates with
            # free_apply (zero on constrained rows) and could never reduce
            # a constrained residual component (it would spin to the cap
            # with polluted step scalars).
            from .cg import richardson_solve
            res = jax.jit(lambda bb: richardson_solve(
                d.elasticity_constrained, bb,
                (1.0 - d.free_mask_u) * bb, ir, tol, max_iter=30))(b)
            u_bc = res.x
        elif row_ops is not None:
            res = cg_solve(row_ops.constrained_apply, row_ops.to_rows(b),
                           row_ops.to_rows(jnp.zeros_like(b)),
                           row_ops.diag_rows, tol=tol, max_iter=5000)
            u_bc = row_ops.from_rows(res.x)
        else:
            res = jax.jit(lambda bb: cg_solve(
                d.elasticity_constrained, bb, jnp.zeros_like(bb),
                d.diag_elasticity, tol=tol, max_iter=5000))(b)
            u_bc = res.x
        u_bc = jax.block_until_ready(d._hcu.distribute(u_bc))
        object.__setattr__(self, "_bc_response_cache", u_bc)
        return u_bc

    @partial(jax.jit, static_argnums=(0, 2, 4))
    def _time_step_impl(self, state: State, dt, bc_scale=1.0, want_u=True):
        d, data = self.disc, self.data
        dim = d.dim
        vol = VOLUMETRIC_ENTRIES[dim]
        shear = SHEAR_ENTRIES[dim]
        p_old = state.p
        resync = data.resync_volumetric_strain
        # accumulation reference strain: the reference compares against the
        # t=0 strain for ALL time (PoroelasticityFSS.h:317 — quirk mode);
        # corrected mode uses the step-start strain (backward Euler).
        eps_v0 = state.eps_v if resync else state.eps_v0
        max_fss = data.max_fss_iterations
        max_press = data.max_pressure_iterations

        def pressure_inner(p, eps_v, delta_p):
            """Inner 'Newton' loop (PoroelasticityFSS.h:358-384):
            stationary iteration on the fixed-stress-stabilized linear flow
            system; the predictor eps_v += (b/K) dp applies BEFORE each
            residual (PoroElasticPressureSolver.h:187-194)."""
            jac_diag = self._pressure_jacobian_diag(dt)
            # refined f64 path: the f32 inner replaces the (f64) GMG
            # preconditioner entirely — don't build the latter (the host
            # wrapper deliberately skipped its eager warm)
            irp0 = self._ir_press_for(dt)
            p_precond = None if irp0 is not None \
                else self._pressure_precond(dt)

            r0 = self._pressure_residual(p, p_old, eps_v, eps_v0, dt)
            err0 = jnp.linalg.norm(r0)

            def cond(c):
                k, err = c[0], c[5]
                return (k < max_press) & (err > data.pressure_tol)

            def body(c):
                k, p, eps_v, delta_p, r, err, cg_tot, _cg_ok = c
                # NOTE: unlike the mechanics solve, the pressure CG keeps
                # its quadratic forms well above f32 operator noise (the
                # Q1 Jacobian is far better conditioned than Q2 elasticity)
                # — measured healthy, so no Richardson fallback here.  A
                # tighter Richardson target (0.25x tol) was tried and spun
                # to the iteration cap: it sits below the V-cycle's f32
                # attainable floor on real residuals.
                ptol = data.pressure_cg_tol * jnp.linalg.norm(r)
                irp = self._ir_press_for(dt)
                if irp is not None:
                    # f64 refinement: Richardson outer, full f32 GMG-CG
                    # inner per pass (see _ir_pressure) — ~1e-5
                    # contraction/pass at f32 cost
                    from .cg import richardson_solve
                    res = richardson_solve(
                        lambda x: self._pressure_jacobian_apply(x, dt),
                        r, self.disc._hcp.zero_hanging(delta_p), irp,
                        tol=ptol, max_iter=20)
                else:
                    res = cg_solve(
                        lambda x: self._pressure_jacobian_apply(x, dt),
                        r, self.disc._hcp.zero_hanging(delta_p), jac_diag,
                        tol=ptol, max_iter=data.cg_max_iterations,
                        precond=p_precond)
                delta_p = self.disc._hcp.distribute(res.x)
                p = p + delta_p
                eps_v = eps_v + (data.biot_coef / data.bulk_modulus) * delta_p
                r = self._pressure_residual(p, p_old, eps_v, eps_v0, dt)
                return (k + 1, p, eps_v, delta_p, r, jnp.linalg.norm(r),
                        cg_tot + res.iterations, c[-1] & res.converged)

            init = (jnp.int32(0), p, eps_v, delta_p, r0, err0, jnp.int32(0),
                    jnp.bool_(True))
            k, p, eps_v, delta_p, r, err, cg_tot, cg_ok = jax.lax.while_loop(
                cond, body, init)
            return p, eps_v, delta_p, err, k, cg_tot, cg_ok

        def fss_cond(c):
            it = c["fss_iter"]
            return (it < max_fss) & (c["err"] > data.fss_tol)

        # row-layout warm-start cache is threaded through the carry when
        # the rows mechanics path is active (trace-time static decision);
        # full residency (u only in rows through the loop) additionally
        # needs the rows-direct projection RHS
        ro = getattr(d, "row_ops", None)
        rows_active = _rows_ready(ro)

        def fss_body(c):
            delta_p = jnp.zeros_like(c["p"])  # reset per FSS iteration (:356)
            p, eps_v, delta_p, err_p, n_press, cg_p, ok_p = pressure_inner(
                c["p"], c["eps_v"], delta_p)
            u, cg_u, ok_u, st_u, u_rows, mech_b = self._mechanics_solve(
                p, c.get("u"), bc_scale,
                u_warm_rows=c.get("u_rows") if rows_active else None,
                b_prev=c["mech_b"])
            rhs_all = self._projection_rhs(
                u, u_rows=u_rows if rows_active else None)
            vol_strains, cg_proj, ok_pr = self._project(
                None, vol, c["vol_strains"], rhs_all=rhs_all)
            if resync:
                # textbook fixed-stress correction: eps_v follows the
                # projected mechanical strain (the line the reference left
                # commented out, PoroelasticityFSS.h:399)
                eps_v = jnp.sum(vol_strains, axis=0)
            r = self._pressure_residual(p, p_old, eps_v, eps_v0, dt)
            err = jnp.linalg.norm(r)
            it = c["fss_iter"]
            out = dict(
                p=p, eps_v=eps_v, vol_strains=vol_strains,
                proj_rhs=rhs_all,   # reused by the end-of-step shear solve
                mech_b=mech_b,      # skip-if-unchanged cache
                err=err, fss_iter=it + 1,
                press_total=c["press_total"] + n_press,
                cg_p=c["cg_p"] + cg_p, cg_u=c["cg_u"] + cg_u,
                cg_proj=c["cg_proj"] + cg_proj,
                err_hist=c["err_hist"].at[it].set(err),
                cg_ok=c["cg_ok"] & ok_p & ok_u & ok_pr,
                cg_stall=c["cg_stall"] | st_u,
            )
            if rows_active:
                # u lives ONLY in rows through the FSS loop (flat layout
                # materialized once per step, after convergence)
                out["u_rows"] = u_rows
            else:
                out["u"] = u
            return out

        n_voigt = len(VOIGT_PAIRS[dim])
        # the FSS loop's first-iteration decision is STATIC: err starts at
        # exactly 2*pressure_tol (:345).  In the normal regime
        # (fss_tol < 2*pressure_tol) the loop runs >= 1 iteration and the
        # end-of-step shear solve reuses its final proj_rhs, so the zeros
        # initializer is never consumed.  In the degenerate configuration
        # (fss_tol >= 2*pressure_tol: zero FSS iterations possible) the
        # real RHS must be assembled here or the shear projection would
        # solve against zeros and silently wipe the shear strains
        # (round-3 review finding, reproduced).
        if data.fss_tol >= 2.0 * data.pressure_tol:
            init_proj_rhs = self._projection_rhs(
                state.u, u_rows=(state.u_rows if rows_active else None))
        else:
            init_proj_rhs = jnp.zeros((n_voigt, d.n_pdofs), d.dtype)
        carry = dict(
            p=state.p, eps_v=state.eps_v,
            vol_strains=state.strains[jnp.asarray(vol)],
            proj_rhs=init_proj_rhs,
            err=jnp.asarray(2.0 * data.pressure_tol, d.dtype),  # :345
            fss_iter=jnp.int32(0),
            press_total=jnp.int32(0), cg_p=jnp.int32(0), cg_u=jnp.int32(0),
            cg_proj=jnp.int32(0),
            err_hist=jnp.full((max_fss,), -1.0, d.dtype),
            cg_ok=jnp.bool_(True),
            cg_stall=jnp.bool_(False),
        )
        if rows_active:
            carry["u_rows"] = (state.u_rows if state.u_rows is not None
                               else ro.to_rows(state.u))
            b_shape_like = ro.free_mask_rows
        else:
            carry["u"] = state.u
            b_shape_like = d.free_mask_u
        # zeros start: any real RHS differs from 0 somewhere, so the first
        # iteration after a restart/remesh always solves
        carry["mech_b"] = (state.mech_b if state.mech_b is not None
                           else jnp.zeros_like(b_shape_like))
        c = jax.lax.while_loop(fss_cond, fss_body, carry)

        # shear strains once per step after FSS convergence (:409)
        strains = state.strains.at[jnp.asarray(vol)].set(c["vol_strains"])
        cg_proj = c["cg_proj"]
        cg_ok = c["cg_ok"]
        if shear:
            # c["proj_rhs"] is the final FSS iteration's all-Voigt RHS for
            # the SAME u (no reassembly); if the loop can run zero
            # iterations (fss_tol >= 2*pressure_tol) the carry was seeded
            # with the real RHS above
            shear_strains, cg_sh, ok_sh = self._project(
                None, shear, state.strains[jnp.asarray(shear)],
                rhs_all=c["proj_rhs"])
            strains = strains.at[jnp.asarray(shear)].set(shear_strains)
            cg_proj = cg_proj + cg_sh
            cg_ok = cg_ok & ok_sh

        if rows_active:
            u_final = ro.from_rows(c["u_rows"]) if want_u else None
        else:
            u_final = c["u"]
        # keep the stored eps_v0 = the t=0 strain in BOTH modes (in resync
        # mode the per-step reference strain is the local eps_v0 variable;
        # the State field must not drift — it feeds quirk-mode restarts and
        # checkpoints)
        new_state = State(p=c["p"], u=u_final, eps_v=c["eps_v"],
                          eps_v0=state.eps_v0, strains=strains,
                          u_rows=c.get("u_rows"), mech_b=c["mech_b"])
        stats = StepStats(
            fss_iterations=c["fss_iter"], pressure_error=c["err"],
            pressure_iterations=c["press_total"],
            pressure_cg_iterations=c["cg_p"], mech_cg_iterations=c["cg_u"],
            projection_cg_iterations=cg_proj,
            fss_error_history=c["err_hist"],
            cg_converged=cg_ok, cg_stalled=c["cg_stall"])
        return new_state, stats

    # ---------------- nodal effective stresses ------------------------------

    @partial(jax.jit, static_argnums=0)
    def effective_stresses(self, strains):
        """sigma = C : eps nodally (PoroelasticityFSS.h:190-224), exploiting
        isotropy: sigma_ij = lam tr(eps) delta_ij + 2 mu eps_ij."""
        d = self.disc
        dim = d.dim
        pairs = VOIGT_PAIRS[dim]
        tr = sum(strains[e] for e in VOLUMETRIC_ENTRIES[dim])
        rows = []
        for e, (i, j) in enumerate(pairs):
            s = 2.0 * d.mu * strains[e]
            if i == j:
                s = s + d.lam * tr
            rows.append(s)
        return jnp.stack(rows, axis=0)
