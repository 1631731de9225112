"""Preconditioned conjugate gradients as a jitted ``lax.while_loop``.

Replaces the reference's deal.II ``SolverCG`` + ``PreconditionSSOR`` calls
(``PoroElasticPressureSolver.h:172-185``,
``PoroElasticDisplacementSolver.h:294-307``, ``StrainProjector.h:201-232``).
SSOR is a sequential triangular sweep and therefore does not vectorize; we use
Jacobi (diagonal) preconditioning, which vectorizes perfectly — the
equivalence target is identical solutions at the same tolerances with
iteration counts of the same order (SURVEY §7 hard-part 3).

Everything runs on-chip: the convergence check is a scalar in the while_loop
carry, so no host synchronization happens per iteration.  Multi-RHS solves
(the strain projection) are ``jax.vmap`` of this function: converged lanes
freeze their state while the rest keep iterating.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


def _dot(a, b, precise=False):
    """Inner product, optionally with float64 accumulation.

    CG's alpha = rz / pAp suffers catastrophic cancellation in f32 when the
    preconditioner is good (z ~ A^{-1}r makes the true p·Ap tiny relative
    to sum(|p_i (Ap)_i|)); observed as a *negative* p·Ap and a completely
    stalled solve.  When x64 is enabled (f64 is fine for a
    bandwidth-bound dot), accumulate in float64; otherwise keep
    the plain dot (enable x64 for f32 production runs — bench.py does).

    Reduction form (``sum(a*b)``), NOT ``jnp.vdot``: vdot flattens via
    reshape(-1) first, and under GSPMD a flatten of an array sharded on an
    interior axis (the 2D parity y-slab layout, axis 3 of 5) is only
    partitionable by ALL-GATHERING the operand — one full volume over ICI
    per dot, 3x per CG iteration.  The elementwise+reduce form partitions
    as a local reduce + scalar all-reduce on every layout
    (tests/test_parity_sharding.py::test_2d_mech_cg_loop_collectives...)."""
    if precise and a.dtype == jnp.float32 and jax.config.jax_enable_x64:
        return jnp.sum(a.astype(jnp.float64)
                       * b.astype(jnp.float64)).astype(a.dtype)
    return jnp.sum(a * b)


class CGResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray   # int32 — number of A-applies performed
    residual_norm: jnp.ndarray
    converged: jnp.ndarray    # bool
    stalled: jnp.ndarray = False  # bool — ended on a stagnation early-exit
    #                               (residual flat-lined, e.g. the f32
    #                               attainable floor) rather than the
    #                               iteration cap


def cg_solve(apply_a: Callable, b: jnp.ndarray, x0: jnp.ndarray,
             diag: jnp.ndarray = None, tol: jnp.ndarray = 0.0,
             max_iter: int = 1000, precond: Callable = None,
             precise_dots: bool = False,
             apply_iter: Callable = None,
             flexible: bool = None) -> CGResult:
    """Solve ``A x = b`` with preconditioned CG.

    Args:
      apply_a: SPD operator ``x -> A x`` (matrix-free).
      b: right-hand side.
      x0: initial guess (the reference warm-starts from the previous
        solution — deal.II ``cg.solve`` uses the solution vector's incoming
        content as the start vector).
      diag: operator diagonal (Jacobi preconditioner), used when
        ``precond`` is None.
      tol: *absolute* residual L2 tolerance — callers pass
        ``1e-8 * ||b||`` / ``1e-12`` etc. to match SolverControl semantics.
      max_iter: iteration cap (reference uses 1000).
      precond: optional SPD fixed linear operator ``r -> M^{-1} r``
        (e.g. a multigrid V-cycle); overrides ``diag``.
      precise_dots: accumulate the CG scalars in float64 (requires x64
        enabled).  Needed when a very strong preconditioner drives the true
        p·Ap into f32 cancellation territory; off by default.
      apply_iter: optional cheaper operator used for the PER-ITERATION
        applies (on search directions p only).  Caller must guarantee it
        equals ``apply_a`` on the Krylov subspace actually visited —
        e.g. ElasticityRowOps.free_apply is bitwise-equal to
        constrained_apply on free-subspace vectors, and every p is in the
        free subspace when b/x0 carry the Dirichlet values (then
        r0 = b - A x0 is exactly zero at constrained dofs, Jacobi/any
        diagonal precond preserves those zeros, and p = z + beta p keeps
        them inductively).  ``apply_a`` is still used for the one initial
        residual evaluation on x0, which is NOT in the free subspace.
      flexible: use the Polak-Ribiere beta (one extra dot per iteration).
        Default: on exactly when an operator ``precond`` is given — the
        safe choice for approximate/nonlinear preconditioners like a
        float32 V-cycle.  A FIXED SPD linear preconditioner (e.g. the
        node-block Jacobi) may pass ``flexible=False`` to keep the
        2-dots-per-iteration Fletcher-Reeves update.
    """
    if flexible is None:
        flexible = precond is not None
    if apply_iter is None:
        apply_iter = apply_a
    if precond is None:
        inv_diag = 1.0 / diag
        precond = lambda r: r * inv_diag  # noqa: E731

    r0 = b - apply_a(x0)
    z0 = precond(r0)
    dot = lambda a, b: _dot(a, b, precise_dots)  # noqa: E731
    rz0 = dot(r0, z0)
    rnorm0 = jnp.linalg.norm(r0)

    def cond(state):
        k, _, _, _, _, rz, rnorm = state
        return (k < max_iter) & (rnorm > tol)

    def body(state):
        k, x, r, r_prev, p, rz, rnorm = state
        ap = apply_iter(p)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r_new = r - alpha * ap
        z = precond(r_new)
        if flexible:
            # Polak-Ribiere beta: robust to slight nonsymmetry / rounding
            # of an operator preconditioner (e.g. a float32 V-cycle, whose
            # ~1e-7 transfer asymmetry stalls Fletcher-Reeves CG)
            rz_new = dot(r_new, z)
            beta = dot(z, r_new - r) / rz
            beta = jnp.maximum(beta, 0.0)
        else:
            rz_new = dot(r_new, z)
            beta = rz_new / rz
        p = z + beta * p
        return (k + 1, x, r_new, r, p, rz_new, jnp.linalg.norm(r_new))

    init = (jnp.int32(0), x0, r0, r0, z0, rz0, rnorm0)
    k, x, r, r_prev, p, rz, rnorm = lax.while_loop(cond, body, init)
    # stalled is an explicit traced bool so cg_solve and richardson_solve
    # results share one pytree structure (a Python-bool leaf here would
    # break lax.cond/while carries that mix the two solvers)
    return CGResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=rnorm <= tol, stalled=jnp.bool_(False))


def richardson_solve(apply_a: Callable, b: jnp.ndarray, x0: jnp.ndarray,
                     precond: Callable, tol: jnp.ndarray,
                     max_iter: int) -> CGResult:
    """Preconditioned Richardson iteration: ``x += M^{-1}(b - A x)``.

    The robust companion to :func:`cg_solve` for very strong operator
    preconditioners in float32: when M approximates A^{-1} well, the true
    quadratic form p·Ap falls below the forward-error noise of the f32
    operator apply itself, and CG's step computation becomes noise-dominated
    (observed: bit-exact stagnation of f32 GMG-CG at 40^3 elasticity
    while this iteration contracts steadily at ~0.5/step).  No dot products
    enter the update — only the stopping test.

    Stops early on stagnation (residual reduction < 2% per iteration,
    ``converged=False``, ``stalled=True``): a tolerance below the f32
    attainable floor of the preconditioned operator otherwise spins all the
    way to ``max_iter`` (measured: 1000 wasted V-cycles per solve at a
    0.25x-tightened pressure tolerance).

    The residual vector is carried in the loop state, so each iteration
    costs ONE operator apply (plus one V-cycle)."""
    def cond(state):
        k, _, _, rnorm, rprev = state
        return (k < max_iter) & (rnorm > tol) & (rnorm < 0.98 * rprev)

    def body(state):
        k, x, r, rnorm, _ = state
        x = x + precond(r)
        r_new = b - apply_a(x)
        return (k + 1, x, r_new, jnp.linalg.norm(r_new), rnorm)

    r0 = b - apply_a(x0)
    rnorm0 = jnp.linalg.norm(r0)
    inf = jnp.asarray(jnp.inf, rnorm0.dtype)
    k, x, _, rnorm, rprev = lax.while_loop(
        cond, body, (jnp.int32(0), x0, r0, rnorm0, inf))
    converged = rnorm <= tol
    return CGResult(x=x, iterations=k, residual_norm=rnorm,
                    converged=converged,
                    stalled=~converged & (rnorm >= 0.98 * rprev))


def cg_solve_batched(apply_a: Callable, b: jnp.ndarray, x0: jnp.ndarray,
                     diag: jnp.ndarray, tol: jnp.ndarray,
                     max_iter: int) -> CGResult:
    """vmapped multi-RHS CG sharing one operator and preconditioner.

    Used for the strain projection's one-mass-matrix / many-components solves
    (``StrainProjector.h:201-232`` — the reference solves them serially; here
    all components run as one batched solve).  ``b``/``x0``: (n_rhs, n);
    ``tol``: (n_rhs,) absolute tolerances.
    """
    f = partial(cg_solve, apply_a, max_iter=max_iter)
    return jax.vmap(lambda bb, xx, tt: f(bb, xx, diag=diag, tol=tt))(b, x0, tol)
