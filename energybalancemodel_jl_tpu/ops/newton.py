"""Newton solver for nonlinear systems with tridiagonal Jacobians.

Replacement for the reference's ``NonlinearSolve.TrustRegion``
inner solver (/root/reference/src/miz.jl:55-60). The MIZ ice-surface
temperature residual couples neighbors only through the 3-point diffusion
stencil, so its Jacobian is analytically tridiagonal; a warm-started Newton
iteration (the reference warm-starts through ``@persistent T0``,
/root/reference/src/miz.jl:47) with an exact tridiagonal solve per step
converges in a handful of iterations. Runs under ``jit``/``vmap``/``scan``:
``lax.while_loop`` with a static iteration cap, no data-dependent shapes.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .tridiag import tridiag_solve

__all__ = ["newton_tridiag"]


def newton_tridiag(
    residual_and_bands,
    x0,
    abstol: float = 1e-8,
    reltol: float = 1e-6,
    max_iter: int = 30,
    method: str = "pcr",
    max_step: float = None,
    axis_name: str = None,
    cond_axis_name: str = None,
):
    """Solve ``r(x) = 0`` where ``J = dr/dx`` is tridiagonal.

    Parameters
    ----------
    residual_and_bands:
        ``x -> (r, (lo, di, up))`` returning the residual and the Jacobian
        bands at ``x``.
    x0:
        Initial guess (warm start), shape ``(..., n)``.
    abstol, reltol:
        Convergence on the residual inf-norm:
        ``||r||_inf <= max(abstol, reltol * ||r0||_inf)`` — matching the
        tolerances the reference passes to NonlinearSolve
        (/root/reference/src/miz.jl:58-59).
    max_iter:
        Static iteration cap (keeps the loop bounded under jit).
    method:
        Tridiagonal solver: ``'pcr'`` (default) or ``'thomas'``.
    max_step:
        Optional elementwise cap on the Newton update — trust-region-style
        safeguard against float32 blow-ups on ill-conditioned iterates
        (the reference's TrustRegion bounds its steps the same way).
    cond_axis_name:
        Extra mesh axis the LOOP CONDITION is OR-reduced over — a 2-D
        (members x grid) mesh passes its member axis so every device runs
        the same trip count (divergent ``while_loop`` counts across member
        rows deadlock runtimes with a global collective rendezvous; the
        unsharded batched engine's single ``jnp.any`` over all members has
        the same global-trip-count semantics). Per-member norms,
        tolerances, and the returned ``converged`` flags are untouched —
        members of other rows only keep the loop alive.

    Returns
    -------
    ``(x, converged, iterations)`` — solution, bool convergence flag (scalar
    or batched), and the iteration count actually used.
    """
    def global_norm(r):
        # with a sharded grid axis, the convergence decision must be
        # identical on every shard (the body contains collectives — a
        # per-shard loop count would deadlock), so reduce over the mesh
        n = jnp.max(jnp.abs(r), axis=-1)
        if axis_name is not None:
            n = lax.pmax(n, axis_name)
        return n

    r0, bands0 = residual_and_bands(x0)
    rnorm0 = global_norm(r0)
    tol = jnp.maximum(jnp.asarray(abstol, dtype=x0.dtype), reltol * rnorm0)

    def cond(state):
        _, _, _, it, rnorm = state
        go = jnp.any(rnorm > tol)
        if cond_axis_name is not None:
            go = lax.pmax(go.astype(jnp.int32), cond_axis_name) > 0
        return jnp.logical_and(it < max_iter, go)

    def body(state):
        # the residual/Jacobian of the current iterate are carried from the
        # previous iteration — one evaluation per Newton step
        x, r, (lo, di, up), it, _ = state
        delta = tridiag_solve(
            lo, di, up, -r, method=method, axis_name=axis_name
        )
        if max_step is not None:
            delta = jnp.clip(delta, -max_step, max_step)
        # a non-finite update (singular float32 Jacobian) freezes the lane
        # instead of poisoning it; the convergence flag reports the failure
        delta = jnp.where(jnp.isfinite(delta), delta, jnp.zeros_like(delta))
        x = x + delta
        r, bands = residual_and_bands(x)
        return x, r, bands, it + 1, global_norm(r)

    x, _, _, iters, rnorm = lax.while_loop(
        cond, body, (x0, r0, bands0, jnp.int32(0), rnorm0)
    )
    return x, rnorm <= tol, iters
