"""Tridiagonal linear solvers, jit/vmap/scan-safe.

The reference's two native solves — UMFPACK ``kappa \\ rhs`` in the classic
implicit ghost-layer step (/root/reference/src/classic.jl:55-63) and the
LAPACK-backed TrustRegion inner solves in the MIZ model
(/root/reference/src/miz.jl:55-60) — both act on strictly tridiagonal
systems, so no general sparse machinery is needed; two solvers are
provided:

- :func:`thomas_solve` — sequential Thomas algorithm as a ``lax.scan``.
  O(n) work, O(n) sequential depth. Exact parity path.
- :func:`pcr_solve` — parallel cyclic reduction: ``ceil(log2(n))`` fully
  vectorized elimination sweeps, O(n log n) work but O(log n) sequential
  depth. This is the default: each sweep is a handful of fused
  elementwise ops over the whole system (and over the whole vmapped
  ensemble), instead of a 2n-step device loop.

Both are stable for the diagonally dominant systems that arise here and are
transparent to ``vmap`` (batched ensembles) and reverse-mode AD.
"""
from __future__ import annotations

import math
import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["thomas_solve", "pcr_solve", "tridiag_solve", "tridiag_matvec"]


def tridiag_matvec(lo, di, up, x):
    """``A @ x`` for bands ``(lo, di, up)`` with lo[0] = up[-1] = 0."""
    return lo * jnp.roll(x, 1, axis=-1) + di * x + up * jnp.roll(x, -1, axis=-1)


def thomas_solve(lo, di, up, b):
    """Solve the tridiagonal system with the Thomas algorithm.

    Bands: ``lo[i] x[i-1] + di[i] x[i] + up[i] x[i+1] = b[i]`` with
    ``lo[0] = up[-1] = 0``. 1-D operands; batch with ``vmap``.
    """
    def fwd(carry, row):
        cp_prev, dp_prev = carry
        l, d, u, bb = row
        denom = d - l * cp_prev
        cp = u / denom
        dp = (bb - l * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zero = jnp.zeros((), dtype=b.dtype)
    _, (cps, dps) = lax.scan(fwd, (zero, zero), (lo, di, up, b))

    def bwd(x_next, row):
        cp, dp = row
        x = dp - cp * x_next
        return x, x

    _, xs = lax.scan(bwd, zero, (cps, dps), reverse=True)
    return xs


def _shift(v, s):
    """Shift ``v`` by ``s`` along the last axis, filling with zeros.

    ``s > 0`` moves entries toward higher indices (out[i] = v[i-s]).
    Static ``s`` — compiles to a pad+slice, no gather.
    """
    axis = v.ndim - 1
    n = v.shape[axis]
    if s == 0 or abs(s) >= n:
        return jnp.zeros_like(v) if abs(s) >= n else v
    pad = [(0, 0)] * v.ndim
    index = [slice(None)] * v.ndim
    if s > 0:
        pad[axis] = (s, 0)
        index[axis] = slice(0, n)
    else:
        pad[axis] = (0, -s)
        index[axis] = slice(-n, None)
    return jnp.pad(v, pad)[tuple(index)]


def pcr_solve(lo, di, up, b):
    """Solve a tridiagonal system by parallel cyclic reduction.

    At stride ``s`` every equation eliminates its ``±s`` neighbors:

        alpha_i = -lo_i / di_{i-s}          beta_i = -up_i / di_{i+s}
        lo'_i = alpha_i lo_{i-s}            up'_i = beta_i up_{i+s}
        di'_i = di_i + alpha_i up_{i-s} + beta_i lo_{i+s}
        b'_i  = b_i + alpha_i b_{i-s} + beta_i b_{i+s}

    After ``ceil(log2(n))`` doublings the system is diagonal: ``x = b / di``.
    Out-of-range neighbors are identity rows (di = 1, off-diagonals and rhs 0),
    realized by zero-filled shifts of the bands and a ones-filled shift of the
    diagonal. Works on ``(..., n)`` operands — already batched, no vmap needed.
    """
    n = b.shape[-1]
    steps = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    one = jnp.ones((), dtype=b.dtype)

    # Row-scale by the diagonal: improves float32 conditioning materially
    # (the systems here mix O(1e4) conduction terms with O(1) couplings).
    inv = one / di
    lo = lo * inv
    up = up * inv
    b = b * inv
    di = jnp.ones_like(di)

    def shift_di(d, s):
        # out-of-range diagonal = 1 (identity row)
        shifted = _shift(d, s)
        mask = _shift(jnp.ones_like(d), s)
        return shifted + (one - mask)

    def safe_div(num, den):
        # reduced diagonals never vanish for diagonally dominant systems in
        # exact arithmetic; the guard stops a float32-cancelled zero pivot
        # from injecting inf/NaN (bitwise no-op in healthy lanes)
        return jnp.where(den == 0, jnp.zeros_like(num), num / jnp.where(den == 0, one, den))

    s = 1
    for _ in range(steps):
        di_m = shift_di(di, s)
        di_p = shift_di(di, -s)
        alpha = safe_div(-lo, di_m)
        beta = safe_div(-up, di_p)
        b = b + alpha * _shift(b, s) + beta * _shift(b, -s)
        di = di + alpha * _shift(up, s) + beta * _shift(lo, -s)
        lo = alpha * _shift(lo, s)
        up = beta * _shift(up, -s)
        s *= 2
    return b / di


def tridiag_solve(lo, di, up, b, method: str = "pcr", axis_name: str = None):
    """Dispatch between :func:`pcr_solve` (default),
    :func:`thomas_solve` (``method='thomas'``, sequential parity path), and
    the distributed :func:`~.spike.spike_tridiag_solve` (``method='spike'``,
    grid axis sharded over ``axis_name``)."""
    if method == "spike":
        from .spike import spike_tridiag_solve

        return spike_tridiag_solve(lo, di, up, b, axis_name)
    if method == "thomas":
        if b.ndim == 1:
            return thomas_solve(lo, di, up, b)
        flat_solve = thomas_solve
        for _ in range(b.ndim - 1):
            flat_solve = jax.vmap(flat_solve)
        lo_b = jnp.broadcast_to(lo, b.shape)
        di_b = jnp.broadcast_to(di, b.shape)
        up_b = jnp.broadcast_to(up, b.shape)
        return flat_solve(lo_b, di_b, up_b, b)
    if method == "pcr":
        return pcr_solve(lo, di, up, b)
    raise ValueError(f"Unknown tridiagonal solver {method!r}")
