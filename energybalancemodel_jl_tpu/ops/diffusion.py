"""Meridional heat diffusion operator ``D∇²`` as a tridiagonal stencil.

Rebuild of /root/reference/src/infrastructure.jl:477-533. The reference keeps
two code paths — a cached sparse tridiagonal matrix for the uniform grid
(:480-491) and a flux-form 3-point stencil for general grids (:505-527). Both
are strictly tridiagonal, so here each becomes a set of precomputed stencil
*bands* ``(lo, di, up)`` (diffusivity ``D`` factored out so parameter
ensembles can vmap over ``D`` without rebuilding geometry):

    (∇²T)_j = lo_j T_{j-1} + di_j T_j + up_j T_{j+1},   D∇²T = D * ∇²T

with zero-flux boundaries (lo_0 = up_{nx-1} = 0). Application is one fused
elementwise expression — XLA folds it into the surrounding physics; no sparse
machinery, no UMFPACK.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

__all__ = ["DiffusionGeometry", "diffusion_bands", "apply_diffusion", "diffusion"]


@dataclasses.dataclass(frozen=True)
class DiffusionGeometry:
    """Precomputed stencil bands (numpy float64, host-side statics)."""

    lo: np.ndarray  # coefficient on T_{j-1}; lo[0] = 0
    di: np.ndarray  # coefficient on T_j
    up: np.ndarray  # coefficient on T_{j+1}; up[-1] = 0


def diffusion_bands(st) -> DiffusionGeometry:
    """Build the stencil bands for a :class:`SpaceTime`.

    Uniform (``identity``) grid — reference ``get_diffop``
    (/root/reference/src/infrastructure.jl:480-491): interior cell edges
    ``x_b = dx .. 1-dx`` carry weights ``lambda_b = (1 - x_b^2)/dx^2``; row j is
    ``lambda_{j-1} T_{j-1} - (lambda_{j-1}+lambda_j) T_j + lambda_j T_{j+1}``
    with ``lambda_0 = lambda_nx = 0``.

    General grid — reference ``diffusion!`` (:505-527): reflective ghost
    extension ``[-x_0; x; 2-x_{nx-1}]``, edge midpoints ``x_{j±1/2}``, weights
    ``(1 - x_{j±1/2}^2)``, divided differences over ``diff(x)`` and
    ``x_{j+1/2} - x_{j-1/2}``.
    """
    nx = st.nx
    if st.grid == "identity":
        dx = 1.0 / nx
        xb = np.arange(1, nx, dtype=np.float64) * dx  # dx .. 1-dx (interior edges)
        lam = (1.0 - xb**2) / dx**2  # (nx-1,)
        lo = np.concatenate(([0.0], lam))
        up = np.concatenate((lam, [0.0]))
        di = -(lo + up)
        return DiffusionGeometry(lo=lo, di=di, up=up)
    x = st.x
    xg = np.concatenate(([-x[0]], x, [2.0 - x[-1]]))  # reflective ghosts (:510)
    diffx = np.diff(xg)  # (nx+1,)
    xxph = (xg[2:] + xg[1:-1]) / 2.0  # x_{j+1/2}, j = 0..nx-1 (:514)
    xxmh = (xg[1:-1] + xg[:-2]) / 2.0  # x_{j-1/2} (:515)
    mxxph = 1.0 - xxph**2  # (:516)
    mxxmh = 1.0 - xxmh**2  # (:517)
    phmmh = xxph - xxmh  # (:518)
    a = mxxph / diffx[1:] / phmmh  # weight on (T_{j+1} - T_j)
    b = mxxmh / diffx[:-1] / phmmh  # weight on (T_j - T_{j-1})
    a[-1] = 0.0  # diffT[end] = 0 — zero-flux (:522)
    b[0] = 0.0  # diffT[1] = 0
    lo = b.copy()
    up = a.copy()
    di = -(a + b)
    return DiffusionGeometry(lo=lo, di=di, up=up)


def neighbor_cells(v, axis_name=None):
    """``(v_{i-1}, v_{i+1})`` along the grid (last) axis.

    Single-shard: boundary-rolled values (multiplied by zero band entries at
    the boundaries, so wraparound is harmless). With ``axis_name`` set (grid
    axis sharded under ``shard_map``): one-cell halo exchange with the ring
    neighbors via ``lax.ppermute``.
    """
    import jax.numpy as _jnp
    from jax import lax as _lax

    if axis_name is None:
        return _jnp.roll(v, 1, axis=-1), _jnp.roll(v, -1, axis=-1)
    P = _lax.psum(1, axis_name)
    fwd = [(k, (k + 1) % P) for k in range(P)]
    bwd = [(k, (k - 1) % P) for k in range(P)]
    from_left = _lax.ppermute(v[..., -1:], axis_name, fwd)
    from_right = _lax.ppermute(v[..., :1], axis_name, bwd)
    vm1 = _jnp.concatenate([from_left, v[..., :-1]], axis=-1)
    vp1 = _jnp.concatenate([v[..., 1:], from_right], axis=-1)
    return vm1, vp1


def apply_diffusion(T, geom, D):
    """``D∇²T`` for a temperature field ``T`` of shape ``(..., nx)``.

    Boundary-rolled neighbors are multiplied by zero band entries, so
    ``jnp.roll`` is safe and keeps the expression a single fused elementwise
    op (no scatter/gather).
    """
    Tm1 = jnp.roll(T, 1, axis=-1)
    Tp1 = jnp.roll(T, -1, axis=-1)
    return D * (geom.lo * Tm1 + geom.di * T + geom.up * Tp1)


def diffusion(T, st, par):
    """Out-of-place ``D∇²`` convenience matching the reference's ``diffusion``
    (/root/reference/src/infrastructure.jl:529-530)."""
    return apply_diffusion(jnp.asarray(T), diffusion_bands(st), par["D"])
