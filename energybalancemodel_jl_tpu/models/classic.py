"""Classic diffusive EBM with sea ice (Wagner & Eisenman 2015, "WE15").

Rebuild of /root/reference/src/classic.jl. One enthalpy field ``E(x,t)`` with
seasonal insolation, A+BT outgoing longwave, ice-albedo switching, an
implicit "ghost layer" surface temperature ``Tg``, and meridional heat
diffusion. The per-step UMFPACK sparse solve for ``Tg`` (reference :55-63)
becomes a tridiagonal solve (the implicit matrix ``kappa`` is strictly
tridiagonal); everything else is fused elementwise arithmetic.

Reference quirks reproduced deliberately:

- The albedo switch ``alpha = aw*(E>0) + ai*(E<0)`` is **zero at E == 0**
  (reference :47) — initial ``E = 0`` states absorb no solar on step 1.
- The diffusion operator is always the *uniform-grid* operator
  ``get_diffop(nx)`` (reference :21 calls it regardless of the grid map), so
  the classic model uses uniform-grid geometry even on a sin grid.
- ``T`` stored in solutions is computed from the *pre-update* ``E``
  (reference :51 before :53), while the ``Tg`` solve uses the updated ``E``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.diffusion import DiffusionGeometry
from ..ops.tridiag import tridiag_solve
from ..utils.collection import Collection
from .base import ModelSpec, StepConfig, register_model

__all__ = ["CLASSIC"]


def uniform_bands(nx: int) -> DiffusionGeometry:
    """Uniform-grid diffusion bands, matching ``get_diffop``
    (/root/reference/src/infrastructure.jl:480-491)."""
    dx = 1.0 / nx
    xb = np.arange(1, nx, dtype=np.float64) * dx
    lam = (1.0 - xb**2) / dx**2
    lo = np.concatenate(([0.0], lam))
    up = np.concatenate((lam, [0.0]))
    di = -(lo + up)
    return DiffusionGeometry(lo=lo, di=di, up=up)


def statics(st, par, dtype):
    """Traced per-run precompute (rebuild of ``get_statics``
    /root/reference/src/classic.jl:12-34). Computed inside jit from traced
    parameters so ensembles can vmap over any of them."""
    x = jnp.asarray(st.x, dtype=dtype)
    t = jnp.asarray(st.t, dtype=dtype)
    dt = st.dt
    cg_tau = par["cg"] / par["tau"]
    dt_tau = dt / par["tau"]
    dc = dt_tau * cg_tau
    M = par["B"] + cg_tau
    aw = par["a0"] - par["a2"] * x**2
    kLf = par["k"] * par["Lf"]
    # Seasonal insolation table S[(nt+1), nx], S[nt] = S[0] (wraparound column,
    # reference :23-25): S = (S0 - S2 x^2) - (S1 cos(2 pi t)) x
    cosv = jnp.cos(2.0 * jnp.pi * t)
    S = (par["S0"] - par["S2"] * x**2)[None, :] - (par["S1"] * cosv)[:, None] * x[None, :]
    S = jnp.concatenate([S, S[:1]], axis=0)
    # Implicit matrix kappa = (1 + dt_tau) I - dt D diffop / cg (reference :21),
    # as tridiagonal bands over the uniform-grid operator.
    geom = uniform_bands(st.nx)
    klo = -(dt * par["D"]) * jnp.asarray(geom.lo, dtype=dtype) / par["cg"]
    kup = -(dt * par["D"]) * jnp.asarray(geom.up, dtype=dtype) / par["cg"]
    kdi = (1.0 + dt_tau) - (dt * par["D"]) * jnp.asarray(geom.di, dtype=dtype) / par["cg"]
    return Collection(
        cg_tau=cg_tau, dt_tau=dt_tau, dc=dc, M=M, aw=aw, kLf=kLf,
        S=S, klo=klo, kdi=kdi, kup=kup, dt=dt,
    )


def init_carry(init, st, dtype):
    """Scan carry from initial conditions; classic needs ``E`` and ``Tg``
    (reference docstring /root/reference/src/infrastructure.jl:604-605)."""
    return Collection(
        E=jnp.asarray(init["E"], dtype=dtype),
        Tg=jnp.asarray(init["Tg"], dtype=dtype),
    )


def step_inputs(stat, fyear):
    """Per-step scan inputs for one year: insolation column i, column i+1
    (the implicit step reads the wraparound column, reference :61), and the
    forcing value."""
    return dict(S_i=stat.S[:-1], S_ip1=stat.S[1:], f=fyear)


def step(carry, xs, stat, par, cfg: StepConfig):
    """One WE15 step (rebuild of ``step!(::Val{:Classic})``
    /root/reference/src/classic.jl:37-71)."""
    E, Tg = carry["E"], carry["Tg"]
    S_i, S_ip1, f = xs["S_i"], xs["S_ip1"], xs["f"]
    dtype = E.dtype

    pos = (E > 0.0).astype(dtype)
    neg = (E < 0.0).astype(dtype)
    nonneg = (E >= 0.0).astype(dtype)
    alpha = stat.aw * pos + par["ai"] * neg  # WE15 Eq. (4); zero at E == 0 (:47)
    C = alpha * S_i + stat.cg_tau * Tg - par["A"] + f  # (:48)
    # E == 0 lanes: the reference's kLf/0 = inf gives T0 = -+0.0, whose only
    # use is through the (T0 < 0) mask — false for both signed zeros — so
    # pinning T0 = 0 there is output-identical while keeping reverse-mode AD
    # free of inf * 0 cotangents (double-where pattern).
    zeroE = E == 0.0
    T0 = jnp.where(
        zeroE, 0.0, C / (stat.M - stat.kLf / jnp.where(zeroE, 1.0, E))
    )  # WE15 Eq. (A3) (:50)
    T = E / par["cw"] * nonneg + T0 * (neg * (T0 < 0.0).astype(dtype))  # WE15 Eq. (9) (:51)
    E_new = E + stat.dt * (C - stat.M * T + par["Fb"])  # WE15 Eq. (A2) (:53)

    # Implicit Euler for Tg (WE15 Eq. (A1), :55-63) — masks use the *updated* E.
    # E_new == 0 lanes have mask == 0 (E_new < 0 false), so the guarded
    # denominator is again output-identical.
    zeroEn = E_new == 0.0
    negn = (E_new < 0.0).astype(dtype)
    nonnegn = (E_new >= 0.0).astype(dtype)
    t0neg = (T0 < 0.0).astype(dtype)
    denom = stat.M - stat.kLf / jnp.where(zeroEn, 1.0, E_new)
    mask = t0neg * negn
    kdi = stat.kdi - stat.dc / denom * mask
    rhs = Tg + stat.dt_tau * (
        E_new / par["cw"] * nonnegn + (par["ai"] * S_ip1 - par["A"] + f) / denom * mask
    )
    method = "spike" if cfg.spatial_axis is not None else cfg.solver
    Tg_new = tridiag_solve(
        stat.klo, kdi, stat.kup, rhs, method=method,
        axis_name=cfg.spatial_axis,
    )

    h = -E_new / par["Lf"] * negn  # diagnostic ice thickness (:65)

    carry = Collection(E=E_new, Tg=Tg_new)
    out = Collection(E=E_new, T=T, h=h)
    return carry, out


CLASSIC = register_model(
    ModelSpec(
        name="Classic",
        statics=statics,
        init_carry=init_carry,
        step=step,
        step_inputs=step_inputs,
        solution_vars=("E", "T", "h"),
        init_vars=("E", "Tg"),
    )
)
