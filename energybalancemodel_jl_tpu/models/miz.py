"""Extended EBM with a Marginal Ice Zone (MIZ).

Rebuild of /root/reference/src/miz.jl: separate ice/water enthalpies
``Ei, Ew``, ice concentration ``phi``, floe size ``D``, floe number ``n``,
ice thickness ``h``, lateral melt/growth, pancake-ice formation, floe
welding, and a per-step nonlinear solve for the ice surface temperature.

The reference's NonlinearSolve TrustRegion solve (:55-60) becomes a
warm-started Newton iteration with an analytic tridiagonal Jacobian (the
``T0eq`` residual couples neighbors only through the 3-point diffusion
stencil, :33-45); the warm start is carried through the scan state, mirroring
the reference's ``@persistent T0`` (:47).

Reference quirks reproduced deliberately (see SURVEY.md §2):

- ``D_t``'s lateral-melt term is ``-(pi/2)*alpha*wlat`` — Julia operator
  precedence in ``-pi / 2.0*par.alpha * wlat`` (:141), not ``-pi/(2 alpha)``.
- ``wlat = m1*(Tw - Tm^m2)`` — the exponent binds to ``Tm`` only (:71).
- NaNs are presentation-only: ``Ti``/``Tw`` are NaN-masked at the *end* of a
  step for storage (:193-194) and ``Tw`` NaNs are zeroed at the start of the
  next (:157). The scan carry stays NaN-free; masking is applied to the
  emitted outputs only.
- ``n`` stored per step is computed from the *pre-update* ``D`` and ``phi``
  (:160).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.diffusion import diffusion_bands, neighbor_cells
from ..ops.newton import newton_tridiag
from ..ops.tridiag import tridiag_solve
from ..utils.collection import Collection
from .base import ModelSpec, StepConfig, register_model

__all__ = ["MIZ"]


def statics(st, par, dtype):
    """Traced per-run precompute: insolation table, water coalbedo, stencil
    bands (geometry is parameter-free; diffusivity ``D`` multiplies at use)."""
    x = jnp.asarray(st.x, dtype=dtype)
    t = jnp.asarray(st.t, dtype=dtype)
    # insolation bracket shared by ice and water solar terms
    # (/root/reference/src/miz.jl:11,14): (S0 - (S1 x) cos(2 pi t)) - S2 x^2
    cosv = jnp.cos(2.0 * jnp.pi * t)
    insol = (par["S0"] - (par["S1"] * x)[None, :] * cosv[:, None]) - (par["S2"] * x**2)[None, :]
    aw = par["a0"] - par["a2"] * x**2  # water coalbedo (:14)
    geom = diffusion_bands(st)
    return Collection(
        insol=insol,
        aw=aw,
        glo=jnp.asarray(geom.lo, dtype=dtype),
        gdi=jnp.asarray(geom.di, dtype=dtype),
        gup=jnp.asarray(geom.up, dtype=dtype),
        dt=st.dt,
        # scalar Tm^m2 of ``wlat`` (:71), hoisted out of the step
        Tm_pow_m2=par["Tm"] ** par["m2"],
    )


def init_carry(init, st, dtype):
    """Scan carry: the five prognostic fields (reference init vars
    /root/reference/src/infrastructure.jl:604-605) plus the Newton warm-start
    ``T0`` (reference ``@persistent T0`` zeros, /root/reference/src/miz.jl:47-53)."""
    z = jnp.zeros(st.nx, dtype=dtype)
    return Collection(
        Ei=jnp.asarray(init["Ei"], dtype=dtype),
        Ew=jnp.asarray(init["Ew"], dtype=dtype),
        h=jnp.asarray(init["h"], dtype=dtype),
        D=jnp.asarray(init["D"], dtype=dtype),
        phi=jnp.asarray(init["phi"], dtype=dtype),
        T0=z,
    )


def step_inputs(stat, fyear):
    return dict(insol=stat.insol, f=fyear)


def _dstencil(stat, par, v, axis_name=None):
    """``D∇²v`` via the precomputed bands (rebuild of ``diffusion!``
    /root/reference/src/infrastructure.jl:505-527); halo exchange when the
    grid axis is sharded."""
    vm1, vp1 = neighbor_cells(v, axis_name)
    return par["D"] * (stat.glo * vm1 + stat.gdi * v + stat.gup * vp1)


def _t0_residual(T0, args, axis_name=None):
    """The ``T0eq`` residual (/root/reference/src/miz.jl:33-45) as a pure
    function of explicit arrays (differentiable in every input)."""
    insol, hp, Tw, phi, f, glo, gdi, gup, k, Tm, A, B, ai, D = args
    Ti = jnp.minimum(T0, Tm)
    Tb = Ti * phi + (1.0 - phi) * Tw
    r = k * (Tm - T0) / hp
    r = r + ai * insol
    r = r + ((-A) - B * (T0 - Tm))
    Tbm1, Tbp1 = neighbor_cells(Tb, axis_name)
    r = r + D * (glo * Tbm1 + gdi * Tb + gup * Tbp1)
    r = r + f
    return r


def _t0_bands(T0, args, axis_name=None):
    """Analytic tridiagonal Jacobian bands of :func:`_t0_residual`."""
    insol, hp, Tw, phi, f, glo, gdi, gup, k, Tm, A, B, ai, D = args
    g = phi * (T0 < Tm).astype(T0.dtype)
    gm1, gp1 = neighbor_cells(g, axis_name)
    jlo = D * glo * gm1
    jdi = -k / hp - B + D * gdi * g
    jup = D * gup * gp1
    return jlo, jdi, jup


def _solver_method(cfg: StepConfig) -> str:
    return "spike" if cfg.spatial_axis is not None else cfg.solver


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _newton_root(T0_warm, args, cfg: StepConfig):
    def residual_and_bands(T0):
        return (
            _t0_residual(T0, args, cfg.spatial_axis),
            _t0_bands(T0, args, cfg.spatial_axis),
        )

    return newton_tridiag(
        residual_and_bands,
        T0_warm,
        abstol=cfg.newton_abstol,
        reltol=cfg.newton_reltol,
        max_iter=cfg.newton_max_iter,
        method=_solver_method(cfg),
        axis_name=cfg.spatial_axis,
        cond_axis_name=cfg.batch_axis,
        # float32 config caps the update: physical surface temperatures move
        # by at most a few K per step from a warm start, and the cap keeps
        # low-precision iterates from blowing up through the min(T0, Tm) kink
        max_step=cfg.newton_max_step,
    )


def _newton_root_fwd(T0_warm, args, cfg):
    out = _newton_root(T0_warm, args, cfg)
    return out, (out[0], args)


def _newton_root_bwd(cfg, residuals, cotangents):
    """Implicit-function-theorem VJP: with ``r(x*, args) = 0``,
    ``dL/dargs = -lambda^T dr/dargs`` where ``J^T lambda = dL/dx*``.

    The Newton ``while_loop`` itself is never differentiated --- this makes
    the whole integrator reverse-differentiable (gradient-based calibration,
    a capability with no reference analog)."""
    T0, args = residuals
    # jit-constant residuals can arrive as jax-internal const wrappers
    # without operator support; normalize to arrays
    T0 = jnp.asarray(T0)
    args = jax.tree_util.tree_map(jnp.asarray, args)
    gT0 = cotangents[0]
    jlo, jdi, jup = _t0_bands(T0, args, cfg.spatial_axis)
    # transpose bands: (J^T)lo[i] = jup[i-1], (J^T)up[i] = jlo[i+1]; the
    # shifted-in boundary entries are multiples of the zero stencil-boundary
    # bands, so neighbor exchange (or plain rolls) are safe
    jup_m1, _ = neighbor_cells(jup, cfg.spatial_axis)
    _, jlo_p1 = neighbor_cells(jlo, cfg.spatial_axis)
    lam = tridiag_solve(
        jup_m1, jdi, jlo_p1, gT0,
        method=_solver_method(cfg),
        axis_name=cfg.spatial_axis,
    )
    _, vjp_fn = jax.vjp(
        lambda a: _t0_residual(T0, a, cfg.spatial_axis), args
    )
    (g_args,) = vjp_fn(-lam)
    return jnp.zeros_like(T0), g_args


_newton_root.defvjp(_newton_root_fwd, _newton_root_bwd)


def solve_T0(T0_warm, insol, h, Tw, phi, f, stat, par, cfg: StepConfig):
    """Ice surface temperature from the single-column energy balance.

    Rebuild of ``solveTi``'s inner solve (/root/reference/src/miz.jl:47-64).
    Residual (``T0eq``, :33-45)::

        k (Tm - T0)/h + ai S(x,t) - A - B (T0 - Tm)
          + D∇²( phi min(T0,Tm) + (1-phi) Tw ) + f

    with ``h -> hmin`` where ``h == 0`` (:51). The Jacobian is tridiagonal;
    solved by warm-started Newton with an implicit-diff custom VJP
    (reverse-mode AD flows through the root, not the iteration).
    """
    hp = jnp.where(h == 0.0, par["hmin"], h)
    args = (
        insol, hp, Tw, phi, f, stat.glo, stat.gdi, stat.gup,
        par["k"], par["Tm"], par["A"], par["B"], par["ai"], par["D"],
    )
    return _newton_root(T0_warm, args, cfg)


def step(carry, xs, stat, par, cfg: StepConfig):
    """One MIZ step (rebuild of ``step!(::Val{:MIZ})``
    /root/reference/src/miz.jl:150-196, preserving the reference's exact
    update order and masking semantics)."""
    Ei, Ew, h, Df, phi = carry["Ei"], carry["Ew"], carry["h"], carry["D"], carry["phi"]
    insol, f = xs["insol"], xs["f"]
    dtype = Ei.dtype
    dt = stat.dt
    Tm = par["Tm"]

    # -- temperatures (:156-158) ---------------------------------------
    # water_temp (:30) with a guarded denominator: the reference computes
    # Ew/((1-phi) cw) and only cleans the 0/0 NaN afterwards (:157); a lane
    # with phi == 1 and Ew > 0 would produce +inf and cascade to NaN through
    # Tbar's 0*inf. Such a state never arises in float64 (oracle-parity
    # tested), but float32 rounding can reach it — the guard returns 0 there
    # and is exact everywhere else.
    den = (1.0 - phi) * par["cw"]
    Tw = Tm + jnp.where(den == 0.0, 0.0, Ew / jnp.where(den == 0.0, 1.0, den))
    Tw = jnp.where(jnp.isnan(Tw), 0.0, Tw)  # condset!(Tw, 0, isnan) (:157)
    T0, converged, _ = solve_T0(carry["T0"], insol, h, Tw, phi, f, stat, par, cfg)
    Ti = jnp.minimum(T0, Tm)  # ice_temp (:31,65)
    Ti = jnp.where(h == 0.0, 0.0, Ti)  # zeroref!(Ti, h) (:66)

    # -- floe number from pre-update D, phi (:160, num :83-87) ---------
    # Masked divisions use the "double where" pattern throughout: the
    # denominator is guarded with the same mask that discards the lane, so
    # the primal is bitwise-identical to the reference's compute-then-mask
    # (the masked lane's value never escapes) while reverse-mode AD never
    # sees an inf/NaN to multiply by the zero cotangent.
    zeroD = Df == 0.0
    n = phi / jnp.where(zeroD, 1.0, par["alpha"] * Df**2)
    n = jnp.where(zeroD, 0.0, n)

    # -- fluxes (:162-164) ---------------------------------------------
    Tb = Ti * phi + (1.0 - phi) * Tw  # Tbar (:21-28)
    L = par["A"] + par["B"] * (Tb - Tm)  # OLR (:99)
    dTb = _dstencil(stat, par, Tb, cfg.spatial_axis)
    Fvi = par["ai"] * insol - L + dTb + par["Fb"] + f  # vert_flux ice (:96-101)
    Fvw = stat.aw * insol - L + dTb + par["Fb"] + f  # vert_flux water
    wl = par["m1"] * (Tw - stat["Tm_pow_m2"])  # wlat (:71) — exponent binds to Tm
    Flat = phi * h * par["Lf"] * wl * jnp.pi / jnp.where(zeroD, 1.0, par["alpha"] * Df)  # lat_flux (:103-107)
    Flat = jnp.where(zeroD, 0.0, Flat)

    # -- enthalpy forward Euler + redistribution (:166-170, :109-117) --
    rEi = Ei + (phi * Fvi + Flat) * dt  # Ei_t (:137)
    rEw = Ew + ((1.0 - phi) * Fvw - Flat) * dt  # Ew_t (:138)
    cEi = jnp.minimum(rEi, 0.0)  # clamp(rEi, -Inf, 0)
    cEw = jnp.maximum(rEw, 0.0)  # clamp(rEw, 0, Inf)
    psiEidt = rEi - cEi  # >= 0
    psiEwdt = rEw - cEw  # <= 0
    Ei1 = cEi + psiEwdt
    Ew1 = cEw + psiEidt

    # -- floe size/thickness updates (:172-181) ------------------------
    ring = par["alpha"] * n * ((Df + 2.0 * par["rl"]) ** 2 - Df**2)  # area_lead (:90-93)
    Al = jnp.minimum(ring, 1.0 - phi)
    psiEw = psiEwdt / dt
    phi_one = phi == 1.0
    Ql = Al / jnp.where(phi_one, 1.0, 1.0 - phi) * psiEw  # split_psiEw (:120-125)
    Ql = jnp.where(phi_one, 0.0, Ql)  # condset!(Ql, 0, isone, phi)
    Qp = psiEw - Ql
    dn = dt * (-Qp / (par["Lf"] * par["alpha"] * par["Dmin"] ** 2 * par["hmin"]))  # psinplus (:127)

    # D_t (:140-146) — note the reference's operator-precedence quirk:
    # lat_melt = ((-pi)/2.0*alpha)*wlat = -(pi/2) alpha wlat
    lat_melt = -jnp.pi / 2.0 * par["alpha"] * wl
    # guard on the full denominator (h or phi zero): lanes with phi == 0 and
    # h > 0 necessarily have Ei == 0, so the altered intermediate is always
    # rescued by the zeroref(D, Ei) below — final outputs unchanged
    lg_den = 2.0 * par["Lf"] * h * phi
    lat_grow = -Df / jnp.where(lg_den == 0.0, 1.0, lg_den) * Ql
    lat_grow = jnp.where(lg_den == 0.0, 0.0, lat_grow)
    lat_grow = jnp.where(h == 0.0, 0.0, lat_grow)  # zeroref!(lat_grow, h) (:144)
    weld = par["kappa"] * par["alpha"] / 4.0 * phi * Df**3
    rD = Df + (lat_melt + lat_grow + weld) * dt
    total = n + dn
    zero_total = total == 0.0
    D1 = (n * rD + dn * par["Dmin"]) / jnp.where(zero_total, 1.0, total)  # average new pancakes (:129-134,176)
    D1 = jnp.where(zero_total, 0.0, D1)
    D1 = jnp.clip(D1, par["Dmin"], par["Dmax"])  # (:177)
    D1 = jnp.where(Ei1 == 0.0, 0.0, D1)  # zeroref!(D, Ei) (:178)

    rh = h + (-1.0 / par["Lf"] * Fvi) * dt  # h_t (:139,179)
    rh = jnp.maximum(rh, 0.0)  # clamp!(rh, 0, Inf) (:180)
    h1 = (n * rh + dn * par["hmin"]) / jnp.where(zero_total, 1.0, total)  # (:181)
    h1 = jnp.where(zero_total, 0.0, h1)

    # -- concentration (:183, concentration :74-80) --------------------
    zero_h1 = h1 == 0.0
    phi1 = -Ei1 / jnp.where(zero_h1, 1.0, par["Lf"] * h1)
    phi1 = jnp.where(zero_h1, 0.0, phi1)
    phi1 = jnp.where(phi1 > 1.0, 1.0, phi1)

    # -- totals (:185-187) ---------------------------------------------
    Ei1 = jnp.where(h1 == 0.0, 0.0, Ei1)  # zeroref!(Ei, h)
    E = phi1 * Ei1 + (1.0 - phi1) * Ew1
    T = Ti * phi1 + (1.0 - phi1) * Tw  # Tbar(Ti, Tw, phi) with updated phi

    # -- NaN masking for storage only (:193-194) -----------------------
    nan = jnp.asarray(jnp.nan, dtype=dtype)
    Ti_out = jnp.where(Ei1 == 0.0, nan, Ti)
    Tw_out = jnp.where(phi1 > 0.99, nan, Tw)

    carry = Collection(Ei=Ei1, Ew=Ew1, h=h1, D=D1, phi=phi1, T0=T0)
    out = Collection(
        E=E, T=T, h=h1, Ei=Ei1, Ew=Ew1, Ti=Ti_out, Tw=Tw_out, D=D1, phi=phi1, n=n,
        # float (1.0 = all converged): boolean reductions have no AD rules,
        # and this flag must ride through differentiable scans
        newton_converged=jax.lax.stop_gradient(
            jnp.min(jnp.asarray(converged, dtype))
        ),
    )
    return carry, out


MIZ = register_model(
    ModelSpec(
        name="MIZ",
        statics=statics,
        init_carry=init_carry,
        step=step,
        step_inputs=step_inputs,
        solution_vars=("E", "T", "h", "Ei", "Ew", "Ti", "Tw", "D", "phi", "n"),
        presentation_nan_vars=("Ti", "Tw"),
        init_vars=("Ei", "Ew", "h", "D", "phi"),
    )
)
