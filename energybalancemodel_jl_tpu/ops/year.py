"""Whole-year engine (``engine='fused'``): one simulated year of a ``(K, nx)``
ensemble as a single jitted XLA program.

The year is a ``lax.fori_loop`` over the ``nt`` physics steps of
:func:`..models.miz.step` / :func:`..models.classic.step` — the functions the
per-year scan engine (:func:`..integrate.make_year_fn`) runs — with the
seasonal stores (annual sums, winter/summer snapshots at the reference tick
indices, ``savesol!`` /root/reference/src/infrastructure.jl:549-589), the
Newton convergence flag and the optional per-step extras carried through the
loop. What it adds over the per-year scan engine:

- every parameter may be swept per member, including the insolation and
  coalbedo parameters (the separable insolation
  ``(S0 - (S1 x) cos 2 pi t) - S2 x^2`` is rebuilt each step from per-member
  values, in the statics table's op order), plus the virtual constant
  forcing offset ``F``;
- per-step per-member forcing offsets: an explicit ``(nt, K)`` table, or
  white noise drawn from per-member keys inside the year program
  (:func:`normal_table`), optionally turned into an Ornstein-Uhlenbeck path
  — by the serial recurrence inside the loop or by a log-depth associative
  scan before it;
- a per-step record of the first step at which the instantaneous ice area
  crosses a per-member threshold (sub-annual transition timing).

The adaptive Newton loop decides convergence over the whole batch each step,
as in the per-year batched engine; the two engines therefore agree to the
Newton tolerance, not bitwise.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..solutions import Seasonal
from ..utils.collection import Collection

__all__ = ["miz_year", "classic_year", "normal_table"]

# scan-carry fields and recorded variables (models/miz.py, models/classic.py)
CARRY_KEYS = ("Ei", "Ew", "h", "D", "phi", "T0")
OUT_VARS = ("E", "T", "h", "Ei", "Ew", "Ti", "Tw", "D", "phi", "n")
C_CARRY_KEYS = ("E", "Tg")
C_OUT_VARS = ("E", "T", "h")


def normal_table(keys, nt: int, dtype):
    """The ``(nt, K)`` white-noise table of per-member keys: column ``k`` is
    ``jax.random.normal(keys[k], (nt,), dtype)`` — the same draws the
    per-year scan engine takes for the same keys. ``keys`` is ``(K, 2)``
    uint32 key data."""
    return jax.vmap(lambda k: jax.random.normal(k, (nt,), dtype),
                    out_axes=1)(jnp.asarray(keys))


def _check_noise_args(nt: int, K: int, noise, noise_ou, noise_keys):
    if noise is not None and noise_keys is not None:
        raise ValueError(
            "noise= (explicit table) and noise_keys= (generated draws) are "
            "mutually exclusive")
    if noise_keys is not None:
        keys = jnp.asarray(noise_keys)
        if keys.dtype != jnp.uint32 or keys.shape != (K, 2):
            raise ValueError(
                f"noise_keys must be a ({K}, 2) uint32 key-data array, got "
                f"{keys.dtype} {keys.shape}")
    if noise is not None and jnp.shape(noise) != (nt, K):
        raise ValueError(
            f"noise must have shape (nt, K) = ({nt}, {K}), got "
            f"{jnp.shape(noise)}")
    if noise_ou is not None and noise is None and noise_keys is None:
        raise ValueError(
            "noise_ou requires the white-noise table (noise=) or generation "
            "keys (noise_keys=)")


def _offsets(noise, noise_ou, noise_keys, ou_assoc: bool, nt: int, K: int,
             dtype):
    """The loop's per-step offset table and OU state.

    Returns ``(table, ou, eta_end)``: ``table`` is the ``(nt, K)`` table the
    loop reads (None without noise); ``ou = (rho, scale, eta0)`` when the
    loop runs the serial OU recurrence over that (white) table, else None;
    ``eta_end`` the year-end OU value when it is known before the loop (the
    associative path)."""
    if noise_keys is not None:
        white = normal_table(noise_keys, nt, dtype)
    elif noise is not None:
        white = jnp.asarray(noise, dtype)
    else:
        return None, None, None
    if noise_ou is None:
        return white, None, None
    rho, scale, eta0 = (jnp.asarray(v, dtype) for v in noise_ou)
    eta0 = jnp.broadcast_to(eta0, (K,))
    if not ou_assoc:
        return white, (rho, scale, eta0), None
    # eta_t = rho eta_{t-1} + scale xi_t as a composition of affine maps
    # x -> a x + b, evaluated by a log-depth scan over time: the same
    # recurrence, regrouped (round-off-level twin of the serial chain;
    # scale = eta0 = 0 still gives eta == 0 exactly)
    a = jnp.broadcast_to(rho, white.shape)
    b = scale * white
    A, B = lax.associative_scan(
        lambda p, q: (q[0] * p[0], q[0] * p[1] + q[1]), (a, b), axis=0)
    path = A * eta0 + B
    return path, None, path[-1]


def _trapezoid_weights(x, dtype):
    """Per-cell weights ``w`` with ``sum_i w_i v_i`` equal to the trapezoid
    integral (utils.numerics.hemispheric_mean) up to summation order."""
    dx = np.diff(np.asarray(x, dtype=np.float64))
    w = np.zeros(dx.size + 1)
    w[:-1] += dx / 2.0
    w[1:] += dx / 2.0
    return jnp.asarray(w, dtype)


def _member(v, K: int):
    """A scalar stays scalar; a (K,) leaf becomes a (K, 1) column."""
    if jnp.ndim(v) == 0:
        return v
    v = jnp.reshape(v, (-1,))
    if v.shape[0] != K:
        raise ValueError(
            f"swept parameter leaves must have shape ({K},), got {v.shape}")
    return v[:, None]


def _year_loop(step, carry0, out_vars, st, dtype, K, forcing_t, inputs_t,
               table, ou, crossing, area_of):
    """The shared ``fori_loop`` over the year's steps. ``inputs_t(t)`` gives
    the step's insolation inputs, ``forcing_t(t)`` the shared forcing plus
    the per-member constant offset; ``table``/``ou`` add the per-step
    offsets (see :func:`_offsets`)."""
    nt = st.nt
    w0 = st.winter_inx - 1  # reference tick indices are 1-based
    s0 = st.summer_inx - 1
    shape = carry0[next(iter(carry0))].shape
    zeros = Collection({k: jnp.zeros(shape, dtype) for k in out_vars})
    first0 = thr = sgn = None
    if crossing is not None:
        thr, sgn = (jnp.broadcast_to(jnp.asarray(v, dtype), (K,))
                    for v in crossing)
        first0 = jnp.full((K,), -1.0, dtype)

    def body(t, state):
        carry, acc, wint, summ, conv, eta, first = state
        f_t = forcing_t(t)
        if ou is not None:
            eta = ou[0] * eta + ou[1] * table[t]
            f_t = f_t + eta[:, None]
        elif table is not None:
            f_t = f_t + table[t][:, None]
        xs = inputs_t(t)
        xs["f"] = f_t
        carry, out = step(carry, xs)
        out = Collection(out)
        step_conv = out.pop("newton_converged", None)
        if step_conv is not None:
            conv = jnp.minimum(conv, step_conv)
        acc = Collection({k: acc[k] + out[k] for k in out_vars})
        wint = Collection(
            {k: jnp.where(t == w0, out[k], wint[k]) for k in out_vars})
        summ = Collection(
            {k: jnp.where(t == s0, out[k], summ[k]) for k in out_vars})
        if first is not None:
            area = jnp.sum(area_of(out), axis=-1)
            crossed = (first < 0) & (sgn * (area - thr) > 0)
            first = jnp.where(crossed, lax.convert_element_type(t, dtype),
                              first)
        return carry, acc, wint, summ, conv, eta, first

    state0 = (carry0, zeros, zeros, zeros, jnp.ones((), dtype),
              None if ou is None else ou[2], first0)
    carry, acc, wint, summ, conv, eta, first = lax.fori_loop(
        0, nt, body, state0)
    avg = Collection({k: v / jnp.asarray(float(nt), dtype)
                      for k, v in acc.items()})
    return carry, (wint, summ, avg), conv, eta, first


def _finish(carry, stores, conv, eta_end, first, crossing):
    if crossing is not None:
        return carry, Seasonal(*stores), conv, eta_end, first
    return carry, Seasonal(*stores), conv, eta_end


def _prepare(carry, par, fyear, st, keys, noise, noise_ou, noise_keys,
             ou_assoc):
    dtype = carry[keys[0]].dtype
    K = carry[keys[0]].shape[0]
    _check_noise_args(st.nt, K, noise, noise_ou, noise_keys)
    par = Collection({k: jnp.asarray(v, dtype) for k, v in par.items()})
    table, ou, eta_end = _offsets(noise, noise_ou, noise_keys, ou_assoc,
                                  st.nt, K, dtype)
    carry0 = Collection({k: jnp.asarray(carry[k], dtype) for k in keys})
    f = jnp.asarray(fyear, dtype)
    F = _member(par.get("F", jnp.zeros((), dtype)), K)
    pc = Collection({k: _member(v, K) for k, v in par.items() if k != "F"})
    x = jnp.asarray(st.x, dtype)[None, :]
    cosv = jnp.cos(2.0 * jnp.pi * jnp.asarray(st.t, dtype))
    w = _trapezoid_weights(st.x, dtype)[None, :]
    return dtype, K, pc, table, ou, eta_end, carry0, f, F, x, cosv, w


@functools.partial(jax.jit, static_argnames=("st", "cfg", "ou_assoc"))
def miz_year(carry, par, fyear, st, cfg, noise=None, noise_ou=None,
             noise_keys=None, ou_assoc: bool = False, crossing=None):
    """Run one MIZ model year for a ``(K, nx)`` ensemble.

    Twin of the seasonal-only ``make_year_fn`` signature:
    ``(carry, par, fyear) -> (carry, Seasonal, converged, eta_end)``. Any
    parameter leaf may be scalar (shared) or ``(K,)`` (swept per member);
    ``par['F']`` is a per-member constant forcing offset.

    ``noise`` is an optional ``(nt, K)`` per-step per-member forcing offset
    — step ``t`` of member ``k`` sees ``f[t] + F[k] + noise[t, k]``; a zero
    table reproduces the deterministic year. ``noise_keys`` (``(K, 2)``
    uint32 key data, exclusive with ``noise``) generates that table as
    white noise inside the year program: member ``k``'s draws are
    ``jax.random.normal(keys[k], (nt,), dtype)`` (:func:`normal_table`).

    ``noise_ou=(rho, scale, eta0)`` reinterprets the table as WHITE noise
    and adds the Ornstein-Uhlenbeck path ``eta_t = rho eta_{t-1} + scale
    xi_t`` (from ``eta0``, ``scale`` scalar or per-member) instead; the 4th
    return value is then the year-end ``eta`` (``(K,)``), else None.
    ``ou_assoc=True`` evaluates the path by a log-depth scan before the loop
    instead of the serial in-loop recurrence (round-off-level twin).

    ``crossing=(thr, sign)`` (per-member rows) adds a 5th return value: the
    first step at which ``sign * (area - thr) > 0`` for the instantaneous
    ice area (trapezoid integral of ``phi``), -1 where never.

    The loop runs on the drivers' ``(K, nx)`` layout: on one H100 at K=8192
    an ``(nx, K)`` loop ran Classic 10% slower and MIZ within 1% (PERF.md
    "Bring-up")."""
    from ..models import miz
    from .diffusion import diffusion_bands

    (dtype, K, pc, table, ou, eta_end, carry0, f, F, x, cosv,
     w) = _prepare(carry, par, fyear, st, CARRY_KEYS, noise, noise_ou,
                   noise_keys, ou_assoc)
    geom = diffusion_bands(st)
    x2 = x**2
    stat = Collection(
        aw=pc["a0"] - pc["a2"] * x2,
        glo=jnp.asarray(geom.lo, dtype)[None, :],
        gdi=jnp.asarray(geom.di, dtype)[None, :],
        gup=jnp.asarray(geom.up, dtype)[None, :],
        dt=st.dt,
        Tm_pow_m2=pc["Tm"] ** pc["m2"],
    )

    def inputs(t):
        # same products, same order as the statics table build
        return Collection(
            insol=(pc["S0"] - (pc["S1"] * x) * cosv[t]) - pc["S2"] * x2)

    def area_of(out):
        phi = out["phi"]
        return w * jnp.where(phi == phi, phi, jnp.zeros((), dtype))

    carry, stores, conv, eta, first = _year_loop(
        lambda c, xs: miz.step(c, xs, stat, pc, cfg), carry0, OUT_VARS, st,
        dtype, K, lambda t: f[t] + F, inputs, table, ou, crossing, area_of)
    if ou is not None:
        eta_end = eta
    return _finish(carry, stores, conv, eta_end, first, crossing)


@functools.partial(jax.jit, static_argnames=("st", "cfg", "ou_assoc"))
def classic_year(carry, par, fyear, st, cfg, noise=None, noise_ou=None,
                 noise_keys=None, ou_assoc: bool = False, crossing=None):
    """Whole-year WE15 integration: the classic twin of :func:`miz_year`
    (same signature, sweep surface and noise/crossing options; the
    instantaneous ice area is the trapezoid integral of ``E < 0``). The
    convergence flag is None (the classic step has no iterative solve)."""
    from ..models import classic

    (dtype, K, pc, table, ou, eta_end, carry0, f, F, x, cosv,
     w) = _prepare(carry, par, fyear, st, C_CARRY_KEYS, noise, noise_ou,
                   noise_keys, ou_assoc)
    geom = classic.uniform_bands(st.nx)
    dt = st.dt
    x2 = x**2
    # classic.statics' scalar combinations and implicit bands, same ops
    cg_tau = pc["cg"] / pc["tau"]
    dt_tau = dt / pc["tau"]

    def band(b):
        return jnp.asarray(b, dtype)[None, :]

    stat = Collection(
        cg_tau=cg_tau, dt_tau=dt_tau, dc=dt_tau * cg_tau,
        M=pc["B"] + cg_tau, aw=pc["a0"] - pc["a2"] * x2,
        kLf=pc["k"] * pc["Lf"],
        klo=-(dt * pc["D"]) * band(geom.lo) / pc["cg"],
        kdi=(1.0 + dt_tau) - (dt * pc["D"]) * band(geom.di) / pc["cg"],
        kup=-(dt * pc["D"]) * band(geom.up) / pc["cg"],
        dt=dt,
    )
    colA = pc["S0"] - pc["S2"] * x2
    cosw = jnp.concatenate([cosv, cosv[:1]])  # wraparound column (:61)

    def inputs(t):
        # statics: S = (S0 - S2 x^2) - (S1 cos) x; row t and row t + 1
        return Collection(S_i=colA - (pc["S1"] * cosw[t]) * x,
                          S_ip1=colA - (pc["S1"] * cosw[t + 1]) * x)

    def area_of(out):
        return w * (out["E"] < 0.0).astype(dtype)

    carry, stores, conv, eta, first = _year_loop(
        lambda c, xs: classic.step(c, xs, stat, pc, cfg), carry0,
        C_OUT_VARS, st, dtype, K, lambda t: f[t] + F, inputs, table, ou,
        crossing, area_of)
    if ou is not None:
        eta_end = eta
    return _finish(carry, stores, None, eta_end, first, crossing)
