"""Equilibrium parameter sensitivities: one reverse pass ranks every knob.

No reference analog — the reference probes "what moves the ice edge" by
hand-rerunning sweeps. Here the equilibrium seasonal state is a
differentiable function of the parameters
(:func:`~energybalancemodel_jl_tpu.equilibrium.make_equilibrium_seasonal_fn`,
the implicit-function-theorem adjoint through the year-map fixed point),
so the derivative of a scalar climate diagnostic with respect to EVERY
parameter — all ~22 of them at once — costs one reverse pass, not 22
rerun sweeps. :class:`SensitivityResult` reports raw gradients and
ELASTICITIES (``p * dg/dp`` — the objective change per fractional
parameter change, comparable across parameters of different units), with
``.top()`` ranking the influential knobs.

Caveats inherited from the adjoint (see ``make_equilibrium_seasonal_fn``):
the MIZ year map carries exact neutral frozen-cell modes, so leaves whose
true equilibrium sensitivity diverges (the constant forcing level is one)
return their best TRUNCATED value — finite, descent-useful, and flagged
by validating against finite differences where it matters. Float64 is
strongly recommended (the cotangent iteration composes many reverse
years).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .forcing import Forcing
from .integrate import default_dtype
from .models.base import default_step_config, get_model
from .spacetime import SpaceTime
from .utils.collection import Collection
from .utils.numerics import hemispheric_mean

__all__ = ["sensitivity", "SensitivityResult"]


@dataclasses.dataclass
class SensitivityResult:
    """Result of :func:`sensitivity`.

    ``value`` is the objective at the equilibrium; ``grads`` maps each
    parameter name to ``dg/dp`` (and ``"F"`` to the constant-forcing
    sensitivity, the summed forcing-row cotangent). ``elasticity(name)``
    is ``p * dg/dp`` — the objective change per fractional parameter
    change (zero-valued parameters fall back to the raw gradient);
    ``top(n)`` ranks parameters by its magnitude. Caveat: elasticities
    compare FRACTIONAL changes, which is misleading for offset-scaled
    parameters — ``Tm`` (a melting point in Kelvin) tops every ranking
    because "1% of 273 K" is a physically enormous perturbation; read
    the raw gradient for such parameters.
    """

    of: str
    value: Union[float, np.ndarray]  # scalar, or (K,) for ensembles
    grads: Collection
    par: Collection

    def elasticity(self, name: str):
        """``p * dg/dp`` (raw gradient where p == 0); scalar for single
        runs, ``(K,)`` for ensembles."""
        g = np.asarray(self.grads[name], dtype=np.float64)
        p = (np.asarray(self.par[name], dtype=np.float64)
             if name in self.par else np.zeros(()))
        e = np.where(p != 0.0, g * p, g)
        return float(e) if e.ndim == 0 else e

    def top(self, n: int = 10):
        """The ``n`` most influential parameters as
        ``(name, dg/dp, elasticity)``, by descending ``|elasticity|``
        (ensembles rank by the worst member)."""
        rows = [(k, self.grads[k], self.elasticity(k))
                for k in self.grads]
        rows.sort(key=lambda r: -float(np.max(np.abs(r[2]))))
        return rows[:n]

    def __repr__(self):
        def mag(e):
            return float(np.max(np.abs(np.atleast_1d(e))))

        lead = ", ".join(f"{k}: {mag(e):.3g}" for k, _, e in self.top(3))
        v = np.atleast_1d(np.asarray(self.value, dtype=np.float64))
        val = (f"{float(v[0]):.6g}" if v.size == 1
               else f"{v.size} members, mean {float(v.mean()):.6g}")
        return (f"SensitivityResult({self.of} = {val}; "
                f"top |elasticities| {lead})")


def sensitivity(
    model: str,
    st: SpaceTime,
    forcing: Union[Forcing, float],
    par: Collection,
    init: Collection,
    of: str = "ice_area",
    var: Optional[str] = None,
    season: str = "avg",
    wrt: Optional[Sequence[str]] = None,
    tol: float = 1e-9,
    max_years: int = 500,
    dtype=None,
    newton_max_iter: int = 30,
) -> SensitivityResult:
    """Differentiate a scalar equilibrium diagnostic w.r.t. every parameter.

    ``of`` selects the objective, evaluated on the equilibrium's
    ``season`` store:

    * ``"ice_area"`` (default): ``2 pi <phi>`` — MIZ only (the classic
      model's ice indicator ``E < 0`` has zero gradient almost
      everywhere; ask for a smooth diagnostic there instead);
    * ``"mean"``: hemispheric mean of ``var`` (any solution variable,
      presentation NaNs contribute zero — both models). Precisely: the
      reference's trapezoid-integral ``hemispheric_mean`` normalized by
      the cell-center span ``x[-1] - x[0]`` (the raw integral is an
      AREA-scaled quantity; oracle comparisons must match this
      definition — tests/test_oracle_equilibrium.py does).

    ``wrt`` restricts the differentiated names (default: every ``par``
    key plus the constant forcing level ``"F"``). The fixed point is
    solved to ``tol`` within ``max_years`` INSIDE one jitted dispatch
    (``make_equilibrium_seasonal_fn`` — keep configs calibration-sized;
    ensemble members multiply the device time of that dispatch); the
    gradient is
    the IFT adjoint, never an unroll.

    ``par`` leaves of shape ``(K,)`` — including the virtual forcing
    key ``"F"`` — make the run a lockstep ENSEMBLE: the solves and
    adjoints vmap over members, every gradient comes back ``(K,)``, and
    ``top()`` ranks by the worst member — e.g. sweep ``"F"`` toward a
    fold and watch the sensitivities blow up as the branch loses
    stability. ``init`` may be shared ``(nx,)`` or per-member
    ``(K, nx)`` (a previous ensemble equilibrate's ``.state``).

    Returns a :class:`SensitivityResult`; reference-free capability
    (the reference reruns sweeps per parameter by hand).
    """
    spec = get_model(model)
    if not isinstance(forcing, Forcing):
        forcing = Forcing(float(forcing))
    if not forcing.constant:
        raise ValueError("sensitivity needs constant forcing (equilibria "
                         "do not exist under a ramp)")
    if dtype is None:
        dtype = default_dtype()
    dtype = jnp.dtype(dtype)
    if dtype != jnp.float64:
        import warnings

        warnings.warn(
            "sensitivity at float32: the adjoint composes many reverse "
            "years and frozen-cell lanes carry spurious f32 gain "
            "(stability docstring) — float64 strongly recommended."
        )

    par = Collection(par)
    par.pop("__K__", None)  # batched_parameters() marker, not a parameter
    sizes = {np.shape(v)[0] for v in par.values() if np.ndim(v) > 0}
    sizes |= {np.shape(v)[0] for v in init.values() if np.ndim(v) > 1}
    if len(sizes) > 1:
        raise ValueError(f"inconsistent ensemble sizes {sorted(sizes)}")
    K = sizes.pop() if sizes else None
    F_off = par.pop("F", None)
    if F_off is not None and np.ndim(F_off) == 0 and K is None:
        forcing = Forcing(float(forcing.base) + float(F_off))
        F_off = None

    if of == "ice_area":
        if "phi" not in spec.solution_vars:
            raise ValueError(
                "of='ice_area' needs the MIZ phi field; the classic ice "
                "indicator (E < 0) has zero gradient a.e. — use "
                "of='mean' with var='T' or var='E'")

        def objective(coll):
            return 2.0 * jnp.pi * hemispheric_mean(
                jnp.nan_to_num(coll["phi"]), jnp.asarray(st.x, dtype))
    elif of == "mean":
        if var is None or var not in spec.solution_vars:
            raise ValueError(
                f"of='mean' needs var= one of {sorted(spec.solution_vars)}")

        def objective(coll):
            x = jnp.asarray(st.x, dtype)
            return hemispheric_mean(jnp.nan_to_num(coll[var]), x) / (
                x[-1] - x[0])
    else:
        raise ValueError(f"unknown objective {of!r}; 'ice_area' or 'mean'")

    from .equilibrium import make_equilibrium_seasonal_fn

    cfg = default_step_config(dtype.name, newton_max_iter=newton_max_iter)
    eq_fn = make_equilibrium_seasonal_fn(
        model, st, cfg, dtype.name, tol=float(tol),
        max_years=int(max_years),
    )
    frow = jnp.asarray(forcing.table(st)[0], dtype)
    carry0 = spec.init_carry(init, st, dtype)

    def g(p, f, c):
        s = eq_fn(p, f, c)
        return objective(getattr(s, season))

    vg = jax.value_and_grad(g, argnums=(0, 1))
    if K is None:
        par_j = Collection({k: jnp.asarray(v, dtype)
                            for k, v in par.items()})
        value, (pbar, fbar) = vg(par_j, frow, carry0)
        fgrad = np.asarray(fbar).sum()
    else:
        # lockstep ensemble: every par leaf broadcast to (K,), per-member
        # forcing rows carry the virtual "F" offsets, solves and adjoints
        # vmapped over members (carry leaves map on axis 0 only when
        # per-member)
        par_j = Collection({
            k: jnp.broadcast_to(jnp.asarray(v, dtype), (int(K),))
            for k, v in par.items()
        })
        frow_b = jnp.broadcast_to(frow, (int(K), st.nt))
        if F_off is not None:
            frow_b = frow_b + jnp.asarray(
                np.broadcast_to(np.asarray(F_off, np.float64), (int(K),)),
                dtype)[:, None]
        c_axes = Collection({
            k: (0 if jnp.ndim(v) > 1 else None) for k, v in carry0.items()
        })
        value, (pbar, fbar) = jax.vmap(vg, in_axes=(0, 0, c_axes))(
            par_j, frow_b, carry0)
        fgrad = np.asarray(fbar).sum(axis=-1)
    grads = {k: np.asarray(v) for k, v in pbar.items()}
    # constant forcing enters every step additively, so dg/dF is the
    # summed forcing-row cotangent (truncated where the neutral frozen
    # modes make the true value diverge — module docstring)
    grads["F"] = fgrad
    grads = {k: (float(v) if np.ndim(v) == 0 else v)
             for k, v in grads.items()}
    if wrt is not None:
        unknown = [k for k in wrt if k not in grads]
        if unknown:
            raise ValueError(f"wrt names {unknown} not in {sorted(grads)}")
        grads = {k: grads[k] for k in wrt}
    rep_par = Collection(par)
    rep_par["F"] = (float(forcing.base) if F_off is None
                    else float(forcing.base) + np.asarray(F_off, np.float64))
    value = np.asarray(value)
    return SensitivityResult(
        of=of if of == "ice_area" else f"mean({var})",
        value=float(value) if value.ndim == 0 else value,
        grads=Collection(grads),
        par=rep_par,
    )
