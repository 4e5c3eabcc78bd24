"""Gradient-based parameter calibration.

A capability with no reference analog (the reference tunes parameters by
hand-run sweeps): the integrator is reverse-differentiable end to end — the
MIZ surface-temperature Newton solve carries an implicit-function-theorem
custom VJP (:mod:`.models.miz`), masked divisions are cotangent-safe — so a
physical parameter vector can be FIT to target diagnostics by gradient
descent. The whole optimization step (multi-year forward scan, backward
pass, optax update) compiles into one XLA program.

Usage::

    import energybalancemodel_jl_tpu as ebm

    result = ebm.calibrate(
        "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
        target={"T": T_obs},          # seasonal annual-mean targets, (nx,)
        vary=("D", "A"),              # parameters to fit
        steps=150,
    )
    result.params["D"]                # fitted values
    result.par                        # full fitted parameter Collection
    sols = ebm.integrate("MIZ", st, forcing, result.par, init)

Caveats (same physics as examples/adjoint_sensitivity.py): the system is
chaotic, so gradients are well-behaved over short horizons — calibrate
against one-to-few-year seasonal means (the default) rather than long
transients; for long-horizon objectives use ensemble-averaged losses.

The loss LANDSCAPE matters as much as the gradients: MIZ seasonal means
are jagged in the parameters (the discrete ice-edge position jumps between
grid cells — measured: the 1-year-from-zeros mean-E misfit vs D is
non-monotone at 0.01-level steps), so gradient descent refines within a
basin but cannot be trusted to cross one. The reliable recipe is a coarse
:func:`~energybalancemodel_jl_tpu.parallel.sweep` scan to locate the basin
(thousands of candidates in one ensemble), then ``calibrate`` to polish.
Smooth configurations — the classic model from an ice-free init, integral
diagnostics, spun-up initial states — converge directly (the test recovers
the classic OLR constant to 1e-3 from 3 W/m^2 away).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .forcing import Forcing
from .models.base import default_step_config, get_model
from .spacetime import SpaceTime
from .utils.collection import Collection

__all__ = ["calibrate", "CalibrationResult"]


@dataclasses.dataclass
class CalibrationResult:
    """Outcome of :func:`calibrate`.

    ``params``: fitted values of the varied parameters (name -> float).
    ``par``: the full parameter Collection with fitted values substituted.
    ``losses``: loss trajectory, shape ``(steps,)`` — ``losses[i]`` is the
    loss AFTER ``i + 1`` optimizer steps, so ``losses[-1]`` is evaluated
    at the returned parameters themselves (one extra objective evaluation
    after the loop; without it the report would lag the parameters by one
    update, and a final step off a jagged basin would go unnoticed).
    ``grads``: gradient at the returned parameters (stationarity
    diagnostic: large values mean the fit has not converged).

    Multi-start runs (``n_starts``/``theta0``) report the BEST start in the
    fields above — smallest final loss among starts whose loss and fitted
    values are all finite (diverged starts never win; if every start
    diverged, start 0 is reported with a warning) — and additionally fill
    ``best`` (its index), ``start_params`` (per-start fitted values,
    ``(S,)`` each) and ``start_losses`` (per-start final loss, ``(S,)``) —
    inspecting them shows which basins the starts found.
    """
    params: Collection
    par: Collection
    losses: np.ndarray
    grads: Collection
    best: Optional[int] = None
    start_params: Optional[Collection] = None
    start_losses: Optional[np.ndarray] = None

    def __repr__(self):
        fitted = ", ".join(f"{k}={float(v):.6g}" for k, v in self.params.items())
        starts = (f", best of {len(self.start_losses)} starts"
                  if self.start_losses is not None else "")
        if len(self.losses) == 0:  # steps=0: plumbing-only call
            return f"CalibrationResult({fitted}; 0 steps{starts})"
        return (
            f"CalibrationResult({fitted}; loss {self.losses[0]:.3e} -> "
            f"{self.losses[-1]:.3e} in {len(self.losses)} steps{starts})"
        )


def _default_loss(target: Dict[str, np.ndarray],
                  nan_ok: Sequence[str] = ()):
    """Mean-squared misfit of final-year seasonal annual means against
    ``target`` fields.

    For PRESENTATION-NaN variables (``nan_ok`` — the model's
    ``Ti``/``Tw``, NaN-masked over ice-free/ice-covered cells in healthy
    runs), cells where EITHER side is NaN are masked out of the misfit
    entirely — a target taken from a prior run's ``seasonal.avg`` contains
    them, and zeroing only one side would score real predictions against a
    spurious 0.0 in edge cells that changed regime, pulling the fit toward
    T=0 there instead of ignoring them.

    For every OTHER variable a NaN prediction means the run DIVERGED, so it
    incurs an infinite loss instead of being masked: silently excluding it
    would report loss 0 for a fully diverged run, and a multi-start fit
    would then select the diverged start as the winner. NaN cells in the
    *target* are still excluded (caller-provided junk is harmless)."""
    tgt = {k: jnp.asarray(v) for k, v in target.items()}
    nan_ok = frozenset(nan_ok)

    def loss(seasonal):
        total = 0.0
        for k, v in tgt.items():
            pred = seasonal.avg[k]
            tgt_ok = ~jnp.isnan(v)
            if k in nan_ok:
                valid = tgt_ok & ~jnp.isnan(pred)
            else:
                valid = tgt_ok
                diverged = jnp.any(jnp.isnan(pred) & tgt_ok)
                # constant branch values: no gradient path through `where`
                total = total + jnp.where(diverged, jnp.inf, 0.0)
            # mask-multiply on nan_to_num'd operands: where() alone still
            # propagates NaN through the gradient of the untaken branch
            diff = jnp.nan_to_num(pred) - jnp.nan_to_num(v)
            total = total + jnp.mean(jnp.where(valid, diff, 0.0) ** 2)
        return total

    return loss


def calibrate(
    model: str,
    st: SpaceTime,
    forcing: Forcing,
    par: Collection,
    init: Collection,
    target: Optional[Dict[str, np.ndarray]] = None,
    vary: Sequence[str] = ("D",),
    loss: Optional[Callable] = None,
    steps: int = 100,
    learning_rate: float = 1e-2,
    optimizer=None,
    newton_max_iter: int = 30,
    dtype=None,
    equilibrium: bool = False,
    equilibrium_tol: float = 1e-9,
    equilibrium_max_years: int = 500,
    n_starts: Optional[int] = None,
    start_spread: float = 0.1,
    seed: int = 0,
    theta0: Optional[Dict[str, np.ndarray]] = None,
) -> CalibrationResult:
    """Fit the parameters named in ``vary`` so the run's final-year seasonal
    diagnostics match ``target`` (or minimize a custom ``loss``).

    Parameters
    ----------
    target:
        Mapping of solution-variable name -> target array, compared against
        the FINAL simulated year's seasonal annual mean (``seasonal.avg``)
        under mean-squared error. Arrays broadcast against ``(nx,)`` rows.
        Exactly one of ``target``/``loss`` must be given.
    equilibrium:
        Fit against the EQUILIBRIUM seasonal state instead of year
        ``st.dur``: the forward model becomes the year-map fixed point
        (solved to ``equilibrium_tol`` within ``equilibrium_max_years``),
        and its gradient uses the implicit-function-theorem adjoint
        (:func:`~energybalancemodel_jl_tpu.equilibrium.make_equilibrium_seasonal_fn`)
        — no unrolling, so the chaotic-horizon gradient explosion that
        limits the ``dur``-year objective does not apply. Requires constant
        forcing; meaningful only where the fixed point is attracting (MIZ,
        or ice-free classic configs — see ``equilibrium.py``). Keep
        configs calibration-sized: the solve runs as one jitted dispatch
        (``make_equilibrium_seasonal_fn`` docstring).
    loss:
        Custom objective ``seasonal -> scalar`` receiving the final year's
        :class:`~energybalancemodel_jl_tpu.solutions.Seasonal` store (use
        ``jnp.nan_to_num`` on ``T``/``Ti``/``Tw`` — NaN is presentation).
    vary:
        Parameter names to optimize; all must exist in ``par``. Every other
        parameter is held fixed.
    steps, learning_rate, optimizer:
        ``optimizer`` is any optax gradient transformation (default
        ``optax.adam(learning_rate)``); ``steps`` update steps are run.
    n_starts, start_spread, seed, theta0:
        MULTI-START mode — the one-program version of the sweep-then-polish
        recipe the jagged MIZ landscape demands (module docstring): ``S``
        independent optimizations run vmapped in ONE compiled program (S
        independent optimizer states; the hardware sees one batched
        model), and the best final loss wins. ``n_starts=S`` perturbs
        each varied parameter multiplicatively by
        ``U(-start_spread, +start_spread)`` (start 0 is the unperturbed
        value; additive for a zero base value); ``theta0`` instead gives
        explicit start values per varied name, shape ``(S,)``. The result
        reports the best start and keeps every start's outcome
        (``start_params``/``start_losses``/``best``).
    dtype:
        Defaults to :func:`~energybalancemodel_jl_tpu.integrate.default_dtype`
        — float64 when x64 is enabled (strongly recommended: f32 gradient
        noise from the Newton solve is comparable to small parameter
        sensitivities; a float32 resolution warns). Explicit float64
        without ``jax_enable_x64`` raises — JAX would silently downcast
        the arrays while the f64 Newton tolerances stayed unreachable.

    Returns a :class:`CalibrationResult`. The forward model is the same
    ``make_year_fn`` graph ``integrate(engine='scan')`` runs — fitted
    parameters reproduce under the standard driver.
    """
    import optax

    if (target is None) == (loss is None):
        raise ValueError("pass exactly one of target= or loss=")
    spec = get_model(model)
    missing = [n for n in vary if n not in par]
    if missing:
        raise ValueError(f"vary names {missing} not in par")
    if target is not None:
        unknown = [k for k in target if k not in spec.solution_vars]
        if unknown:
            raise ValueError(
                f"target variables {unknown} not in {spec.solution_vars}"
            )
        loss = _default_loss(target, nan_ok=spec.presentation_nan_vars)

    from .integrate import default_dtype, make_year_fn

    if dtype is None:
        dtype = default_dtype()
        if dtype != jnp.float64:
            warnings.warn(
                "calibrating in float32 (x64 disabled): f32 Newton-solve "
                "gradient noise is comparable to small parameter "
                "sensitivities — enable jax_enable_x64 for reliable fits"
            )
    dtype = jnp.dtype(dtype)
    if dtype == jnp.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "dtype=float64 requires jax_enable_x64 — without it JAX silently "
            "downcasts the arrays to float32 while the float64 Newton "
            "tolerances stay unreachable (every solve would spin to "
            "max_iter); enable x64 or pass dtype='float32'"
        )
    # same per-dtype tolerance table as every driver, so fitted parameters
    # reproduce under integrate() exactly
    cfg = default_step_config(dtype.name, newton_max_iter=newton_max_iter)
    year = make_year_fn(model, st, cfg, dtype.name, False)
    f_tab = jnp.asarray(forcing.table(st), dtype=dtype)
    base = Collection({k: jnp.asarray(v, dtype=dtype) for k, v in par.items()})
    init_carry = spec.init_carry(init, st, dtype)

    if equilibrium:
        if not forcing.constant:
            raise ValueError(
                "equilibrium=True needs constant forcing (equilibria do "
                "not exist under a ramp)"
            )
        from .equilibrium import make_equilibrium_seasonal_fn

        eq_fn = make_equilibrium_seasonal_fn(
            model, st, cfg, dtype.name, tol=float(equilibrium_tol),
            max_years=int(equilibrium_max_years),
        )

        def objective(theta):
            p = Collection(base)
            for n in vary:
                p[n] = theta[n]
            return loss(eq_fn(p, f_tab[0], init_carry))
    else:
        def objective(theta):
            p = Collection(base)
            for n in vary:
                p[n] = theta[n]
            carry = init_carry

            def body(c, frow):
                c, seasonal, _conv, _ = year(c, p, frow)
                return c, seasonal

            carry, seasons = jax.lax.scan(body, carry, f_tab)
            final = jax.tree_util.tree_map(lambda v: v[-1], seasons)
            return loss(final)

    multi = (n_starts is not None) or (theta0 is not None)
    if theta0 is not None:
        missing = [n for n in vary if n not in theta0]
        if missing:
            raise ValueError(f"theta0 missing varied names {missing}")
        th0 = {n: jnp.atleast_1d(jnp.asarray(np.asarray(theta0[n]),
                                             dtype=dtype)) for n in vary}
        sizes = {v.shape[0] for v in th0.values()}
        if len(sizes) != 1:
            raise ValueError(
                f"theta0 leaves must share one length, got {sorted(sizes)}"
            )
        S = sizes.pop()
        if n_starts is not None and int(n_starts) != S:
            raise ValueError(
                f"n_starts={n_starts} conflicts with theta0 length {S}"
            )
    elif multi:
        S = int(n_starts)
        if S < 1:
            raise ValueError("n_starts must be >= 1")
        rng = np.random.default_rng(seed)
        th0 = {}
        for n in vary:
            val = float(np.asarray(par[n]))
            u = rng.uniform(-1.0, 1.0, S)
            pert = (val * (1.0 + start_spread * u) if val != 0.0
                    else start_spread * u)
            pert[0] = val  # start 0: the unperturbed base, a free baseline
            th0[n] = jnp.asarray(pert, dtype=dtype)
    else:
        th0 = {n: jnp.asarray(par[n], dtype=dtype) for n in vary}

    opt = optax.adam(learning_rate) if optimizer is None else optimizer
    opt_state = opt.init(dict(th0))
    # vmap makes the S starts one batched model; optax transformations are
    # elementwise over the (S,) leaves, i.e. S independent optimizers
    vg = (jax.vmap(jax.value_and_grad(objective)) if multi
          else jax.value_and_grad(objective))

    @jax.jit
    def update(theta, opt_state):
        val, grads = vg(theta)
        updates, opt_state = opt.update(grads, opt_state, theta)
        theta = optax.apply_updates(theta, updates)
        return theta, opt_state, val, grads

    theta = dict(th0)
    losses = []
    for _ in range(int(steps)):
        theta, opt_state, val, _g = update(theta, opt_state)
        losses.append(val)
    # update() evaluates the objective BEFORE applying the step, so the
    # recorded values lag the parameters by one update; evaluate once more
    # at the RETURNED theta so losses[-1]/grads (and the multi-start
    # winner selection below) describe the parameters actually reported —
    # on the jagged MIZ landscapes the final step can leave the basin
    final_val, grads = jax.jit(vg)(theta)
    losses.append(final_val)
    losses = losses[1:]  # keep (steps,): drop the pre-fit initial loss
    # (steps,) single-start, (steps, S) multi-start
    losses = np.asarray(jax.device_get(losses), dtype=np.float64)
    theta, grads = jax.device_get((theta, grads))
    full = Collection({k: np.asarray(v) for k, v in par.items()})
    if multi:
        if len(losses):
            final = losses[-1]
            # a start only qualifies as "best" if its final loss AND its
            # fitted values are finite: np.argmin alone would pick a NaN
            # loss over every finite one, and a NaN theta with a masked-to-
            # zero loss is a diverged run, not a fit
            ok = np.isfinite(final)
            for v in theta.values():
                ok &= np.isfinite(np.asarray(v))
            if ok.any():
                best = int(np.argmin(np.where(ok, final, np.inf)))
            else:  # every start diverged; report start 0 (grads flag it)
                best = 0
                warnings.warn(
                    "all calibration starts diverged (non-finite loss or "
                    "fitted values); reporting start 0 — shrink "
                    "learning_rate/start_spread or check the configuration"
                )
        else:
            best = 0
        start_params = Collection(
            {k: np.asarray(v) for k, v in theta.items()}
        )
        start_losses = (losses[-1] if len(losses)
                        else np.full(S, np.nan))
        fitted = Collection(
            {k: np.asarray(v)[best] for k, v in theta.items()}
        )
        full.update(fitted)
        return CalibrationResult(
            params=fitted,
            par=full,
            losses=losses[:, best] if len(losses) else losses.reshape(0),
            grads=Collection(
                {k: np.asarray(v)[best] for k, v in grads.items()}
            ),
            best=best,
            start_params=start_params,
            start_losses=np.asarray(start_losses),
        )
    fitted = Collection({k: np.asarray(v) for k, v in theta.items()})
    full.update(fitted)
    return CalibrationResult(
        params=fitted,
        par=full,
        losses=losses,
        grads=Collection({k: np.asarray(v) for k, v in grads.items()}),
    )
