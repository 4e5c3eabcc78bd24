"""Gradient-based parameter calibration — sweep-then-polish recipe.

Identifies the OLR constant ``A`` of the classic model from a synthetic
"observed" enthalpy field, demonstrating the reliable two-stage recipe for
this framework's calibration API (``ebm.calibrate``):

1. a coarse :func:`~energybalancemodel_jl_tpu.parallel.sweep` scan locates
   the misfit basin (thousands of candidates in one ensemble — and the
   only trustworthy tool when the landscape is jagged, as the MIZ model's
   ice-edge jumps make it);
2. ``calibrate`` polishes inside the basin by gradient descent through the
   reverse-differentiable integrator.

    python examples/calibration.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)
# this example runs float64 calibration on the CPU; set BEFORE any
# backend query — the env var alone can be overridden by site config
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import energybalancemodel_jl_tpu as ebm  # noqa: E402
from energybalancemodel_jl_tpu.parallel import sweep  # noqa: E402


def main(fast=False):
    # fast=True: CI-sized — smaller grid/coarser sweep/fewer steps
    st = ebm.SpaceTime.sin(8 if fast else 30, 1000, 1)
    base = ebm.default_parameters("Classic")
    E0 = np.full(st.nx, 40.0)
    init = ebm.Collection(E=E0, Tg=E0 / float(base["cw"]))
    forcing = ebm.Forcing(0.0)

    # synthetic observations from the "true" parameter
    A_true = 196.3  # deliberately OFF the coarse grid below
    par_true = ebm.Collection(base)
    par_true["A"] = A_true
    obs = ebm.integrate("Classic", st, forcing, par_true, init,
                        progress=False, raw_mode="none")
    E_obs = np.asarray(obs.seasonal.avg["E"][-1])

    # stage 1: coarse sweep across the plausible range
    grid = np.linspace(185.0, 205.0, 5 if fast else 21)
    ens = sweep("Classic", st, forcing, base, {"A": grid}, init,
                progress=False)
    misfit = np.mean(
        (np.asarray(ens.seasonal.avg["E"][:, -1, :]) - E_obs) ** 2, axis=1
    )
    A0 = float(grid[np.argmin(misfit)])
    print(f"sweep: best A on the coarse grid = {A0} "
          f"(misfit {misfit.min():.3g})")

    # stage 2: gradient polish from the basin
    par0 = ebm.Collection(base)
    par0["A"] = A0
    res = ebm.calibrate("Classic", st, forcing, par0, init,
                        target={"E": E_obs}, vary=("A",),
                        steps=15 if fast else 80, learning_rate=0.05)
    print(res)
    print(f"fitted A = {float(res.params['A']):.4f} (true {A_true}); "
          f"|grad| at stop = {abs(float(res.grads['A'])):.2e}")

    # one-call alternative: multi-start calibration — S vmapped
    # optimizations in ONE compiled program (the sweep-then-polish recipe
    # fused on chip); the best final loss wins, every start is reported
    n_st = 4 if fast else 8
    res_ms = ebm.calibrate("Classic", st, forcing, base, init,
                           target={"E": E_obs}, vary=("A",),
                           steps=15 if fast else 80, learning_rate=0.3,
                           n_starts=n_st, start_spread=0.03)
    print(res_ms)
    print(f"multi-start: best start #{res_ms.best} of {n_st}, "
          f"per-start A = {np.round(np.asarray(res_ms.start_params['A']), 3)}")


if __name__ == "__main__":
    main()
