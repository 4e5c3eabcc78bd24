"""Snowball-Earth bifurcation across the solar constant S0.

Classic EBM theory (Budyko/Sellers) predicts bistability in the solar
constant: below a critical S0 the ice-albedo feedback runs away into a
snowball state. In the reference this sweep would be a sequential loop of
``integrate`` calls with edited parameter dicts; here the whole S0 range
runs as ONE device ensemble through the whole-year engine, which rebuilds
the separable insolation per member, so even the table-shaping
parameters (S0, S1, S2, a0, a2) sweep in one program.

    python examples/solar_constant_sweep.py [outdir]
"""
import os
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import energybalancemodel_jl_tpu as ebm  # noqa: E402
from energybalancemodel_jl_tpu.parallel import sweep  # noqa: E402
from energybalancemodel_jl_tpu.utils.numerics import np_hemispheric_mean  # noqa: E402


def main(outdir=".", fast=False):
    # fast=True: CI-sized grid/members on the default engine
    # (engine='auto' picks the right one)
    spinup = 4 if fast else 30
    st = (ebm.SpaceTime.sin(24, 200, spinup) if fast
          else ebm.SpaceTime.sin(180, 2000, spinup))
    par = ebm.default_parameters("MIZ")

    S0s = np.linspace(390.0, 450.0, 8 if fast else 64)
    kwargs = ({} if fast
              else dict(engine="fused", years_per_dispatch=8))
    ens = sweep(
        "MIZ", st, ebm.Forcing(0.0), par, {"S0": S0s}, ebm.zeros_init(st),
        dtype="float32", **kwargs,
    )

    # final-year annual means per member
    phi = np.nan_to_num(ens.seasonal.avg["phi"][:, -1])  # (K, nx)
    T = np.nan_to_num(ens.seasonal.avg["T"][:, -1])
    area = np.array(
        [2.0 * np.pi * np_hemispheric_mean(p, st.x) for p in phi]
    )
    Tmean = np.array([np_hemispheric_mean(t, st.x) for t in T])

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4.2),
                                   constrained_layout=True)
    ax1.plot(S0s, area, "o-", ms=3, lw=1.0)
    ax1.set_xlabel(r"solar constant $S_0$ (W m$^{-2}$)")
    ax1.set_ylabel(r"ice area $2\pi\langle\varphi\rangle$")
    ax1.set_title(f"Ice area after {spinup} years")
    ax2.plot(S0s, Tmean, "o-", ms=3, lw=1.0, color="tab:red")
    ax2.set_xlabel(r"solar constant $S_0$ (W m$^{-2}$)")
    ax2.set_ylabel(r"$\langle T \rangle$ (°C)")
    ax2.set_title("Mean temperature")
    ebm.save(fig, os.path.join(outdir, "solar_constant_sweep.png"), dpi=120)
    print(f"swept S0 over {len(S0s)} members x {spinup} years; "
          f"ice area range [{area.min():.2f}, {area.max():.2f}]")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
