"""Bifurcation/hysteresis study over a CO2-style forcing ramp.

The reference user runs warming/cooling scenarios sequentially and plots
hysteresis loops with ``plot_seasonal`` (/root/reference/src/plot.jl:173-225).
Here the same study runs as a single run (hysteresis plot) plus an on-chip
vmapped diffusivity ensemble (bifurcation structure across D).

    python examples/hysteresis.py [outdir]
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
    # 5-segment ramp: hold 0 -> warm to +8 -> hold -> cool to -8 -> hold
    # (fast=True: CI-sized — 1-year segments, small grid, 4 members)
    if fast:
        ramp = ebm.Forcing(0.0, 4.0, -4.0, (1, 1), (4.0, -4.0))
        dur = ramp.domain[4] + 1
        st = ebm.SpaceTime.sin(24, 200, dur)
    else:
        ramp = ebm.Forcing(0.0, 8.0, -8.0, (10, 10), (0.8, -0.8))
        dur = ramp.domain[4] + 5
        st = ebm.SpaceTime.sin(90, 1000, dur)
    par = ebm.default_parameters("MIZ")

    # single-run hysteresis loop (reference plot_seasonal)
    sols = ebm.integrate("MIZ", st, ramp, par, ebm.zeros_init(st))
    fig = ebm.plot_seasonal(sols)
    ebm.save(fig, os.path.join(outdir, "hysteresis.png"), dpi=120)

    # bifurcation across diffusivity: one device ensemble; float32 is
    # plenty for the hysteresis statistics.
    Ds = np.linspace(0.45, 0.75, 4 if fast else 16)
    ens = sweep("MIZ", st, ramp, par, {"D": Ds}, ebm.zeros_init(st),
                dtype="float32")
    area = np.array(
        [
            [
                2.0 * np.pi * np_hemispheric_mean(
                    np.nan_to_num(ens.seasonal.avg["phi"][m, y]), st.x
                )
                for y in range(dur)
            ]
            for m in range(len(Ds))
        ]
    )
    fig, ax = plt.subplots(figsize=(7, 4.5), constrained_layout=True)
    for m, D in enumerate(Ds):
        ax.plot(np.arange(1, dur + 1), area[m], lw=1.2,
                label=f"D={D:.2f}" if m % 5 == 0 else None)
    ax.set_xlabel("year")
    ax.set_ylabel(r"ice area $2\pi\langle\varphi\rangle$")
    ax.set_title("Ice area under forcing ramp across diffusivities")
    ax.legend()
    ebm.save(fig, os.path.join(outdir, "bifurcation.png"), dpi=120)
    print(f"ensemble of {ens.n_members} members over {dur} years done")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
