"""Canonical MIZ run: 30 years, seasonal ice cycle, Hovmöller plots.

Reproduces the workflow of the reference's module docstring
(/root/reference/src/EnergyBalanceModel.jl:15-72): SpaceTime{sin}(180, 2000,
30), constant zero forcing, default MIZ parameters, zero initial conditions;
saves the solutions and renders the raw/annual-average tile plots.

    python examples/miz_seasonal.py [outdir]
"""
import os
import sys

import matplotlib

matplotlib.use("Agg")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import energybalancemodel_jl_tpu as ebm  # noqa: E402


def main(outdir=".", fast=False):
    # fast=True: CI-sized config (seconds on CPU) — same workflow, smaller
    # grid/horizon; the canonical 180x2000x30 run wants an accelerator
    st = (ebm.SpaceTime.sin(40, 200, 3) if fast
          else ebm.SpaceTime.sin(180, 2000, 30))
    forcing = ebm.Forcing(0.0)
    par = ebm.default_parameters("MIZ")
    init = ebm.zeros_init(st, "MIZ")
    sols = ebm.integrate("MIZ", st, forcing, par, init)
    ebm.save(sols, os.path.join(outdir, "miz_sol.h5"))
    ebm.save(ebm.plot_raw(sols), os.path.join(outdir, "miz_raw.png"), dpi=120)
    ebm.save(ebm.plot_avg(sols), os.path.join(outdir, "miz_avg.png"), dpi=120)
    print("ice area, final winter vs summer:",
          float(ebm.hemispheric_mean(sols.seasonal.winter.phi[-1], st.x)),
          float(ebm.hemispheric_mean(sols.seasonal.summer.phi[-1], st.x)))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
