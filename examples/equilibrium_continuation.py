"""Hysteresis branches by numerical continuation of equilibria.

The reference maps hysteresis by integrating a multi-decade forcing ramp
and reading states off the trajectory (plot_seasonal workflows,
/root/reference/src/plot.jl:173-225). `ebm.continuation` traces each branch
directly: equilibrate at a forcing level, then WARM-START the next level
from the converged state — the warm/cold branch is followed (and its fold
located) without simulating the ramp at all. Each equilibration runs on
device (`lax.while_loop` over the year map, dispatched in bounded
chunks).

Run: python examples/equilibrium_continuation.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import energybalancemodel_jl_tpu as ebm  # noqa: E402


def main(fast=False):
    # fast=True: CI-sized grid and path, same workflow
    st = ebm.SpaceTime.sin(16, 150, 1) if fast else ebm.SpaceTime.sin(60, 500, 1)
    par = ebm.default_parameters("MIZ")

    # tol 1e-2: in float32 (the throughput default) the adaptive Newton solve
    # leaves O(1e-3) year-over-year noise in the annual means — a tighter
    # tol chases solver noise, not physics (use float64 for tighter
    # equilibria)
    F_up = np.linspace(-4.0, 6.0, 4 if fast else 11)
    cont = ebm.continuation("MIZ", st, F_up, par, ebm.zeros_init(st),
                            round_trip=True, tol=1e-2,
                            max_years=150 if fast else 400)
    print(cont)

    area = cont.ice_area()
    fwd = cont.direction > 0
    print(f"{'F':>6}  {'cold->warm':>10}  {'warm->cold':>10}")
    for F in F_up:
        a_up = area[fwd & (cont.values == F)]
        a_dn = area[~fwd & (cont.values == F)]
        dn = f"{a_dn[0]:10.3f}" if len(a_dn) else " " * 10
        gap = (" <- bistable" if len(a_dn)
               and abs(a_up[0] - a_dn[0]) > 0.05 else "")
        print(f"{F:+6.1f}  {a_up[0]:10.3f}  {dn}{gap}")
    print("Where the two legs disagree at the same F, the model is "
          "bistable — the hysteresis window.")


if __name__ == "__main__":
    main()
