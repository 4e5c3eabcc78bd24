"""High-resolution transient CO2-ramp run with checkpoint + JLD2 I/O.

The last BASELINE.json benchmark configuration: a high-resolution grid
driven by a transient (5-segment) CO2-style forcing ramp, with mid-run
checkpointing and JLD2 persistence. The model is Classic: its implicit
tridiagonal Tg solve (/root/reference/src/classic.jl) is unconditionally
stable in nx, while MIZ's explicit Tb diffusion substep
(/root/reference/src/miz.jl:150-162) requires nt ~ nx**2 and cannot reach
high resolution at a sane step count — in the reference package too (the
envelope is pinned by tests/test_highres.py).

What this demonstrates:
- ``engine='auto'`` at high resolution: the same engines as at the
  canonical grid — no size predicate, no fallback.
- per-year ``checkpoint=`` snapshots: re-invoking the identical run
  resumes from the checkpoint (here: the completed state — no recompute)
  instead of starting over; a killed run resumes mid-trajectory the same
  way (bit-exact, tests/test_highres.py).
- JLD2 persistence: the finished ``Solutions`` round-trips through the
  reference package's on-disk format (``io_jld2.write_jld2`` /
  ``load_jld2_solutions``, /root/reference/src/io.jl:10-16).

    python examples/highres_transient.py [outdir]
"""
import os
import sys

import matplotlib

matplotlib.use("Agg")
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import energybalancemodel_jl_tpu as ebm  # noqa: E402
from energybalancemodel_jl_tpu.io_jld2 import (  # noqa: E402
    load_jld2_solutions, write_jld2)


def ice_edge(E, x):
    """Sine-latitude of the equatorward-most ice-covered cell."""
    icy = np.where(E < 0.0)[0]
    return float(x[icy[0]]) if len(icy) else 1.0


def main(outdir=".", fast=False):
    # fast=True: CI-sized (nx=256, 6-year ramp); full: nx=1024, 40 years.
    # nt=1000 is the classic model's step-stability floor either way.
    if fast:
        nx, dur = 256, 6
        ramp = ebm.Forcing(0.0, 2.0, 0.0, (1, 1), (2.0, -2.0))
    else:
        nx, dur = 1024, 40
        ramp = ebm.Forcing(0.0, 4.0, 0.0, (5, 5), (0.4, -0.4))
    st = ebm.SpaceTime.sin(nx, 1000, dur)
    par = ebm.default_parameters("Classic")
    E0 = np.full(nx, 30.0)
    init = ebm.Collection(E=E0, Tg=E0 / par.cw)

    ck = os.path.join(outdir, "highres_transient.ck")
    sols = ebm.integrate("Classic", st, ramp, par, init, engine="auto",
                         lastonly=False, raw_mode="none", checkpoint=ck)
    # the same call again resumes from the checkpoint — no recompute
    sols = ebm.integrate("Classic", st, ramp, par, init, engine="auto",
                         lastonly=False, raw_mode="none", checkpoint=ck,
                         resume=True)

    # JLD2 round-trip: the reference package's load! can open this file
    jld = os.path.join(outdir, "highres_transient.jld2")
    write_jld2(sols, jld)
    back = load_jld2_solutions(jld)

    years = np.arange(dur) + 1.0
    f_vals = np.array([ramp(t) for t in years - 0.5])
    edges_w = np.array([ice_edge(np.asarray(sols.seasonal.winter.E[y]), st.x)
                        for y in range(dur)])
    edges_s = np.array([ice_edge(np.asarray(sols.seasonal.summer.E[y]), st.x)
                        for y in range(dur)])
    edges_back = np.array([ice_edge(np.asarray(back.seasonal.winter.E[y]),
                                    st.x) for y in range(dur)])
    assert np.array_equal(edges_w, edges_back), "JLD2 round-trip drifted"

    print(f"nx={nx}, {dur}-year 5-segment ramp (peak F={ramp(dur/2):+.1f} "
          f"mid-run, F={f_vals[-1]:+.1f} at end)")
    print(f"winter ice edge: start {edges_w[0]:.3f} -> "
          f"min {edges_w.min():.3f} -> end {edges_w[-1]:.3f} (sine lat)")
    print(f"JLD2 round-trip OK: {os.path.basename(jld)}")

    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True, figsize=(7, 5))
    ax1.plot(years, f_vals, color="tab:red")
    ax1.set_ylabel("forcing F (W m$^{-2}$)")
    ax1.set_title(f"Classic nx={nx}: transient CO2-style ramp")
    ax2.plot(years, edges_w, label="winter")
    ax2.plot(years, edges_s, label="summer")
    ax2.set_ylabel("ice edge (sine lat)")
    ax2.set_xlabel("year")
    ax2.legend()
    fig.tight_layout()
    ebm.save(fig, os.path.join(outdir, "highres_transient.png"), dpi=120)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else ".")
