"""MIZ saddle hunt: map where (if anywhere) the MIZ model is bistable,
and if a window exists, produce and verify its saddle.

VERDICT r3 item #5.  Background: Wagner & Eisenman's headline result for
this model family (the reference's own source, /root/reference/src/miz.jl)
is that latitudinal diffusion + seasonal cycle + ice thermodynamics
TOGETHER suppress the small/large-ice-cap instabilities that simpler EBMs
show — the round-2 map (examples/bistability_map.py) measured leg gaps
< 0.1 over F in [-6, 8], D in [0.05, 0.7] at defaults.  The same theory
says the single-column limit D -> 0 should recover EW09-style bistability.
This script tests exactly that frontier:

  stage A  hysteresis scan — one lockstep `continuation(round_trip=True)`
           with D as a (K,) par leaf over an extended forcing path
           (F: +8 .. -24), leg-vs-leg ice-area gap per (D, F) cell;
  stage B  (only where stage A finds a window) saddle production —
           `edge_state` between the two coexisting attractors — the
           boundary CROSSING + its transverse escape growth. (Round-4
           measurement: the MIZ snowball boundary is razor-thin, no
           year-map fixed point is numerically reachable there —
           `unstable_branch` is classic-only in practice; see
           examples/miz_hysteresis.py and tests/test_miz_bistability.py.)

Run on the GPU:
    python scripts/miz_saddle_hunt.py
CPU smoke:  python scripts/miz_saddle_hunt.py --fast

Writes the sweep artifact to scripts/miz_saddle_hunt.json; the pinned
conclusions live in tests/test_miz_bistability.py.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import energybalancemodel_jl_tpu as ebm  # noqa: E402
from energybalancemodel_jl_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)


def hysteresis_scan(st, D_vals, F_path, tol, max_years, dtype):
    """One round-trip continuation with D swept across members.

    Returns (gvals, gap): forcing levels compared leg-vs-leg and the
    (L', K) ice-area split between the descending and returning legs.
    """
    par = ebm.Collection(ebm.default_parameters("MIZ"))
    par["D"] = np.asarray(D_vals, dtype=np.float64)
    cont = ebm.continuation("MIZ", st, F_path, par, ebm.zeros_init(st),
                            round_trip=True, tol=tol, max_years=max_years,
                            dtype=dtype)
    gvals, gap = cont.hysteresis_gap()
    return cont, gvals, np.asarray(gap)


def saddle_at(st, D, F, tol, max_years, dtype, fast):
    """Produce the saddle between the two coexisting attractors at (D, F).

    ``st`` here is the DIAGNOSTIC grid (default nx=24): the dense TRF
    polish costs one reverse year per state coordinate (the basins.py
    scale guard), and the saddle's existence/spectrum is grid-robust —
    the scan grid pins the window, this pins the object."""
    par = ebm.Collection(ebm.default_parameters("MIZ"))
    par["D"] = float(D)

    # the two attractors: warm-branch state continued down from high F,
    # cold-branch state continued up from deep freeze (warm starts keep
    # each solve inside its own basin)
    warm_path = np.array([max(8.0, float(F) + 12.0), float(F)])
    cold_path = np.array([min(-24.0, float(F) - 12.0), float(F)])
    kw = dict(tol=tol, max_years=max_years, dtype=dtype)
    warm = ebm.continuation("MIZ", st, warm_path, par, ebm.zeros_init(st),
                            **kw)
    cold = ebm.continuation("MIZ", st, cold_path, par, ebm.zeros_init(st),
                            **kw)
    a = warm.results[-1].state
    b = cold.results[-1].state

    wa = float(np.asarray(warm.ice_area()).reshape(len(warm_path), -1)[-1, 0])
    ca = float(np.asarray(cold.ice_area()).reshape(len(cold_path), -1)[-1, 0])
    print(f"  attractors at D={D:g}, F={F:g}: "
          f"warm area {wa:.3f}, cold area {ca:.3f}")

    # The MIZ snowball boundary is RAZOR-thin (measured round 4, see
    # examples/miz_hysteresis.py): no year-map fixed point is numerically
    # reachable — the polish floors at ||year(x)-x|| ~ 1e2 enthalpy units
    # and measured escape growths reach ~1e11/yr through the thin-ice
    # channel. The honest deliverable is the boundary CROSSING (area
    # strictly between the attractors) + its transverse escape growth.
    saddle = ebm.edge_state("MIZ", st, par, a, b, forcing=float(F),
                            stages=3, tol=np.inf, dtype=dtype)
    g = float(np.max(np.atleast_1d(np.abs(
        np.asarray(saddle.stability.growth)))))
    print(f"  boundary crossing area {saddle.area:.3f}, stationarity "
          f"floor {float(saddle.resid):.3g}, escape growth {g:.3g}/yr")
    return par, saddle, (wa, ca), g


def main():
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="CPU smoke sizes (small grid, short path)")
    ap.add_argument("--cpu", action="store_true",
                    help="full sizes but forced onto CPU (f64)")
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--nt", type=int, default=None)
    args = ap.parse_args()
    fast = args.fast

    import jax
    if fast or args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    t0 = time.time()
    nx = args.nx or (16 if fast else 40)
    nt = args.nt or 1000
    st = ebm.SpaceTime.sin(nx, nt, 1)
    dtype = "float64" if jax.default_backend() == "cpu" else "float32"
    tol = 0.5
    max_years = 150 if fast else 400

    # stage A: D from the single-column limit up through the default.
    # First full run (nx=40, f64, F in [+8, -24]) measured: D >= 0.3
    # bistable over huge windows reaching past F=+8 (default D=0.6:
    # [-16, +8]); D <= 0.2 monostable everywhere in the box. This pass
    # resolves the onset (0.2 < D* <= 0.3) and closes the window's upper
    # edge (the snowball thaw fold) by extending the path to F=+28.
    D_vals = (np.array([0.0, 0.05, 0.3, 0.6]) if fast else
              np.array([0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.45, 0.6]))
    F_path = (np.linspace(8.0, -24.0, 9) if fast else
              np.linspace(28.0, -24.0, 27))
    print(f"stage A: hysteresis scan nx={nx} nt={nt} dtype={dtype} "
          f"K={len(D_vals)} levels={2 * len(F_path)} "
          f"backend={jax.default_backend()}", flush=True)
    cont, gvals, gap = hysteresis_scan(st, D_vals, F_path, tol,
                                       max_years, dtype)

    gap_tol = 0.5
    print("\n  D \\ F " + "".join(f"{F:+6.1f}" for F in gvals))
    for k, D in enumerate(D_vals):
        row = ["     B" if g > gap_tol else "     ." for g in gap[:, k]]
        print(f"  {D:5.2f} " + "".join(row))

    window = {}
    for k, D in enumerate(D_vals):
        hit = [float(F) for F, g in zip(gvals, gap[:, k]) if g > gap_tol]
        if hit:
            window[float(D)] = (min(hit), max(hit))
    print(f"\nbistable windows (gap > {gap_tol}): "
          f"{window if window else 'NONE anywhere in the box'}")

    artifact = {
        "nx": nx, "nt": nt, "dtype": dtype, "tol": tol,
        "max_years": max_years, "gap_tol": gap_tol,
        "D_vals": [float(d) for d in D_vals],
        "F_levels": [float(f) for f in gvals],
        "gap": gap.tolist(),
        "windows": {str(k): v for k, v in window.items()},
        "wall_s": time.time() - t0,
    }

    # stage B: saddle at the reference's own default D when it carries a
    # window (the headline result), else at the widest window
    if window:
        D_star = (0.6 if any(abs(d - 0.6) < 1e-9 for d in window) else
                  max(window, key=lambda d: window[d][1] - window[d][0]))
        lo, hi = window[D_star]
        F_star = 0.5 * (lo + hi)
        # nx=16: the grid where the boundary bisection stays interior
        # (nx=12 and nx=24 midpoints slide onto the snowball — measured)
        nx_b = 16
        st_b = ebm.SpaceTime.sin(nx_b, nt, 1)
        print(f"\nstage B: saddle at D={D_star:g}, F={F_star:g} "
              f"(diagnostic nx={nx_b})", flush=True)
        try:
            par, saddle, (wa, ca), g = saddle_at(
                st_b, D_star, F_star, tol, max_years, dtype, fast)
            lo, hi = min(wa, ca), max(wa, ca)
            artifact["saddle"] = {
                "D": float(D_star), "F": float(F_star), "nx": nx_b,
                "kind": "boundary crossing (razor-thin: no reachable "
                        "year-map fixed point, see miz_hysteresis.py)",
                "area": float(saddle.area),
                "attractor_areas": [lo, hi],
                "stationarity_floor": float(saddle.resid),
                "escape_growth_per_yr": g,
                "is_unstable_boundary_object": bool(
                    g > 1.0 and lo + 0.1 < saddle.area < hi - 0.1),
            }
        except Exception as e:  # keep the scan artifact either way
            print(f"  stage B failed: {e!r}")
            artifact["saddle"] = {"error": repr(e)}

    out = os.path.join(os.path.dirname(__file__), "miz_saddle_hunt.json")
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"\nartifact -> {out}  ({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main()
