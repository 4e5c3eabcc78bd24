"""Benchmark: model-years/day per card on the seasonal MIZ configuration.

Runs a K-member ensemble of canonical MIZ runs
(``SpaceTime{sin}(180, 2000, ...)``, the configuration behind the reference's
only published throughput number — 511.24 steps/s ≈ 2.2e4 model-yr/day on a
single CPU core, /root/reference/src/EnergyBalanceModel.jl:59-61) in float32
with seasonal-only storage through the public drivers, times steady-state
years after a compile warm-up, and prints ONE JSON line. Exits non-zero when
JAX finds no GPU.

Environment knobs: EBM_BENCH_K (ensemble size, default 8192),
EBM_BENCH_YEARS (timed years, default 8), EBM_BENCH_DTYPE
(float32|float64), EBM_BENCH_ENGINE (auto|batched|vmap|fused, default
auto), EBM_BENCH_MODEL (MIZ|Classic), EBM_BENCH_MODE
(integrate|equilibrate|transitions — equilibrate times a fixed-horizon
equilibration of a forcing sweep, transitions the OU-forced noisy path with
EBM_BENCH_NOISE="sigma,tau").
"""
import json
import os
import sys
import time

import numpy as np

BASELINE = 2.2e4  # reference: single-core CPU model-years/day (BASELINE.md)


def _report(metric, K, years, elapsed, extra):
    import jax

    years_per_day = K * years / elapsed * 86400.0
    print(json.dumps({
        "metric": metric,
        "value": round(years_per_day, 1),
        "unit": "model-years/day",
        "vs_baseline": round(years_per_day / BASELINE, 2),
    }))
    dev = jax.devices()[0]
    print(f"# K={K} years={years} elapsed={elapsed:.3f}s {extra} "
          f"device={dev.platform}:{dev.device_kind}x{len(jax.devices())}",
          file=sys.stderr)


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        print("bench.py measures the GPU; no GPU found", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from energybalancemodel_jl_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    K = int(os.environ.get("EBM_BENCH_K", "8192"))
    years = int(os.environ.get("EBM_BENCH_YEARS", "8"))
    dtype = os.environ.get("EBM_BENCH_DTYPE", "float32")
    engine = os.environ.get("EBM_BENCH_ENGINE", "auto")
    mode = os.environ.get("EBM_BENCH_MODE", "integrate")
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    if mode == "equilibrate":
        return bench_equilibrate(K, years, dtype, engine)
    if mode == "transitions":
        return bench_transitions(K, years, dtype, engine)
    if mode != "integrate":
        raise SystemExit(f"unknown EBM_BENCH_MODE {mode!r}")
    return bench_integrate(K, years, dtype, engine)


def bench_integrate(K, years, dtype, engine):
    import energybalancemodel_jl_tpu as ebm

    model = os.environ.get("EBM_BENCH_MODEL", "MIZ")
    par = ebm.Collection(ebm.default_parameters(model))
    # realistic bifurcation sweep: spread diffusivity across members
    par["D"] = np.linspace(0.55, 0.65, K)
    if model == "MIZ":
        init = ebm.zeros_init(ebm.SpaceTime.sin(180, 2000, 1))
    else:
        # classic needs a Tg = E/cw-consistent warm init (a cold shock from
        # zeros lands in the snowball attractor)
        E0 = np.full(180, 30.0)
        init = ebm.Collection(E=E0, Tg=E0 / float(par["cw"]))

    def run(n):
        return ebm.ensemble_integrate(
            model, ebm.SpaceTime.sin(180, 2000, n), ebm.Forcing(0.0), par,
            init, dtype=dtype, engine=engine, progress=False)

    t0 = time.time()
    run(1)  # compile + one year
    compile_s = time.time() - t0
    t0 = time.time()
    sols = run(years)
    elapsed = time.time() - t0
    E = np.asarray(sols.seasonal.avg["E"])
    _report(f"{model.lower()}_model_years_per_day_per_chip", K, years,
            elapsed, f"model={model} dtype={dtype} engine={engine} "
            f"first_call={compile_s:.1f}s finite={bool(np.isfinite(E).all())} "
            f"checksum={float(np.nan_to_num(E[:, -1]).sum()):.6g}")


def bench_equilibrate(K, years, dtype, engine):
    """Fixed-point throughput: a fixed-horizon equilibration (tol=0 pins
    the year count) of a K-member forcing sweep."""
    import energybalancemodel_jl_tpu as ebm

    st = ebm.SpaceTime.sin(180, 2000, 1)
    par = ebm.Collection(ebm.default_parameters("MIZ"))
    par["F"] = np.linspace(0.0, 6.0, K)
    kw = dict(tol=0.0, dtype=dtype, engine=engine)
    t0 = time.time()
    ebm.equilibrate("MIZ", st, 0.0, par, ebm.zeros_init(st), max_years=2,
                    **kw)
    compile_s = time.time() - t0
    t0 = time.time()
    res = ebm.equilibrate("MIZ", st, 0.0, par, ebm.zeros_init(st),
                          max_years=years, **kw)
    elapsed = time.time() - t0
    E = np.asarray(res.seasonal.avg["E"])
    _report("miz_equilibration_model_years_per_day_per_chip", K,
            int(res.years), elapsed,
            f"dtype={dtype} engine={engine} first_call={compile_s:.1f}s "
            f"finite={bool(np.isfinite(E).all())}")


def bench_transitions(K, years, dtype, engine):
    """Noisy-path throughput: OU-forced transitions from fixed seeds."""
    import energybalancemodel_jl_tpu as ebm

    sigma, tau = (float(v) for v in
                  os.environ.get("EBM_BENCH_NOISE", "2.0,0.02").split(","))
    st = ebm.SpaceTime.sin(180, 2000, 1)
    par = ebm.Collection(ebm.default_parameters("MIZ"))
    init = ebm.zeros_init(st)
    a = ebm.equilibrate("MIZ", st, 5.0, par, init, tol=0.0, max_years=1,
                        dtype=dtype)
    b = ebm.equilibrate("MIZ", st, -15.0, par, init, tol=0.0, max_years=1,
                        dtype=dtype)
    kw = dict(sigma=sigma, tau=tau, K=K, seed=0, dtype=dtype, engine=engine)
    t0 = time.time()
    ebm.transitions("MIZ", st, 0.0, par, a, b, years=1, **kw)
    compile_s = time.time() - t0
    t0 = time.time()
    res = ebm.transitions("MIZ", st, 0.0, par, a, b, years=years, **kw)
    elapsed = time.time() - t0
    _report("miz_noisy_model_years_per_day_per_chip", K, years, elapsed,
            f"sigma={sigma} tau={tau} dtype={dtype} engine={res.engine} "
            f"first_call={compile_s:.1f}s "
            f"finite={bool(np.isfinite(res.areas).all())}")


if __name__ == "__main__":
    sys.exit(main())
