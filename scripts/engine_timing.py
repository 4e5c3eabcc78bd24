"""Time the XLA year engines on the GPU at the canonical grid.

Measures, for ``SpaceTime.sin(180, 2000, .)`` in float32:

- the single run (K=1): the per-year scan engine vs the whole-year engine;
- the K=8192 ``D`` sweep: the per-year batched engine vs the whole-year
  engine;
- the same for the Classic model;
- at K=8192, the whole-year engine, whose loop holds its state in the
  drivers' ``(K, nx)`` layout, against a variant that holds it ``(nx, K)``
  (engine ``fused-xk``).

``--drivers`` times the public drivers instead, each with ``engine='auto'``'s
two candidates: ``integrate`` (K=1), ``parallel.sweep`` (K=8192 ``D`` sweep,
float32 and float64 for MIZ), ``equilibrate`` (K=1024 ``F`` sweep) and
``transitions`` (K=1024). Each configuration runs in the order A, B, A, B and
reports both steady times of each engine.

Each line gives the first call's seconds (compilation included) and the
steady seconds per simulated year (mean over ``--years`` calls, each ended by
``block_until_ready``). ``--trace`` also records one year of each engine with
``jax.profiler`` and reduces the trace to device kernel launches per year,
busy share and device-to-host copies (summary in
``chiprun_out/engine_timing.json``).

Run on the card: ``python scripts/engine_timing.py [--trace] [--drivers]``. Exits
non-zero when JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

GRID = (180, 2000)  # canonical (nx, nt)
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "chiprun_out")


def trace_summary(trace_dir: str) -> dict:
    """Reduce a ``jax.profiler`` trace to device counts: kernel events,
    device busy time (union of event intervals per device line), memcpy
    events by direction, and the ten longest kernels by total time."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    data = ProfileData.from_file(path)
    out = {"lines": {}, "kernels": {}, "memcpy": {}}
    t_lo, t_hi = None, None
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.start_ns, e.end_ns, e.name) for e in line.events]
            if not evs:
                continue
            evs.sort()
            busy, cur_s, cur_e = 0.0, None, None
            for s, e, name in evs:
                if cur_e is None or s > cur_e:
                    if cur_e is not None:
                        busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
                low = name.lower()
                if "memcpy" in low or "memset" in low:
                    out["memcpy"][name] = out["memcpy"].get(name, 0) + 1
                else:
                    k = out["kernels"].setdefault(name, [0, 0.0])
                    k[0] += 1
                    k[1] += (e - s) / 1e6
            busy += cur_e - cur_s
            lo, hi = evs[0][0], max(e for _, e, _ in evs)
            t_lo = lo if t_lo is None else min(t_lo, lo)
            t_hi = hi if t_hi is None else max(t_hi, hi)
            out["lines"][f"{plane.name}|{line.name}"] = {
                "events": len(evs), "busy_ms": busy / 1e6,
                "span_ms": (hi - lo) / 1e6}
    out["window_ms"] = None if t_lo is None else (t_hi - t_lo) / 1e6
    out["kernel_launches"] = sum(v[0] for v in out["kernels"].values())
    out["top_kernels"] = sorted(
        ((n, c, round(ms, 3)) for n, (c, ms) in out["kernels"].items()),
        key=lambda r: -r[2])[:10]
    del out["kernels"]
    return out


def _setup(model: str, K: int, dtype):
    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.models.base import get_model
    from energybalancemodel_jl_tpu.utils.collection import Collection

    st = ebm.SpaceTime.sin(*GRID, 1)
    par = Collection({k: jnp.asarray(v, dtype)
                      for k, v in ebm.default_parameters(model).items()})
    if K > 1:
        par["D"] = jnp.asarray(np.linspace(0.55, 0.65, K), dtype)
    init = (ebm.zeros_init(st) if model == "MIZ"
            else Collection(E=np.zeros(st.nx), Tg=np.zeros(st.nx)))
    carry = get_model(model).init_carry(init, st, dtype)
    carry = Collection({k: jnp.broadcast_to(v, (K,) + v.shape)
                        for k, v in carry.items()})
    return st, par, carry, jnp.zeros(st.nt, dtype)


def _engines(model: str, K: int, dtype):
    """name -> (fn(carry) -> carry, carry0) for every engine at this K."""
    from energybalancemodel_jl_tpu.integrate import _jitted_year_fn
    from energybalancemodel_jl_tpu.models.base import default_step_config
    from energybalancemodel_jl_tpu.ops.year import classic_year, miz_year
    from energybalancemodel_jl_tpu.parallel import ensemble as ens
    from energybalancemodel_jl_tpu.utils.collection import Collection

    st, par, carry, fy = _setup(model, K, dtype)
    cfg = default_step_config(jnp.dtype(dtype).name)
    year = miz_year if model == "MIZ" else classic_year
    out = {}
    if K == 1:
        scan = _jitted_year_fn(model, st, cfg, jnp.dtype(dtype).name, False,
                               None)
        c1 = Collection({k: v[0] for k, v in carry.items()})
        out["scan"] = (lambda c: scan(c, par, fy)[0], c1)
    else:
        native = ens._native_year_fn(model, st, cfg, jnp.dtype(dtype).name,
                                     False, False)
        par_aug = ens._augment_batched(par)
        out["batched"] = (lambda c: native(c, par_aug, fy)[0], carry)
    out["fused"] = (lambda c: year(c, par, fy, st, cfg)[0], carry)
    if K > 1:
        out["fused-xk"] = (_xk_year(year, carry, par, fy, st, cfg), carry)
    return out


def _xk_year(year, carry, par, fy, st, cfg):
    """The whole-year engine with its loop state held ``(nx, K)``: traced
    with ``ops.year._year_loop`` wrapped to hold the carry and the seasonal
    stores transposed and to transpose around each step. Compiled with the
    engine's arguments and outputs; returns ``carry -> carry``."""
    from energybalancemodel_jl_tpu.ops import year as Y
    from energybalancemodel_jl_tpu.utils.collection import Collection

    loop = Y._year_loop

    def T(c):
        return Collection({k: (v.T if jnp.ndim(v) == 2 else v)
                           for k, v in c.items()})

    def loop_xk(step, carry0, *args):
        carry, stores, conv, eta, first = loop(
            lambda c, xs: tuple(map(T, step(T(c), xs))), T(carry0), *args)
        return T(carry), tuple(map(T, stores)), conv, eta, first

    Y._year_loop = loop_xk
    try:
        compiled = jax.jit(
            lambda c, p, f: year.__wrapped__(c, p, f, st, cfg)
        ).lower(carry, par, fy).compile()
    finally:
        Y._year_loop = loop
    return lambda c: compiled(c, par, fy)[0]


def time_engine(fn, carry, years: int):
    t0 = time.perf_counter()
    c = jax.block_until_ready(fn(carry))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(years):
        c = fn(c)
    jax.block_until_ready(c)
    steady = (time.perf_counter() - t0) / years
    finite = all(bool(jnp.isfinite(v).all()) for v in c.values())
    return first, steady, finite, c


def _drivers(model: str, K: int, dtype: str, years: int):
    """name -> (engine -> zero-argument run) for the driver configurations;
    each run blocks until its result is on the host."""
    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.parallel import sweep
    from energybalancemodel_jl_tpu.utils.collection import Collection

    st = ebm.SpaceTime.sin(*GRID, years)
    par = Collection(ebm.default_parameters(model))
    init = (ebm.zeros_init(st) if model == "MIZ" else
            Collection(E=np.full(GRID[0], 30.0),
                       Tg=np.full(GRID[0], 30.0) / float(par["cw"])))
    kw = dict(dtype=dtype)
    if K == 1:
        return "integrate", {
            e: (lambda e=e: np.asarray(ebm.integrate(
                model, st, ebm.Forcing(0), par, init, engine=e,
                progress=False, raw_mode="none", **kw).seasonal.avg["E"]))
            for e in ("scan", "fused")}
    return "sweep", {
        name: (lambda e=e, y=y: np.asarray(sweep(
            model, st, ebm.Forcing(0), par,
            {"D": np.linspace(0.55, 0.65, K)}, init, engine=e,
            years_per_dispatch=y, progress=False, **kw).seasonal.avg["E"]))
        for name, e, y in (("batched", "batched", None),
                           ("fused", "fused", None),
                           ("fused-ypd1", "fused", 1))}


def _eq_tr(years: int, K: int):
    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.utils.collection import Collection

    st = ebm.SpaceTime.sin(*GRID, 1)
    pm = Collection(ebm.default_parameters("MIZ"))
    pm["F"] = np.linspace(-4.0, 4.0, K)
    eq = {e: (lambda e=e: np.asarray(ebm.equilibrate(
        "MIZ", st, 0.0, pm, ebm.zeros_init(st), tol=0.0, max_years=years,
        dtype="float32", engine=e).seasonal.avg["E"]))
        for e in ("batched", "fused")}
    pc = ebm.default_parameters("Classic")
    a, b = (Collection(E=np.full(GRID[0], e0),
                       Tg=np.full(GRID[0], e0) / float(pc["cw"]))
            for e0 in (30.0, -30.0))
    tr = {e: (lambda e=e: ebm.transitions(
        "Classic", st, 5.5, pc, a, b, sigma=24.0, tau=0.05, years=years,
        K=K, seed=0, dtype="float32", engine=e).areas)
        for e in ("scan", "fused")}
    return eq, tr


def time_drivers(years: int, members: int, eq_members: int):
    """Steady seconds of each driver configuration per engine, in the
    order A, B, A, B after one compiling call of each."""
    confs = [(*_drivers(m, 1, "float32", 8), m, 1, "float32", 8)
             for m in ("MIZ", "Classic")]
    confs += [(*_drivers(m, members, d, years), m, members, d, years)
              for m, d in (("MIZ", "float32"), ("Classic", "float32"),
                           ("MIZ", "float64"))]
    eq, tr = _eq_tr(3, eq_members)
    confs += [("equilibrate", eq, "MIZ", eq_members, "float32", 3),
              ("transitions", tr, "Classic", eq_members, "float32", 3)]
    rows = []
    for driver, runs, model, K, dtype, yrs in confs:
        t = {}
        for name, fn in runs.items():
            t0 = time.perf_counter()
            fn()
            t[name] = [time.perf_counter() - t0]
        for _ in range(2):
            for name, fn in runs.items():
                t0 = time.perf_counter()
                fn()
                t[name].append(time.perf_counter() - t0)
        for name, ts in t.items():
            row = dict(driver=driver, model=model, K=K, dtype=dtype,
                       years=yrs, engine=name, first_call_s=round(ts[0], 3),
                       steady_s=[round(x, 4) for x in ts[1:]],
                       member_years_per_s=[round(K * yrs / x, 1)
                                           for x in ts[1:]])
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--years", type=int, default=3)
    ap.add_argument("--members", type=int, default=8192)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--models", default="MIZ,Classic")
    ap.add_argument("--drivers", action="store_true",
                    help="time the public drivers per engine instead")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("no GPU found; this script measures the card only",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}")
    print(f"device: {jax.devices()[0].device_kind} x{len(jax.devices())}")
    os.makedirs(OUT, exist_ok=True)
    if args.drivers:
        jax.config.update("jax_enable_x64", True)
        rows = time_drivers(2, args.members, args.members // 8)
        with open(os.path.join(OUT, "driver_timing.json"), "w") as f:
            json.dump({"card": smi.strip(), "rows": rows}, f, indent=1)
        return 0
    rows = []
    for model in args.models.split(","):
        for K in (1, args.members):
            for name, (fn, c0) in _engines(model, K, jnp.float32).items():
                first, steady, finite, c = time_engine(fn, c0, args.years)
                row = dict(model=model, K=K, engine=name,
                           first_call_s=round(first, 3),
                           s_per_year=round(steady, 4),
                           member_years_per_s=round(K / steady, 2),
                           finite=finite)
                if args.trace:
                    tdir = tempfile.mkdtemp(prefix=f"trace_{model}_{K}_")
                    with jax.profiler.trace(tdir):
                        jax.block_until_ready(fn(c))
                    row["trace"] = trace_summary(tdir)
                rows.append(row)
                print(json.dumps({k: v for k, v in row.items()
                                  if k != "trace"}), flush=True)
                if args.trace:
                    tr = row["trace"]
                    print("  trace:", json.dumps(
                        {k: tr[k] for k in ("window_ms", "kernel_launches",
                                            "memcpy", "lines")}), flush=True)
                    print("  top:", json.dumps(tr["top_kernels"][:5]),
                          flush=True)
    with open(os.path.join(OUT, "engine_timing.json"), "w") as f:
        json.dump({"card": smi.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
