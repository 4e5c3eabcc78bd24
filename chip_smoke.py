"""Smoke test of the drivers' main path on the GPU.

Runs the public drivers at the canonical width (``SpaceTime.sin(180, 2000,
.)``, MIZ and Classic, float32 and float64) on one card and checks each
phase against a reference:

(a) ``ebm.integrate`` — single MIZ runs in float32 and float64, one Classic
    run; finite seasonal stores;
(b) the float64 MIZ trajectory against the NumPy/SciPy oracle
    (``tests/ref_impl.MIZRef``) and against the same call on the CPU device;
(c) a K=8192 ``D`` sweep through ``parallel.sweep``: ``engine='auto'``
    (the whole-year engine) against the per-year batched engine, MIZ and
    Classic;
(d) ``ebm.equilibrate`` on a K=1024 ``F`` sweep against
    ``ensemble_integrate`` of the same members;
(e) ``ebm.transitions(subyear=True)`` at K=1024 against the same call on
    the CPU device.

``--multi`` runs only the paths across four cards instead: the sharded
ensemble and equilibration (``mesh=ensemble_mesh(4)``) and the 2-D
member x grid mesh (``grid2d_mesh(2, 2)``), each against one card.

Each phase prints its first-call seconds (compilation included), steady
model-years per second and its comparison with the tolerance it is held to;
the last line is one JSON object. Exits non-zero when JAX finds no GPU or
any check fails.

Run: ``python chip_smoke.py`` on one card, ``python chip_smoke.py --multi``
on four.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# canonical grid and the sizes of each phase; a rehearsal on the CPU may
# shrink them
GRID = (180, 2000)
ORACLE_STEPS = 200   # (b) one-step-ahead oracle window
FREE_STEPS = 80      # (b) free-running oracle window (test_miz.py)
SWEEP_K = 8192       # (c)
EQ_K = 1024          # (d)
TR_K = 1024          # (e)
MULTI_K = 4 * 2048   # (f)

MIZ_VARS = ("E", "T", "h", "Ei", "Ew", "Ti", "Tw", "D", "phi", "n")


def log(msg):
    print(msg, flush=True)


def _ebm():
    import energybalancemodel_jl_tpu as ebm

    return ebm


def _st(years):
    return _ebm().SpaceTime.sin(GRID[0], GRID[1], years)


def _classic_init(par, e0=30.0):
    ebm = _ebm()
    E0 = np.full(GRID[0], e0)
    return ebm.Collection(E=E0, Tg=E0 / float(par["cw"]))


def _timed(fn):
    """(result, first-call s, steady s): the call twice, the first compiles."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, first, time.perf_counter() - t0


def _finite(coll, skip=("Ti", "Tw")):
    """All non-presentation fields finite (Ti/Tw carry NaN by design)."""
    return all(np.isfinite(np.asarray(v)).all()
               for k, v in coll.items() if k not in skip)


def _spread(a, b, atol):
    """max |a-b|, mean |a-b| and the share of entries beyond ``atol``."""
    d = np.abs(np.nan_to_num(np.asarray(a, np.float64))
               - np.nan_to_num(np.asarray(b, np.float64)))
    return float(d.max()), float(d.mean()), float((d > atol).mean())


def phase_integrate():
    """(a) single runs through ``ebm.integrate``."""
    import jax.numpy as jnp

    ebm = _ebm()
    years = 3
    st = _st(years)
    for model, dtype in (("MIZ", jnp.float32), ("MIZ", jnp.float64),
                         ("Classic", jnp.float32)):
        par = ebm.default_parameters(model)
        init = (ebm.zeros_init(st) if model == "MIZ"
                else _classic_init(par))
        sols, first, steady = _timed(lambda: ebm.integrate(
            model, st, ebm.Forcing(0), par, init, dtype=dtype,
            progress=False, raw_mode="none").seasonal.avg)
        ok = _finite(sols)
        log(f"(a) integrate {model} {jnp.dtype(dtype).name}: first call "
            f"{first:.2f} s, steady {years / steady:.2f} years/s, "
            f"finite={ok}")
        assert ok, f"(a) {model} {jnp.dtype(dtype).name} not finite"
        assert sols["E"].shape == (years, GRID[0])


def phase_oracle():
    """(b) the float64 MIZ trajectory against the NumPy/SciPy oracle and
    against the CPU device."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from ref_impl import MIZRef

    ebm = _ebm()
    st = _st(1)
    par = ebm.default_parameters("MIZ")

    def run():
        return ebm.integrate("MIZ", st, ebm.Forcing(0), par,
                             ebm.zeros_init(st), dtype=jnp.float64,
                             lastonly=False, progress=False, engine="scan")

    gpu = {k: np.asarray(run().raw[k][:ORACLE_STEPS]) for k in MIZ_VARS}
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = {k: np.asarray(run().raw[k][:ORACLE_STEPS]) for k in MIZ_VARS}
    oracle = MIZRef(GRID[0], GRID[1], "sin", dict(par))

    # one step ahead: the oracle steps from the card's state each step
    # (tests/test_miz.py midwinter-window tolerance: rtol 5e-9, atol 1e-9)
    state = {k: np.zeros(GRID[0]) for k in ("Ei", "Ew", "h", "D", "phi")}
    worst = 0.0
    for i in range(ORACLE_STEPS):
        out = oracle.step(state["Ei"], state["Ew"], state["h"], state["D"],
                          state["phi"], oracle.t[i], 0.0)
        for k in MIZ_VARS:
            a, b = np.nan_to_num(gpu[k][i]), np.nan_to_num(out[k])
            worst = max(worst, float(np.max(
                np.abs(a - b) / (1e-9 + 5e-9 * np.abs(b)))))
        state = {k: gpu[k][i].copy() for k in state}
    log(f"(b) oracle, {ORACLE_STEPS} steps one step ahead at nx={GRID[0]}: "
        f"worst |card - oracle| / (1e-9 + 5e-9 |oracle|) = {worst:.3g} "
        "(limit 1)")
    assert worst <= 1.0, "(b) one-step oracle parity"

    # free run: test_canonical_config_window's window and tolerance
    free = MIZRef(GRID[0], GRID[1], "sin", dict(par)).run(FREE_STEPS)
    worst_free = worst_cpu = 0.0
    for k in MIZ_VARS:
        for other, acc in ((free[k], "o"), (cpu[k][:FREE_STEPS], "c")):
            a = np.nan_to_num(gpu[k][:FREE_STEPS])
            b = np.nan_to_num(other)
            r = float(np.max(np.abs(a - b) / (1e-8 + 1e-7 * np.abs(b))))
            if acc == "o":
                worst_free = max(worst_free, r)
            else:
                worst_cpu = max(worst_cpu, r)
    cpu_all = max(_spread(gpu[k], cpu[k], 0.0)[0] for k in MIZ_VARS)
    log(f"(b) oracle, {FREE_STEPS} steps free run: worst |card - oracle| / "
        f"(1e-8 + 1e-7 |oracle|) = {worst_free:.3g} (limit 1)")
    log(f"(b) CPU device, {FREE_STEPS} steps: worst ratio at the same "
        f"tolerance = {worst_cpu:.3g} (limit 1); max |card - cpu| over "
        f"{ORACLE_STEPS} steps = {cpu_all:.3g} (reported; the pancake "
        "average amplifies round-off after ~step 100)")
    assert worst_free <= 1.0, "(b) free-run oracle parity"
    assert worst_cpu <= 1.0, "(b) card vs CPU device"


def _sweep(model, engine, K, years=2):
    ebm = _ebm()
    from energybalancemodel_jl_tpu.parallel import sweep

    par = ebm.default_parameters(model)
    init = ebm.zeros_init(_st(1)) if model == "MIZ" else _classic_init(par)
    return sweep(model, _st(years), ebm.Forcing(0), par,
                 {"D": np.linspace(0.55, 0.65, K)}, init, dtype="float32",
                 engine=engine, progress=False).seasonal.avg


def phase_sweep():
    """(c) the K-member D sweep: whole-year (auto) vs per-year batched."""
    years = 2
    for model, atol, share in (("MIZ", 0.5, 0.02), ("Classic", 1e-3, 0.0)):
        runs = {}
        for engine in ("auto", "batched"):
            out, first, steady = _timed(
                lambda: _sweep(model, engine, SWEEP_K, years))
            runs[engine] = out
            log(f"(c) sweep {model} K={SWEEP_K} engine={engine}: first call "
                f"{first:.2f} s, steady {SWEEP_K * years / steady:.1f} "
                f"member-years/s, finite={_finite(out)}")
            assert _finite(out), f"(c) {model} {engine} not finite"
        dmax, dmean, over = _spread(runs["auto"]["E"], runs["batched"]["E"],
                                    atol)
        log(f"(c) {model} whole-year vs batched, annual-mean E over "
            f"{years} years: max {dmax:.3g}, mean {dmean:.3g}, share beyond "
            f"{atol:g} = {over:.4f} (limit {share:g})")
        assert over <= share, f"(c) {model} engine parity"


def phase_equilibrate():
    """(d) equilibrate on a K-member F sweep vs ensemble_integrate."""
    ebm = _ebm()
    years = 3
    par = ebm.Collection(ebm.default_parameters("MIZ"))
    par["F"] = np.linspace(-4.0, 4.0, EQ_K)
    init = ebm.zeros_init(_st(1))
    res, first, steady = _timed(lambda: ebm.equilibrate(
        "MIZ", _st(1), 0.0, par, init, tol=0.0, max_years=years,
        dtype="float32"))
    log(f"(d) equilibrate MIZ K={EQ_K}: first call {first:.2f} s, steady "
        f"{EQ_K * years / steady:.1f} member-years/s, years={res.years}, "
        f"finite={_finite(res.seasonal.avg)}")
    assert res.years == years and _finite(res.seasonal.avg)
    from energybalancemodel_jl_tpu.parallel import ensemble_integrate

    ens = ensemble_integrate("MIZ", _st(years), ebm.Forcing(0), par, init,
                             dtype="float32", progress=False)
    atol, share = 0.5, 0.02
    dmax, dmean, over = _spread(res.seasonal.avg["E"],
                                ens.seasonal.avg["E"][:, -1], atol)
    log(f"(d) equilibrate vs ensemble_integrate, year-{years} annual-mean "
        f"E: max {dmax:.3g}, mean {dmean:.3g}, share beyond {atol:g} = "
        f"{over:.4f} (limit {share:g})")
    assert over <= share, "(d) equilibrate parity"


def phase_transitions():
    """(e) sub-annual crossings on the card vs the CPU device."""
    import jax

    ebm = _ebm()
    par = ebm.default_parameters("Classic")
    st = _st(1)
    a, b = _classic_init(par, 30.0), _classic_init(par, -30.0)

    def run():
        return ebm.transitions("Classic", st, 5.5, par, a, b, sigma=24.0,
                               tau=0.05, years=2, K=TR_K, seed=0,
                               dtype="float32", subyear=True)

    r, first, steady = _timed(run)
    log(f"(e) transitions Classic K={TR_K} subyear: first call {first:.2f} "
        f"s, steady {TR_K * 2 / steady:.1f} member-years/s, engine="
        f"{r.engine}, escaped {int(r.escaped.sum())}, crossings "
        f"{int((r.crossing_step >= 0).sum())}")
    with jax.default_device(jax.devices("cpu")[0]):
        rc = run()
    g, c = r.crossing_step, rc.crossing_step
    both = (g >= 0) & (c >= 0)
    one_sided = int(((g >= 0) != (c >= 0)).sum())
    crossings = int(((g >= 0) | (c >= 0)).sum())
    shift = float(np.abs(g - c)[both].max()) if both.any() else 0.0
    log(f"(e) crossing steps card vs CPU: {int((g == c).sum())}/{g.size} "
        f"member-years identical; largest shift where both cross {shift:g} "
        f"steps (limit 2); crossed on one device only {one_sided} of "
        f"{crossings} crossings (limit 10%: an f32 trajectory that grazes "
        "the midpoint on one device can miss it on the other)")
    assert r.engine == "fused" and np.isfinite(r.areas).all()
    assert crossings > 0 and shift <= 2, "(e) crossing parity"
    assert one_sided <= 0.1 * crossings, "(e) crossing parity"


def phase_multi():
    """(f) the paths across four cards, each against one card."""
    import jax

    ebm = _ebm()
    from energybalancemodel_jl_tpu.parallel import (
        ensemble_integrate, ensemble_mesh, ensemble_spatial_integrate,
        grid2d_mesh)

    assert len(jax.devices()) >= 4, "--multi needs four devices"
    years = 2
    par = ebm.Collection(ebm.default_parameters("MIZ"))
    par["D"] = np.linspace(0.55, 0.65, MULTI_K)
    init = ebm.zeros_init(_st(1))
    kw = dict(dtype="float32", engine="fused", progress=False)
    one, first1, steady1 = _timed(lambda: ensemble_integrate(
        "MIZ", _st(years), ebm.Forcing(0), par, init, **kw).seasonal.avg)
    four, first4, steady4 = _timed(lambda: ensemble_integrate(
        "MIZ", _st(years), ebm.Forcing(0), par, init,
        mesh=ensemble_mesh(4), **kw).seasonal.avg)
    atol, share = 0.5, 0.02
    dmax, dmean, over = _spread(one["E"], four["E"], atol)
    log(f"(f) ensemble K={MULTI_K} one card: first {first1:.2f} s, steady "
        f"{MULTI_K * years / steady1:.1f} member-years/s; mesh of 4: first "
        f"{first4:.2f} s, steady {MULTI_K * years / steady4:.1f} "
        f"member-years/s; annual-mean E max {dmax:.3g}, mean {dmean:.3g}, "
        f"share beyond {atol:g} = {over:.4f} (limit {share:g})")
    assert _finite(four) and over <= share, "(f) sharded ensemble"

    pf = ebm.Collection(ebm.default_parameters("MIZ"))
    pf["F"] = np.linspace(-4.0, 4.0, MULTI_K // 8)
    eq = lambda **m: ebm.equilibrate(  # noqa: E731
        "MIZ", _st(1), 0.0, pf, init, tol=0.0, max_years=years,
        dtype="float32", engine="fused", **m)
    e1, e4 = eq(), eq(mesh=ensemble_mesh(4))
    dmax, dmean, over = _spread(e1.seasonal.avg["E"], e4.seasonal.avg["E"],
                                atol)
    log(f"(f) equilibrate K={MULTI_K // 8} mesh of 4 vs one card: max "
        f"{dmax:.3g}, mean {dmean:.3g}, share beyond {atol:g} = {over:.4f} "
        f"(limit {share:g})")
    assert e4.years == years and over <= share, "(f) sharded equilibrate"

    pc = ebm.Collection(ebm.default_parameters("Classic"))
    pc["D"] = np.linspace(0.55, 0.65, 64)
    ic = _classic_init(pc)
    ref = ensemble_integrate("Classic", _st(1), ebm.Forcing(0), pc, ic,
                                 dtype="float64", progress=False)
    g2, first2, steady2 = _timed(lambda: ensemble_spatial_integrate(
        "Classic", _st(1), ebm.Forcing(0), pc, ic,
        mesh=grid2d_mesh(2, 2), dtype="float64", progress=False).seasonal.avg)
    err = max(float(np.max(np.abs(np.asarray(g2[k])
                                  - np.asarray(ref.seasonal.avg[k]))
                           / (1e-9 + 1e-9 * np.abs(ref.seasonal.avg[k]))))
              for k in g2)
    log(f"(f) grid2d (2, 2) Classic f64 K=64: first {first2:.2f} s, steady "
        f"{64 / steady2:.1f} member-years/s; worst |mesh - one card| / "
        f"(1e-9 + 1e-9 |one card|) = {err:.3g} (limit 1)")
    assert err <= 1.0, "(f) grid2d parity"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card paths (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("chip_smoke.py: no GPU found", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from energybalancemodel_jl_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    phases = ([phase_multi] if args.multi else
              [phase_integrate, phase_oracle, phase_sweep,
               phase_equilibrate, phase_transitions])
    for phase in phases:
        phase()
    log(f"total {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
