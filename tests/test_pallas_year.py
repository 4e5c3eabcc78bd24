"""Whole-year engine (ops/year.py) vs the per-year XLA scan engines.

The whole-year loop calls ``models.miz.step`` / ``models.classic.step``
itself, so per-step semantics are shared by construction; what needs
testing is (a) the year loop (storage accumulation, snapshot ticks, Newton
grouping, per-step insolation rebuild) reproduces the scan engines'
seasonal storage, (b) the noise, OU and crossing options, (c) the drivers'
integration. Comparisons are tolerance-based in float32: the two are
different compiled graphs, and the MIZ trajectory amplifies even
fusion-level rounding (see CLAUDE.md); with a *fixed* Newton iteration
count they agree to ~1e-3 absolute over a 200-step year — asserted with
10x headroom. In float64 they agree to round-off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import energybalancemodel_jl_tpu as ebm
from energybalancemodel_jl_tpu.models import miz
from energybalancemodel_jl_tpu.models.base import StepConfig, get_model
from energybalancemodel_jl_tpu.ops.year import classic_year, miz_year
from energybalancemodel_jl_tpu.parallel import ensemble as ens
from energybalancemodel_jl_tpu.utils.collection import Collection

DTYPE = jnp.dtype("float32")
K = 8

# fixed iteration count (tol = 0 never satisfied) removes Newton-grouping
# noise: both paths do identical per-step work
FIXED_CFG = StepConfig(
    solver="pcr", newton_abstol=0.0, newton_reltol=0.0,
    newton_max_step=50.0, newton_max_iter=8,
)


def small_setup(nx=40, nt=200, k=K, dtype=DTYPE):
    st = ebm.SpaceTime.sin(nx, nt, 1)
    par = Collection(
        {k_: jnp.asarray(v, dtype) for k_, v in ebm.default_parameters("MIZ").items()}
    )
    par["D"] = jnp.asarray(np.linspace(0.55, 0.65, k), dtype)
    spec = get_model("MIZ")
    carry = spec.init_carry(ebm.zeros_init(st), st, dtype)
    carry = Collection(
        {k_: jnp.broadcast_to(v, (k,) + v.shape) for k_, v in carry.items()}
    )
    fyear = jnp.zeros(st.nt, dtype=dtype)
    return st, par, carry, fyear


@pytest.fixture(scope="module")
def year_pair():
    st, par, carry, fyear = small_setup()
    run_year = ens._native_year_fn("MIZ", st, FIXED_CFG, DTYPE.name, False, False)
    xla = run_year(carry, ens._augment_batched(par), fyear)
    fused = miz_year(carry, par, fyear, st, FIXED_CFG)
    return xla, fused


class TestFusedYear:
    def test_carry_matches_xla(self, year_pair):
        (c_x, _, _, _), (c_p, _, _, _) = year_pair
        for k in c_x:
            np.testing.assert_allclose(
                np.asarray(c_x[k]), np.asarray(c_p[k]), atol=0.5, err_msg=k
            )

    def test_seasonal_matches_xla(self, year_pair):
        (_, s_x, _, _), (_, s_p, _, _) = year_pair
        for name in ("winter", "summer", "avg"):
            cx, cp = getattr(s_x, name), getattr(s_p, name)
            for k in cx:
                a, b = np.asarray(cx[k]), np.asarray(cp[k])
                np.testing.assert_array_equal(
                    np.isnan(a), np.isnan(b), err_msg=f"{name}.{k} NaN pattern"
                )
                np.testing.assert_allclose(
                    np.nan_to_num(a), np.nan_to_num(b), atol=0.05,
                    err_msg=f"{name}.{k}",
                )

    def test_convergence_flag(self, year_pair):
        # tol = 0 is unsatisfiable: both paths must report non-convergence
        (_, _, conv_x, _), (_, _, conv_p, _) = year_pair
        assert float(np.asarray(conv_x)) == 0.0
        assert float(np.asarray(conv_p)) == 0.0

    def test_scalar_D_broadcasts(self):
        st, par, carry, fyear = small_setup()
        par = Collection(par)
        par["D"] = jnp.asarray(0.6, DTYPE)
        c, seas, conv, _ = miz_year(carry, par, fyear, st, FIXED_CFG)
        assert c["Ei"].shape == (K, st.nx)
        # identical members -> identical rows
        e = np.asarray(seas.avg["E"])
        np.testing.assert_array_equal(e, np.broadcast_to(e[:1], e.shape))

    def test_sweeps_any_physical_param(self):
        """Parameters sweep per member inside the year loop — e.g. an
        OLR-intercept (A) sweep matches the batch-native XLA engine."""
        st, par, carry, fyear = small_setup()
        par = Collection(par)
        par["A"] = jnp.asarray(np.linspace(190, 196, K), DTYPE)
        run_year = ens._native_year_fn("MIZ", st, FIXED_CFG, DTYPE.name, False, False)
        c_x, s_x, _, _ = run_year(carry, ens._augment_batched(par), fyear)
        c_p, s_p, _, _ = miz_year(carry, par, fyear, st, FIXED_CFG)
        # members differ (the sweep took effect) ...
        e = np.asarray(s_p.avg["E"])
        assert not np.allclose(e[0], e[-1])
        # ... and match the XLA engine per member
        for key in ("E", "h", "phi"):
            np.testing.assert_allclose(
                np.nan_to_num(np.asarray(s_x.avg[key])),
                np.nan_to_num(np.asarray(s_p.avg[key])),
                atol=0.05, err_msg=key,
            )

    def test_sweeps_table_params(self):
        """The year loop rebuilds the separable insolation from per-member
        values, so S0/S1/S2/a0/a2 sweep like any parameter. Each swept
        member must equal a uniform-ensemble run at its parameter value."""
        # float64: a swept leaf builds (K, nx) insolation where a shared
        # one broadcasts a row, so the two graphs fuse differently; in
        # float64 that difference stays at round-off
        f64 = jnp.dtype("float64")
        st, par, carry, fyear = small_setup(dtype=f64)
        par = Collection(par)
        par["D"] = jnp.asarray(0.6, f64)
        sweep = np.linspace(415, 425, K)
        par_s = Collection(par)
        par_s["S0"] = jnp.asarray(sweep, f64)
        swept = miz_year(carry, par_s, fyear, st, FIXED_CFG)
        for i in (0, K - 1):
            par_i = Collection(par)
            par_i["S0"] = jnp.asarray(sweep[i], f64)
            solo = miz_year(carry, par_i, fyear, st, FIXED_CFG)
            for k in swept[0]:
                np.testing.assert_allclose(
                    np.asarray(swept[0][k])[i], np.asarray(solo[0][k])[i],
                    rtol=1e-10, atol=1e-9, err_msg=f"member {i} {k}",
                )


class TestShardedFused:
    def test_matches_unsharded_on_virtual_mesh(self):
        """Each device runs the whole-year engine on its ensemble shard; pure
        DP must reproduce the unsharded engine (fixed iterations make the
        Newton grouping irrelevant)."""
        from energybalancemodel_jl_tpu.parallel.sharding import (
            ensemble_mesh, shard_map_fused_year_fn,
        )

        k = 32
        st, par, carry, fyear = small_setup(k=k)
        mesh = ensemble_mesh(8)
        fn = shard_map_fused_year_fn(st, mesh, par, DTYPE.name, FIXED_CFG)
        c_s, seas_s, conv_s = fn(carry, par, fyear)
        c_u, seas_u, conv_u, _ = miz_year(carry, par, fyear, st, FIXED_CFG)
        assert float(np.asarray(conv_s)) == float(np.asarray(conv_u))
        for key in c_u:
            np.testing.assert_allclose(
                np.asarray(c_s[key]), np.asarray(c_u[key]), atol=1e-4,
                err_msg=key,
            )
        for key in ("E", "h", "phi"):
            np.testing.assert_allclose(
                np.nan_to_num(np.asarray(seas_s.avg[key])),
                np.nan_to_num(np.asarray(seas_u.avg[key])),
                atol=1e-4, err_msg=key,
            )


class TestFusedEngine:
    def test_matches_batched_engine(self):
        # dur=1: over longer horizons the adaptive-Newton grouping difference
        # amplifies chaotically at the ice edge (documented in CLAUDE.md)
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.default_parameters("MIZ")
        par["D"] = np.linspace(0.55, 0.65, K)
        init = ebm.zeros_init(st)
        kw = dict(dtype=DTYPE, newton_max_iter=8)
        sols_f = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, init, n_members=K,
            engine="fused", **kw,
        )
        sols_b = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, init, n_members=K,
            engine="batched", **kw,
        )
        assert sols_f.seasonal.avg["E"].shape == (K, st.dur, st.nx)
        for k in ("E", "h", "phi", "T"):
            a = np.nan_to_num(sols_b.seasonal.avg[k])
            b = np.nan_to_num(sols_f.seasonal.avg[k])
            np.testing.assert_allclose(a, b, atol=0.5, err_msg=k)

    def test_raw_last_year_fallback(self):
        st = ebm.SpaceTime.sin(40, 200, 2)
        par = ebm.default_parameters("MIZ")
        par["D"] = np.linspace(0.55, 0.65, K)
        sols = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            n_members=K, engine="fused", raw_mode="last", dtype=DTYPE,
        )
        assert sols.raw["E"].shape == (K, st.nt, st.nx)
        assert np.isfinite(np.nan_to_num(sols.raw["E"])).all()

    def test_classic_fused_matches_batched(self):
        """The classic (WE15) model has its own whole-year kernel."""
        st = ebm.SpaceTime.sin(40, 1000, 1)
        par = ebm.Collection(ebm.default_parameters("Classic"))
        par["D"] = np.linspace(0.55, 0.65, K)
        init = Collection(E=np.zeros(st.nx), Tg=np.zeros(st.nx))
        kw = dict(n_members=K, dtype=DTYPE)
        sols_f = ens.ensemble_integrate(
            "Classic", st, ebm.Forcing(0.0), par, init, engine="fused", **kw
        )
        sols_b = ens.ensemble_integrate(
            "Classic", st, ebm.Forcing(0.0), par, init, engine="batched", **kw
        )
        assert sols_f.seasonal.avg["E"].shape == (K, st.dur, st.nx)
        for k in ("E", "T", "h"):
            np.testing.assert_allclose(
                sols_b.seasonal.avg[k], sols_f.seasonal.avg[k], atol=0.05,
                err_msg=k,
            )

    def test_auto_engine_follows_the_resolver(self, monkeypatch):
        """engine='auto' takes the shared resolver's choice: a resolver
        that picks the whole-year engine must reproduce the explicit
        engine='fused' run bitwise; the thomas solver keeps 'auto' on the
        per-year engines."""
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.default_parameters("MIZ")
        par["D"] = np.linspace(0.55, 0.65, K)
        kw = dict(n_members=K, dtype=DTYPE)
        explicit = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            engine="fused", **kw,
        )
        monkeypatch.setattr(
            ens, "auto_whole_year",
            lambda *a, per_year_only=False, **kw_: not per_year_only)
        auto = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            engine="auto", **kw,
        )
        for k in ("E", "T"):
            np.testing.assert_array_equal(
                np.nan_to_num(explicit.seasonal.avg[k]),
                np.nan_to_num(auto.seasonal.avg[k]), err_msg=k,
            )
        # thomas solver is a per-year-engine feature: auto must not pick
        # the whole-year engine
        sols = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            engine="auto", solver="thomas", **kw,
        )
        assert np.isfinite(np.nan_to_num(sols.seasonal.avg["E"])).all()

    def test_rejects_model_without_kernel(self):
        from energybalancemodel_jl_tpu.models.base import (
            ModelSpec, register_model,
        )
        import energybalancemodel_jl_tpu.models.base as base

        spec = ModelSpec(
            name="_NoKernel", statics=None, init_carry=None, step=None,
            step_inputs=None, solution_vars=("E",), init_vars=(),
        )
        register_model(spec)
        try:
            st = ebm.SpaceTime.sin(40, 200, 1)
            with pytest.raises(ValueError, match="no whole-year kernel"):
                ens.ensemble_integrate(
                    "_NoKernel", st, ebm.Forcing(0.0),
                    ebm.default_parameters("MIZ"), Collection(),
                    n_members=4, engine="fused", dtype=DTYPE,
                )
        finally:
            base._REGISTRY.pop("_NoKernel", None)

    def test_rejects_unknown_engine(self):
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.default_parameters("MIZ")
        with pytest.raises(ValueError, match="unknown engine"):
            ens.ensemble_integrate(
                "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
                n_members=4, engine="bogus", dtype=DTYPE,
            )

    def test_fused_rejects_raw_mode_all(self):
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.default_parameters("MIZ")
        with pytest.raises(ValueError, match="raw_mode"):
            ens.ensemble_integrate(
                "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
                n_members=4, raw_mode="all", engine="fused", dtype=DTYPE,
            )

    def test_raw_mode_all_memory_guard(self):
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.default_parameters("MIZ")
        with pytest.raises(ValueError, match="GiB"):
            ens.ensemble_integrate(
                "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
                n_members=4, raw_mode="all", dtype=DTYPE,
                raw_memory_limit=1024,
            )

    def test_ensemble_progress_renders(self, capsys, monkeypatch):
        import energybalancemodel_jl_tpu.utils.progress as prog_mod

        rendered = []
        real = prog_mod.Progress.update

        def spy(self, current=None, feedargs=()):
            rendered.append(current)
            return real(self, current, feedargs)

        monkeypatch.setattr(prog_mod.Progress, "update", spy)
        st = ebm.SpaceTime.sin(40, 200, 3)
        par = ebm.default_parameters("MIZ")
        ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            n_members=4, dtype=DTYPE,
        )
        assert rendered and rendered[-1] == st.dur

    def test_table_param_sweep_matches_vmap(self):
        """engine='fused' sweeps table parameters in the year loop
        (seasonal storage); members must match the vmap engine."""
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.default_parameters("MIZ")
        par["S0"] = np.linspace(415, 425, K)
        kw = dict(n_members=K, dtype=DTYPE)
        sols_f = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            engine="fused", **kw,
        )
        sols_v = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            engine="vmap", **kw,
        )
        # the engines differ in Newton grouping and the f32 trajectory
        # amplifies solver noise at the ice edge (~2/320 outliers): same
        # tolerance as the carry-level kernel-vs-XLA comparison
        for k in ("E", "T", "phi"):
            np.testing.assert_allclose(
                np.nan_to_num(sols_v.seasonal.avg[k]),
                np.nan_to_num(sols_f.seasonal.avg[k]),
                atol=0.5, err_msg=k,
            )

    def test_classic_table_param_sweep_matches_vmap(self):
        st = ebm.SpaceTime.sin(40, 1000, 1)
        par = ebm.default_parameters("Classic")
        par["S0"] = np.linspace(415, 425, K)
        init = Collection(E=np.zeros(st.nx), Tg=np.zeros(st.nx))
        kw = dict(n_members=K, dtype=DTYPE)
        sols_f = ens.ensemble_integrate(
            "Classic", st, ebm.Forcing(0.0), par, init, engine="fused", **kw
        )
        sols_v = ens.ensemble_integrate(
            "Classic", st, ebm.Forcing(0.0), par, init, engine="vmap", **kw
        )
        for k in ("E", "T", "h"):
            np.testing.assert_allclose(
                sols_v.seasonal.avg[k], sols_f.seasonal.avg[k], atol=0.05,
                err_msg=k,
            )

    def test_table_param_sweep_with_raw_collection(self):
        # the raw-collect year falls back to the vmap engine for table
        # sweeps (the batch-native fallback shares one insolation table);
        # with dur=1 the raw year starts from identical init in both
        # engines, so the fallback must reproduce the vmap engine exactly
        # (beyond one year the carries differ at solver-noise level and the
        # trajectories amplify pointwise — see CLAUDE.md)
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.default_parameters("MIZ")
        par["S0"] = np.linspace(415, 425, K)
        kw = dict(n_members=K, raw_mode="last", dtype=DTYPE)
        sols_f = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            engine="fused", **kw,
        )
        sols_v = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            engine="vmap", **kw,
        )
        assert sols_f.raw["E"].shape == (K, st.nt, st.nx)
        np.testing.assert_allclose(
            np.nan_to_num(sols_v.raw["E"]), np.nan_to_num(sols_f.raw["E"]),
            atol=1e-5,
        )

    def test_table_and_F_sweep_with_raw_multiyear(self):
        # fused seasonal year -> vmap raw-fallback year, with per-member
        # forcing offsets riding alongside the table sweep
        st = ebm.SpaceTime.sin(40, 200, 2)
        par = ebm.default_parameters("MIZ")
        par["S0"] = np.linspace(415, 425, K)
        par["F"] = np.linspace(-1.0, 1.0, K)
        sols = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            n_members=K, engine="fused", raw_mode="last", dtype=DTYPE,
        )
        assert sols.raw["E"].shape == (K, st.nt, st.nx)
        assert np.isfinite(np.nan_to_num(sols.raw["E"])).all()
        assert sols.seasonal.avg["E"].shape == (K, st.dur, st.nx)


class TestIntegrateFused:
    def test_single_run_matches_scan(self):
        st = ebm.SpaceTime.sin(40, 200, 2)
        par = ebm.default_parameters("MIZ")
        init = ebm.zeros_init(st)
        kw = dict(progress=False, dtype=DTYPE, newton_max_iter=8)
        s_scan = ebm.integrate("MIZ", st, ebm.Forcing(0.0), par, init, **kw)
        s_fused = ebm.integrate("MIZ", st, ebm.Forcing(0.0), par, init,
                                engine="fused", **kw)
        # final-year raw comes from the scan fallback in both runs; the
        # carry handed to it went through the fused year -> tolerance-level
        for k in ("E", "h", "phi"):
            np.testing.assert_allclose(
                np.nan_to_num(s_scan.seasonal.avg[k]),
                np.nan_to_num(s_fused.seasonal.avg[k]),
                atol=0.5, err_msg=k,
            )
        assert s_fused.raw["E"].shape == (st.nt, st.nx)

    def test_classic_single_run(self):
        st = ebm.SpaceTime.sin(40, 1000, 2)
        par = ebm.default_parameters("Classic")
        init = Collection(E=np.zeros(st.nx), Tg=np.zeros(st.nx))
        s = ebm.integrate("Classic", st, ebm.Forcing(0.0), par, init,
                          engine="fused", progress=False, dtype=DTYPE)
        assert np.isfinite(s.seasonal.avg["E"]).all()
        assert s.raw["E"].shape == (st.nt, st.nx)

    def test_auto_engine_follows_the_resolver(self, monkeypatch):
        """integrate's engine='auto' takes the whole-year engine when the
        resolver says so, and the scan graph when a debug hook needs it."""
        import importlib

        integ = importlib.import_module("energybalancemodel_jl_tpu.integrate")

        st = ebm.SpaceTime.sin(40, 200, 2)
        par = ebm.default_parameters("MIZ")
        init = ebm.zeros_init(st)
        kw = dict(progress=False, dtype=DTYPE, newton_max_iter=8,
                  raw_mode="none")
        explicit = ebm.integrate("MIZ", st, ebm.Forcing(0.0), par, init,
                                 engine="fused", **kw)
        monkeypatch.setattr(
            integ, "auto_whole_year",
            lambda *a, per_year_only=False, **kw_: not per_year_only)
        auto = ebm.integrate("MIZ", st, ebm.Forcing(0.0), par, init, **kw)
        np.testing.assert_array_equal(
            np.nan_to_num(explicit.seasonal.avg["E"]),
            np.nan_to_num(auto.seasonal.avg["E"]),
        )
        # a debug hook is a scan-only feature: auto must pick scan and
        # record the diagnostic rather than raising
        dbg = ebm.integrate(
            "MIZ", st, ebm.Forcing(0.0), par, init,
            debug=lambda vars_, p: vars_["phi"].sum(), **kw,
        )
        assert "debug" in dbg.seasonal.avg

    def test_rejects_debug_hook(self):
        st = ebm.SpaceTime.sin(40, 200, 1)
        with pytest.raises(ValueError, match="debug"):
            ebm.integrate("MIZ", st, ebm.Forcing(0.0),
                          ebm.default_parameters("MIZ"), ebm.zeros_init(st),
                          engine="fused", debug=lambda v, p: v["E"],
                          progress=False, dtype=DTYPE)

    def test_rejects_unknown_engine(self):
        st = ebm.SpaceTime.sin(40, 200, 1)
        with pytest.raises(ValueError, match="unknown engine"):
            ebm.integrate("MIZ", st, ebm.Forcing(0.0),
                          ebm.default_parameters("MIZ"), ebm.zeros_init(st),
                          engine="bogus", progress=False, dtype=DTYPE)


class TestMeshedFusedEngine:
    def test_high_level_api_on_virtual_mesh(self):
        from energybalancemodel_jl_tpu.parallel.sharding import ensemble_mesh

        st = ebm.SpaceTime.sin(40, 200, 2)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["D"] = np.linspace(0.55, 0.65, 16)
        kw = dict(n_members=16, dtype=DTYPE, newton_max_iter=8)
        meshed = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            engine="fused", mesh=ensemble_mesh(8), **kw,
        )
        local = ens.ensemble_integrate(
            "MIZ", st, ebm.Forcing(0.0), par, ebm.zeros_init(st),
            engine="fused", **kw,
        )
        assert meshed.seasonal.avg["E"].shape == (16, st.dur, st.nx)
        assert meshed.seasonal.avg["E"].shape == (16, st.dur, st.nx)
        # shard_map groups the adaptive Newton over 2-member shards, so the
        # graph difference is larger than in the local case; compare the
        # pre-amplification year only
        for k in ("E", "h", "phi"):
            assert np.isfinite(np.nan_to_num(meshed.seasonal.avg[k])).all(), k
            np.testing.assert_allclose(
                np.nan_to_num(meshed.seasonal.avg[k][:, 0]),
                np.nan_to_num(local.seasonal.avg[k][:, 0]),
                atol=0.5, err_msg=k,
            )

    def test_mesh_requires_fused(self):
        from energybalancemodel_jl_tpu.parallel.sharding import ensemble_mesh

        st = ebm.SpaceTime.sin(40, 200, 1)
        with pytest.raises(ValueError, match="mesh= requires"):
            ens.ensemble_integrate(
                "MIZ", st, ebm.Forcing(0.0), ebm.default_parameters("MIZ"),
                ebm.zeros_init(st), n_members=8, engine="batched",
                mesh=ensemble_mesh(8), dtype=DTYPE,
            )

    def test_mesh_rejects_raw(self):
        from energybalancemodel_jl_tpu.parallel.sharding import ensemble_mesh

        st = ebm.SpaceTime.sin(40, 200, 1)
        with pytest.raises(ValueError, match="raw_mode='none'"):
            ens.ensemble_integrate(
                "MIZ", st, ebm.Forcing(0.0), ebm.default_parameters("MIZ"),
                ebm.zeros_init(st), n_members=8, engine="fused",
                mesh=ensemble_mesh(8), raw_mode="last", dtype=DTYPE,
            )


def test_convergence_flag_reports_success():
    """The adaptive Newton flag reports convergence for single runs and
    small ensembles (regression: padded members once forced it to 0)."""
    st = ebm.SpaceTime.sin(40, 200, 1)
    par = Collection(
        {k: jnp.asarray(v, DTYPE) for k, v in ebm.default_parameters("MIZ").items()}
    )
    cfg = StepConfig(solver="pcr", newton_abstol=0.5, newton_reltol=1e-4,
                     newton_max_step=50.0)
    spec = get_model("MIZ")
    for k in (1, 3):
        carry = spec.init_carry(ebm.zeros_init(st), st, DTYPE)
        carry = Collection(
            {n: jnp.broadcast_to(v, (k,) + v.shape) for n, v in carry.items()}
        )
        _, _, conv, _ = miz_year(carry, par, jnp.zeros(st.nt, DTYPE), st,
                                 cfg)
        assert float(np.asarray(conv)) == 1.0, k


class TestFusedYearsPerDispatch:
    """Multi-year whole-year dispatch: a lax.scan feeds the carry through
    the same year program. XLA compiles the year inside the scan as a
    different graph, and FMA-level rounding amplifies through the chaotic
    MIZ dynamics — here we assert the semantic properties that survive
    that: year-1 closeness (a chunk off-by-one or dropped accumulator would
    blow past these tolerances by orders of magnitude), chunk-boundary
    shapes, and checkpoint-key compatibility."""

    def _run(self, model, dur, raw_mode="none", **kw):
        st = ebm.SpaceTime.sin(40, 200 if model == "MIZ" else 1000, dur)
        par = ebm.default_parameters(model)
        init = (ebm.zeros_init(st) if model == "MIZ"
                else Collection(E=np.zeros(st.nx), Tg=np.zeros(st.nx)))
        return ebm.integrate(model, st, ebm.Forcing(0.0), par, init,
                             engine="fused", raw_mode=raw_mode, progress=False,
                             dtype=DTYPE, newton_max_iter=8, **kw)

    @staticmethod
    def assert_chunk_equiv(a, b, atol_by_year):
        for store in ("avg", "winter", "summer"):
            for k, va in getattr(a, store).items():
                vb = getattr(b, store)[k]
                assert va.shape == vb.shape, f"{store}.{k}"
                for y, atol in enumerate(atol_by_year):
                    np.testing.assert_allclose(
                        np.nan_to_num(va[..., y, :]),
                        np.nan_to_num(vb[..., y, :]),
                        atol=atol, err_msg=f"{store}.{k} year {y}",
                    )

    @pytest.mark.parametrize("model,atols", [
        ("MIZ", (0.2, 2.0)),       # chaotic: graph-rounding amplifies
        ("Classic", (1e-3, 1e-3)), # stable: rounding stays at float32 level
    ])
    def test_single_run_chunk_equivalence(self, model, atols):
        a = self._run(model, dur=2)
        b = self._run(model, dur=2, years_per_dispatch=2)
        self.assert_chunk_equiv(a.seasonal, b.seasonal, atols)

    def test_chunk_boundaries_and_raw_fallback(self):
        # dur=5 with ypd=2 and a raw final year: chunks 2+2, then the
        # raw-collect year takes the scan fallback — shapes must line up
        a = self._run("MIZ", dur=5, raw_mode="last")
        b = self._run("MIZ", dur=5, raw_mode="last", years_per_dispatch=2)
        assert b.raw["E"].shape == (200, 40)
        assert b.seasonal.avg["E"].shape == (5, 40)
        self.assert_chunk_equiv(a.seasonal, b.seasonal, (0.2,))
        assert all(np.isfinite(np.nan_to_num(v)).all()
                   for v in b.seasonal.avg.values())

    def test_checkpoint_resume_mixes_chunkings(self, tmp_path):
        """engine='fused' keeps ypd out of the checkpoint key: a run
        checkpointed per-year resumes under a
        chunked dispatch without a config-mismatch restart, and the two
        resumed continuations agree."""
        import warnings as _warnings

        ck = str(tmp_path / "fused_ypd.h5")
        st = ebm.SpaceTime.sin(40, 200, 3)
        par = ebm.default_parameters("MIZ")
        kw = dict(progress=False, dtype=DTYPE, newton_max_iter=8,
                  engine="fused", raw_mode="none")

        # 1-year prefix checkpoint grafted under the 3-year key (dur is keyed)
        from energybalancemodel_jl_tpu import checkpoint as ckpt_mod

        st1 = ebm.SpaceTime.sin(40, 200, 1)
        ebm.integrate("MIZ", st1, ebm.Forcing(0.0), par, ebm.zeros_init(st1),
                      checkpoint=ck, **kw)
        carry, years, accs, key = ckpt_mod.read_checkpoint(ck)
        ckpt_mod.write_checkpoint(ck, carry, years, accs,
                                  key.replace(repr(st1), repr(st)))

        def resume(**extra):
            with _warnings.catch_warnings(record=True) as caught:
                _warnings.simplefilter("always")
                out = ebm.integrate("MIZ", st, ebm.Forcing(0.0), par,
                                    ebm.zeros_init(st), checkpoint=ck,
                                    resume=True, **extra, **kw)
            assert not any("does not match" in str(w.message) for w in caught)
            return out

        plain = resume()
        # rewrite the prefix checkpoint, then resume chunked: the ypd must
        # NOT enter the key (a mismatch would warn and restart from init)
        ckpt_mod.write_checkpoint(ck, carry, years, accs,
                                  key.replace(repr(st1), repr(st)))
        chunked = resume(years_per_dispatch=2, checkpoint_every=4)
        # year 1 comes verbatim from the checkpoint in both: exact
        for k, v in plain.seasonal.avg.items():
            np.testing.assert_array_equal(
                np.nan_to_num(chunked.seasonal.avg[k][0]),
                np.nan_to_num(v[0]), err_msg=k,
            )
        self.assert_chunk_equiv(plain.seasonal, chunked.seasonal,
                                (0.0, 0.2, 2.0))

    def test_ensemble_chunk_equivalence(self):
        st = ebm.SpaceTime.sin(40, 200, 2)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["D"] = np.linspace(0.55, 0.65, 8)
        kw = dict(n_members=8, dtype=DTYPE, newton_max_iter=8, engine="fused")
        a = ens.ensemble_integrate("MIZ", st, ebm.Forcing(0.0), par,
                                   ebm.zeros_init(st), **kw)
        b = ens.ensemble_integrate("MIZ", st, ebm.Forcing(0.0), par,
                                   ebm.zeros_init(st), years_per_dispatch=2,
                                   **kw)
        assert b.seasonal.avg["E"].shape == (8, st.dur, st.nx)
        self.assert_chunk_equiv(a.seasonal, b.seasonal, (0.2, 2.0))

    def test_ensemble_chunked_on_virtual_mesh(self):
        from energybalancemodel_jl_tpu.parallel.sharding import ensemble_mesh

        st = ebm.SpaceTime.sin(40, 200, 2)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["D"] = np.linspace(0.55, 0.65, 16)
        kw = dict(n_members=16, dtype=DTYPE, newton_max_iter=8, engine="fused")
        local = ens.ensemble_integrate("MIZ", st, ebm.Forcing(0.0), par,
                                       ebm.zeros_init(st), **kw)
        meshed = ens.ensemble_integrate("MIZ", st, ebm.Forcing(0.0), par,
                                        ebm.zeros_init(st),
                                        mesh=ensemble_mesh(8),
                                        years_per_dispatch=2, **kw)
        assert meshed.seasonal.avg["E"].shape == (16, st.dur, st.nx)
        # shard_map groups the adaptive Newton over 2-member shards, so the
        # graph difference is larger than in the local case; compare the
        # pre-amplification year only
        for k in ("E", "h", "phi"):
            assert np.isfinite(np.nan_to_num(meshed.seasonal.avg[k])).all(), k
            np.testing.assert_allclose(
                np.nan_to_num(meshed.seasonal.avg[k][:, 0]),
                np.nan_to_num(local.seasonal.avg[k][:, 0]),
                atol=0.5, err_msg=k,
            )

    def test_ensemble_rejects_ypd_for_xla_engines(self):
        st = ebm.SpaceTime.sin(40, 200, 2)
        with pytest.raises(ValueError, match="years_per_dispatch"):
            ens.ensemble_integrate(
                "MIZ", st, ebm.Forcing(0.0), ebm.default_parameters("MIZ"),
                ebm.zeros_init(st), n_members=8, engine="batched",
                years_per_dispatch=2, dtype=DTYPE,
            )


class TestInKernelOU:
    """The ``noise_ou`` mode: the OU recurrence computed in the year loop
    from a white-noise table must match feeding the loop the precomputed
    OU path as a plain ``noise`` table (same per-step forcing offsets, so
    identical trajectories up to the two graphs' contraction-level
    rounding), and the 4th return value must be the year-end eta row."""

    def _ou_inputs(self, st, k, seed=3):
        rng = np.random.default_rng(seed)
        xi = jnp.asarray(rng.normal(size=(st.nt, k)), DTYPE)  # (nt, K)
        rho = jnp.asarray(0.97, DTYPE)
        scale = jnp.asarray(np.linspace(0.5, 2.0, k), DTYPE)  # per-member
        eta0 = jnp.asarray(rng.normal(size=(k,)), DTYPE)

        def ou(e, z):
            e = rho * e + scale * z
            return e, e

        eta_end, etas = jax.lax.scan(ou, eta0, xi)
        return xi, etas, eta_end, rho, scale, eta0

    def test_miz_ou_mode_matches_precomputed_table(self):
        st, par, carry, fyear = small_setup(nx=16, nt=48, k=4)
        xi, etas, eta_end, rho, scale, eta0 = self._ou_inputs(st, 4)
        c_tab, s_tab, conv_tab, none4 = miz_year(
            carry, par, fyear, st, FIXED_CFG, noise=etas)
        assert none4 is None
        c_ou, s_ou, conv_ou, eta_ret = miz_year(
            carry, par, fyear, st, FIXED_CFG, noise=xi,
            noise_ou=(rho, scale, eta0))
        assert eta_ret is not None and eta_ret.shape == (4,)
        np.testing.assert_allclose(np.asarray(eta_ret),
                                   np.asarray(eta_end), rtol=1e-5)
        for key in c_tab:
            np.testing.assert_allclose(
                np.asarray(c_ou[key]), np.asarray(c_tab[key]),
                atol=1e-3, err_msg=key)
        np.testing.assert_allclose(
            np.asarray(s_ou.avg["E"]), np.asarray(s_tab.avg["E"]), atol=1e-3)

    def test_classic_ou_mode_matches_precomputed_table(self):
        st = ebm.SpaceTime.sin(16, 48, 1)
        k = 4
        par, carry = _classic_setup(st, k)
        par["D"] = jnp.asarray(np.linspace(0.55, 0.65, k), DTYPE)
        fyear = jnp.zeros(st.nt, dtype=DTYPE)
        xi, etas, eta_end, rho, scale, eta0 = self._ou_inputs(st, k)
        c_tab, s_tab, _, _ = classic_year(
            carry, par, fyear, st, FIXED_CFG, noise=etas)
        c_ou, s_ou, _, eta_ret = classic_year(
            carry, par, fyear, st, FIXED_CFG, noise=xi,
            noise_ou=(rho, scale, eta0))
        assert eta_ret is not None and eta_ret.shape == (k,)
        np.testing.assert_allclose(np.asarray(eta_ret),
                                   np.asarray(eta_end), rtol=1e-5)
        # classic at nt=48 sits below its nt~1000 stability floor
        # (dt*M/cw > 1, CLAUDE.md), so the two graphs' FMA-contraction
        # differences amplify along the year — the per-step forcing
        # equivalence is pinned by the tight eta match above; the
        # trajectory check is a coarse same-dynamics guard
        np.testing.assert_allclose(
            np.asarray(c_ou["E"]), np.asarray(c_tab["E"]),
            rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(
            np.asarray(s_ou.avg["T"]), np.asarray(s_tab.avg["T"]),
            rtol=1e-3, atol=1e-2)

    def test_ou_without_table_raises(self):
        st, par, carry, fyear = small_setup(nx=16, nt=48, k=4)
        with pytest.raises(ValueError, match="noise_ou requires"):
            miz_year(carry, par, fyear, st, FIXED_CFG,
                     noise_ou=(0.9, 1.0, jnp.zeros((4,), DTYPE)))


def _classic_setup(st, k):
    par = Collection(
        {k_: jnp.asarray(v, DTYPE)
         for k_, v in ebm.default_parameters("Classic").items()})
    spec = get_model("Classic")
    E0 = np.full(st.nx, 30.0)
    init = Collection(E=E0, Tg=E0 / float(par["cw"]))
    carry = spec.init_carry(init, st, DTYPE)
    carry = Collection(
        {k_: jnp.broadcast_to(v, (k,) + v.shape) for k_, v in carry.items()})
    return par, carry


class TestInKernelDraws:
    """The ``noise_keys`` mode: the year program draws its white-noise
    table from per-member keys. Correctness contract: a keys-mode year must
    be BITWISE identical to a table-mode year fed ``jax.random.normal`` of
    the same keys — the scan engine's weather (any draw-bit difference
    would diverge the chaotic trajectories). ``ou_assoc`` evaluates the eta
    path by log-depth scan — engine-parity (not bitwise) vs serial."""

    def _keys(self, k, seed=7, year=2):
        base = jax.random.PRNGKey(seed)
        keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
            jnp.arange(k, dtype=jnp.uint32))
        return jax.vmap(lambda key: jax.random.fold_in(key, year))(keys)

    def test_miz_keys_mode_bitwise_vs_oracle_table(self):
        st, par, carry, fyear = small_setup(nx=16, nt=48, k=4)
        yk = self._keys(4)
        table = _oracle_table(yk, st.nt)
        rho = jnp.asarray(0.9, DTYPE)
        scale = jnp.asarray(np.linspace(0.5, 2.0, 4), DTYPE)
        eta0 = jnp.zeros((4,), DTYPE)
        c_tab, s_tab, _, eta_tab = miz_year(
            carry, par, fyear, st, FIXED_CFG, noise=table,
            noise_ou=(rho, scale, eta0))
        c_gen, s_gen, _, eta_gen = miz_year(
            carry, par, fyear, st, FIXED_CFG, noise_keys=yk,
            noise_ou=(rho, scale, eta0))
        for key in c_tab:
            np.testing.assert_array_equal(
                np.asarray(c_gen[key]), np.asarray(c_tab[key]),
                err_msg=key)
        np.testing.assert_array_equal(np.asarray(s_gen.avg["E"]),
                                      np.asarray(s_tab.avg["E"]))
        np.testing.assert_array_equal(np.asarray(eta_gen),
                                      np.asarray(eta_tab))

    @pytest.mark.parametrize("nt", [48, 1536])
    def test_classic_keys_mode_bitwise_vs_oracle_table(self, nt):
        st = ebm.SpaceTime.sin(8 if nt > 48 else 16, nt, 1)
        par, carry = _classic_setup(st, 4)
        fyear = jnp.zeros(st.nt, dtype=DTYPE)
        yk = self._keys(4, seed=1)
        table = _oracle_table(yk, st.nt)
        rho = jnp.asarray(0.9, DTYPE)
        scale = jnp.asarray(1.5, DTYPE)
        eta0 = jnp.zeros((4,), DTYPE)
        c_tab, s_tab, _, eta_tab = classic_year(
            carry, par, fyear, st, FIXED_CFG, noise=table,
            noise_ou=(rho, scale, eta0))
        c_gen, s_gen, _, eta_gen = classic_year(
            carry, par, fyear, st, FIXED_CFG, noise_keys=yk,
            noise_ou=(rho, scale, eta0))
        assert np.isfinite(np.asarray(eta_gen)).all()
        for key in c_tab:
            np.testing.assert_array_equal(
                np.asarray(c_gen[key]), np.asarray(c_tab[key]),
                err_msg=key)
        np.testing.assert_array_equal(np.asarray(eta_gen),
                                      np.asarray(eta_tab))

    def test_plain_noise_keys_mode_matches_table(self):
        """Keys without an OU process are plain white-noise offsets: the
        same year as the explicit table of those draws, bitwise."""
        st, par, carry, fyear = small_setup(nx=16, nt=48, k=4)
        yk = self._keys(4, seed=5)
        c_gen, _, _, eta = miz_year(carry, par, fyear, st, FIXED_CFG,
                                    noise_keys=yk)
        c_tab, _, _, _ = miz_year(carry, par, fyear, st, FIXED_CFG,
                                  noise=_oracle_table(yk, st.nt))
        assert eta is None
        for key in c_tab:
            np.testing.assert_array_equal(
                np.asarray(c_gen[key]), np.asarray(c_tab[key]),
                err_msg=key)

    def test_assoc_matches_serial_at_roundoff(self):
        st, par, carry, fyear = small_setup(nx=16, nt=48, k=4)
        yk = self._keys(4)
        rho = jnp.asarray(0.9, DTYPE)
        scale = jnp.asarray(np.linspace(0.5, 2.0, 4), DTYPE)
        eta0 = jnp.asarray([0.3, -0.2, 0.0, 1.0], DTYPE)
        c_s, _, _, eta_s = miz_year(
            carry, par, fyear, st, FIXED_CFG, noise_keys=yk,
            noise_ou=(rho, scale, eta0))
        c_a, _, _, eta_a = miz_year(
            carry, par, fyear, st, FIXED_CFG, noise_keys=yk,
            noise_ou=(rho, scale, eta0), ou_assoc=True)
        # the tree-regrouped eta is a ~1 ulp twin of the serial chain
        np.testing.assert_allclose(np.asarray(eta_a), np.asarray(eta_s),
                                   rtol=1e-5, atol=1e-6)
        for key in c_s:
            np.testing.assert_allclose(
                np.asarray(c_a[key]), np.asarray(c_s[key]),
                atol=1e-3, err_msg=key)

    def test_assoc_eta_path_matches_xla_scan(self):
        """The log-depth OU path == a numpy serial recurrence on the oracle
        draws, at round-off."""
        st, par, carry, fyear = small_setup(nx=16, nt=48, k=4)
        yk = self._keys(4, seed=9)
        xi = np.asarray(_oracle_table(yk, st.nt), np.float64)
        rho, eta0 = 0.93, np.array([0.5, -1.0, 0.0, 2.0])
        scale = np.linspace(0.5, 2.0, 4)
        eta = eta0.copy()
        for t_ in range(st.nt):
            eta = rho * eta + scale * xi[t_]
        _, _, _, eta_a = miz_year(
            carry, par, fyear, st, FIXED_CFG, noise_keys=yk,
            noise_ou=(jnp.asarray(rho, DTYPE), jnp.asarray(scale, DTYPE),
                      jnp.asarray(eta0, DTYPE)),
            ou_assoc=True)
        np.testing.assert_allclose(np.asarray(eta_a), eta,
                                   rtol=1e-4, atol=1e-5)

    def test_error_paths(self):
        st, par, carry, fyear = small_setup(nx=16, nt=48, k=4)
        yk = self._keys(4)
        table = jnp.zeros((st.nt, 4), DTYPE)
        with pytest.raises(ValueError, match="mutually exclusive"):
            miz_year(carry, par, fyear, st, FIXED_CFG, noise=table,
                     noise_keys=yk)
        with pytest.raises(ValueError, match="uint32 key-data"):
            miz_year(carry, par, fyear, st, FIXED_CFG,
                     noise_keys=jnp.zeros((4, 2), jnp.int32),
                     noise_ou=(0.9, 1.0, jnp.zeros((4,), DTYPE)))
        with pytest.raises(ValueError, match=r"shape \(nt, K\)"):
            miz_year(carry, par, fyear, st, FIXED_CFG,
                     noise=jnp.zeros((st.nt, 3), DTYPE))


def _oracle_table(keys, nt, dtype=DTYPE):
    """``(nt, K)`` table of ``jax.random.normal(keys[k], (nt,), dtype)``."""
    return jax.vmap(lambda k: jax.random.normal(k, (nt,), dtype),
                    out_axes=1)(keys)


class TestFloat64Parity:
    """In float64 the whole-year engine and the per-year scan engine run
    the same step arithmetic; they agree to round-off over a year."""

    @pytest.mark.parametrize("model", ["MIZ", "Classic"])
    def test_whole_year_matches_scan_in_f64(self, model):
        from energybalancemodel_jl_tpu.integrate import make_year_fn
        from energybalancemodel_jl_tpu.models.base import default_step_config

        f64 = jnp.float64
        st = ebm.SpaceTime.sin(24, 200 if model == "MIZ" else 1000, 1)
        par = Collection({k: jnp.asarray(v, f64)
                          for k, v in ebm.default_parameters(model).items()})
        if model == "MIZ":
            init = ebm.zeros_init(st)
        else:
            E0 = np.linspace(20.0, -20.0, st.nx)
            init = Collection(E=E0, Tg=E0 / float(par["cw"]))
        cfg = default_step_config("float64")
        carry = get_model(model).init_carry(init, st, f64)
        scan = jax.jit(make_year_fn(model, st, cfg, "float64", False))
        c_s, s_s, _, _ = scan(carry, par, jnp.zeros(st.nt, f64))
        year = miz_year if model == "MIZ" else classic_year
        c1 = Collection({k: v[None] for k, v in carry.items()})
        c_w, s_w, _, _ = year(c1, par, jnp.zeros(st.nt, f64), st, cfg)
        for k in c_s:
            np.testing.assert_allclose(np.asarray(c_w[k])[0],
                                       np.asarray(c_s[k]), rtol=1e-9,
                                       atol=1e-9, err_msg=k)
        for k in s_s.avg:
            np.testing.assert_allclose(
                np.nan_to_num(np.asarray(s_w.avg[k])[0]),
                np.nan_to_num(np.asarray(s_s.avg[k])), rtol=1e-9,
                atol=1e-9, err_msg=k)


class TestEngineResolver:
    """One ``engine='auto'`` policy for the four drivers (engine.py): the
    whole-year engine for MIZ and Classic unless the run needs a per-year
    engine feature."""

    def test_policy(self):
        from energybalancemodel_jl_tpu.engine import auto_whole_year

        assert auto_whole_year("MIZ")
        assert auto_whole_year("Classic")
        assert not auto_whole_year("MIZ", per_year_only=True)
        assert not auto_whole_year("_NoKernel")

    def _run(self, driver, monkeypatch, **extra):
        """Run ``driver`` with engine='auto' on a tiny Classic config;
        True when the whole-year engine ran."""
        import energybalancemodel_jl_tpu.ops.year as yr
        from energybalancemodel_jl_tpu.stochastic import transitions

        seen = []

        def spy(*a, **kw):
            seen.append(True)
            return classic_year(*a, **kw)

        monkeypatch.setattr(yr, "classic_year", spy)
        st = ebm.SpaceTime.sin(8, 24, 1)
        par = Collection(ebm.default_parameters("Classic"))
        init = Collection(E=np.full(st.nx, 10.0), Tg=np.full(st.nx, 0.1))
        kw = dict(dtype=DTYPE, **extra)
        if driver == "integrate":
            ebm.integrate("Classic", st, ebm.Forcing(0.0), par, init,
                          progress=False, raw_mode="none", **kw)
        elif driver == "ensemble":
            par["D"] = np.array([0.5, 0.6])
            ens.ensemble_integrate("Classic", st, ebm.Forcing(0.0), par,
                                   init, progress=False, **kw)
        elif driver == "equilibrate":
            par["D"] = np.array([0.5, 0.6])
            ebm.equilibrate("Classic", st, 0.0, par, init, max_years=2,
                            tol=0.0, **kw)
        else:
            r = transitions("Classic", st, 0.0, par, init, init, sigma=0.0,
                            years=1, K=2, **kw)
            assert r.engine == ("fused" if seen else "scan")
        return bool(seen)

    @pytest.mark.parametrize("driver", ["integrate", "ensemble",
                                        "equilibrate", "transitions"])
    def test_auto_takes_the_whole_year_engine(self, driver, monkeypatch):
        assert self._run(driver, monkeypatch)

    @pytest.mark.parametrize("driver,extra", [
        ("integrate", {"progress_steps": 6}),
        ("integrate", {"solver": "thomas"}),
        ("ensemble", {"raw_mode": "all"}),
        ("ensemble", {"solver": "thomas"})])
    def test_per_year_features_resolve_to_the_per_year_engine(
            self, driver, extra, monkeypatch):
        assert not self._run(driver, monkeypatch, **extra)

    @pytest.mark.parametrize("driver,extra", [
        ("ensemble", "mesh"), ("equilibrate", "mesh"),
        ("transitions", "subyear")])
    def test_whole_year_features_resolve_to_the_whole_year_engine(
            self, driver, extra, monkeypatch):
        from jax.sharding import Mesh

        kw = ({"mesh": Mesh(np.array(jax.devices()[:2]), ("members",))}
              if extra == "mesh" else {"subyear": True})
        assert self._run(driver, monkeypatch, **kw)


class TestRemovedNames:
    """Solver names whose kernels were removed fail with a clear error."""

    @pytest.mark.parametrize("solver", ["pallas", "pcr_fused"])
    def test_removed_solver_raises(self, solver):
        st = ebm.SpaceTime.sin(8, 24, 1)
        with pytest.raises(ValueError, match="no longer available"):
            ebm.integrate("MIZ", st, ebm.Forcing(0.0),
                          ebm.default_parameters("MIZ"), ebm.zeros_init(st),
                          solver=solver, progress=False)

    def test_removed_solver_raises_in_ensembles(self):
        st = ebm.SpaceTime.sin(8, 24, 1)
        par = ebm.default_parameters("MIZ")
        par["D"] = np.array([0.5, 0.6])
        with pytest.raises(ValueError, match="no longer available"):
            ens.ensemble_integrate("MIZ", st, ebm.Forcing(0.0), par,
                                   ebm.zeros_init(st), solver="pallas",
                                   progress=False)

    def test_unknown_solver_raises(self):
        from energybalancemodel_jl_tpu.models.base import default_step_config

        with pytest.raises(ValueError, match="unknown solver"):
            default_step_config("float32", solver="bogus")

    @pytest.mark.parametrize("kwarg", ["layout", "block_k", "interpret"])
    def test_removed_year_options_raise(self, kwarg):
        st, par, carry, fyear = small_setup(nx=8, nt=24, k=2)
        with pytest.raises(TypeError):
            miz_year(carry, par, fyear, st, FIXED_CFG, **{kwarg: 1})


def test_package_has_no_interpreted_kernels():
    """Nothing in the package runs a Pallas kernel or the Pallas
    interpreter, and no code branches on the platform: every engine is
    compiled XLA."""
    import pathlib

    root = pathlib.Path(ebm.__file__).parent
    bad = []
    for path in sorted(root.rglob("*.py")):
        text = path.read_text()
        for needle in ("pallas_call", "interpret=", "default_interpret",
                       "jax.experimental.pallas", "default_backend()"):
            if needle in text:
                bad.append(f"{path.relative_to(root)}: {needle}")
    assert not bad, bad
