"""Steady-state equilibration (equilibrium.py) — no reference analog; the
reference reaches equilibria by integrating a long hand-chosen dur.

Tolerance notes (module docstring has the details): MIZ relaxes cleanly;
classic's discrete E==0 albedo hole leaves an O(0.1) irregular wobble at
ice-edge cells, so its year map has a fixed point only to that resolution —
classic tests use tol=0.5 (arrival at the attractor), MIZ tests 1e-3.
"""
import numpy as np
import pytest

import energybalancemodel_jl_tpu as ebm


def classic_setup():
    st = ebm.SpaceTime.sin(24, 1000, 1)
    base = ebm.default_parameters("Classic")
    E0 = np.full(st.nx, 40.0)  # ice-free warm init (stability notes)
    init = ebm.Collection(E=E0, Tg=E0 / float(base["cw"]))
    return st, base, init


class TestEquilibrate:
    def test_classic_matches_integrate_at_equal_years(self):
        """The loop is the same year graph integrate runs: at equal year
        counts the states agree to rounding (~1e-12 measured)."""
        st, base, init = classic_setup()
        res = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), base, init,
                              tol=0.5, max_years=500)
        assert res.converged
        assert 2 <= res.years < 500
        long_st = ebm.SpaceTime.sin(24, 1000, res.years)
        sols = ebm.integrate("Classic", long_st, ebm.Forcing(0.0), base, init,
                             progress=False, raw_mode="none")
        np.testing.assert_allclose(
            np.asarray(res.seasonal.avg["E"]),
            np.asarray(sols.seasonal.avg["E"][-1]),
            rtol=0, atol=1e-9,
        )

    def test_warm_start_continuation(self):
        """Re-equilibrating from a converged state must be immediate."""
        st, base, init = classic_setup()
        res = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), base, init,
                              tol=0.5, max_years=500)
        res2 = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), base,
                               res.state, tol=0.5, max_years=500)
        assert res2.converged and res2.years <= 3

    def test_miz_converges_tight(self):
        st = ebm.SpaceTime.sin(16, 150, 1)
        res = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0),
                              ebm.default_parameters("MIZ"),
                              ebm.zeros_init(st), tol=1e-3, max_years=400)
        assert res.converged
        assert res.newton_ok
        assert float(res.resid) <= 1e-3

    def test_miz_ensemble_F_sweep_matches_solo(self):
        """Members with per-member forcing offsets equilibrate in lockstep
        and match solo runs with the offset folded into the forcing."""
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["F"] = np.array([0.0, 2.0])
        init = ebm.zeros_init(st)
        ens = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init,
                              tol=1e-3, max_years=400)
        assert ens.member_years is not None and ens.member_years.shape == (2,)
        assert ens.converged.all()
        assert (ens.member_years > 0).all()
        for i, F in enumerate([0.0, 2.0]):
            solo = ebm.equilibrate(
                "MIZ", st, ebm.Forcing(F), ebm.default_parameters("MIZ"),
                init, tol=1e-3, max_years=400,
            )
            # the ensemble stops when the SLOWEST member converges, so the
            # faster member runs extra years past its own convergence —
            # compare states, not trajectories, to attractor resolution
            np.testing.assert_allclose(
                np.nan_to_num(np.asarray(ens.seasonal.avg["E"][i])),
                np.nan_to_num(np.asarray(solo.seasonal.avg["E"])),
                rtol=0, atol=5e-2, err_msg=f"member {i}",
            )
        # the two forcing levels must land on different states
        dE = np.abs(np.asarray(ens.seasonal.avg["E"][0])
                    - np.asarray(ens.seasonal.avg["E"][1]))
        assert dE.max() > 1.0

    def test_scalar_F_on_single_run_is_constant_forcing(self):
        st, base, init = classic_setup()
        par = ebm.Collection(base)
        par["F"] = 2.0
        res = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), par, init,
                              tol=0.5, max_years=300)
        res_f = ebm.equilibrate("Classic", st, ebm.Forcing(2.0), base, init,
                                tol=0.5, max_years=300)
        np.testing.assert_array_equal(
            np.asarray(res.seasonal.avg["E"]),
            np.asarray(res_f.seasonal.avg["E"]),
        )

    def test_max_years_bound(self):
        st, base, init = classic_setup()
        res = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), base, init,
                              tol=1e-12, max_years=3)
        assert res.years == 3
        assert not res.converged
        assert "NOT converged" in repr(res)

    def test_validation(self):
        st, base, init = classic_setup()
        ramp = ebm.Forcing(0.0, 2.0, -2.0, (1, 1), (1.0, -1.0))
        with pytest.raises(ValueError, match="constant"):
            ebm.equilibrate("Classic", st, ramp, base, init)
        with pytest.raises(ValueError, match="metric"):
            ebm.equilibrate("Classic", st, ebm.Forcing(0.0), base, init,
                            metric=("nope",))

    def test_float_forcing_accepted(self):
        st, base, init = classic_setup()
        res = ebm.equilibrate("Classic", st, 0.0, base, init, tol=0.5,
                              max_years=300)
        assert res.converged
        assert "converged" in repr(res)


class TestFusedEngine:
    """equilibrate(engine='fused') runs the whole-year engine (ops/year.py)
    inside the convergence while_loop. Parity runs pin the year count with
    tol=0 so both engines simulate exactly max_years years; f32 engine
    agreement measured at 1e-4..5e-3 after 3 years (Newton tolerance and
    fusion-level rounding)."""

    KW = dict(tol=0.0, max_years=3, dtype="float32")

    @staticmethod
    def _dmax(a, b):
        return np.nanmax(np.abs(np.nan_to_num(np.asarray(a))
                                - np.nan_to_num(np.asarray(b))))

    def test_miz_single_matches_batched(self):
        st = ebm.SpaceTime.sin(16, 100, 1)
        par = ebm.default_parameters("MIZ")
        a = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), engine="batched", **self.KW)
        b = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), engine="fused", **self.KW)
        assert a.years == b.years == 3
        assert b.seasonal.avg["E"].shape == (st.nx,)
        assert self._dmax(a.seasonal.avg["E"], b.seasonal.avg["E"]) < 0.5
        assert self._dmax(a.state["Ei"], b.state["Ei"]) < 0.5

    def test_miz_ensemble_F_sweep_matches_batched(self):
        st = ebm.SpaceTime.sin(16, 100, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["F"] = np.array([0.0, 1.0, 2.0])
        # float64: in float32 the F=1 member's ice edge amplifies the two
        # XLA:CPU graphs' round-off past 0.5 by year 3 (measured 5e-4,
        # 0.04, 1.06 in years 1-3); float64 keeps it at round-off
        kw = dict(self.KW, dtype="float64")
        a = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), engine="batched", **kw)
        b = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), engine="fused", **kw)
        assert b.seasonal.avg["E"].shape == (3, st.nx)
        assert self._dmax(a.seasonal.avg["E"], b.seasonal.avg["E"]) < 0.5
        # the F offsets must actually reach the whole-year forcing
        assert self._dmax(b.seasonal.avg["E"][0],
                          b.seasonal.avg["E"][2]) > 1e-3

    def test_classic_single_matches_batched(self):
        st = ebm.SpaceTime.sin(16, 1000, 1)
        par = ebm.default_parameters("Classic")
        init = ebm.Collection(E=np.zeros(st.nx), Tg=np.zeros(st.nx))
        a = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), par, init,
                            engine="batched", **self.KW)
        b = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), par, init,
                            engine="fused", **self.KW)
        assert self._dmax(a.seasonal.avg["E"], b.seasonal.avg["E"]) < 0.5

    def test_fused_converges_and_reports(self):
        """The fused loop's convergence accounting (resid/member_years/
        newton flag) behaves like the batched one's."""
        st = ebm.SpaceTime.sin(16, 100, 1)
        res = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0),
                              ebm.default_parameters("MIZ"),
                              ebm.zeros_init(st), tol=1e-2, max_years=300,
                              dtype="float32", engine="fused")
        assert res.converged
        assert res.newton_ok
        assert 2 <= res.years < 300

    def test_auto_resolves_to_fused(self):
        """The shared resolver puts 'auto' on the whole-year engine for MIZ
        (no platform branch): the result equals engine='fused' bitwise."""
        st = ebm.SpaceTime.sin(16, 100, 1)
        args = ("MIZ", st, ebm.Forcing(0.0), ebm.default_parameters("MIZ"),
                ebm.zeros_init(st))
        res = ebm.equilibrate(*args, engine="auto", **self.KW)
        ref = ebm.equilibrate(*args, engine="fused", **self.KW)
        assert res.years == 3
        np.testing.assert_array_equal(np.asarray(res.state["Ei"]),
                                      np.asarray(ref.state["Ei"]))

    def test_unknown_engine_raises(self):
        st = ebm.SpaceTime.sin(16, 100, 1)
        with pytest.raises(ValueError, match="unknown engine"):
            ebm.equilibrate("MIZ", st, ebm.Forcing(0.0),
                            ebm.default_parameters("MIZ"),
                            ebm.zeros_init(st), engine="turbo")


class TestMeshEngine:
    """equilibrate(mesh=...): members shard across the (virtual 8-device)
    mesh, each device runs the whole-year engine on its local shard inside
    the convergence loop. Spread vs the unsharded run is Newton-grouping
    level (each shard's members iterate together)."""

    def test_mesh_matches_single_fused(self):
        from energybalancemodel_jl_tpu.parallel.sharding import ensemble_mesh

        mesh = ensemble_mesh()
        assert mesh.size == 8
        st = ebm.SpaceTime.sin(16, 100, 1)
        K = 16
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["F"] = np.linspace(0.0, 2.0, K)
        kw = dict(tol=0.0, max_years=3, dtype="float32")
        a = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), engine="fused", **kw)
        b = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), mesh=mesh, **kw)
        assert b.seasonal.avg["E"].shape == (K, st.nx)
        d = np.nanmax(np.abs(np.nan_to_num(np.asarray(a.seasonal.avg["E"]))
                             - np.nan_to_num(np.asarray(b.seasonal.avg["E"]))))
        assert d < 0.5, d

    def test_mesh_engine_conflicts_raise(self):
        from energybalancemodel_jl_tpu.parallel.sharding import ensemble_mesh

        mesh = ensemble_mesh()
        st = ebm.SpaceTime.sin(16, 100, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["F"] = np.linspace(0.0, 2.0, 16)
        with pytest.raises(ValueError, match="engine='fused'"):
            ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), mesh=mesh, engine="batched")
        with pytest.raises(ValueError, match="ensemble"):
            ebm.equilibrate("MIZ", st, ebm.Forcing(0.0),
                            ebm.default_parameters("MIZ"),
                            ebm.zeros_init(st), mesh=mesh)
        par_bad = ebm.Collection(ebm.default_parameters("MIZ"))
        par_bad["F"] = np.linspace(0.0, 2.0, 12)  # 12 % 8 != 0
        with pytest.raises(ValueError, match="divisible"):
            ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par_bad,
                            ebm.zeros_init(st), mesh=mesh)


class TestImplicitGradients:
    """Implicit-function-theorem adjoint through the fixed point — validated
    against finite differences (measured rel err ~4e-4 at eps=1e-4; the FD
    noise floor of two 1e-10-tolerance equilibria)."""

    def test_ift_gradient_matches_finite_difference(self):
        import jax
        import jax.numpy as jnp

        from energybalancemodel_jl_tpu.equilibrium import (
            make_equilibrium_seasonal_fn,
        )
        from energybalancemodel_jl_tpu.models.base import (
            default_step_config,
            get_model,
        )

        st = ebm.SpaceTime.sin(16, 150, 1)
        spec = get_model("MIZ")
        cfg = default_step_config("float64")
        fn = make_equilibrium_seasonal_fn("MIZ", st, cfg, "float64",
                                          tol=1e-10, max_years=600)
        base = ebm.default_parameters("MIZ")
        frow = jnp.zeros(st.nt)
        carry0 = spec.init_carry(ebm.zeros_init(st), st, jnp.float64)

        def g(A):
            par = ebm.Collection(
                {k: jnp.float64(v) for k, v in base.items()}
            )
            par["A"] = A
            s = fn(par, frow, carry0)
            return jnp.sum(jnp.nan_to_num(s.avg["E"]))

        A0 = jnp.float64(base["A"])
        grad = jax.grad(g)(A0)
        eps = 1e-4
        fd = (g(A0 + eps) - g(A0 - eps)) / (2 * eps)
        assert np.isfinite(float(grad))
        np.testing.assert_allclose(float(grad), float(fd), rtol=5e-3)

    def test_calibrate_to_equilibrium_recovers_A(self):
        """calibrate(equilibrium=True): fit the OLR constant so the MIZ
        equilibrium matches a synthetic equilibrium target — the horizon-
        free objective the unrolled dur-year fit cannot provide."""
        st = ebm.SpaceTime.sin(16, 150, 1)
        base = ebm.default_parameters("MIZ")
        truth = ebm.Collection(base)
        truth["A"] = 196.0
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), truth,
                             ebm.zeros_init(st), tol=1e-8, max_years=600)
        assert eq.converged
        target = {"E": np.asarray(eq.seasonal.avg["E"])}
        res = ebm.calibrate("MIZ", st, ebm.Forcing(0.0),
                            ebm.Collection(base), ebm.zeros_init(st),
                            target=target, vary=("A",), steps=60,
                            learning_rate=0.2, equilibrium=True,
                            equilibrium_tol=1e-8,
                            equilibrium_max_years=600)
        assert np.isfinite(res.losses).all()
        assert res.losses[-1] < 1e-2 * res.losses[0]
        # moved decisively toward the generating value
        assert abs(float(res.params["A"]) - 196.0) < 1.0

    def test_equilibrium_requires_constant_forcing(self):
        st = ebm.SpaceTime.sin(16, 150, 1)
        base = ebm.default_parameters("MIZ")
        ramp = ebm.Forcing(0.0, 2.0, -2.0, (1, 1), (1.0, -1.0))
        with pytest.raises(ValueError, match="constant"):
            ebm.calibrate("MIZ", st, ramp, base, ebm.zeros_init(st),
                          target={"E": np.zeros(st.nx)}, vary=("A",),
                          equilibrium=True)


class TestStability:
    """Year-map spectral radius by reverse-mode power iteration
    (ebm.stability). Expected magnitudes measured in development (f64,
    nx=16-24): classic warm equilibrium ~0.985, classic icy ~0.96,
    classic step-instability regime (nt < ~1000) reads 5-50, healthy MIZ
    equilibria -> exactly 1 (frozen-cell integrator modes)."""

    def test_classic_warm_equilibrium_attracting(self):
        st, base, init = classic_setup()
        # the spectral radius is a smooth function of the state, so the
        # linearization point only needs to be NEAR the attractor — and
        # classic can't do better anyway: even warmed configs keep a
        # winter ice edge whose E==0 albedo-hole wobble floors the
        # year-over-year residual at O(1e-2) (module docstring), so use
        # the documented arrival tolerance
        eq = ebm.equilibrate("Classic", st, ebm.Forcing(6.0), base, init,
                             tol=0.5, max_years=300)
        assert eq.converged and eq.resid < 0.5
        res = ebm.stability("Classic", st, ebm.Forcing(6.0), base, eq.state,
                            n_iter=40)
        assert res.converged
        assert 0.9 < res.growth < 1.0
        assert res.history.shape == (40,)
        assert "attracting" in repr(res)
        # chunked dispatch is invariant (same v sequence; the forward
        # linearization is recomputed per dispatch, bitwise-identically)
        res2 = ebm.stability("Classic", st, ebm.Forcing(6.0), base, eq.state,
                             n_iter=40, iters_per_dispatch=7)
        np.testing.assert_array_equal(res.history, res2.history)

    def test_classic_unstable_config_detected(self):
        """nt=400 puts the classic explicit step in its dt*M/cw > 1
        oscillatory regime (CLAUDE.md invariant); the year map at the
        warm init must read strongly non-attracting."""
        st = ebm.SpaceTime.sin(24, 400, 1)
        base = ebm.default_parameters("Classic")
        E0 = np.full(st.nx, 40.0)
        init = ebm.Collection(E=E0, Tg=E0 / float(base["cw"]))
        res = ebm.stability("Classic", st, ebm.Forcing(0.0), base, init,
                            n_iter=10)
        assert res.growth > 2.0
        assert "non-attracting" in repr(res)

    def test_miz_neutral_and_projected(self):
        """Healthy MIZ equilibrium: spectral radius -> 1 (frozen-cell Ew
        integrator mode, with its mass in fully ice-covered cells);
        projecting the frozen families keeps the estimate at/below
        neutral rather than above."""
        st = ebm.SpaceTime.sin(16, 150, 1)
        base = ebm.default_parameters("MIZ")
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), base,
                             ebm.zeros_init(st), tol=1e-7, max_years=400)
        assert eq.converged
        res = ebm.stability("MIZ", st, ebm.Forcing(0.0), base, eq.state,
                            n_iter=50)
        assert 0.97 < res.growth < 1.05
        full_ice = np.asarray(eq.state["phi"]) >= 0.99
        m = np.asarray(res.mode["Ew"])
        assert (m[full_ice] ** 2).sum() > 0.5 * (m**2).sum()

        proj = ebm.stability("MIZ", st, ebm.Forcing(0.0), base, eq.state,
                             n_iter=50, project=("Ew", "phi"))
        assert proj.growth < 1.05
        mp = np.asarray(proj.mode["Ew"])
        assert (mp[full_ice] ** 2).sum() < 1e-8

    def test_ensemble_lockstep_matches_solo(self):
        """Members iterate independently (block-diagonal Jacobian): the
        2-member run reproduces each solo estimate."""
        st = ebm.SpaceTime.sin(16, 150, 1)
        base = ebm.default_parameters("MIZ")
        par = ebm.Collection(base)
        par["A"] = np.array([193.0, 196.0])
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                             ebm.zeros_init(st), tol=1e-6, max_years=400)
        res = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                            n_iter=30)
        assert res.growth.shape == (2,)
        assert np.isfinite(res.growth).all()
        assert res.history.shape == (30, 2)
        for i in (0, 1):
            solo_par = ebm.Collection(base)
            solo_par["A"] = float(np.asarray(par["A"])[i])
            solo_init = ebm.Collection(
                {k: np.asarray(v)[i] for k, v in eq.state.items()}
            )
            solo = ebm.stability("MIZ", st, ebm.Forcing(0.0), solo_par,
                                 solo_init, n_iter=30)
            # the random start vectors differ between the (K, nx) and
            # (nx,) draws, so the two estimates share a limit but not a
            # transient: compare at the iteration-30 convergence level
            np.testing.assert_allclose(res.growth[i], solo.growth,
                                       rtol=5e-3)
        assert "members" in repr(res)

    def test_forcing_offset_sweep(self):
        """The virtual 'F' parameter works as in equilibrate: per-member
        constant forcing offsets (scalar F folds into the base)."""
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["F"] = np.array([0.0, 2.0])
        res = ebm.stability("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), n_iter=5)
        assert res.growth.shape == (2,)
        assert np.isfinite(res.growth).all()
        solo_par = ebm.Collection(ebm.default_parameters("MIZ"))
        solo_par["F"] = 2.0  # scalar offset on a single run
        solo = ebm.stability("MIZ", st, ebm.Forcing(0.0), solo_par,
                             ebm.zeros_init(st), n_iter=5)
        assert np.isfinite(solo.growth)

    def test_validation(self):
        st, base, init = classic_setup()
        with pytest.raises(ValueError, match="constant forcing"):
            ebm.stability("Classic", st,
                          ebm.Forcing(0.0, 1.0, -1.0, (2, 2), (0.5, -0.5)),
                          base, init)
        with pytest.raises(ValueError, match="n_iter"):
            ebm.stability("Classic", st, ebm.Forcing(0.0), base, init,
                          n_iter=1)
        with pytest.raises(ValueError, match="not in the Classic carry"):
            ebm.stability("Classic", st, ebm.Forcing(0.0), base, init,
                          project=("Ew",))


class TestContinuation:
    """Warm-started parameter-path equilibration (ebm.continuation) — the
    native replacement for the reference's ramp-based hysteresis recipe."""

    def test_forcing_path_round_trip(self):
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.default_parameters("MIZ")
        cont = ebm.continuation("MIZ", st, [-2.0, 2.0, 6.0], par,
                                ebm.zeros_init(st), round_trip=True,
                                tol=1e-2, max_years=300)
        assert len(cont.results) == 5
        np.testing.assert_array_equal(cont.values, [-2, 2, 6, 2, -2])
        np.testing.assert_array_equal(cont.direction, [1, 1, 1, -1, -1])
        assert cont.converged.all()
        area = cont.ice_area()
        assert area.shape == (5,)
        assert np.isfinite(area).all()
        # more forcing, less ice on the forward leg
        assert area[0] > area[2]
        # warming melts: hemispheric-mean enthalpy rises with F
        E = cont.mean("E")
        assert E[2] > E[0]
        assert "round trip" in repr(cont)
        # levels chain: the final level's state warm-starts nothing, but
        # each stored result is a full EquilibriumResult
        assert all(hasattr(r, "state") for r in cont.results)
        # hysteresis_gap: both repeated values compared leg-to-leg; MIZ
        # at defaults has no real bistable window (CLAUDE.md), so gaps
        # stay small
        vals, gap = cont.hysteresis_gap()
        np.testing.assert_array_equal(vals, [-2.0, 2.0])
        assert gap.shape == (2,)
        assert np.all(gap < 0.5), gap
        vals_E, gap_E = cont.hysteresis_gap(var="E")
        assert gap_E.shape == (2,)

    def test_hysteresis_gap_needs_round_trip(self):
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.default_parameters("MIZ")
        cont = ebm.continuation("MIZ", st, [0.0, 2.0], par,
                                ebm.zeros_init(st), tol=1e-2,
                                max_years=200)
        with pytest.raises(ValueError, match="round_trip"):
            cont.hysteresis_gap()

    def test_parameter_path_and_ensemble(self):
        """vary= names a par key; (K,) par leaves trace the path as a
        lockstep ensemble."""
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["D"] = np.array([0.55, 0.65])
        cont = ebm.continuation("MIZ", st, [196.0, 193.0], par,
                                ebm.zeros_init(st), vary="A",
                                tol=1e-2, max_years=300)
        assert cont.ice_area().shape == (2, 2)
        assert cont.mean("E").shape == (2, 2)
        assert np.isfinite(cont.ice_area()).all()
        assert "one-way" in repr(cont)

    def test_validation(self):
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.default_parameters("MIZ")
        with pytest.raises(ValueError, match="non-empty"):
            ebm.continuation("MIZ", st, [], par, ebm.zeros_init(st))
        with pytest.raises(ValueError, match="not in par"):
            ebm.continuation("MIZ", st, [1.0], par, ebm.zeros_init(st),
                             vary="bogus")
        with pytest.raises(ValueError, match="constant base forcing"):
            ebm.continuation(
                "MIZ", st, [1.0], par, ebm.zeros_init(st),
                forcing=ebm.Forcing(0.0, 1.0, -1.0, (2, 2), (0.5, -0.5)),
            )


class TestStabilityDenseOracle:
    """ebm.stability vs a dense-Jacobian eigendecomposition of the SAME
    year map: assemble J with jax.jacrev, take np.linalg.eigvals, and the
    power-iteration growth must reproduce the spectral radius — including
    for the PROJECTED operator (zeroing Ew/phi rows+columns in frozen
    cells is exactly what per-iteration projection applies). AD-vs-FD
    correctness of the underlying VJPs is covered by test_gradients.py;
    this validates the iteration/normalization/projection machinery."""

    @staticmethod
    def _dense_jac(model, st, forcing, par, state):
        import jax
        import jax.numpy as jnp

        from energybalancemodel_jl_tpu.integrate import make_year_fn
        from energybalancemodel_jl_tpu.models.base import (
            default_step_config, get_model)

        spec = get_model(model)
        cfg = default_step_config("float64", newton_max_iter=30)
        year = make_year_fn(model, st, cfg, "float64", False)
        carry = spec.init_carry(state, st, jnp.float64)
        par_j = ebm.Collection(
            {k: jnp.asarray(v, jnp.float64) for k, v in par.items()}
        )
        frow = jnp.asarray(forcing.table(st)[0], jnp.float64)
        Jt = jax.jacrev(lambda c: year(c, par_j, frow)[0])(carry)
        keys = sorted(carry.keys())
        rows = [
            np.concatenate([
                np.asarray(Jt[ko][ki]).reshape(
                    np.asarray(carry[ko]).size, np.asarray(carry[ki]).size
                )
                for ki in keys
            ], axis=1)
            for ko in keys
        ]
        return np.concatenate(rows, axis=0), keys, carry

    def test_classic_matches_dense_radius(self):
        st, base, init = classic_setup()
        eq = ebm.equilibrate("Classic", st, ebm.Forcing(6.0), base, init,
                             tol=0.5, max_years=300)
        J, _, _ = self._dense_jac("Classic", st, ebm.Forcing(6.0), base,
                                  eq.state)
        lam = float(np.max(np.abs(np.linalg.eigvals(J))))
        res = ebm.stability("Classic", st, ebm.Forcing(6.0), base, eq.state,
                            n_iter=80)
        assert abs(res.growth - lam) <= 1e-3 * lam

    def test_miz_raw_and_projected_match_dense(self):
        st = ebm.SpaceTime.sin(8, 150, 1)
        par = ebm.default_parameters("MIZ")
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                             ebm.zeros_init(st), tol=1e-6, max_years=500)
        assert eq.resid < 1e-6  # near enough: the radius is smooth in the state
        J, keys, carry = self._dense_jac("MIZ", st, ebm.Forcing(0.0), par,
                                         eq.state)
        lam = float(np.max(np.abs(np.linalg.eigvals(J))))
        res = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                            n_iter=80)
        assert abs(res.growth - lam) <= 5e-3 * lam

        frozen = np.asarray(eq.state["phi"]) >= 0.99
        assert frozen.any()
        keep = ~np.concatenate([
            frozen if k in ("Ew", "phi")
            else np.zeros(np.asarray(carry[k]).size, bool)
            for k in keys
        ])
        P = np.diag(keep.astype(float))
        lam_p = float(np.max(np.abs(np.linalg.eigvals(P @ J @ P))))
        proj = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                             n_iter=80, project=("Ew", "phi"))
        assert abs(proj.growth - lam_p) <= 5e-3 * max(lam_p, 1e-12)

    def test_block_modes_match_dense_spectrum(self):
        """n_modes=3 subspace iteration reproduces the three largest
        eigenvalue moduli of the dense classic Jacobian."""
        st, base, init = classic_setup()
        eq = ebm.equilibrate("Classic", st, ebm.Forcing(6.0), base, init,
                             tol=0.5, max_years=300)
        J, _, _ = self._dense_jac("Classic", st, ebm.Forcing(6.0), base,
                                  eq.state)
        top = np.sort(np.abs(np.linalg.eigvals(J)))[::-1][:3]
        res = ebm.stability("Classic", st, ebm.Forcing(6.0), base, eq.state,
                            n_iter=120, n_modes=3)
        assert res.growth.shape == (3,)
        assert res.history.shape == (120, 3)
        # the leading mode separates cleanly; modes 2-3 are near-degenerate
        # here (modulus ratio ~0.992), so individual values converge slowly
        # while the SET is already right — compare sorted with a looser bar
        np.testing.assert_allclose(res.growth[0], top[0], rtol=2e-3)
        np.testing.assert_allclose(np.sort(res.growth), np.sort(top),
                                   rtol=1e-2)
        # chunked dispatch invariance holds for blocks too
        res2 = ebm.stability("Classic", st, ebm.Forcing(6.0), base, eq.state,
                             n_iter=120, n_modes=3, iters_per_dispatch=13)
        np.testing.assert_array_equal(res.history, res2.history)
        np.testing.assert_array_equal(res.eigenvalues, res2.eigenvalues)

    def test_ritz_eigenvalues_match_dense(self):
        """.eigenvalues (Rayleigh–Ritz on the final subspace) reproduce
        the SIGNED dense eigenvalues — growth only ever sees moduli."""
        st, base, init = classic_setup()
        eq = ebm.equilibrate("Classic", st, ebm.Forcing(6.0), base, init,
                             tol=0.5, max_years=300)
        J, _, _ = self._dense_jac("Classic", st, ebm.Forcing(6.0), base,
                                  eq.state)
        dense = np.linalg.eigvals(J)
        dense = dense[np.argsort(-np.abs(dense))]
        assert abs(dense[0].imag) < 1e-12  # classic lead mode is real

        solo = ebm.stability("Classic", st, ebm.Forcing(6.0), base,
                             eq.state, n_iter=80)
        assert isinstance(solo.eigenvalues, float)  # signed Rayleigh
        np.testing.assert_allclose(solo.eigenvalues, dense[0].real,
                                   rtol=2e-3)

        res = ebm.stability("Classic", st, ebm.Forcing(6.0), base,
                            eq.state, n_iter=120, n_modes=3)
        assert res.eigenvalues.shape == (3,)
        # sorted by descending modulus
        mags = np.abs(res.eigenvalues)
        assert (mags[:-1] >= mags[1:] - 1e-12).all()
        # the leading Ritz value is tight; the near-degenerate 2-3 pair
        # converges as a SET (same caveat as growth)
        np.testing.assert_allclose(res.eigenvalues[0], dense[0], rtol=2e-3)
        np.testing.assert_allclose(np.sort(mags),
                                   np.sort(np.abs(dense[:3])), rtol=1e-2)

    def test_right_side_matches_dense_and_gives_physical_mode(self):
        """side='right' iterates J itself (jax.linear_transpose of the
        linear pullback): the spectrum matches the adjoint side, and the
        converged mode is a genuine RIGHT eigenvector — J v ~ lambda v
        against the dense Jacobian, which the adjoint mode is NOT."""
        st, base, init = classic_setup()
        eq = ebm.equilibrate("Classic", st, ebm.Forcing(6.0), base, init,
                             tol=0.5, max_years=300)
        J, _, _ = self._dense_jac("Classic", st, ebm.Forcing(6.0), base,
                                  eq.state)
        lam = float(np.max(np.abs(np.linalg.eigvals(J))))
        res = ebm.stability("Classic", st, ebm.Forcing(6.0), base,
                            eq.state, n_iter=150, side="right")
        assert res.side == "right"
        np.testing.assert_allclose(res.growth, lam, rtol=2e-3)
        v = np.concatenate([np.asarray(res.mode[k]).ravel()
                            for k in sorted(res.mode.keys())])
        resid = float(np.linalg.norm(J @ v - res.eigenvalues * v))
        assert resid <= 2e-2 * lam, resid
        # the adjoint mode is a LEFT eigenvector: J^T u ~ lambda u
        adj = ebm.stability("Classic", st, ebm.Forcing(6.0), base,
                            eq.state, n_iter=150)
        u = np.concatenate([np.asarray(adj.mode[k]).ravel()
                            for k in sorted(adj.mode.keys())])
        resid_t = float(np.linalg.norm(J.T @ u - adj.eigenvalues * u))
        assert resid_t <= 2e-2 * lam, resid_t
        with pytest.raises(ValueError, match="side"):
            ebm.stability("Classic", st, ebm.Forcing(6.0), base, eq.state,
                          side="left")

    def test_nonfinite_state_reports_not_converged(self):
        """A divergent (NaN) linearization state — e.g. one level of a
        path that never converged — must come back as converged=False
        with NaN eigenvalues, never raise; and one bad ensemble member
        must not poison the others' Ritz values (np.linalg.eigvals
        refuses non-finite blocks outright)."""
        st = ebm.SpaceTime.sin(8, 150, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["A"] = np.array([193.0, 196.0])
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                             ebm.zeros_init(st), tol=0.0, max_years=5)
        state = ebm.Collection({k: np.array(v, copy=True)
                                for k, v in eq.state.items()})
        for k in state:
            state[k][1] = np.nan  # member 1 diverged
        res = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, state,
                            n_iter=20, n_modes=2)
        assert np.isfinite(np.abs(res.eigenvalues[0])).all()
        assert np.isnan(res.eigenvalues[1]).all()
        assert not np.asarray(res.converged)[1].any()
        # the healthy member still reports a finite leading modulus
        assert np.isfinite(np.asarray(res.growth)[0]).all()

    def test_block_modes_ensemble_shapes_and_validation(self):
        st = ebm.SpaceTime.sin(8, 150, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["A"] = np.array([193.0, 196.0])
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                             ebm.zeros_init(st), tol=1e-5, max_years=500)
        res = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                            n_iter=30, n_modes=3)
        assert res.growth.shape == (2, 3)
        assert res.history.shape == (30, 2, 3)
        assert np.isfinite(res.growth).all()
        assert res.eigenvalues.shape == (2, 3)
        mags = np.abs(res.eigenvalues)
        assert np.isfinite(mags).all()
        assert (mags[:, :-1] >= mags[:, 1:] - 1e-12).all()  # sorted
        # right-side block iteration composes with ensembles (vmapped
        # linear_transpose applications)
        res_r = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                              n_iter=10, n_modes=2, side="right")
        assert res_r.side == "right"
        assert res_r.growth.shape == (2, 2)
        assert np.isfinite(res_r.growth).all()
        # modes within a member are orthonormal
        v = np.concatenate([np.asarray(res.mode[k]) for k in
                            sorted(res.mode.keys())], axis=-1)  # (3, 2, n)
        for kmem in (0, 1):
            g = v[:, kmem, :] @ v[:, kmem, :].T
            np.testing.assert_allclose(g, np.eye(3), atol=1e-10)
        with pytest.raises(ValueError, match="n_modes"):
            ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                          n_modes=0)
        with pytest.raises(ValueError, match="n_modes"):
            ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                          n_modes=10_000)


class TestAnderson:
    """Safeguarded Anderson acceleration (equilibrate(anderson=m)).
    Measured on CPU f64: MIZ nx=16/nt=150 tol=1e-6 needs 125 Picard years
    vs 44 with m=5; a 5-member A-sweep ensemble 204 vs 81."""

    def test_accelerates_and_matches_picard(self):
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.default_parameters("MIZ")
        plain = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                                ebm.zeros_init(st), tol=1e-6, max_years=600)
        aa = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                             ebm.zeros_init(st), tol=1e-6, max_years=600,
                             anderson=5)
        assert plain.converged and aa.converged
        assert aa.years < plain.years * 0.6, (aa.years, plain.years)
        # the MIZ year map is non-hyperbolic (frozen-cell neutral
        # families, see stability), so its equilibria form a MANIFOLD:
        # AA lands on a different — equally stationary — point than
        # forward integration (measured: E offsets up to ~2.5 in frozen
        # cells, ~0.3-0.9 elsewhere; probe resid 1.6e-8 vs Picard's own
        # 5.4e-7). Assert genuine plain-map stationarity plus coarse
        # agreement of the observables.
        probe = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                                aa.state, tol=0.0, max_years=3)
        assert float(probe.resid) < 5e-6
        # the reported state is a MODEL-EVALUATED state (the AA
        # extrapolation itself is never returned), so bounded fields obey
        # their ranges
        phi = np.asarray(aa.state["phi"])
        assert (phi >= 0.0).all() and (phi <= 1.0).all()
        np.testing.assert_allclose(
            np.nan_to_num(np.asarray(aa.seasonal.avg["E"])),
            np.nan_to_num(np.asarray(plain.seasonal.avg["E"])),
            atol=5.0,
        )
        np.testing.assert_allclose(
            np.nan_to_num(np.asarray(aa.seasonal.avg["phi"])),
            np.nan_to_num(np.asarray(plain.seasonal.avg["phi"])),
            atol=0.05,
        )

    def test_ensemble_per_member_and_matches_solo(self):
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        A = np.array([193.0, 197.0])
        par["A"] = A
        ens = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                              ebm.zeros_init(st), tol=1e-5, max_years=600,
                              anderson=4)
        assert np.asarray(ens.converged).all()
        for i in (0, 1):
            solo_par = ebm.Collection(ebm.default_parameters("MIZ"))
            solo_par["A"] = float(A[i])
            solo = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), solo_par,
                                   ebm.zeros_init(st), tol=1e-5,
                                   max_years=600, anderson=4)
            # per-member AA algebra (incl. per-member scaling) means a
            # member's trajectory is the solo trajectory while both are
            # still iterating; they stop at different years, so compare
            # the converged attractors
            np.testing.assert_allclose(
                np.nan_to_num(np.asarray(ens.seasonal.avg["E"]))[i],
                np.nan_to_num(np.asarray(solo.seasonal.avg["E"])),
                atol=2e-4, err_msg=f"member {i}",
            )

    def test_chunking_bitwise_invariant(self):
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.default_parameters("MIZ")
        a = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), tol=1e-6, max_years=100,
                            anderson=4, years_per_dispatch=100)
        b = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), tol=1e-6, max_years=100,
                            anderson=4, years_per_dispatch=7)
        assert a.years == b.years
        for k in a.state:
            np.testing.assert_array_equal(
                np.asarray(a.state[k]), np.asarray(b.state[k]), err_msg=k)

    def test_wobbling_attractor_reports_not_converged(self):
        """nx=40/nt=200 MIZ wobbles at O(0.27) forever; AA iterates settle
        at the cycle's center, but the honest residual (which includes the
        plain year-map carry residual) must keep reporting NOT converged
        at a tolerance below the wobble."""
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.default_parameters("MIZ")
        aa = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                             ebm.zeros_init(st), tol=1e-5, max_years=120,
                             anderson=5)
        assert not aa.converged
        assert float(aa.resid) > 1e-3

    def test_validation(self):
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.default_parameters("MIZ")
        with pytest.raises(ValueError, match="anderson"):
            ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), anderson=-1)

    def test_fused_engine_composes(self):
        """AA wraps any engine's year map; the whole-year engine's AA run
        must converge like the batched one (f32: looser tol)."""
        st = ebm.SpaceTime.sin(16, 100, 1)
        par = ebm.default_parameters("MIZ")
        a = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), tol=1e-2, max_years=200,
                            dtype="float32", engine="batched", anderson=4)
        b = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                            ebm.zeros_init(st), tol=1e-2, max_years=200,
                            dtype="float32", engine="fused", anderson=4)
        assert a.converged and b.converged
        d = np.nanmax(np.abs(
            np.nan_to_num(np.asarray(a.seasonal.avg["E"]))
            - np.nan_to_num(np.asarray(b.seasonal.avg["E"]))))
        assert d < 5.0, d


class TestContinuationProgress:
    def test_progress_bar_completes(self, monkeypatch):
        import io
        import sys

        class Tty(io.StringIO):
            def isatty(self):  # Progress renders only on ttys
                return True

        fake = Tty()
        monkeypatch.setattr(sys, "stdout", fake)
        st = ebm.SpaceTime.sin(16, 100, 1)
        cont = ebm.continuation("MIZ", st, [0.0, 2.0],
                                ebm.default_parameters("MIZ"),
                                ebm.zeros_init(st), tol=1e-2, max_years=60,
                                progress=True)
        out = fake.getvalue()
        assert "Continuation (F)" in out
        assert "Done" in out
        assert "EquilibriumResult" in out  # infofeed carries the level repr
        assert len(cont.results) == 2


class TestContinuationStability:
    def test_stability_along_path_and_roundtrip(self, tmp_path):
        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.default_parameters("MIZ")
        cont = ebm.continuation("MIZ", st, [0.0, 1.0], par,
                                ebm.zeros_init(st), tol=1e-4,
                                max_years=300)
        res = cont.stability(n_iter=15, project=("Ew", "phi"))
        assert len(res) == 2
        assert all(np.isfinite(r.growth) for r in res)
        assert all(r.growth < 1.1 for r in res)  # healthy branch

        # warm_start=False gives independent random starts, same limits
        cold = cont.stability(n_iter=15, project=("Ew", "phi"),
                              warm_start=False)
        for a, b in zip(res, cold):
            assert abs(a.growth - b.growth) < 0.05

        # the analysis config survives save/load
        path = str(tmp_path / "cont.h5")
        ebm.save(cont, path)
        loaded = ebm.load(path)
        assert loaded.model == "MIZ"
        r2 = loaded.stability(n_iter=5)
        assert len(r2) == 2

        # results without the config raise a clear error
        from energybalancemodel_jl_tpu.equilibrium import ContinuationResult
        bare = ContinuationResult(
            values=cont.values, direction=cont.direction,
            results=cont.results, vary=cont.vary, spacetime=cont.spacetime,
        )
        with pytest.raises(ValueError, match="model/par/forcing"):
            bare.stability(n_iter=5)


class TestAndersonFuzz:
    """AA robustness across random configs: the safeguarded iteration must
    never go non-finite, and any 'converged' verdict must be certified by
    a plain-map probe (the honest-residual guarantee)."""

    @pytest.mark.parametrize("seed", [11, 23, 37])
    def test_random_config_stays_finite(self, seed):
        r = np.random.default_rng(seed)
        nx = int(r.choice([16, 24, 32]))
        nt = int(r.choice([100, 150, 250]))
        f = float(r.uniform(-2.0, 3.0))
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        for name in ("D", "A"):
            par[name] = float(par[name] * r.uniform(0.95, 1.05))
        st = ebm.SpaceTime.sin(nx, nt, 1)
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(f), par,
                             ebm.zeros_init(st), tol=1e-4, max_years=150,
                             anderson=int(r.choice([3, 5])))
        for k, v in eq.state.items():
            assert np.isfinite(np.asarray(v)).all(), (k, seed)
        assert np.isfinite(float(eq.resid))
        if eq.converged:
            probe = ebm.equilibrate("MIZ", st, ebm.Forcing(f), par,
                                    eq.state, tol=0.0, max_years=2)
            assert float(probe.resid) < 10 * eq.tol, seed


class TestLockstepBisection:
    def test_virtual_f_bisection_brackets_shrink(self):
        """The fold-tracking workflow (examples/fold_tracking.py): each
        member probes its own bracket midpoint through the virtual
        par['F'] sweep, one lockstep equilibration per bisection step."""
        st = ebm.SpaceTime.sin(16, 1000, 1)
        par = ebm.Collection(ebm.default_parameters("Classic"))
        D_vals = np.array([0.4, 0.8])
        par["D"] = D_vals
        K = len(D_vals)
        E0 = np.full(st.nx, 40.0)
        init = ebm.Collection(E=E0, Tg=E0 / float(par["cw"]))

        p_hi = ebm.Collection(par)
        p_hi["F"] = np.full(K, 20.0)
        warm = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), p_hi, init,
                               tol=0.5, max_years=120)
        assert np.asarray(warm.converged).all()

        from energybalancemodel_jl_tpu.utils.numerics import (
            np_hemispheric_mean,
        )

        lo, hi = np.full(K, -10.0), np.full(K, 20.0)
        for _ in range(5):
            mid = 0.5 * (lo + hi)
            p = ebm.Collection(par)
            p["F"] = mid
            res = ebm.equilibrate("Classic", st, ebm.Forcing(0.0), p,
                                  warm.state, tol=0.5, max_years=100)
            field = (np.asarray(res.seasonal.avg["E"]) < 0.0)
            area = np.asarray([
                2.0 * np.pi * np_hemispheric_mean(
                    f.astype(np.float64), st.x)
                for f in field
            ])
            survived = area < 3.0
            hi = np.where(survived, mid, hi)
            lo = np.where(survived, lo, mid)
        assert (hi - lo <= 30.0 / 2**5 + 1e-9).all()
        # the warm branch dies at higher F for higher diffusivity
        fold = 0.5 * (lo + hi)
        assert fold[1] > fold[0]


class TestContinuationDivergenceWarning:
    def test_non_finite_level_warns(self, monkeypatch):
        import warnings as warnings_mod

        from energybalancemodel_jl_tpu import equilibrium as eqmod

        st = ebm.SpaceTime.sin(16, 100, 1)
        par = ebm.default_parameters("MIZ")
        real = eqmod.equilibrate

        def poisoned(model, st_, fc, p, state, **kw):
            res = real(model, st_, fc, p, state, **kw)
            if float(fc.base) >= 1.0:  # second level diverges
                res.state["Ei"] = np.full_like(
                    np.asarray(res.state["Ei"]), np.nan)
            return res

        monkeypatch.setattr(eqmod, "equilibrate", poisoned)
        with warnings_mod.catch_warnings(record=True) as w:
            warnings_mod.simplefilter("always")
            eqmod.continuation("MIZ", st, [0.0, 1.0], par,
                               ebm.zeros_init(st), tol=1e-2, max_years=30)
        assert any("non-finite state" in str(x.message) for x in w)


class TestEquilibrateProgress:
    def test_progress_bar(self, monkeypatch):
        import io
        import sys

        class Tty(io.StringIO):
            def isatty(self):
                return True

        fake = Tty()
        monkeypatch.setattr(sys, "stdout", fake)
        st = ebm.SpaceTime.sin(16, 100, 1)
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0),
                             ebm.default_parameters("MIZ"),
                             ebm.zeros_init(st), tol=1e-3, max_years=100,
                             progress=True, years_per_dispatch=10)
        out = fake.getvalue()
        assert "Equilibrating" in out
        assert "max resid" in out
        assert "Done" in out
        assert eq.converged


class TestStabilityMesh:
    """stability(mesh=): members sharded across the virtual 8-device mesh
    must reproduce the unsharded estimates (block-diagonal iteration; the
    partitioned norm reductions reassociate, hence ~1e-9 not bitwise)."""

    def test_sharded_matches_unsharded(self):
        from energybalancemodel_jl_tpu.parallel.sharding import ensemble_mesh

        st = ebm.SpaceTime.sin(16, 150, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["A"] = np.linspace(192, 199, 8)
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                             ebm.zeros_init(st), tol=1e-4, max_years=300)
        a = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                          n_iter=15)
        b = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                          n_iter=15, mesh=ensemble_mesh(8))
        np.testing.assert_allclose(a.history, b.history, rtol=1e-9)

        # per-member F offsets + block modes compose with the mesh
        par2 = ebm.Collection(ebm.default_parameters("MIZ"))
        par2["F"] = np.linspace(0.0, 1.0, 8)
        c = ebm.stability("MIZ", st, ebm.Forcing(0.0), par2,
                          ebm.zeros_init(st), n_iter=10, n_modes=2,
                          mesh=ensemble_mesh(8))
        assert c.growth.shape == (8, 2)
        assert np.isfinite(c.growth).all()

        # side="right" (linear_transpose applications) partitions too
        d = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                          n_iter=15, mesh=ensemble_mesh(8), side="right")
        e = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, eq.state,
                          n_iter=15, side="right")
        np.testing.assert_allclose(d.history, e.history, rtol=1e-9)

        with pytest.raises(ValueError, match="mesh= needs an ensemble"):
            ebm.stability("MIZ", st, ebm.Forcing(0.0),
                          ebm.default_parameters("MIZ"),
                          ebm.zeros_init(st), mesh=ensemble_mesh(8))
        par3 = ebm.Collection(ebm.default_parameters("MIZ"))
        par3["A"] = np.linspace(192, 199, 6)  # 6 % 8 != 0
        with pytest.raises(ValueError, match="divisible"):
            ebm.stability("MIZ", st, ebm.Forcing(0.0), par3,
                          ebm.zeros_init(st), mesh=ensemble_mesh(8))

    def test_anderson_composes_with_mesh(self):
        """AA + mesh= (sharded whole-year engine inside the loop): runs,
        finite, and tracks the unsharded fused AA run (f32 engine spread
        ~0.5 amplifies slightly under extrapolation)."""
        from energybalancemodel_jl_tpu.parallel.sharding import ensemble_mesh

        st = ebm.SpaceTime.sin(16, 64, 2)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["D"] = np.linspace(0.5, 0.7, 16)
        eq = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                             ebm.zeros_init(st), tol=0.0, max_years=6,
                             dtype="float32", mesh=ensemble_mesh(8),
                             anderson=3)
        E = np.nan_to_num(np.asarray(eq.seasonal.avg["E"]))
        assert eq.years == 6 and np.isfinite(E).all()
        ref = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par,
                              ebm.zeros_init(st), tol=0.0, max_years=6,
                              dtype="float32", engine="fused", anderson=3)
        E2 = np.nan_to_num(np.asarray(ref.seasonal.avg["E"]))
        assert np.abs(E - E2).max() < 2.0


class TestProductSweep:
    """batched_parameters() product grids compose with the equilibrium
    layer (the sweep -> equilibrate bifurcation-map workflow)."""

    def test_batched_parameters_compose_with_equilibrate(self):
        from energybalancemodel_jl_tpu.parallel.ensemble import (
            batched_parameters,
        )

        st = ebm.SpaceTime.sin(16, 200, 1)
        base = ebm.Collection(ebm.default_parameters("MIZ"))
        par = batched_parameters(base, {"D": [0.55, 0.65],
                                        "F": [0.0, 2.0]})
        init = ebm.zeros_init(st)
        # tol=0 pins the year count so lockstep members equal solo runs
        res = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init,
                              tol=0.0, max_years=20)
        assert np.asarray(res.resid).shape == (4,)
        solo_par = ebm.Collection(base)
        solo_par["D"], solo_par["F"] = 0.55, 0.0
        solo = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), solo_par,
                               init, tol=0.0, max_years=20)
        for k in solo.state:
            assert np.allclose(
                np.nan_to_num(np.asarray(res.state[k][0])),
                np.nan_to_num(np.asarray(solo.state[k])), atol=1e-12), k
        # stability accepts the same product Collection
        stab = ebm.stability("MIZ", st, ebm.Forcing(0.0), par, res.state,
                             n_iter=5)
        assert np.atleast_1d(stab.growth).shape == (4,)


class TestCheckEvery:
    """check_every=M: M-year blocks per while-loop iteration (an inner
    lax.scan), convergence read at block boundaries."""

    ST = None

    @staticmethod
    def _cfg():
        st = ebm.SpaceTime.sin(16, 200, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["A"] = np.array([193.0, 196.0])
        return st, par, ebm.zeros_init(st)

    def test_fused_blocks_are_bitwise_invariant(self):
        st, par, init = self._cfg()
        kw = dict(tol=0.0, max_years=13, dtype="float32", engine="fused")
        a = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init, **kw)
        b = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init,
                            check_every=4, **kw)
        assert a.years == b.years == 13
        for k in a.state:
            assert np.array_equal(np.asarray(a.state[k]),
                                  np.asarray(b.state[k])), k

    def test_xla_blocks_agree_to_rounding(self):
        # the XLA engine re-fuses the M-year block as one scan; FMA
        # contraction choices differ from the per-year loop body at
        # ~1e-13 over 13 f64 years (golden-fixture sensitivity class)
        st, par, init = self._cfg()
        a = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init,
                            tol=0.0, max_years=13)
        b = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init,
                            tol=0.0, max_years=13, check_every=4)
        for k in a.state:
            assert np.allclose(np.asarray(a.state[k]),
                               np.asarray(b.state[k]),
                               rtol=0, atol=1e-9), k

    def test_convergence_resolves_to_block_boundaries(self):
        st, par, init = self._cfg()
        res = ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init,
                              tol=1e-3, max_years=100, check_every=5)
        assert res.years % 5 == 1  # init year + whole blocks
        my = np.asarray(res.member_years)
        assert np.all((my == 0) | (my % 5 == 1)), my

    def test_validation(self):
        st, par, init = self._cfg()
        with pytest.raises(ValueError, match="check_every"):
            ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init,
                            check_every=0)
        with pytest.raises(ValueError, match="anderson"):
            ebm.equilibrate("MIZ", st, ebm.Forcing(0.0), par, init,
                            check_every=4, anderson=3)
