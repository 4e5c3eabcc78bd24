"""Noise-forced transitions (`ebm.transitions`).

The load-bearing invariants:

- ``sigma=0`` reproduces the DETERMINISTIC trajectory — the noise enters
  only through the forcing row, so the zero-noise member-year areas must
  equal a plain :func:`ebm.integrate` of the same init.
- dispatch chunking is bitwise-invariant (the noise realization is keyed
  on (seed, member, ABSOLUTE year), never on the chunk layout).
- the escape statistics respond to the noise amplitude in the physically
  required direction near the classic fold (CLAUDE.md: warm+snowball
  coexist for F in ~[5, 15]; the warm basin is shallow at the low end).
"""
import numpy as np
import pytest

import energybalancemodel_jl_tpu as ebm
from energybalancemodel_jl_tpu.fold import seasonal_ice_area
from energybalancemodel_jl_tpu.stochastic import transitions


def _classic_setup(nx=8, nt=1000):
    st = ebm.SpaceTime.sin(nx, nt, 1)
    par = ebm.Collection(ebm.default_parameters("Classic"))
    cw = float(par["cw"])
    mk = lambda e: ebm.Collection(
        {"E": np.full(nx, e), "Tg": np.full(nx, e) / cw})
    return st, par, mk


@pytest.fixture(scope="module")
def bistable():
    """Warm + snowball attractors of the classic model at F=10 (middle of
    the measured bistable window)."""
    st, par, mk = _classic_setup()
    F = 10.0
    a = ebm.equilibrate("Classic", st, F, par, mk(30.0),
                        max_years=120, tol=2.0)
    b = ebm.equilibrate("Classic", st, F, par, mk(-30.0),
                        max_years=120, tol=2.0)
    assert a.converged and b.converged
    return st, par, F, a, b


class TestDeterministicLimit:
    def test_sigma_zero_matches_integrate(self, bistable):
        st, par, F, a, b = bistable
        res = transitions("Classic", st, F, par, a, b, sigma=0.0,
                          years=4, K=3, seed=7)
        # all members identical (same start, zero noise)
        for k in range(1, 3):
            np.testing.assert_array_equal(res.areas[:, 0], res.areas[:, k])
        # and equal to the deterministic integrate of the same init
        st4 = ebm.SpaceTime.sin(st.nx, st.nt, 4)
        sol = ebm.integrate("Classic", st4, ebm.Forcing(F), par,
                            a.state, engine="scan", lastonly=False)
        ref = np.asarray(seasonal_ice_area(sol.seasonal.avg, st4))
        np.testing.assert_allclose(res.areas[:, 0], ref, rtol=0, atol=1e-12)
        assert not np.any(res.escaped)
        assert res.labels.shape == (4, 3)
        assert np.all(res.labels == 0)

    def test_virtual_F_sweep_members_match_solo(self, bistable):
        st, par, F, a, b = bistable
        offs = np.array([0.0, 2.0])
        par_s = ebm.Collection(par)
        par_s["F"] = offs
        res = transitions("Classic", st, F, par_s, a, b, sigma=0.0,
                          years=3, seed=0)
        assert res.areas.shape == (3, 2)
        for k, off in enumerate(offs):
            st3 = ebm.SpaceTime.sin(st.nx, st.nt, 3)
            sol = ebm.integrate("Classic", st3, ebm.Forcing(F + off), par,
                                a.state, engine="scan", lastonly=False)
            ref = np.asarray(seasonal_ice_area(sol.seasonal.avg, st3))
            np.testing.assert_allclose(res.areas[:, k], ref,
                                       rtol=0, atol=1e-12)


class TestNoise:
    def test_chunking_bitwise_invariant(self, bistable):
        st, par, F, a, b = bistable
        kw = dict(sigma=8.0, tau=0.05, years=6, K=4, seed=1, track=("E",))
        r1 = transitions("Classic", st, F, par, a, b, **kw)
        r2 = transitions("Classic", st, F, par, a, b,
                         years_per_dispatch=2, **kw)
        np.testing.assert_array_equal(r1.areas, r2.areas)
        np.testing.assert_array_equal(r1.tracked["E"], r2.tracked["E"])
        np.testing.assert_array_equal(r1.eta, r2.eta)
        for k in r1.state:
            np.testing.assert_array_equal(r1.state[k], r2.state[k])

    def test_seed_reproducible_and_members_spread(self, bistable):
        st, par, F, a, b = bistable
        kw = dict(sigma=8.0, tau=0.05, years=4, K=4, track=("E",))
        r1 = transitions("Classic", st, F, par, a, b, seed=1, **kw)
        r1b = transitions("Classic", st, F, par, a, b, seed=1, **kw)
        np.testing.assert_array_equal(r1.tracked["E"], r1b.tracked["E"])
        r2 = transitions("Classic", st, F, par, a, b, seed=2, **kw)
        assert not np.array_equal(r1.tracked["E"], r2.tracked["E"])
        # members carry independent noise: the continuous mean spreads
        # (classic ice AREAS are cell-quantized, so compare means)
        assert float(np.std(r1.tracked["E"][-1])) > 1e-3

    def test_ou_stationary_std(self, bistable):
        # final eta across many members ~ the stationary OU std = sigma
        st, par, F, a, b = bistable
        r = transitions("Classic", st, F, par, a, b, sigma=5.0, tau=0.02,
                        years=2, K=256, seed=3)
        assert float(np.std(r.eta)) == pytest.approx(5.0, rel=0.25)

    def test_escapes_near_the_fold(self):
        # at F=5.5 the warm basin is shallow (window edge ~5): strong
        # noise must kick members into the snowball within decades, weak
        # noise must not. Measured per-member escape probability ~0.25
        # at this config (16/64 at seed 0), so K=32 makes zero escapes a
        # ~1e-4 event — seed-robust, not seed-tuned.
        st, par, mk = _classic_setup()
        F = 5.5
        a = ebm.equilibrate("Classic", st, F, par, mk(30.0),
                            max_years=120, tol=2.0)
        b = ebm.equilibrate("Classic", st, F, par, mk(-30.0),
                            max_years=120, tol=2.0)
        assert a.converged and b.converged
        strong = transitions("Classic", st, F, par, a, b, sigma=24.0,
                             tau=0.05, years=25, K=32, seed=0)
        assert strong.newton_ok
        n_esc = int(np.count_nonzero(strong.escaped))
        assert n_esc >= 1
        fp = strong.first_passage[strong.escaped]
        assert np.all((fp >= 1) & (fp <= 25))
        assert strong.escape_rate() > 0.0
        assert strong.escape_fraction() == pytest.approx(n_esc / 32.0)
        # escaped members sit at the snowball label afterwards
        for k in np.nonzero(strong.escaped)[0]:
            y = int(strong.first_passage[k])
            assert strong.labels[y - 1, k] == 1
        weak = transitions("Classic", st, F, par, a, b, sigma=0.5,
                           tau=0.05, years=10, K=8, seed=0)
        assert not np.any(weak.escaped)
        assert np.isnan(weak.mean_first_passage())
        assert weak.escape_rate() == 0.0


class TestFirstPassage:
    def test_label_history_cases(self):
        from energybalancemodel_jl_tpu.stochastic import _first_passage

        labels = np.array([
            # members: stayed | escaped y3 | bad y1 | escape y2 then bad |
            #          bad y3 no escape | escaped y1
            [0, 0, -1, 0, 0, 1],
            [0, 0, -1, 1, 0, 1],
            [0, 1, 0, -1, -1, 1],
            [0, 1, 1, -1, -1, 1],
        ], dtype=np.int8)
        fp, finite = _first_passage(labels, start_label=0)
        np.testing.assert_array_equal(
            fp, [np.nan, 3.0, np.nan, 2.0, np.nan, 1.0])
        np.testing.assert_array_equal(
            finite, [True, True, False, True, False, True])
        # starting from b, "other" is label 0: member 0 crosses at year 1
        fp_b, finite_b = _first_passage(labels, start_label=1)
        assert fp_b[0] == 1.0 and finite_b[0]


class TestMIZ:
    def test_bare_state_references_and_phi_area(self):
        # a/b as bare state Collections exercise the one-year reference
        # re-run; MIZ's area comes from phi (NaN-masked presentation)
        st = ebm.SpaceTime.sin(8, 1000, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        cold = ebm.equilibrate("MIZ", st, -15.0, par, ebm.zeros_init(st),
                               max_years=5, tol=0.0)
        warm = ebm.equilibrate("MIZ", st, 25.0, par, ebm.zeros_init(st),
                               max_years=5, tol=0.0)
        res = transitions("MIZ", st, 5.0, par, warm.state, cold.state,
                          sigma=2.0, tau=0.02, years=3, K=2, seed=0,
                          track=("T",))
        assert res.areas.shape == (3, 2)
        assert np.all(np.isfinite(res.areas))
        assert res.newton_ok
        assert res.tracked["T"].shape == (3, 2)


class TestMesh:
    def test_sharded_matches_unsharded(self, bistable):
        import jax
        from jax.sharding import Mesh

        st, par, F, a, b = bistable
        kw = dict(sigma=6.0, tau=0.05, years=3, K=4, seed=5, track=("E",),
                  engine="scan")
        r0 = transitions("Classic", st, F, par, a, b, **kw)
        mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("members",))
        r1 = transitions("Classic", st, F, par, a, b, mesh=mesh, **kw)
        np.testing.assert_array_equal(r0.areas, r1.areas)
        np.testing.assert_array_equal(r0.tracked["E"], r1.tracked["E"])
        np.testing.assert_array_equal(r0.eta, r1.eta)


class TestValidationAndIO:
    def test_validation_errors(self, bistable):
        st, par, F, a, b = bistable
        ramp = ebm.Forcing(0.0, 5.0, -5.0, (1, 1), (1.0, -1.0))
        # ramps are supported (round 4) but cannot sweep par across members
        par_ramp = ebm.Collection(par)
        par_ramp["D"] = np.array([0.5, 0.6])
        with pytest.raises(ValueError, match="ramped"):
            transitions("Classic", st, ramp, par_ramp, a, b, sigma=1.0)
        # ... and ref_init is ramp-only
        with pytest.raises(ValueError, match="ref_init"):
            transitions("Classic", st, F, par, a, b, sigma=1.0,
                        ref_init=(a.state, b.state))
        with pytest.raises(ValueError, match="start"):
            transitions("Classic", st, F, par, a, b, sigma=1.0, start="c")
        with pytest.raises(ValueError, match="season"):
            transitions("Classic", st, F, par, a, b, sigma=1.0,
                        season="spring")
        with pytest.raises(ValueError, match="sigma"):
            transitions("Classic", st, F, par, a, b, sigma=-1.0)
        with pytest.raises(ValueError, match="track"):
            transitions("Classic", st, F, par, a, b, sigma=1.0,
                        years=1, K=2, track=("nope",))
        par_s = ebm.Collection(par)
        par_s["D"] = np.array([0.4, 0.5, 0.6])
        with pytest.raises(ValueError, match="conflicts"):
            transitions("Classic", st, F, par_s, a, b, sigma=1.0, K=2)
        with pytest.raises(ValueError, match="eta0"):
            transitions("Classic", st, F, par, a, b, sigma=1.0, K=2,
                        years=1, eta0=np.zeros(3))
        import jax
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("members",))
        with pytest.raises(ValueError, match="divisible"):
            transitions("Classic", st, F, par, a, b, sigma=1.0, K=3,
                        years=1, mesh=mesh)

    def test_swept_par_requires_result_references(self, bistable):
        st, par, F, a, b = bistable
        par_s = ebm.Collection(par)
        par_s["D"] = np.array([0.4, 0.5])
        with pytest.raises(ValueError, match="EquilibriumResult"):
            transitions("Classic", st, F, par_s, a.state, b, sigma=1.0,
                        years=1)

    def test_round_trip(self, bistable, tmp_path):
        st, par, F, a, b = bistable
        res = transitions("Classic", st, F, par, a, b, sigma=6.0,
                          years=3, K=2, seed=4, track=("E",))
        path = str(tmp_path / "trans.h5")
        ebm.save(res, path)
        back = ebm.load(path)
        assert isinstance(back, ebm.TransitionResult)
        np.testing.assert_array_equal(back.areas, res.areas)
        np.testing.assert_array_equal(back.first_passage, res.first_passage)
        np.testing.assert_array_equal(back.tracked["E"], res.tracked["E"])
        assert back.sigma == res.sigma and back.start == res.start

    def test_eta0_resume_material(self, bistable):
        st, par, F, a, b = bistable
        r = transitions("Classic", st, F, par, a, b, sigma=6.0,
                        years=2, K=2, seed=4)
        # extend from the returned carries/noise (fresh seed by contract)
        r2 = transitions("Classic", st, F, par, a, b, sigma=6.0,
                         years=2, K=2, seed=5, init=r.state, eta0=r.eta)
        assert r2.areas.shape == (2, 2)
        assert np.all(np.isfinite(r2.areas))

    def test_plot(self, bistable):
        import matplotlib

        matplotlib.use("Agg")
        st, par, F, a, b = bistable
        res = transitions("Classic", st, F, par, a, b, sigma=6.0,
                          years=3, K=2, seed=4)
        fig = ebm.plot_transitions(res)
        assert fig is not None
        import matplotlib.pyplot as plt

        plt.close(fig)


class TestYear0Resume:
    def test_split_run_is_bitwise(self, bistable):
        """The round-4 continuation contract: years=4 equals 2 + 2 with
        year0=2, the SAME seed, and the first half's state/eta — draws are
        keyed on the absolute year, so the tail reproduces bit-exactly."""
        st, par, F, a, b = bistable
        kw = dict(sigma=6.0, tau=0.05, K=3, seed=9, track=("E",))
        full = transitions("Classic", st, F, par, a, b, years=4, **kw)
        head = transitions("Classic", st, F, par, a, b, years=2, **kw)
        tail = transitions("Classic", st, F, par, a, b, years=2, year0=2,
                           init=head.state, eta0=head.eta, **kw)
        np.testing.assert_array_equal(
            np.concatenate([head.areas, tail.areas]), full.areas)
        np.testing.assert_array_equal(
            np.concatenate([head.tracked["E"], tail.tracked["E"]]),
            full.tracked["E"])
        np.testing.assert_array_equal(tail.eta, full.eta)
        for k in full.state:
            np.testing.assert_array_equal(tail.state[k], full.state[k])


class TestPerMemberSigma:
    def test_sigma_vector_zero_member_is_deterministic(self, bistable):
        """sigma=(K,) sweeps noise amplitudes across lockstep members; a
        zero entry reproduces the deterministic trajectory exactly (in the
        scan engine, whose per-member arithmetic does not depend on K)."""
        st, par, F, a, b = bistable
        res = transitions("Classic", st, F, par, a, b,
                          sigma=np.array([0.0, 6.0, 12.0]), tau=0.05,
                          years=3, seed=2, track=("E",), engine="scan")
        assert res.areas.shape == (3, 3)
        det = transitions("Classic", st, F, par, a, b, sigma=0.0,
                          years=3, K=1, seed=2, track=("E",), engine="scan")
        np.testing.assert_array_equal(res.tracked["E"][:, 0],
                                      det.tracked["E"][:, 0])
        # noisy members actually differ from the deterministic one
        assert not np.array_equal(res.tracked["E"][:, 1],
                                  res.tracked["E"][:, 0])
        assert isinstance(res.sigma, np.ndarray)
        assert "sigma in [0, 12]" in repr(res)

    def test_round_trip_vector_sigma(self, bistable, tmp_path):
        st, par, F, a, b = bistable
        res = transitions("Classic", st, F, par, a, b,
                          sigma=np.array([1.0, 2.0]), years=2, seed=0)
        path = str(tmp_path / "vs.h5")
        ebm.save(res, path)
        back = ebm.load(path)
        np.testing.assert_array_equal(back.sigma, res.sigma)
        np.testing.assert_array_equal(back.areas, res.areas)


class TestDegeneracyGuard:
    def test_coincident_references_flag(self, bistable):
        """Passing the SAME attractor twice makes the reference gap zero —
        every label is a coin flip and the result must say so."""
        st, par, F, a, b = bistable
        with pytest.warns(UserWarning, match="degenerate"):
            res = transitions("Classic", st, F, par, a, a, sigma=8.0,
                              tau=0.05, years=4, K=3, seed=1)
        assert res.degenerate

    def test_distinct_references_do_not_flag(self, bistable):
        st, par, F, a, b = bistable
        res = transitions("Classic", st, F, par, a, b, sigma=6.0,
                          tau=0.05, years=4, K=3, seed=1)
        assert not res.degenerate


class TestTieBreak:
    def test_equidistant_year_labels_start(self):
        """An exactly equidistant area must be labeled as the START
        attractor for either start — a tie is never a first passage
        (advisor r3)."""
        from energybalancemodel_jl_tpu.stochastic import _first_passage

        # reproduce the label computation on synthetic areas
        areas = np.array([[2.0]])  # exactly between refs at 1 and 3
        d_a = np.abs(areas - 1.0)
        d_b = np.abs(areas - 3.0)
        lab_a = (d_b < d_a).astype(np.int8)          # start='a' branch
        lab_b = np.where(d_a < d_b, 0, 1).astype(np.int8)  # start='b'
        assert lab_a[0, 0] == 0  # tie -> a
        assert lab_b[0, 0] == 1  # tie -> b
        fp_a, _ = _first_passage(lab_a, 0)
        fp_b, _ = _first_passage(lab_b, 1)
        assert np.isnan(fp_a[0]) and np.isnan(fp_b[0])


class TestRamp:
    def _ramp(self):
        # hold 10 (1 yr), warm to 11 (1 yr), hold 1 yr, cool at -1/yr to
        # -5 (16 yr): the warm branch dies below F ~ 5 (CLAUDE.md), so the
        # deterministic run tips mid-ramp
        return ebm.Forcing(10.0, 11.0, -5.0, (1, 1), (1.0, -1.0))

    def test_sigma_zero_members_ride_the_reference(self, bistable):
        st, par, F, a, b = bistable
        ramp = self._ramp()
        with np.errstate(invalid="ignore"):
            res = transitions("Classic", st, ramp, par, a, b, sigma=0.0,
                              years=8, K=2, seed=0)
        assert res.ramped
        assert res.area_a.shape == (8,)
        assert res.ref_state is not None
        # zero-noise members ARE the on-'a' companion (same program,
        # zero noise) — bitwise
        for k in range(2):
            np.testing.assert_array_equal(res.areas[:, k], res.area_a)
        assert not np.any(res.escaped)

    def test_noise_advances_tipping(self, bistable):
        """The rate-induced-tipping headline: under the down-ramp the
        deterministic run tips when the warm branch dies; noisy members
        tip EARLIER. The post-tip reference merge must trip the
        degeneracy flag."""
        st, par, F, a, b = bistable
        ramp = self._ramp()
        years = 25
        with pytest.warns(UserWarning, match="degenerate"):
            res = transitions("Classic", st, ramp, par, a, b, sigma=10.0,
                              tau=0.05, years=years, K=8, seed=3)
        # deterministic tipping year: the on-'a' companion lands on the
        # snowball area (largest jump of the reference trajectory)
        det_tip = int(np.argmax(np.abs(np.diff(res.area_a)))) + 1
        assert det_tip > 2  # the ramp takes a while to kill the branch
        assert np.any(res.escaped)
        fp = res.first_passage[res.escaped]
        assert np.min(fp) <= det_tip
        assert res.degenerate  # references merge after the det tip

    def test_ramp_chunking_bitwise_invariant(self, bistable):
        st, par, F, a, b = bistable
        ramp = self._ramp()
        kw = dict(sigma=8.0, tau=0.05, years=6, K=3, seed=1)
        import warnings as _w

        with _w.catch_warnings():
            _w.simplefilter("ignore")
            r1 = transitions("Classic", st, ramp, par, a, b, **kw)
            r2 = transitions("Classic", st, ramp, par, a, b,
                             years_per_dispatch=2, **kw)
        np.testing.assert_array_equal(r1.areas, r2.areas)
        np.testing.assert_array_equal(r1.area_a, r2.area_a)
        np.testing.assert_array_equal(r1.area_b, r2.area_b)

    def test_ramp_ref_resume(self, bistable):
        """Ramp split/continue: ref_init + year0 reproduce the
        uninterrupted companions bit-exactly."""
        st, par, F, a, b = bistable
        ramp = self._ramp()
        kw = dict(sigma=8.0, tau=0.05, K=2, seed=4)
        import warnings as _w

        with _w.catch_warnings():
            _w.simplefilter("ignore")
            full = transitions("Classic", st, ramp, par, a, b, years=6, **kw)
            head = transitions("Classic", st, ramp, par, a, b, years=3, **kw)
            tail = transitions("Classic", st, ramp, par, a, b, years=3,
                               year0=3, init=head.state, eta0=head.eta,
                               ref_init=head.ref_state, **kw)
        np.testing.assert_array_equal(
            np.concatenate([head.areas, tail.areas]), full.areas)
        np.testing.assert_array_equal(
            np.concatenate([head.area_a, tail.area_a]), full.area_a)
        for k in full.ref_state[0]:
            np.testing.assert_array_equal(tail.ref_state[0][k],
                                          full.ref_state[0][k])

    def test_ramp_round_trip(self, bistable, tmp_path):
        st, par, F, a, b = bistable
        ramp = self._ramp()
        import warnings as _w

        with _w.catch_warnings():
            _w.simplefilter("ignore")
            res = transitions("Classic", st, ramp, par, a, b, sigma=8.0,
                              years=4, K=2, seed=0)
        path = str(tmp_path / "ramp.h5")
        ebm.save(res, path)
        back = ebm.load(path)
        assert back.ramped
        np.testing.assert_array_equal(back.area_a, res.area_a)
        for k in res.ref_state[0]:
            np.testing.assert_array_equal(back.ref_state[0][k],
                                          res.ref_state[0][k])
        np.testing.assert_array_equal(back.areas, res.areas)


class TestFusedEngine:
    def test_fused_matches_scan_miz(self):
        """engine='fused' draws the SAME weather as the scan engine and
        produces the same areas at cross-graph tolerance (f64: the
        per-step insolation rebuild is ~1 ulp off the XLA table)."""
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        warm = ebm.equilibrate("MIZ", st, 25.0, par, ebm.zeros_init(st),
                               max_years=4, tol=0.0)
        cold = ebm.equilibrate("MIZ", st, -15.0, par, ebm.zeros_init(st),
                               max_years=4, tol=0.0)
        kw = dict(sigma=1.0, tau=0.05, years=2, K=3, seed=6, track=("T",))
        rs = transitions("MIZ", st, 5.0, par, warm.state, cold.state,
                         engine="scan", **kw)
        rf = transitions("MIZ", st, 5.0, par, warm.state, cold.state,
                         engine="fused", **kw)
        assert rf.engine == "fused" and rs.engine == "scan"
        np.testing.assert_allclose(rf.areas, rs.areas, atol=5e-3)
        np.testing.assert_allclose(rf.tracked["T"], rs.tracked["T"],
                                   atol=1e-4)
        np.testing.assert_array_equal(rf.labels, rs.labels)

    def test_fused_sigma_zero_matches_deterministic_kernel(self):
        """sigma=0 through the fused engine equals the deterministic
        whole-year engine bitwise (the OU offsets are exactly zero)."""
        import jax.numpy as jnp

        from energybalancemodel_jl_tpu.models.base import (
            default_step_config, get_model)
        from energybalancemodel_jl_tpu.ops.year import miz_year
        from energybalancemodel_jl_tpu.utils.collection import Collection

        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        warm = ebm.equilibrate("MIZ", st, 25.0, par, ebm.zeros_init(st),
                               max_years=3, tol=0.0)
        cold = ebm.equilibrate("MIZ", st, -15.0, par, ebm.zeros_init(st),
                               max_years=3, tol=0.0)
        res = transitions("MIZ", st, 5.0, par, warm.state, cold.state,
                          sigma=0.0, engine="fused", years=1, K=2, seed=0)
        spec = get_model("MIZ")
        import numpy as _np

        dtype = jnp.dtype("float64")
        cfg = default_step_config(dtype.name, newton_max_iter=30)
        carry = spec.init_carry(warm.state, st, dtype)
        carry = Collection({k: jnp.broadcast_to(v, (2,) + v.shape)
                            for k, v in carry.items()})
        parj = Collection({k: jnp.asarray(v, dtype) for k, v in par.items()})
        parj["F"] = jnp.zeros((2,), dtype)
        fyear = jnp.full((st.nt,), 5.0, dtype)
        det = miz_year(carry, parj, fyear, st, cfg)
        for k in det[0]:
            _np.testing.assert_array_equal(res.state[k],
                                           _np.asarray(det[0][k]))

    def test_fused_chunking_bitwise_invariant(self):
        st = ebm.SpaceTime.sin(40, 200, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        warm = ebm.equilibrate("MIZ", st, 25.0, par, ebm.zeros_init(st),
                               max_years=3, tol=0.0)
        cold = ebm.equilibrate("MIZ", st, -15.0, par, ebm.zeros_init(st),
                               max_years=3, tol=0.0)
        kw = dict(sigma=1.5, tau=0.05, K=2, seed=2, engine="fused")
        r1 = transitions("MIZ", st, 5.0, par, warm.state, cold.state,
                         years=4, **kw)
        r2 = transitions("MIZ", st, 5.0, par, warm.state, cold.state,
                         years=4, years_per_dispatch=2, **kw)
        np.testing.assert_array_equal(r1.areas, r2.areas)
        np.testing.assert_array_equal(r1.eta, r2.eta)
        for k in r1.state:
            np.testing.assert_array_equal(r1.state[k], r2.state[k])

    def test_fused_classic_parity(self, bistable):
        st, par, F, a, b = bistable
        kw = dict(sigma=6.0, tau=0.05, years=3, K=2, seed=5, track=("E",))
        rs = transitions("Classic", st, F, par, a, b, engine="scan", **kw)
        rf = transitions("Classic", st, F, par, a, b, engine="fused", **kw)
        np.testing.assert_allclose(rf.tracked["E"], rs.tracked["E"],
                                   atol=1e-6)
        np.testing.assert_array_equal(rf.labels, rs.labels)

    def test_fused_validation(self, bistable):
        import jax
        from jax.sharding import Mesh

        st, par, F, a, b = bistable
        # fused + mesh is SUPPORTED since round 5 (TestMeshFused); what
        # must still fail is a member count the mesh cannot divide
        mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("members",))
        with pytest.raises(ValueError, match="divisible"):
            transitions("Classic", st, F, par, a, b, sigma=1.0, K=3,
                        years=1, engine="fused", mesh=mesh,
                        dtype="float32")
        with pytest.raises(ValueError, match="engine"):
            transitions("Classic", st, F, par, a, b, sigma=1.0, years=1,
                        engine="warp")


class TestDrawGeneration:
    """Keyed draw generation inside the whole-year engine and the
    log-depth `ou_impl='assoc'` OU path."""

    @pytest.fixture(scope="class")
    def setup32(self):
        st, par, mk = _classic_setup()
        F = 10.0
        a = ebm.equilibrate("Classic", st, F, par, mk(30.0),
                            max_years=120, tol=2.0)
        b = ebm.equilibrate("Classic", st, F, par, mk(-30.0),
                            max_years=120, tol=2.0)
        assert a.converged and b.converged
        return st, par, F, a, b

    def test_keys_mode_draws_the_scan_engines_weather(self, setup32):
        """The whole-year engine draws its weather from the member keys
        inside the year program; the scan engine per year. Same weather:
        the OU state the two carry out of the run agrees to round-off
        (it does not depend on the model state)."""
        st, par, F, a, b = setup32
        kw = dict(sigma=4.0, tau=0.05, years=2, K=5, seed=3,
                  dtype="float32")
        r_key = transitions("Classic", st, F, par, a, b, engine="fused", **kw)
        r_scan = transitions("Classic", st, F, par, a, b, engine="scan",
                             **kw)
        np.testing.assert_allclose(r_key.eta, r_scan.eta, rtol=1e-5,
                                   atol=1e-6)

    def test_keys_mode_year0_resume_bit_exact(self, setup32):
        """The split/continue contract survives keyed generation (keys are
        year-folded per absolute year, same as the scan engine's
        draws)."""
        st, par, F, a, b = setup32
        kw = dict(sigma=4.0, tau=0.05, K=4, seed=9, dtype="float32",
                  engine="fused")
        full = transitions("Classic", st, F, par, a, b, years=4, **kw)
        head = transitions("Classic", st, F, par, a, b, years=2, **kw)
        tail = transitions("Classic", st, F, par, a, b, years=2,
                           year0=2, init=head.state, eta0=head.eta, **kw)
        np.testing.assert_array_equal(full.areas[:2], head.areas)
        np.testing.assert_array_equal(full.areas[2:], tail.areas)
        np.testing.assert_array_equal(full.eta, tail.eta)

    def test_assoc_engine_parity_and_sigma_zero(self, setup32):
        st, par, F, a, b = setup32
        kw = dict(sigma=4.0, tau=0.05, years=4, K=5, seed=3,
                  dtype="float32", engine="fused")
        r_ser = transitions("Classic", st, F, par, a, b,
                            ou_impl="serial", **kw)
        r_as = transitions("Classic", st, F, par, a, b,
                           ou_impl="assoc", **kw)
        assert np.isfinite(r_as.areas).all()
        # same weather at tree-regrouping round-off: year-end etas agree
        # tightly; areas at engine-parity tolerance
        np.testing.assert_allclose(r_as.eta, r_ser.eta, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r_as.areas, r_ser.areas, atol=5e-3)
        # sigma=0: both bitwise-deterministic (and hence equal)
        k0 = dict(kw, sigma=0.0, years=2)
        r0s = transitions("Classic", st, F, par, a, b,
                          ou_impl="serial", **k0)
        r0a = transitions("Classic", st, F, par, a, b,
                          ou_impl="assoc", **k0)
        np.testing.assert_array_equal(r0s.areas, r0a.areas)

    def test_assoc_requires_fused(self, setup32):
        st, par, F, a, b = setup32
        with pytest.raises(ValueError, match="whole-year-engine mode"):
            transitions("Classic", st, F, par, a, b, sigma=1.0, years=2,
                        K=3, engine="scan", ou_impl="assoc")

    def test_assoc_in_float64_matches_serial(self, setup32):
        """The log-depth OU path also runs over float64 tables."""
        st, par, F, a, b = setup32
        kw = dict(sigma=4.0, tau=0.05, years=2, K=3, seed=1,
                  dtype="float64", engine="fused")
        r_ser = transitions("Classic", st, F, par, a, b, **kw)
        r_as = transitions("Classic", st, F, par, a, b, ou_impl="assoc",
                           **kw)
        np.testing.assert_allclose(r_as.eta, r_ser.eta, rtol=1e-10,
                                   atol=1e-10)

    def test_f64_fused_matches_scan_weather(self, setup32):
        """In float64 the fused engine draws the scan engine's weather
        from the same keys and matches its areas."""
        st, par, F, a, b = setup32
        kw = dict(sigma=4.0, tau=0.05, years=2, K=3, seed=1,
                  dtype="float64")
        r_f = transitions("Classic", st, F, par, a, b, engine="fused",
                          **kw)
        r_s = transitions("Classic", st, F, par, a, b, engine="scan",
                          **kw)
        np.testing.assert_allclose(r_f.areas, r_s.areas, atol=1e-9)


class TestMeshFused:
    """Whole-year engine + mesh: the year is shard-mapped over the member
    axis — per-member keying makes the sharded weather EXACTLY the
    unsharded weather, in both OU impls."""

    def test_sharded_fused_matches_unsharded(self, bistable):
        import jax
        from jax.sharding import Mesh

        st, par, F, a, b = bistable
        kw = dict(sigma=6.0, tau=0.05, years=3, K=4, seed=5,
                  dtype="float64", track=("E",), engine="fused")
        r0 = transitions("Classic", st, F, par, a, b, **kw)
        mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("members",))
        r1 = transitions("Classic", st, F, par, a, b, mesh=mesh, **kw)
        # the weather and the cell-quantized areas are exact; XLA compiles
        # the year for the shard's member count, so the fields may differ
        # in the last bits — float64 keeps that at round-off
        np.testing.assert_array_equal(r0.areas, r1.areas)
        np.testing.assert_array_equal(r0.eta, r1.eta)
        np.testing.assert_allclose(r0.tracked["E"], r1.tracked["E"],
                                   rtol=1e-10, atol=1e-9)
        for k in r0.state:
            np.testing.assert_allclose(r0.state[k], r1.state[k],
                                       rtol=1e-10, atol=1e-9, err_msg=k)

    def test_sharded_assoc_and_swept_sigma(self, bistable):
        import jax
        from jax.sharding import Mesh

        st, par, F, a, b = bistable
        # per-member sigma sweep exercises the sharded (K,) scale leaf
        kw = dict(sigma=np.array([2.0, 4.0, 6.0, 8.0]), tau=0.05,
                  years=3, K=4, seed=2, dtype="float32", engine="fused",
                  ou_impl="assoc")
        r0 = transitions("Classic", st, F, par, a, b, **kw)
        mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("members",))
        r1 = transitions("Classic", st, F, par, a, b, mesh=mesh, **kw)
        np.testing.assert_array_equal(r0.areas, r1.areas)
        np.testing.assert_array_equal(r0.eta, r1.eta)


class TestSubyearCrossing:
    """First-crossing detection (`subyear=True`): the whole-year engine
    reduces each STEP's instantaneous ice area and records the first step
    past the reference midpoint — sub-annual transition timing at one
    (K,) row per year."""

    @pytest.fixture(scope="class")
    def escapes(self):
        st, par, mk = _classic_setup()
        F = 5.5
        a = ebm.equilibrate("Classic", st, F, par, mk(30.0),
                            max_years=120, tol=2.0)
        b = ebm.equilibrate("Classic", st, F, par, mk(-30.0),
                            max_years=120, tol=2.0)
        r = transitions("Classic", st, F, par, a, b, sigma=24.0,
                        tau=0.05, years=25, K=32, seed=0,
                        dtype="float32", engine="fused", subyear=True)
        return r

    def test_crossing_semantics(self, escapes):
        r = escapes
        assert r.crossing_step.shape == (25, 32) and r.nt == 1000
        # values are -1 or valid step indices
        cs = r.crossing_step
        assert ((cs == -1) | ((cs >= 0) & (cs < r.nt))).all()
        assert r.escaped.sum() >= 1
        fps = r.first_passage_subyear()
        esc = r.escaped
        # the instantaneous crossing never lags the year-mean classifier
        assert (fps[esc] <= r.first_passage[esc]).all()
        # and at least one member is refined to a non-trivial step
        assert (fps[esc] % 1.0 > 0).any()

    def test_sigma_zero_never_crosses(self, escapes):
        st, par, mk = _classic_setup()
        F = 5.5
        a = ebm.equilibrate("Classic", st, F, par, mk(30.0),
                            max_years=120, tol=2.0)
        b = ebm.equilibrate("Classic", st, F, par, mk(-30.0),
                            max_years=120, tol=2.0)
        r0 = transitions("Classic", st, F, par, a, b, sigma=0.0,
                         years=3, K=3, seed=0, dtype="float32",
                         engine="fused", subyear=True)
        assert (r0.crossing_step == -1).all()
        np.testing.assert_array_equal(
            r0.first_passage_subyear(), r0.first_passage)

    def test_subyear_roundtrip_and_validation(self, escapes, tmp_path):
        p = str(tmp_path / "sub.h5")
        ebm.save(escapes, p)
        r2 = ebm.load(p)
        np.testing.assert_array_equal(r2.crossing_step,
                                      escapes.crossing_step)
        assert r2.nt == escapes.nt
        np.testing.assert_array_equal(r2.first_passage_subyear(),
                                      escapes.first_passage_subyear())
        st, par, mk = _classic_setup()
        a = mk(30.0)
        with pytest.raises(ValueError, match="fused"):
            transitions("Classic", st, 5.5, par, a, a, sigma=1.0,
                        years=2, K=2, engine="scan", subyear=True)
        r64 = transitions("Classic", st, 5.5, par, a, a, sigma=1.0,
                          years=2, K=2, engine="fused", subyear=True,
                          dtype="float64")  # crossings run in float64 too
        assert r64.crossing_step.shape == (2, 2)
        ramp = ebm.Forcing(0.0, 5.0, -5.0, (1, 1), (1.0, -1.0))
        with pytest.raises(ValueError, match="RAMPED"):
            # ref_area0 seeds ramped subyear thresholds only
            transitions("Classic", st, 5.5, par, a, a, sigma=1.0,
                        years=2, K=2, engine="fused", subyear=True,
                        dtype="float32", ref_area0=(1.0, 2.0))
        import jax
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("members",))
        with pytest.raises(ValueError, match="single shard"):
            transitions("Classic", st, ramp, par, a, a, sigma=1.0,
                        years=2, K=2, engine="fused", subyear=True,
                        dtype="float32", mesh=mesh)

    def test_miz_kernel_detector_semantics(self):
        """The MIZ crossing path (phi-based instantaneous area +
        threshold comparison) — previously only the Classic detector had
        coverage. Deterministic contract: members on their
        own attractor never cross (all -1); an ``init=`` override on the
        FAR side is already across at every year start (step 0, the
        documented already-across semantics)."""
        import warnings

        st = ebm.SpaceTime.sin(16, 1000, 1)
        par = ebm.Collection(ebm.default_parameters("MIZ"))
        par["D"] = 0.6  # pinned bistable config (test_miz_bistability)
        F = 0.0
        kw = dict(tol=1e-2, max_years=300, dtype="float32")
        warm = ebm.equilibrate("MIZ", st, F, par, ebm.zeros_init(st),
                               **kw)
        cold = ebm.continuation("MIZ", st, np.array([-24.0, F]), par,
                                ebm.zeros_init(st), **kw).results[-1]
        assert warm.converged
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            on_branch = transitions(
                "MIZ", st, F, par, warm, cold, sigma=0.0, years=2, K=3,
                seed=0, dtype="float32", engine="fused", subyear=True)
            across = transitions(
                "MIZ", st, F, par, warm, cold, sigma=0.0, years=2, K=3,
                seed=0, start="a", init=cold.state, dtype="float32",
                engine="fused", subyear=True)
        assert (on_branch.crossing_step == -1).all()
        assert (across.crossing_step == 0).all()
        np.testing.assert_array_equal(across.first_passage,
                                      np.ones(3))

    def test_crossing_matches_raw_oracle(self):
        """The per-step area + crossing step vs a numpy
        recomputation from the RAW XLA engine under identical weather
        (engine-parity trajectories: the step index matches within a
        small window around the threshold)."""
        import jax
        import jax.numpy as jnp

        from energybalancemodel_jl_tpu.integrate import make_year_fn
        from energybalancemodel_jl_tpu.models.base import (
            default_step_config, get_model)
        from energybalancemodel_jl_tpu.ops.year import (
            _trapezoid_weights, classic_year)
        from energybalancemodel_jl_tpu.utils.collection import Collection

        st = ebm.SpaceTime.sin(8, 200, 1)
        dtype = jnp.float32
        par = Collection({k: jnp.asarray(v, dtype) for k, v in
                          ebm.default_parameters("Classic").items()})
        spec = get_model("Classic")
        cw = float(par["cw"])
        E0 = np.full(st.nx, 12.0)  # warm-ish, will freeze under F=-20
        init = Collection(E=E0, Tg=E0 / cw)
        carry = spec.init_carry(init, st, dtype)
        K = 2
        carry = Collection({k: jnp.broadcast_to(v, (K,) + v.shape)
                            for k, v in carry.items()})
        fyear = jnp.full((st.nt,), -20.0, dtype)
        base = jax.random.PRNGKey(1)
        yk = jax.vmap(lambda i: jax.random.fold_in(base, i))(
            jnp.arange(K, dtype=jnp.uint32))
        cfg = default_step_config("float32")
        rho = jnp.asarray(0.9, dtype)
        scale = jnp.asarray(2.0, dtype)
        eta0 = jnp.zeros((K,), dtype)
        thr = jnp.full((K,), 0.3, dtype)
        sgn = jnp.ones((K,), dtype)
        *_, cross = classic_year(
            carry, par, fyear, st, cfg,
            noise_keys=yk, noise_ou=(rho, scale, eta0),
            crossing=(thr, sgn))
        # oracle: raw XLA year under the same weather
        xi = np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (st.nt,), dtype),
            out_axes=1)(yk), np.float64)
        eta = np.zeros(K)
        etas = np.empty((st.nt, K))
        for t in range(st.nt):
            eta = 0.9 * eta + 2.0 * xi[t]
            etas[t] = eta
        year = make_year_fn("Classic", st, cfg, "float32", True)
        fy = (np.asarray(fyear)[:, None, None]
              + etas[:, :, None]).astype(np.float32)
        _, _, _, ys = year(carry, Collection(
            {k: (v[:, None] if jnp.ndim(v) == 1 else v)
             for k, v in par.items()}), jnp.asarray(fy))
        E_steps = np.asarray(ys["E"])  # (nt, K, nx)
        w = np.asarray(_trapezoid_weights(st.x, dtype))
        areas = ((E_steps < 0).astype(np.float64) * w).sum(axis=-1)
        for k in range(K):
            hit = np.nonzero(areas[:, k] > 0.3)[0]
            want = hit[0] if hit.size else -1
            got = int(np.asarray(cross)[k])
            assert abs(got - want) <= 2, (k, got, want)


class TestSubyearRamped:
    """Round-5b: ramped (rate-induced) subyear crossings — the crossing
    threshold EVOLVES with the sigma-zero companions (lag-1 entering
    midpoint, updated in-scan; chunk boundaries and resumes re-derive it
    bitwise via the host twin `_thr_sgn_rows`)."""

    def _ramp(self):
        # TestRamp's config: the warm branch dies mid-ramp, so the
        # deterministic companion tips and noisy members tip EARLIER
        return ebm.Forcing(10.0, 11.0, -5.0, (1, 1), (1.0, -1.0))

    @pytest.fixture(scope="class")
    def ramped_sub(self, bistable):
        import warnings

        st, par, F, a, b = bistable
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = transitions("Classic", st, self._ramp(), par, a, b,
                            sigma=10.0, tau=0.05, years=20, K=6, seed=3,
                            dtype="float32", engine="fused", subyear=True)
        return r

    def test_subannual_lead_on_the_det_tip(self, ramped_sub):
        r = ramped_sub
        assert r.ramped and r.crossing_step.shape == (20, 6)
        cs = r.crossing_step
        assert ((cs == -1) | ((cs >= 0) & (cs < r.nt))).all()
        det_tip = int(np.argmax(np.abs(np.diff(r.area_a)))) + 1
        esc = r.escaped
        assert esc.any()
        fps = r.first_passage_subyear()
        # the instantaneous crossing never lags the year-mean classifier,
        # refines at least one member to a mid-year step, and leads the
        # deterministic tipping year
        assert (fps[esc] <= r.first_passage[esc]).all()
        assert (fps[esc] % 1.0 > 0).any()
        assert np.nanmin(fps[esc]) < det_tip

    def test_chunking_bitwise_invariant(self, bistable):
        import warnings

        st, par, F, a, b = bistable
        kw = dict(sigma=10.0, tau=0.05, years=7, K=4, seed=1,
                  dtype="float32", engine="fused", subyear=True)
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r1 = transitions("Classic", st, self._ramp(), par, a, b,
                             years_per_dispatch=1, **kw)
            r3 = transitions("Classic", st, self._ramp(), par, a, b,
                             years_per_dispatch=3, **kw)
        np.testing.assert_array_equal(r1.areas, r3.areas)
        np.testing.assert_array_equal(r1.crossing_step, r3.crossing_step)

    def test_resume_with_ref_area0_is_seamless(self, bistable, ramped_sub):
        """Split at year 9 and continue with ref_area0=(area_a[-1],
        area_b[-1]): the resumed segment's thresholds re-enter the lag-1
        chain bitwise — areas AND crossing steps match the uninterrupted
        run exactly."""
        import warnings

        st, par, F, a, b = bistable
        r = ramped_sub
        kw = dict(sigma=10.0, tau=0.05, K=6, seed=3, dtype="float32",
                  engine="fused", subyear=True)
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ra = transitions("Classic", st, self._ramp(), par, a, b,
                             years=9, **kw)
            rb = transitions("Classic", st, self._ramp(), par, a, b,
                             years=11, year0=9, init=ra.state, eta0=ra.eta,
                             ref_init=ra.ref_state,
                             ref_area0=(ra.area_a[-1], ra.area_b[-1]),
                             **kw)
        np.testing.assert_array_equal(ra.areas, r.areas[:9])
        np.testing.assert_array_equal(ra.crossing_step,
                                      r.crossing_step[:9])
        np.testing.assert_array_equal(rb.areas, r.areas[9:])
        np.testing.assert_array_equal(rb.crossing_step,
                                      r.crossing_step[9:])

    def test_start_b_evolving_sign(self, bistable):
        """The sdir=-1 branch of the evolving update (`start='b'`):
        members on the FAR (warm) side of the moving midpoint are
        already across at every year start — step 0 recorded all the
        way down the ramp, and the year-mean classifier fires at year 1
        (the documented init=-override semantics, now under an evolving
        threshold). Cheap and deterministic — the push tier's
        ramped-subyear smoke (the heavy cases run nightly)."""
        import warnings

        st, par, F, a, b = bistable
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = transitions("Classic", st, self._ramp(), par, a, b,
                            start="b", init=a.state, sigma=0.0, years=6,
                            K=3, seed=0, dtype="float32", engine="fused",
                            subyear=True)
        assert (r.crossing_step == 0).all()
        np.testing.assert_array_equal(r.first_passage, np.ones(3))

    def test_sigma_zero_records_the_det_crossing(self, bistable):
        """Zero-noise members ride the on-'a' companion; the detector's
        crossings ARE the deterministic tip's instantaneous timing: none
        while the companion holds its branch, first hit only after the
        companion starts moving and no later than its largest annual
        jump (the instantaneous seasonal peak crosses the evolving
        midpoint YEARS before the annual mean — the lead the subyear
        diagnostic exists to measure). The year-mean classifier itself
        never fires (members == the reference exactly)."""
        import warnings

        st, par, F, a, b = bistable
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = transitions("Classic", st, self._ramp(), par, a, b,
                            sigma=0.0, years=20, K=2, seed=0,
                            dtype="float32", engine="fused", subyear=True)
        assert not r.escaped.any()  # members ride the reference
        det_tip = int(np.argmax(np.abs(np.diff(r.area_a)))) + 1
        first_move = int(np.nonzero(np.diff(r.area_a))[0][0]) + 1
        hit_years = np.nonzero((r.crossing_step >= 0).any(axis=1))[0]
        assert hit_years.size >= 1
        assert first_move <= int(hit_years[0]) <= det_tip
        np.testing.assert_array_equal(r.crossing_step[:, 0],
                                      r.crossing_step[:, 1])
