"""Integrate driver semantics: storage modes, seasonal snapshots, debug hook."""
import numpy as np
import pytest

from energybalancemodel_jl_tpu import (
    Collection,
    Forcing,
    SpaceTime,
    annual_mean,
    default_parameters,
    integrate,
    zeros_init,
)


def small_run(**kw):
    st = SpaceTime.sin(20, 40, 3)
    par = default_parameters("MIZ")
    return st, integrate("MIZ", st, Forcing(0.0), par, zeros_init(st), progress=False, **kw)


class TestStorage:
    def test_lastonly_shapes_and_times(self):
        st, sols = small_run(lastonly=True)
        assert sols.raw["E"].shape == (st.nt, st.nx)
        # ts covers only the final year (reference :352-353)
        np.testing.assert_allclose(sols.ts[0], st.dur - 1 + st.dt / 2)
        np.testing.assert_allclose(sols.ts[-1], st.dur - st.dt / 2)

    def test_full_raw(self):
        st, sols = small_run(lastonly=False)
        assert sols.raw["E"].shape == (st.dur * st.nt, st.nx)
        assert len(sols.ts) == st.dur * st.nt

    def test_lastonly_equals_tail_of_full(self):
        # one engine for both runs: under engine='auto' the seasonal-only
        # years of the lastonly run take the whole-year engine, which
        # agrees with the scan at round-off, not bitwise
        st, s_last = small_run(lastonly=True, engine="scan")
        _, s_full = small_run(lastonly=False, engine="scan")
        for k in ("E", "h", "phi"):
            np.testing.assert_array_equal(
                s_last.raw[k], s_full.raw[k][-st.nt :], err_msg=k
            )

    def test_raw_none(self):
        st, sols = small_run(raw_mode="none")
        assert sols.raw["E"].shape[0] == 0
        assert sols.seasonal.avg["E"].shape == (st.dur, st.nx)

    def test_seasonal_snapshots_match_raw(self):
        st, sols = small_run(lastonly=False)
        w0 = st.winter_inx - 1
        s0 = st.summer_inx - 1
        for year in range(st.dur):
            base = year * st.nt
            for k in ("E", "h"):
                np.testing.assert_array_equal(
                    sols.seasonal.winter[k][year], sols.raw[k][base + w0], err_msg=k
                )
                np.testing.assert_array_equal(
                    sols.seasonal.summer[k][year], sols.raw[k][base + s0], err_msg=k
                )

    def test_annual_mean_matches_raw_mean(self):
        st, sols = small_run(lastonly=False)
        for year in range(st.dur):
            chunk = sols.raw["E"][year * st.nt : (year + 1) * st.nt]
            np.testing.assert_allclose(
                sols.seasonal.avg["E"][year], chunk.mean(axis=0), rtol=1e-12, atol=1e-12
            )

    def test_annual_mean_helper(self):
        _, sols = small_run(lastonly=True)
        means = annual_mean(sols.raw)
        np.testing.assert_allclose(means["E"], sols.raw["E"].mean(axis=0))


class TestDriver:
    def test_debug_hook_recorded(self):
        st = SpaceTime.sin(16, 20, 2)
        par = default_parameters("MIZ")

        def dbg(vars_out, par):
            return vars_out["E"] * 2.0

        sols = integrate("MIZ", st, Forcing(0.0), par, zeros_init(st),
                         debug=dbg, lastonly=False, progress=False)
        np.testing.assert_allclose(sols.raw["debug"], 2.0 * sols.raw["E"])
        assert "debug" in sols.seasonal.avg

    def test_missing_init_raises(self):
        st = SpaceTime.sin(8, 10, 1)
        with pytest.raises(ValueError, match="missing"):
            integrate("MIZ", st, Forcing(0.0), default_parameters("MIZ"),
                      Collection(Ei=np.zeros(8)), progress=False)

    def test_unknown_model_raises(self):
        st = SpaceTime.sin(8, 10, 1)
        with pytest.raises(ValueError, match="Unknown model"):
            integrate("NOPE", st, Forcing(0.0), Collection(), Collection(), progress=False)

    def test_forcing_ramp_is_applied(self):
        """A strong warming ramp melts ice relative to constant forcing."""
        st = SpaceTime.sin(32, 400, 8)
        par = default_parameters("MIZ")
        ramp = Forcing(0.0, 20.0, -20.0, (2, 100), (10.0, -10.0))
        s_const = integrate("MIZ", st, Forcing(0.0), par, zeros_init(st), progress=False)
        s_ramp = integrate("MIZ", st, ramp, par, zeros_init(st), progress=False)
        ice_const = np.nansum(s_const.seasonal.avg["phi"][-1])
        ice_ramp = np.nansum(s_ramp.seasonal.avg["phi"][-1])
        assert ice_ramp < ice_const

    def test_results_independent_of_year_chunking(self):
        """dur=2 equals two manual 1-year runs chained (scan carry is exact)."""
        st2 = SpaceTime.sin(16, 30, 2)
        par = default_parameters("MIZ")
        sols = integrate("MIZ", st2, Forcing(0.0), par, zeros_init(st2),
                         lastonly=False, progress=False)
        st1 = SpaceTime.sin(16, 30, 1)
        first = integrate("MIZ", st1, Forcing(0.0), par, zeros_init(st1),
                          lastonly=False, progress=False)
        np.testing.assert_array_equal(sols.raw["E"][: st1.nt], first.raw["E"])


class TestYearsPerDispatch:
    """Multi-year chunked dispatch (one outer scan per chunk) must reproduce
    the per-year dispatch path (to compiled-graph rounding: the outer scan
    is a different graph, so equality is tolerance-level, not bitwise —
    which is also why the chunking is recorded in the checkpoint key)."""

    def test_chunked_equals_per_year(self):
        st, base = small_run()
        _, chunked = small_run(years_per_dispatch=8)
        for k in ("E", "h", "phi"):
            np.testing.assert_allclose(
                np.nan_to_num(base.seasonal.avg[k]),
                np.nan_to_num(chunked.seasonal.avg[k]),
                rtol=0, atol=1e-7, err_msg=k,
            )
            np.testing.assert_allclose(
                base.raw[k], chunked.raw[k], rtol=0, atol=1e-7, err_msg=k
            )

    def test_chunk_respects_checkpoint_boundaries(self, tmp_path):
        import energybalancemodel_jl_tpu as ebm
        from energybalancemodel_jl_tpu import checkpoint as ckpt

        st = ebm.SpaceTime.sin(16, 30, 5)
        ck = str(tmp_path / "c.h5")
        ebm.integrate(
            "MIZ", st, ebm.Forcing(0.0), ebm.default_parameters("MIZ"),
            ebm.zeros_init(st), progress=False, raw_mode="none",
            checkpoint=ck, checkpoint_every=2, years_per_dispatch=64,
        )
        _, years, acc, _ = ckpt.read_checkpoint(ck)
        assert years == st.dur
        assert len(acc[0]) == st.dur
