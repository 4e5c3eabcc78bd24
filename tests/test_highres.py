"""High-resolution / transient-forcing coverage (VERDICT r2 #1).

The north-star BASELINE config[4] is "high-resolution grid with transient
CO2 forcing ramp and checkpoint I/O". Measured facts this module pins:

- The whole-year engine (ops/year.py) holds NO insolation table (it
  rebuilds the separable insolation each step), so it runs at high nx
  and nt like the per-year scan engine does.
- MIZ inherits the reference's EXPLICIT Tb diffusion substep
  (/root/reference/src/miz.jl:150-162), whose Nyquist (checkerboard)
  stability requires nt to scale like nx**2 — the canonical nx=180/nt=2000
  sits just under the line, and nx>=512 at canonical nt blows up in a few
  steps (measured; the REFERENCE has the same envelope). The legitimate
  high-resolution model is therefore Classic, whose implicit tridiagonal
  Tg solve (/root/reference/src/classic.jl) is unconditionally stable.

Also anchors the TRANSIENT path to the oracle: every prior oracle parity
test ran constant forcing; here a full 5-segment CO2-style ramp (base ->
warming -> peak -> cooling -> cool, /root/reference/src/infrastructure.jl:
171-207) is integrated through every segment and compared year-by-year
against ``ref_impl.py`` with the ramp values computed INDEPENDENTLY from
the reference's piecewise definition.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))
import energybalancemodel_jl_tpu as ebm  # noqa: E402
from ref_impl import ClassicRef  # noqa: E402


def _ramp_value(T, base, peak, cool, holdyrs, rates):
    """The reference Forcing's piecewise law, transcribed from the
    docstring (/root/reference/src/infrastructure.jl:175-182) — shares
    no code with ``forcing.py``."""
    warm_years = (peak - base) / rates[0]
    cool_years = (cool - peak) / rates[1]
    d2 = holdyrs[0]
    d3 = d2 + warm_years
    d4 = d3 + holdyrs[1]
    d5 = d4 + cool_years
    if T < d2:
        return base
    if T < d3:
        return base + rates[0] * (T - d2)
    if T < d4:
        return peak
    if T < d5:
        return peak + rates[1] * (T - d3 - holdyrs[1])
    return cool


class TestRampOracle:
    """Transient-forcing trajectory parity, all five ramp segments."""

    NX, NT, DUR = 40, 1000, 8
    RAMP = dict(base=0.0, peak=2.0, cool=-1.0, holdyrs=(1, 1),
                rates=(2.0, -3.0))  # domain (0, 1, 2, 3, 4): peak by yr 2,
    # cooling over yr 3, cool from yr 4 — all five segments inside 8 years

    def test_classic_ramp_matches_oracle_year_by_year(self):
        st = ebm.SpaceTime.sin(self.NX, self.NT, self.DUR)
        r = self.RAMP
        forcing = ebm.Forcing(r["base"], r["peak"], r["cool"],
                              r["holdyrs"], r["rates"])
        par = ebm.Collection(ebm.default_parameters("Classic"))
        E0 = np.full(self.NX, 30.0)
        init = ebm.Collection(E=E0, Tg=E0 / float(par["cw"]))

        sols = ebm.integrate("Classic", st, forcing, par, init,
                             progress=False, raw_mode="none",
                             lastonly=False)
        avg_f = np.asarray(sols.seasonal.avg["E"])  # (dur, nx)
        assert avg_f.shape == (self.DUR, self.NX)

        ref = ClassicRef(self.NX, self.NT, "sin", dict(par))
        E, Tg = E0.copy(), E0 / float(par["cw"])
        t_in_year = (np.arange(self.NT) + 0.5) / self.NT
        for year in range(self.DUR):
            Esum = np.zeros(self.NX)
            for i in range(self.NT):
                f = _ramp_value(year + t_in_year[i], **r)
                E, Tg, _, _ = ref.step(E, Tg, i, f)
                Esum += E
            diff = float(np.max(np.abs(Esum / self.NT - avg_f[year])))
            # classic is contracting: cross-implementation drift stays at
            # solver-tolerance scale through all five ramp segments
            assert diff < 1e-7, f"year {year}: {diff}"

    def test_ramp_values_cross_check(self):
        # the independent transcription and forcing.py agree pointwise
        r = self.RAMP
        forcing = ebm.Forcing(r["base"], r["peak"], r["cool"],
                              r["holdyrs"], r["rates"])
        for T in (0.0, 0.5, 1.0, 1.25, 1.999, 2.0, 2.5, 3.0, 3.4, 3.99,
                  4.0, 7.5):
            assert forcing(T) == pytest.approx(_ramp_value(T, **r),
                                               abs=1e-12)


class TestWholeYearReach:
    """The whole-year engine at high resolution."""

    def test_classic_whole_year_matches_scan_at_nx_4096(self):
        # nx=4096/nt=1000: the whole-year engine rebuilds the insolation
        # each step where the scan engine reads its table. Engine-vs-engine
        # f32 comparisons carry inherent albedo-step-cell divergence
        # (measured max 0.3 at ice-edge cells).
        st = ebm.SpaceTime.sin(4096, 1000, 1)
        par = ebm.Collection(ebm.default_parameters("Classic"))
        E0 = np.full(4096, 30.0)
        init = ebm.Collection(E=E0, Tg=E0 / float(par["cw"]))
        kw = dict(progress=False, raw_mode="none", dtype="float32")
        fused = ebm.integrate("Classic", st, ebm.Forcing(0.0), par, init,
                              engine="fused", **kw)
        scan = ebm.integrate("Classic", st, ebm.Forcing(0.0), par, init,
                             engine="scan", **kw)
        a = np.asarray(fused.seasonal.avg["E"])
        b = np.asarray(scan.seasonal.avg["E"])
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1.0)
        # the field is O(10-100): typical agreement is ~5e-4 relative
        # (measured median |diff| 0.03), only step cells reach 0.3
        assert float(np.median(np.abs(a - b))) < 0.1


class TestMIZStabilityEnvelope:
    """MIZ's explicit Tb diffusion needs nt ~ nx**2 (inherited from the
    reference, /root/reference/src/miz.jl:150-162): the Nyquist coupling
    D*dt/dx**2 ~ nx**2/nt must stay near the canonical 180**2/2000. This
    pins WHY the high-resolution configs below run Classic."""

    def test_scaled_nt_is_stable(self):
        # nx=256/nt=4000: coupling 256**2/4000 = 16.4 ~ canonical 16.2
        st = ebm.SpaceTime.sin(256, 4000, 1)
        sols = ebm.integrate("MIZ", st, ebm.Forcing(0.0),
                             ebm.default_parameters("MIZ"),
                             ebm.zeros_init(st), progress=False,
                             raw_mode="none")
        E = np.asarray(sols.seasonal.avg["E"])
        assert np.isfinite(E).all()

    def test_canonical_nt_blows_up_at_high_nx(self):
        # nx=512 at canonical-scale nt: coupling 512**2/2000 = 131 >> 16
        st = ebm.SpaceTime.sin(512, 2000, 1)
        sols = ebm.integrate("MIZ", st, ebm.Forcing(0.0),
                             ebm.default_parameters("MIZ"),
                             ebm.zeros_init(st), progress=False,
                             raw_mode="none")
        E = np.asarray(sols.seasonal.avg["E"])
        assert not np.isfinite(E).all()


HIGH_NX, HIGH_NT = 4096, 1000


class TestHighResFallback:
    """The full north-star shape (high-res sin grid, 5-segment ramp,
    checkpoint I/O) end-to-end at nx=4096 under ``engine='auto'``."""

    def test_auto_engine_runs_the_high_res_ramp_with_checkpoint(self,
                                                                tmp_path):
        from energybalancemodel_jl_tpu import checkpoint as ckpt
        st = ebm.SpaceTime.sin(HIGH_NX, HIGH_NT, 2)
        ramp = ebm.Forcing(0.0, 1.0, 0.0, (0, 0), (1.0, -1.0))
        par = ebm.Collection(ebm.default_parameters("Classic"))
        E0 = np.full(HIGH_NX, 30.0)
        init = ebm.Collection(E=E0, Tg=E0 / float(par["cw"]))
        ck_full = str(tmp_path / "full.ck")
        full = ebm.integrate("Classic", st, ramp, par, init,
                             progress=False, raw_mode="none",
                             engine="auto", checkpoint=ck_full)
        # build a genuine MID-RUN checkpoint (year 1 of 2): run the dur=1
        # prefix, then graft its state under the dur=2 run's key (the
        # test_checkpoint.py crash-emulation pattern)
        st1 = ebm.SpaceTime.sin(HIGH_NX, HIGH_NT, 1)
        ck1 = str(tmp_path / "prefix.ck")
        ebm.integrate("Classic", st1, ramp, par, init,
                      progress=False, raw_mode="none", engine="auto",
                      checkpoint=ck1)
        carry, years, acc, _key1 = ckpt.read_checkpoint(ck1)
        assert years == 1
        _c, _y, _a, key2 = ckpt.read_checkpoint(ck_full)
        ck = str(tmp_path / "mid.ck")
        ckpt.write_checkpoint(ck, carry, years, acc, key2)
        resumed = ebm.integrate("Classic", st, ramp, par, init,
                                progress=False, raw_mode="none",
                                engine="auto", checkpoint=ck, resume=True)
        E_full = np.asarray(full.seasonal.avg["E"])
        E_res = np.asarray(resumed.seasonal.avg["E"])
        assert np.isfinite(E_full).all()
        np.testing.assert_array_equal(E_full, E_res)  # bit-exact resume


class TestHighResSharding:
    """The sharded spatial path at REAL shard sizes: nx=1024 over the
    8-device virtual mesh = 128 grid cells per device (the dryrun uses
    4-8)."""

    def test_spatial_integrate_matches_unsharded_at_nx_1024(self):
        from energybalancemodel_jl_tpu.parallel.spatial import (
            grid_mesh, spatial_integrate)
        st = ebm.SpaceTime.sin(1024, 1000, 1)
        par = ebm.Collection(ebm.default_parameters("Classic"))
        E0 = np.full(1024, 30.0)
        init = ebm.Collection(E=E0, Tg=E0 / float(par["cw"]))
        mesh = grid_mesh()
        assert mesh.devices.size == 8
        shr = spatial_integrate("Classic", st, ebm.Forcing(0.0), par,
                                init, mesh=mesh, progress=False)
        solo = ebm.integrate("Classic", st, ebm.Forcing(0.0), par, init,
                             progress=False, raw_mode="none")
        E_s = np.asarray(shr.seasonal.avg["E"])
        E_u = np.asarray(solo.seasonal.avg["E"])
        assert E_s.shape[-1] == 1024
        assert np.isfinite(E_s).all()
        np.testing.assert_allclose(E_s, E_u, atol=1e-8)

    def test_grid2d_matches_batched_at_nx_1024(self):
        # 2-D (members x grid) mesh at a real grid shard size: K=2 members
        # x 4 grid shards = 256 cells/device (the dryrun uses 4-8)
        from energybalancemodel_jl_tpu.parallel.ensemble import (
            ensemble_integrate)
        from energybalancemodel_jl_tpu.parallel.grid2d import (
            ensemble_spatial_integrate, grid2d_mesh)
        st = ebm.SpaceTime.sin(1024, 1000, 1)
        par = ebm.Collection(ebm.default_parameters("Classic"))
        par["A"] = float(par["A"]) + np.array([0.0, 2.0])
        E0 = np.full(1024, 30.0)
        init = ebm.Collection(E=E0, Tg=E0 / float(par["cw"]))
        ens = ensemble_integrate("Classic", st, ebm.Forcing(0.0), par,
                                 init, engine="batched", raw_mode="none",
                                 progress=False)
        ens2 = ensemble_spatial_integrate(
            "Classic", st, ebm.Forcing(0.0), par, init,
            mesh=grid2d_mesh(2, 4), raw_mode="none", progress=False)
        a = np.asarray(ens.seasonal.avg["E"])
        b = np.asarray(ens2.seasonal.avg["E"])
        assert b.shape == (2, 1, 1024)  # (K, dur, nx)
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-11)
